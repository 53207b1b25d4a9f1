"""Shared pieces of the port's tests of the VLM, Mamba2-hybrid and RWKV6
families against the JAX package on the CPU.

Each family is built once per process at its reduced config: the
reference's initial train state (``init_train_state`` under
``jax.jit``), whose parameters every test uses, and the port's copy
(``interop.params_from_jax``).  The reference's entry points are
jitted once per (family, policy); every quantized GEMM they run is
recorded through ``jax.debug.callback`` (its input, weight and output, in
call order), as the port's are through a spy on ``fqt_matmul``.

Forward outputs are held to the repo's cross-backend tolerance (rtol
1e-3, atol 5e-3) by :func:`assert_forward_matches`.  Under a quantized
forward a float32 round-off difference of a GEMM's input can move one
activation code of the per-tensor ``Q_f`` across a rounding boundary; the
reference's own backends part that way at full width (ROADMAP queue 3).
The same holds for the int8 codes of a quantized KV cache.  Where
outputs leave the tolerance, the helper finds the first GEMM whose output
leaves float32 round-off and requires either that its input still agrees
to round-off and the reference's GEMM, re-run on the port's input, gives
the port's output, or (an attention output projection after a read of
an int8 cache) that the step's K/V codes part by single-step flips only:
the paths then part at that code flip, and at nothing else before it.
Decode steps start each from the reference's cache (``to_port``), so a
flip in one step does not carry into the next; ``generate`` runs each
package on its own caches end to end, and its tokens must be equal.
"""

from __future__ import annotations

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.layers.common as jax_common
import repro.layers.embeddings as jax_embeddings
import repro_torch.layers.common as common
import repro_torch.layers.embeddings as embeddings
from repro.configs import get_config as jax_config
from repro.core import QuantPolicy as JaxPolicy
from repro.core import fqt_matmul as jax_fqt_matmul
from repro.engine import init_train_state as jax_init
from repro.engine import make_step_fn as jax_make_step
from repro.models import build_model as jax_build
from repro.optim import adamw as jax_adamw
from repro.optim import cosine_schedule as jax_cosine
from repro_torch import prng
from repro_torch.configs import get_config
from repro_torch.core import QuantPolicy
from repro_torch.engine import make_step_fn
from repro_torch.interop import params_from_jax, train_state_from_jax
from repro_torch.models import build_model
from repro_torch.optim import adamw, cosine_schedule, tree_leaves

RTOL, ATOL = 1e-3, 5e-3
MODEL_TOL = dict(rtol=RTOL, atol=ATOL)
# float32 round-off, relative to the largest entry compared
ROUND_OFF = 2e-5

POLICIES = {
    "exact": (lambda: JaxPolicy.exact(), lambda: QuantPolicy.exact()),
    "qat": (lambda: JaxPolicy.qat(backend="native", fused=True),
            lambda: QuantPolicy.qat(backend="kernel")),
    "fqt_psq8": (lambda: JaxPolicy.fqt("psq", 8, backend="native",
                                       fused=True),
                 lambda: QuantPolicy.fqt("psq", 8, backend="kernel")),
}

_REC = []        # the reference's GEMMs of the call in progress


def _t(a):
    return torch.from_numpy(np.array(a))


def close_round_off(got, want):
    """float32 round-off: the repo's kernel-level tolerance."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-6,
                               atol=ROUND_OFF * float(np.abs(want).max()))


def within(got, want) -> bool:
    return abs(got - want) <= ATOL + RTOL * abs(want)


class Family:
    """One family at its reduced config, in both packages."""

    def __init__(self, arch):
        self.jcfg = jax_config(arch, smoke=True)
        self.cfg = get_config(arch, smoke=True)
        self.jm = jax_build(self.jcfg)
        self.m = build_model(self.cfg)
        # the reference's initial train state (``init_train_state`` under
        # ``jax.jit``: one compile); its parameters serve every test
        self.jstate = jax.jit(lambda: jax_init(self.jm, jax_adamw(), 0))()
        self.jp = self.jstate.params
        self.p = params_from_jax(jax.tree.map(np.asarray, self.jp), "cpu")
        self._jits = {}

    def jit(self, what, pol, fn):
        """``fn`` (of the reference's model and policy ``pol``) jitted once
        per (what, pol), traced with its GEMMs recorded."""
        if (what, pol) not in self._jits:
            jpol = POLICIES[pol][0]()
            with _jax_spy():
                f = jax.jit(functools.partial(fn, self.jm, jpol))
            self._jits[what, pol] = f
        return self._jits[what, pol]

    def run_ref(self, what, pol, fn, *args):
        """(the reference's outputs as numpy, its GEMMs)."""
        f = self.jit(what, pol, fn)
        _REC.clear()
        with _jax_spy():
            out = jax.block_until_ready(f(*args))
        calls = list(_REC)
        _REC.clear()
        return jax.tree.map(np.asarray, out), calls


@functools.lru_cache(maxsize=None)
def family(arch) -> Family:
    return Family(arch)


@contextlib.contextmanager
def _jax_spy():
    """The reference's ``fqt_matmul`` records (path, x, w, y) of every
    call of a function traced while this context is open."""
    def spy(x, w, key, policy, path=""):
        y = jax_fqt_matmul(x, w, key, policy, path=path)
        jax.debug.callback(
            lambda x, w, y, path=path: _REC.append(
                (path, np.asarray(x), np.asarray(w), np.asarray(y))),
            x, w, y, ordered=True)
        return y
    saved = jax_common.fqt_matmul, jax_embeddings.fqt_matmul
    jax_common.fqt_matmul = jax_embeddings.fqt_matmul = spy
    try:
        yield
    finally:
        jax_common.fqt_matmul, jax_embeddings.fqt_matmul = saved


@contextlib.contextmanager
def port_gemms(calls):
    """The port's ``fqt_matmul`` appends (path, x, w, y) of every call to
    ``calls`` while this context is open."""
    real = common.fqt_matmul

    def spy(x, w, key, policy, path=""):
        y = real(x, w, key, policy, path=path)
        calls.append((path, x.detach().numpy().copy(),
                      w.detach().numpy().copy(), y.detach().numpy().copy()))
        return y
    saved = common.fqt_matmul, embeddings.fqt_matmul
    common.fqt_matmul = embeddings.fqt_matmul = spy
    try:
        yield
    finally:
        common.fqt_matmul, embeddings.fqt_matmul = saved


def _kv_flips(got, want, tag):
    """The int8 K/V written by one step (``got`` the port's, ``want`` the
    reference's, trees with ``codes``/``scale``/``zero`` leaves) part only
    by single-step code flips: scales and zeros to float32 round-off,
    codes equal but at a few entries, which differ by one."""
    n = 0
    for side in ("k", "v"):
        g, w = got[side], want[side]
        close_round_off(np.asarray(g["scale"]), w["scale"])
        close_round_off(np.asarray(g["zero"]), w["zero"])
        d = np.asarray(g["codes"]).astype(np.int64) - w["codes"]
        assert np.abs(d).max() <= 1, (tag, np.abs(d).max())
        n += int(np.count_nonzero(d))
    assert 0 < n <= 8, (tag, n)
    return n


@functools.lru_cache(maxsize=None)
def _jax_gemm(pol, path):
    """The reference's forward GEMM at ``path`` under ``pol``, jitted."""
    jpol = POLICIES[pol][0]()
    return jax.jit(lambda x, w: jax_fqt_matmul(x, w, jax.random.PRNGKey(0),
                                               jpol, path=path))


def assert_forward_matches(got, want, port_calls, ref_calls, pol, tag="",
                           kv=None):
    """The port's forward output ``got`` against the reference's ``want``
    under policy ``pol``, given both paths' GEMMs: within rtol 1e-3 /
    atol 5e-3, or parted at a code flip of a quantizer that the paths
    explain (module docstring).  ``kv``: the (port's, reference's) int8
    K/V after the step, where the step read a quantized cache; an
    attention read that parts is then explained by single-step flips of
    its codes.  Returns ``(kind, GEMM index)`` of the flip, or None."""
    assert [c[0] for c in port_calls] == [c[0] for c in ref_calls], tag
    try:
        np.testing.assert_allclose(got, want, **MODEL_TOL)
        return None
    except AssertionError:
        if pol == "exact":
            raise
    for i, ((path, rx, _rw, ry), (_, px, pw, py)) in enumerate(
            zip(ref_calls, port_calls)):
        if float(np.abs(py - ry).max()) <= 1e-4 * float(np.abs(ry).max()):
            continue
        # the first GEMM whose output leaves round-off
        x_off = float(np.abs(px - rx).max())
        if x_off <= ROUND_OFF * float(np.abs(rx).max()):
            # its input agrees, and the reference's GEMM on the port's
            # input is the port's: a flip of the GEMM's own quantizer
            again = _jax_gemm(pol, path)(jnp.asarray(px), jnp.asarray(pw))
            close_round_off(py, np.asarray(again))
            return "gemm", i
        assert kv is not None and path.endswith("attn.wo"), (
            f"{tag}: GEMM {i} ({path}) input parts by {x_off}")
        # the attention read of the int8 cache parted
        _kv_flips(*kv, tag)
        return "kv", i
    raise AssertionError(f"{tag}: outputs part, every GEMM agrees")


def to_port(tree):
    """A reference tree (numpy leaves) as the port's tensors on the CPU."""
    return params_from_jax(tree, "cpu")


def _leaves(t):
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _leaves(t[k])]
    if isinstance(t, (tuple, list)):
        return [x for v in t for x in _leaves(v)]
    return [t]


def port_forward(fn, pol):
    """``fn(policy)`` on the port under ``pol``, and its GEMMs; under
    ``qat`` also under ``fqt(psq, 8)``, whose forward quantizers are
    ``qat``'s: its outputs must be the same bit for bit (``fn`` builds its
    own state each call)."""
    calls = []
    with port_gemms(calls):
        out = fn(POLICIES[pol][1]())
    if pol == "qat":
        again = fn(POLICIES["fqt_psq8"][1]())
        assert all(torch.equal(a, b) if isinstance(a, torch.Tensor)
                   else a == b for a, b in zip(_leaves(out), _leaves(again)))
    return out, calls


def check_forward_paths(fam, pol, x, T, max_seq, steps=4):
    """``lm_loss``, ``lm_prefill`` (logits, cache index, and the KV cache
    where there is one and no flip parted the paths), ``steps`` decode
    steps, each from the reference's cache and fed the reference's greedy
    token (a VLM: its embedding), and the port's ``generate`` (its own
    caches, end to end) against that greedy chain, on the batch ``x``
    (numpy; ``labels`` and the model's inputs), under ``pol``."""
    from repro_torch.launch.serve import generate
    vlm = fam.cfg.family == "vlm"
    jb = {k: jnp.asarray(v) for k, v in x.items()}
    tb = {k: _t(v) for k, v in x.items()}
    prompt = {k: v for k, v in jb.items() if k != "labels"}
    tprompt = {k: v for k, v in tb.items() if k != "labels"}

    (jl, _), _ = fam.run_ref("loss", pol, lambda m, q, p, b: m.loss(
        p, b, jax.random.PRNGKey(3), q), fam.jp, jb)
    (tl, _), _ = port_forward(lambda q: fam.m.loss(
        fam.p, tb, prng.PRNGKey(3), q), pol)
    np.testing.assert_allclose(float(tl), float(jl), **MODEL_TOL)

    (jlog, jcache), rcalls = fam.run_ref(
        "prefill", pol, lambda m, q, p, b: m.prefill(p, b, q, max_seq),
        fam.jp, prompt)
    (tlog, tcache), pcalls = port_forward(
        lambda q: fam.m.prefill(fam.p, tprompt, q, max_seq), pol)
    flip = assert_forward_matches(tlog.numpy(), jlog, pcalls, rcalls, pol,
                                  "prefill")
    assert int(tcache["index"]) == T
    assert sorted(tcache) == sorted(jcache)
    tol = (dict(rtol=2e-6, atol=ROUND_OFF) if pol == "exact"
           else MODEL_TOL)
    if flip is None:
        for got, want in zip(_leaves(tcache), _leaves(jcache)):
            assert tuple(got.shape) == want.shape
            np.testing.assert_allclose(got.numpy(), want, **tol)

    def feed(tok):
        if vlm:
            table = np.asarray(fam.jp["embed"]["table"])
            return {"embeds": table[tok][:, None]}
        return {"tokens": tok[:, None].astype(np.int32)}

    jc, tok = jcache, jlog[:, -1, :fam.cfg.vocab_size].argmax(-1)
    greedy = [tok]
    for step in range(steps):
        b = feed(tok)
        (tlog, tc), pcalls = port_forward(lambda q: fam.m.decode(
            fam.p, to_port(jc), {k: _t(v) for k, v in b.items()}, q), pol)
        (jlog, jc), rcalls = fam.run_ref(
            "decode", pol, lambda m, q, p, c, b: m.decode(p, c, b, q),
            fam.jp, jax.tree.map(jnp.asarray, jc),
            {k: jnp.asarray(v) for k, v in b.items()})
        assert_forward_matches(tlog.numpy(), jlog, pcalls, rcalls, pol,
                               f"decode {step}")
        assert int(tc["index"]) == T + step + 1
        tok = jlog[:, -1, :fam.cfg.vocab_size].argmax(-1)
        greedy.append(tok)

    got, _ = port_forward(lambda q: generate(
        fam.m, fam.p, tprompt, q, max_new=steps + 1, max_seq=max_seq), pol)
    np.testing.assert_array_equal(got.numpy(), np.stack(greedy, 1))


# ---------------------------------------------------------------------------
# one training step from the reference's state
# ---------------------------------------------------------------------------

def _port_keys(run):
    calls = []
    real = common.fqt_matmul

    def spy(x, w, key, policy, path=""):
        calls.append((path, np.asarray(key).astype(np.int64).tolist()))
        return real(x, w, key, policy, path=path)
    saved = common.fqt_matmul
    common.fqt_matmul = spy
    try:
        out = run()
    finally:
        common.fqt_matmul = saved
    return out, sorted(calls)


def _jax_keys(run):
    calls = []
    real = jax_common.fqt_matmul

    def spy(x, w, key, policy, path=""):
        jax.debug.callback(lambda k, path=path: calls.append(
            (path, np.asarray(k).astype(np.int64).tolist())), key)
        return real(x, w, key, policy, path=path)
    saved = jax_common.fqt_matmul
    jax_common.fqt_matmul = spy
    try:
        out = jax.block_until_ready(run())
    finally:
        jax_common.fqt_matmul = saved
    return out, sorted(calls)


@functools.lru_cache(maxsize=None)
def reference_start(arch):
    """The reference's initial train state and first batch (4 x 16)."""
    from repro.data import make_batch_for as jax_batch
    fam = family(arch)
    return fam.jstate, jax.jit(lambda: jax_batch(fam.jcfg, 4, 16,
                                                 step=0))()


def one_step(arch, quant, bits, backend="native", accum_steps=1,
             n_layer_gemms=None, gnorm_rtol=None):
    """One AdamW step of ``arch``'s reduced config from the reference's
    initial state under ``fqt(quant, bits)`` (``exact`` for quant
    "exact"), in both packages on the reference's batch (the reference on
    ``backend``): every layer GEMM draws under the reference's key
    (checked when ``n_layer_gemms``, their count, is given); loss within
    the cross-backend tolerance; gradient norm within it, or within
    ``gnorm_rtol`` of the reference's where the config's quantized
    gradient is chaotic under float32 round-off (the tests say why); the
    new rng and step equal.  Returns (loss, grad norm, the reference's)."""
    fam = family(arch)
    jstate, jbatch = reference_start(arch)
    kw = dict(bhq_block=32) if quant == "bhq" else {}
    if quant == "exact":
        jpol, pol = JaxPolicy.exact(), QuantPolicy.exact()
    else:
        jpol = JaxPolicy.fqt(quant, bits, backend=backend, **kw,
                             **(dict(fused=True) if backend == "native"
                                else {}))
        pol = QuantPolicy.fqt(quant, bits, backend="kernel", **kw)
    jax_step = jax.jit(jax_make_step(fam.jm, jpol, jax_adamw(),
                                     jax_cosine(3e-3, 10, 1), remat=False,
                                     accum_steps=accum_steps))
    (jnext, jm), want = _jax_keys(lambda: jax_step(jstate, jbatch))
    step = make_step_fn(fam.m, pol, adamw(), cosine_schedule(3e-3, 10, 1),
                        remat=False, accum_steps=accum_steps)
    state = train_state_from_jax(jax.tree.map(np.asarray, jstate), "cpu")
    batch = {k: _t(np.asarray(v)) for k, v in jbatch.items()}
    (state, mets), got = _port_keys(lambda: step(state, batch))
    if n_layer_gemms is not None:
        assert len(got) == n_layer_gemms
        assert got == want
    loss, gnorm = float(mets["loss"]), float(mets["grad_norm"])
    ref = float(jm["grad_norm"])
    assert within(loss, float(jm["loss"])), (loss, float(jm["loss"]))
    if gnorm_rtol is None:
        assert within(gnorm, ref), (gnorm, ref)
    else:
        assert abs(gnorm - ref) <= gnorm_rtol * abs(ref), (gnorm, ref)
    assert state.step == int(jnext.step) == 1
    np.testing.assert_array_equal(state.rng.numpy(),
                                  np.asarray(jnext.rng).astype(np.int64))
    assert all(torch.isfinite(t).all() for t in tree_leaves(state.params))
    return loss, gnorm, ref


__all__ = ["RTOL", "ATOL", "MODEL_TOL", "POLICIES", "family", "Family",
           "close_round_off", "within", "port_gemms",
           "assert_forward_matches", "one_step", "reference_start", "prng",
           "to_port", "port_forward", "check_forward_paths", "_t"]
