"""granite-3-2b at full width (d=2048, d_ff=8192, padded vocab 49,408),
depth cut to one layer, on the CPU: how far the repo's cross-backend
tolerance (rtol 1e-3 / atol 5e-3) holds for the serving policy
(``QuantPolicy.qat``) at a real width.

Held: every quantized GEMM of one prefill, re-run from the very input the
port's ``kernel`` path gave it, agrees with the port's ``simulate`` backend
and with the JAX package's fused ``native`` path.

Not held, by the JAX package itself: the prefill logits of two backends
each driven end to end.  The per-tensor ``Q_f`` of a (32, 2048) or
(32, 8192) activation slab maps values on a 1/255-of-range grid; the two
backends' float32 round-off (about 1e-6) moves a few of those values
across a rounding boundary, the next GEMM then sees inputs that differ by
whole quantization steps, and the difference spreads to every later
quantized tensor.  The tests pin the JAX package's own native-vs-simulate
gap above the tolerance, and the port's kernel-vs-simulate gap to at most
twice it.

Run as a script for the same figures at other depths, and the trace of
where the two backends part (each GEMM's input difference, and its output
difference on a shared input):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_fullwidth.py 1 2 4
"""

import dataclasses
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import QuantPolicy as JaxPolicy  # noqa: E402
from repro.core import fqt_matmul as jax_fqt  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
import repro_torch.layers.common as tcommon  # noqa: E402
import repro_torch.layers.embeddings as tembeddings  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import QuantPolicy, fqt_matmul  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

ARCH = "granite-3-2b"
PROMPT_LEN = 23                     # padded into a 32-token bucket
RTOL, ATOL = 1e-3, 5e-3
JAX_FUSED = JaxPolicy.qat(backend="native", fused=True)


def _prefill_both(n_layers: int) -> dict:
    """Prefill one prompt at full width through both packages and both
    backends; returns the logits, the port's GEMM calls on the kernel
    path, and the objects needed to re-run them."""
    jcfg = dataclasses.replace(jax_config(ARCH), n_layers=n_layers)
    tcfg = dataclasses.replace(get_config(ARCH), n_layers=n_layers)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    prompt = np.random.RandomState(0).randint(0, jcfg.vocab_size, PROMPT_LEN)
    bucket = 1 << (PROMPT_LEN - 1).bit_length()
    toks = np.zeros((1, bucket), np.int64)
    toks[0, :PROMPT_LEN] = prompt
    last = np.array([PROMPT_LEN - 1])

    def jax_logits(policy):
        lg, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                           policy, max_seq=bucket,
                           last_pos=jnp.asarray(last, jnp.int32))
        return np.asarray(lg)

    out = {"jax_native": jax_logits(JAX_FUSED),
           "jax_simulate": jax_logits(JaxPolicy.qat(backend="simulate")),
           "jax_exact": jax_logits(JaxPolicy.exact())}
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    del jp
    tm = build_model(tcfg)
    calls = []

    def spy(x, w, key, policy, path=""):
        y = fqt_matmul(x, w, key, policy, path=path)
        calls.append((path, x, w, y))
        return y

    def port_logits(backend):
        saved = tcommon.fqt_matmul, tembeddings.fqt_matmul
        tcommon.fqt_matmul = tembeddings.fqt_matmul = spy
        calls.clear()
        try:
            lg, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                               QuantPolicy.qat(backend=backend),
                               max_seq=bucket, last_pos=torch.from_numpy(last))
        finally:
            tcommon.fqt_matmul, tembeddings.fqt_matmul = saved
        return lg.numpy(), list(calls)

    with torch.no_grad():
        out["port_simulate"], out["simulate_calls"] = port_logits("simulate")
        out["port_kernel"], out["kernel_calls"] = port_logits("kernel")
    return out


@pytest.fixture(scope="module")
def one_layer():
    return _prefill_both(1)


def test_fullwidth_every_gemm_agrees_on_shared_inputs(one_layer):
    calls = one_layer["kernel_calls"]
    assert [c[0] for c in calls] == [
        "layers.attn.wq", "layers.attn.wk", "layers.attn.wv",
        "layers.attn.wo", "layers.mlp.gate", "layers.mlp.up",
        "layers.mlp.down", "lm_head"]
    sim = QuantPolicy.qat(backend="simulate")
    for path, x, w, y in calls:
        with torch.no_grad():
            ref = fqt_matmul(x, w, None, sim, path=path)
        np.testing.assert_allclose(y.numpy(), ref.numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=path)
        want = jax_fqt(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
                       jax.random.PRNGKey(0), JAX_FUSED, path=path)
        np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL, err_msg=path)


def test_fullwidth_logit_gap_is_the_references_own(one_layer):
    jax_gap = np.abs(one_layer["jax_native"] - one_layer["jax_simulate"])
    port_gap = np.abs(one_layer["port_kernel"] - one_layer["port_simulate"])
    limit = ATOL + RTOL * np.abs(one_layer["jax_simulate"])
    # the reference's own backends already part beyond the tolerance ...
    assert (jax_gap > limit).any(), jax_gap.max()
    # ... and the port's part no further than twice as far
    assert port_gap.max() <= 2 * jax_gap.max(), (port_gap.max(),
                                                 jax_gap.max())
    for v in one_layer.values():
        if isinstance(v, np.ndarray):
            assert np.isfinite(v).all()


def _report(n_layers: int) -> None:
    r = _prefill_both(n_layers)

    def gap(a, b):
        d = np.abs(r[a] - r[b])
        same = bool(r[a].argmax() == r[b].argmax())
        return f"max|d|={d.max():.4g} same argmax={same}"

    print(f"{ARCH} full width, {n_layers} layer(s), prompt {PROMPT_LEN}: "
          f"max|logit|={np.abs(r['jax_simulate']).max():.4g}")
    for a, b in [("jax_native", "jax_simulate"),
                 ("port_kernel", "port_simulate"),
                 ("port_kernel", "jax_native"),
                 ("port_simulate", "jax_simulate"),
                 ("jax_simulate", "jax_exact")]:
        print(f"  {a} vs {b}: {gap(a, b)}")
    print("  GEMM by GEMM, kernel path vs simulate path: input max|dx|; "
          "output max|dy| on the kernel path's input")
    sim = QuantPolicy.qat(backend="simulate")
    for (path, xk, w, yk), (_, xs, _, _) in zip(r["kernel_calls"],
                                                r["simulate_calls"]):
        with torch.no_grad():
            shared = float((fqt_matmul(xk, w, None, sim) - yk).abs().max())
        print(f"    {path:16s} x {tuple(xk.shape)} max|x|="
              f"{float(xs.abs().max()):.3g} max|dx|="
              f"{float((xk - xs).abs().max()):.3g} shared-input max|dy|="
              f"{shared:.3g}")


if __name__ == "__main__":
    for n in sys.argv[1:] or ["1"]:
        _report(int(n))
