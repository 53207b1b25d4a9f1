"""Fully-Quantized-Training matmul (paper Eq. 3/5/6).

Port of ``repro.core.fqt``: the paper's computational primitive as a
``torch.autograd.Function`` (the reference's ``custom_vjp``).  For a
linear layer ``Y = X @ W``:

  forward   (Eq. 3):  ``Y = Q_f(X) @ Q_theta(W)``          (deterministic PTQ)
  backward  (Eq. 6, with the gradient bifurcation of App. E):
      ``dW = Q_f(X)^T @ Q_b1(dY)``   Q_b1 = stochastic per-tensor PTQ
      ``dX = Q_b2(dY) @ Q_theta(W)^T``  Q_b2 in {PTQ, PSQ, BHQ}

Each role's quantizer comes from the registry through the resolved
:class:`~repro_torch.core.registry.GemmQuantConfig`.  A ``None`` backward
role computes that gradient from the dequantized forward operands; both
``None`` is exactly QAT (Eq. 4).  The backward derives its keys as
``split(fold_in(key, 0x5151))`` -> (wgrad, agrad), as the reference does.
STE (Eq. 4): the backward differentiates through the quantized operands,
no gradient flows into the quantizers.

On the ``kernel`` backend the fused roles run the fused CUDA kernels: the
forward quantize inside ``fused_qlhs_matmul``, the PTQ wgrad inside
``fused_qboth_tn_matmul``, the PTQ/PSQ agrad inside
``fused_qlhs_matmul(trans_b=True)``; BHQ's agrad quantizes in PyTorch and
runs ``q8_matmul``.  A role that does not fuse (``fused=False``, or a
forward other than ``ptq_det``) quantizes on its own — PTQ/PSQ through the
``quantize_sr`` kernels — and runs its GEMM through ``q8_matmul``.
``simulate`` quantize-dequantizes and runs fp32 matmuls.  dW comes back in fp32, dX in the stream dtype.

The bit-packed forward-weight quantizers (``int4w``, ``binary``,
``ternary``) fuse like ``ptq_det``: their packed weight runs through
``fused_qlhs_packed_matmul`` (or ``packed_matmul`` unfused), and the
backward unpacks it transiently.  A weight packed once at load (a
:class:`~repro_torch.kernels.pack.PackedTensor` given as ``w``, the
serving engine's ``weight_bits``) takes the inference-only ``_packed_fwd``.

Each role's work runs under the reference's markers (``core/exempt.py``:
``q[path|role]``, ``qfp[path|role]``, ``qk[path]``), which appear in a
profile and cost nothing outside one.
"""

from __future__ import annotations

import contextlib
from typing import Union

import torch
import torch.utils._pytree as pytree

from .. import prng
from ..kernels.pack import PackedTensor
from ..sharding import data
from .backend import (_ptq_range, fused_fqt_dw, fused_fqt_dx, fused_fqt_fwd,
                      qt_gemm, qt_gemm_nt, qt_gemm_tn, requantize_det)
from .exempt import key_scope, quant_scope
from .policy import QuantPolicy
from .quantizers import QTensor
from .registry import GemmQuantConfig, QuantizerSpec, get_quantizer

__all__ = ["fqt_matmul", "recomputed"]


def _fused_roles(cfg: GemmQuantConfig):
    """(fwd, wgrad, agrad) eligibility for the fused kernels.

    ``cfg.fused`` is the knob (None = auto: on for the kernel backend); a
    role only fuses when the fused kernels implement its quantizer — the
    deterministic-PTQ forward (its weight ``ptq_det`` or a packed-weight
    quantizer), per-tensor stochastic-PTQ wgrad, PTQ/PSQ agrad; the fused
    wgrad also needs the fused forward's residuals.  Only the ``kernel``
    backend has fused kernels: ``native``'s ``torch._int_mm`` is the bare
    product, so there every role runs unfused.
    """
    if cfg.backend != "kernel" or not cfg.quantize_fwd:
        return False, False, False
    if cfg.fused is False:
        return False, False, False
    w_packed = get_quantizer(cfg.fwd_weight.name).packed_weights
    fwd = (cfg.fwd_act.name == "ptq_det"
           and (cfg.fwd_weight.name == "ptq_det" or w_packed))
    wg = fwd and cfg.wgrad is not None and cfg.wgrad.name == "ptq"
    ag = cfg.agrad is not None and cfg.agrad.name in ("ptq", "psq")
    return fwd, wg, ag


def _quantize_role(spec: QuantizerSpec, x2d: torch.Tensor, key,
                   cfg: GemmQuantConfig):
    """Registry dispatch for one tensor role."""
    q = get_quantizer(spec.name)
    if key is None and q.stochastic:
        raise ValueError(
            f"quantizer {spec.name!r} is stochastic and needs a PRNG key "
            f"(fwd_act/fwd_weight must be deterministic, e.g. 'ptq_det'; "
            f"the backward roles draw from the key given to fqt_matmul)")
    return q.quantize(x2d, key, spec, backend=cfg.backend)


def _fqt_operands(cfg: GemmQuantConfig, x: torch.Tensor, w: torch.Tensor):
    """The forward GEMM's quantized operands, its residuals: ``(xres, wq,
    lead)``.  ``xres`` is the activation's ``QTensor``, or on the fused
    forward ``(x2, scale, zero)``: its range, the GEMM quantizing inside
    (the backward rematerializes the codes deterministically)."""
    lead = x.shape[:-1]
    # quantizer math in fp32 regardless of activation dtype
    x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
    wq = _quantize_role(cfg.fwd_weight, w.to(torch.float32), None, cfg)
    if _fused_roles(cfg)[0]:
        zx, sx = _ptq_range(x2, cfg.fwd_act.bits or 8)
        xres = (x2, sx, zx)
    else:
        xres = _quantize_role(cfg.fwd_act, x2, None, cfg)             # Q_f
    return xres, wq, tuple(lead)


def _fqt_gemm(cfg: GemmQuantConfig, res, dtype, n: int) -> torch.Tensor:
    """The forward GEMM ``Q_f(X) @ Q_theta(W)`` on the residuals."""
    xres, wq, lead = res
    if isinstance(xres, tuple):             # the fused forward's range
        x2, sx, zx = xres
        y, _, _ = fused_fqt_fwd(x2, wq, cfg.fwd_act.bits or 8,
                                backend=cfg.backend, zero_scale=(zx, sx))
    else:
        y = qt_gemm(xres, wq, backend=cfg.backend)
    return y.reshape(*lead, n).to(dtype)


def _fqt_bwd(cfg: GemmQuantConfig, path: str, res, key, g: torch.Tensor,
             group):
    """(dx, dw) of the backward GEMMs, in the forward's data group
    ``group``.  dY's rows are the batch's, so its quantizers run as on a
    batch-spanning operand (``sharding.data``)."""
    with data.batch_operand(group):
        return _fqt_bwd_grads(cfg, path, res, key, g)


def _fqt_bwd_grads(cfg: GemmQuantConfig, path: str, res, key,
                   g: torch.Tensor):
    xres, wq, lead = res
    dtype = g.dtype                  # cotangent dtype == stream dtype
    g2 = g.reshape(-1, g.shape[-1]).to(torch.float32)
    f_fwd, f_wg, f_ag = _fused_roles(cfg)
    bits_act = (cfg.fwd_act.bits or 8) if cfg.quantize_fwd else 8

    def xq_remat():
        if f_fwd:
            x2, sx, zx = xres
            return requantize_det(x2, sx, zx, bits_act)
        return xres

    if cfg.wgrad is None and cfg.agrad is None:
        # QAT (Eq. 4): full-precision gradient through quantized operands
        with quant_scope(path, "wgrad", False):
            dw = xq_remat().dequant().T @ g2
        with quant_scope(path, "agrad", False):
            dx = g2 @ wq.dequant().T
    else:
        if key is None:
            raise ValueError(f"the FQT backward ({cfg.describe()}) needs a "
                             f"PRNG key; fqt_matmul was given None")
        with key_scope(path):
            k1, k2 = prng.split(prng.fold_in(key, 0x5151))
        if cfg.wgrad is None:
            with quant_scope(path, "wgrad", False):
                dw = xq_remat().dequant().T @ g2
        elif f_wg:
            with quant_scope(path, "wgrad", True):
                x2, sx, zx = xres
                dw = fused_fqt_dw(x2, sx, zx, bits_act, g2, k1,
                                  cfg.wgrad.bits or 8, backend=cfg.backend)
        else:
            with quant_scope(path, "wgrad", True):
                gq1 = _quantize_role(cfg.wgrad, g2, k1, cfg)       # Q_b1
                dw = qt_gemm_tn(xq_remat(), gq1, backend=cfg.backend)
        if cfg.agrad is None:
            with quant_scope(path, "agrad", False):
                dx = g2 @ wq.dequant().T
        elif f_ag:
            with quant_scope(path, "agrad", True):
                dx = fused_fqt_dx(g2, k2, cfg.agrad, wq, backend=cfg.backend)
        else:
            # BHQ's Householder transform counts as quantized agrad work
            with quant_scope(path, "agrad", True):
                gq2 = _quantize_role(cfg.agrad, g2, k2, cfg)       # Q_b2
                dx = qt_gemm_nt(gq2, wq, backend=cfg.backend)
    return dx.reshape(*lead, -1).to(dtype), dw


class _FQT(torch.autograd.Function):
    """``x @ w`` quantized by ``cfg``: Eq. 3 forward, Eq. 6 backward.  The
    residuals are ``_fqt_operands``' (``res``), or computed here when
    ``res`` is None and then kept on ``ctx``; given, they come back
    through ``keep`` (an :class:`_FQTKeep` node's ``saved_tensors``).  The
    data group of the forward (``sharding.data``) is the backward's too:
    a loss chunk runs its head GEMM in a group of its own."""

    @staticmethod
    def forward(ctx, x, w, res, keep, key, cfg, path):
        if res is None:
            res = ctx.res = _fqt_operands(cfg, x, w)
        ctx.keep, ctx.key, ctx.cfg, ctx.path = keep, key, cfg, path
        ctx.group = data.current()
        return _fqt_gemm(cfg, res, x.dtype, w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        if ctx.keep is None:
            res = ctx.res
        else:
            res = _FQTKeep.residuals(ctx.keep)
        dx, dw = _fqt_bwd(ctx.cfg, ctx.path, res, ctx.key, g, ctx.group)
        ctx.res = ctx.keep = None             # free the residuals now
        return dx, dw, None, None, None, None, None


class _FQTKeep(torch.autograd.Function):
    """Saves a GEMM's residuals, through ``save_for_backward``, before
    the GEMM runs; ``x`` and ``w`` pass through.  Inside
    :func:`recomputed` (a layer under ``torch.utils.checkpoint``) the
    checkpoint drops them after the forward and recomputes them for the
    backward, and since they are saved before the GEMM, the recomputation
    stops once it has them all: a layer's last GEMM, whose output no
    backward reads, is not run again (as XLA leaves it out of the
    reference's rematerialized forward)."""

    @staticmethod
    def forward(ctx, x, w, spec, consts, *tensors):
        ctx.spec, ctx.consts = spec, consts
        ctx.save_for_backward(*tensors)
        return x.view_as(x), w.view_as(w)

    @staticmethod
    def backward(ctx, gx, gw):
        return (gx, gw) + (None,) * (len(ctx.needs_input_grad) - 2)

    @staticmethod
    def residuals(node):
        """The residuals that ``node`` (this Function's backward node)
        saved."""
        tensors = iter(node.saved_tensors)
        leaves = [next(tensors) if c is None else c for c in node.consts]
        return pytree.tree_unflatten(leaves, node.spec)


# the residuals' dataclasses as pytree nodes, for _FQTKeep to flatten
for _cls in (QTensor, PackedTensor):
    pytree.register_dataclass(_cls)

_RECOMPUTED = 0      # depth of recomputed() regions


@contextlib.contextmanager
def recomputed():
    """The block is recomputed in the backward (``models.lm.remat_call``):
    its FQT GEMMs save their residuals in an :class:`_FQTKeep` node of
    their own."""
    global _RECOMPUTED
    _RECOMPUTED += 1
    try:
        yield
    finally:
        _RECOMPUTED -= 1


def _fqt(x, w, key, cfg: GemmQuantConfig, path: str) -> torch.Tensor:
    """The FQT GEMM, differentiable when grad mode is on and an operand
    needs a gradient."""
    with quant_scope(path, "fwd", True):
        if not (torch.is_grad_enabled()
                and (x.requires_grad or w.requires_grad)):
            return _fqt_gemm(cfg, _fqt_operands(cfg, x, w), x.dtype,
                             w.shape[-1])
        if not _RECOMPUTED:
            return _FQT.apply(x, w, None, None, key, cfg, path)
        with torch.no_grad():
            res = _fqt_operands(cfg, x, w)
        leaves, spec = pytree.tree_flatten(res)
        consts = [None if isinstance(v, torch.Tensor) else v for v in leaves]
        xk, wk = _FQTKeep.apply(x, w, spec, consts,
                                *(v for v in leaves
                                  if isinstance(v, torch.Tensor)))
        return _FQT.apply(xk, wk, res, xk.grad_fn, key, cfg, path)


def _matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype, as ``jnp.matmul`` promotes (a
    bfloat16 stream against float32 weights gives float32)."""
    if x.dtype == w.dtype:
        return x @ w
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def fqt_matmul(x: torch.Tensor, w: torch.Tensor, key,
               policy: Union[QuantPolicy, GemmQuantConfig],
               path: str = "") -> torch.Tensor:
    """``x @ w`` under the given quantization policy, differentiable.

    x: (..., K) activations; w: (K, N) weights; key: PRNG key (a
    ``prng`` key, kept on the CPU) consumed by the backward's stochastic
    quantizers (``None`` is fine for the forward and for QAT).  ``policy``
    is a :class:`QuantPolicy`, resolved against ``path``, or an
    already-resolved :class:`GemmQuantConfig`.  A :class:`PackedTensor`
    ``w`` (quantized and packed once at load) runs the inference-only
    packed forward.
    """
    if isinstance(w, PackedTensor):
        return _packed_fwd(x, w, policy, path)
    if isinstance(policy, QuantPolicy):
        if not policy.enabled:
            # qfp marker: policy-declared full precision (its gradients run
            # outside the scope, in autograd's own backward)
            with quant_scope(path, "fwd", False):
                return _matmul(x, w)
        cfg = policy.resolve(path)           # validated at resolution
    else:
        cfg = policy.validate()
    if not cfg.quantize_fwd:                 # layer pinned exact
        with quant_scope(path, "fwd", False):
            return _matmul(x, w)
    return _fqt(x, w, key, cfg, path)


def _packed_fwd(x: torch.Tensor, pt: PackedTensor,
                policy: Union[QuantPolicy, GemmQuantConfig],
                path: str) -> torch.Tensor:
    """Forward against a pre-packed weight: ``Q_f(x) @ B-hat``, B packed.

    The weight role was applied when the weight was packed, so only the
    activation side of the resolved config runs here: exact or simulated
    activations against the dequantized weight (no quantized forward, or
    ``simulate``), the fused packed kernel, or ``Q_f`` then
    ``packed_matmul``.  No gradient: training with packed weights goes
    through the packed quantizers on fp32 weights."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
    if isinstance(policy, QuantPolicy):
        cfg = policy.resolve(path) if policy.enabled else None
    else:
        cfg = policy.validate() if policy is not None else None
    with quant_scope(path, "fwd", True):
        if cfg is None or not cfg.quantize_fwd or cfg.backend == "simulate":
            if cfg is not None and cfg.quantize_fwd:
                xv = _quantize_role(cfg.fwd_act, x2, None, cfg).dequant()
            else:
                xv = x2
            y = xv @ pt.dequant().reshape(-1, pt.shape[-1])
        elif _fused_roles(cfg)[0]:
            y, _, _ = fused_fqt_fwd(x2, pt, cfg.fwd_act.bits or 8,
                                    backend=cfg.backend)
        else:
            xq = _quantize_role(cfg.fwd_act, x2, None, cfg)
            y = qt_gemm(xq, pt, backend=cfg.backend)
    return y.reshape(*lead, pt.shape[-1]).to(x.dtype)
