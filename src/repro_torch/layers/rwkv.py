"""RWKV-6 "Finch" block: data-dependent-decay linear attention
[arXiv:2404.05892], attention-free.

Port of ``repro.layers.rwkv``.  Per layer: time-mix (the WKV linear
recurrence) and channel-mix.  The R/K/V/G/O and channel-mix projections
are FQT linear layers; the low-rank token-shift mix and decay products
(``fp_exempt`` ``rwkv.ddlerp`` and ``rwkv.decay``) and the WKV
recurrence (``rwkv.wkv``, a Python loop over time on (hd x hd) state
blocks) stay full precision, as in the reference.

State per layer: ``s`` (B, H, hd, hd) WKV state (float32), ``x_tm`` /
``x_cm`` (B, d) the previous token's normalized inputs (token shift).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import meta
from ..configs.base import ArchConfig
from ..core import QuantPolicy
from ..core.exempt import fp_exempt
from .common import dense, init_dense, randn
from .norms import layernorm

__all__ = ["init_rwkv_layer", "rwkv_layer", "rwkv_decode_step",
           "init_rwkv_state"]

_MIX = ("w", "k", "v", "r", "g")
_LORA_MIX = 32
_LORA_DECAY = 64


def init_rwkv_layer(gen: torch.Generator, cfg: ArchConfig, lead=()) -> dict:
    """One RWKV-6 layer, or a ``(*lead, ...)`` stack: the reference's
    leaves and deterministic ``ramp``-based mixes and decay base, other
    random draws."""
    d, hd = cfg.d_model, cfg.ssm_headdim
    H = d // hd
    dev = gen.device
    ramp = torch.arange(d, device=dev) / d

    def fixed(t):
        return t.expand(*lead, *t.shape).clone()

    def ln():
        return {"g": torch.ones((*lead, d), device=dev),
                "b": torch.zeros((*lead, d), device=dev)}
    return {
        "ln1": ln(),
        "ln2": ln(),
        "mu_x": fixed(ramp * 0.5),
        "mu": fixed(torch.stack([ramp * 0.5 + 0.1 * i for i in range(5)])),
        "tm_w1": randn(gen, (*lead, d, 5 * _LORA_MIX), 1e-2),
        "tm_w2": randn(gen, (*lead, 5, _LORA_MIX, d), 1e-2),
        "w0": fixed(-6.0 + 5.0 * ramp),
        "dec_w1": randn(gen, (*lead, d, _LORA_DECAY), 1e-2),
        "dec_w2": randn(gen, (*lead, _LORA_DECAY, d), 1e-2),
        "u": randn(gen, (*lead, H, hd), 0.1),
        "wr": init_dense(gen, d, d, lead=lead),
        "wk": init_dense(gen, d, d, lead=lead),
        "wv": init_dense(gen, d, d, lead=lead),
        "wg": init_dense(gen, d, d, lead=lead),
        "wo": init_dense(gen, d, d, lead=lead),
        "ln_x": ln(),
        "cm_mu_k": fixed(ramp * 0.5),
        "cm_mu_r": fixed(ramp * 0.5),
        "cm_wk": init_dense(gen, d, cfg.d_ff, lead=lead),
        "cm_wv": init_dense(gen, cfg.d_ff, d, lead=lead),
        "cm_wr": init_dense(gen, d, d, lead=lead),
    }


def init_rwkv_state(cfg: ArchConfig, batch: int, dtype=torch.float32,
                    lead=(), device=None) -> dict:
    """Zero state: the WKV state ``s`` in float32 whatever the stream
    dtype, the token-shift rows in ``dtype``."""
    d, hd = cfg.d_model, cfg.ssm_headdim
    return {"s": torch.zeros((*lead, batch, d // hd, hd, hd), device=device),
            "x_tm": torch.zeros((*lead, batch, d), dtype=dtype,
                                device=device),
            "x_cm": torch.zeros((*lead, batch, d), dtype=dtype,
                                device=device)}


def _head_groupnorm(p, y, H):
    """GroupNorm(H) over the head dim, RWKV's ln_x (float32 statistics,
    the population variance as ``jnp.var``)."""
    B, T, d = y.shape
    yh = y.reshape(B, T, H, d // H).to(torch.float32)
    mu = torch.mean(yh, dim=-1, keepdim=True)
    var = torch.var(yh, dim=-1, keepdim=True, correction=0)
    yh = (yh - mu) * torch.rsqrt(var + 1e-5)
    return yh.reshape(B, T, d) * p["g"] + p["b"]


def _time_mix_inputs(p, x, x_prev):
    """ddlerp: five data-dependently mixed views of (x, x_prev)."""
    with fp_exempt("rwkv.ddlerp",
                   "tiny low-rank token-shift mix (rank 32 per view); full "
                   "precision like every non-linear-layer GEMM in the paper"):
        sx = x_prev - x
        xxx = x + sx * p["mu_x"]
        a = torch.tanh(torch.matmul(xxx, p["tm_w1"]))            # (..., 5*r)
        a = a.reshape(*a.shape[:-1], 5, _LORA_MIX)
        delta = torch.einsum("...fr,frd->...fd", a, p["tm_w2"])  # (..., 5, d)
        return [(x + sx * (p["mu"][i] + delta[..., i, :])).to(x.dtype)
                for i in range(len(_MIX))]  # [xw, xk, xv, xr, xg]


def _decay(p, xw):
    with fp_exempt("rwkv.decay",
                   "rank-64 data-dependent decay LoRA feeding exp(-exp(.)); "
                   "precision-critical and tiny next to the R/K/V/G/O GEMMs"):
        # a bfloat16 stream promotes to the weights' float32, as in jnp
        xw = xw.to(torch.promote_types(xw.dtype, p["dec_w1"].dtype))
        lora = torch.matmul(torch.tanh(torch.matmul(xw, p["dec_w1"])),
                            p["dec_w2"])
        return torch.exp(-torch.exp(p["w0"] + lora))


_WKV_REASON = ("WKV recurrence: elementwise/outer-product state math on "
               "(hd x hd) blocks, no linear-layer GEMM (DESIGN.md Sec. 5 "
               "arch-applicability)")


def _wkv_step(r, k, v, w, u, s, t):
    """Token ``t`` of the recurrence: (y_t (B, H, hd), S_t)."""
    with fp_exempt("rwkv.wkv", _WKV_REASON):
        kv = torch.einsum("bhk,bhv->bhkv", k[:, t], v[:, t])
        y = torch.einsum("bhk,bhkv->bhv", r[:, t],
                         s + u[None, :, :, None] * kv)
    return y, w[:, t, ..., None] * s + kv


def _wkv_scan(r, k, v, w, u, s0):
    """The RWKV-6 recurrence over time.

    r, k, v, w: (B, T, H, hd); u: (H, hd); s0: (B, H, hd, hd).
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t);  S_t = diag(w_t) S_{t-1} +
    k_t^T v_t.  Returns (y (B, T, H, hd), final state).  On the meta
    device (the dry run) one step stands for all (:class:`_MetaWKV`)."""
    with fp_exempt("rwkv.wkv", _WKV_REASON):
        if meta.is_meta(r):
            return _MetaWKV.apply(r, k, v, w, u, s0)
        s, ys = s0, []
        for t in range(r.shape[1]):
            y, s = _wkv_step(r, k, v, w, u, s, t)
            ys.append(y)
        return torch.stack(ys, dim=1), s


class _MetaWKV(torch.autograd.Function):
    """:func:`_wkv_scan` on the meta device: the loop's result shapes,
    with the loop's counts (``meta.py``) from one step scaled to its T
    steps.  The forward holds the bytes the loop keeps for its backward;
    the backward is one step's, scaled, then the T - 1 sums of each
    input's per-step gradients the autograd engine makes."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        T = r.shape[1]
        ins = [x.detach().requires_grad_() for x in (r, k, v, w, u, s0)]
        inputs = {x.untyped_storage()._cdata for x in ins[:5]}
        state = ins[5].untyped_storage()._cdata
        kept, kept_state = [], []

        def pack(x):
            # what a step keeps beyond its inputs' storages; the state it
            # keeps is the one before it (an input for the first step only)
            key = x.untyped_storage()._cdata
            if key not in inputs:
                (kept_state if key == state else kept).append(
                    x.untyped_storage().nbytes())
            return x
        with torch.enable_grad(), meta.scaled(T), \
                torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
            y0, s1 = _wkv_step(*ins, 0)
        B, _, H, hd = r.shape
        ctx.step = (ins, (y0, s1))
        ctx.held = meta.hold(T * sum(kept) + (T - 1) * sum(kept_state),
                             r.device)
        ys = meta.hold(T * y0.numel() * y0.element_size(), r.device)
        y, s = meta.uncounted(lambda: (
            torch.empty((B, T, H, hd), dtype=y0.dtype, device=r.device),
            torch.empty_like(s1)))
        del ys                                 # the per-token outputs
        meta.add_counts(2 * y.numel() * y.element_size())    # the stack
        return y, s

    @staticmethod
    def backward(ctx, gy, gs):
        ins, outs = ctx.step
        T = gy.shape[1]
        with meta.scaled(T):
            grads = torch.autograd.grad(outs, ins,
                                        (gy[:, 0], gs), allow_unused=True)
        meta.track(*grads)
        for g in grads[:5]:
            other = meta.uncounted(torch.empty_like, g)
            with meta.scaled(T - 1):
                g + other
        ctx.step = ctx.held = None
        return grads


def _time_mix(p, x, x_prev, s0, key, policy, cfg, tag=0x30, path="rwkv"):
    B, T, d = x.shape
    hd = cfg.ssm_headdim
    H = d // hd
    xw, xk, xv, xr, xg = _time_mix_inputs(p, x, x_prev)
    r = dense(p["wr"], xr, key, policy, tag + 1, f"{path}.wr")
    k = dense(p["wk"], xk, key, policy, tag + 2, f"{path}.wk")
    v = dense(p["wv"], xv, key, policy, tag + 3, f"{path}.wv")
    g = F.silu(dense(p["wg"], xg, key, policy, tag + 4, f"{path}.wg"))
    w = _decay(p, xw)
    rs, ks, vs, ws = (t.reshape(B, T, H, hd).to(torch.float32)
                      for t in (r, k, v, w))
    y, s = _wkv_scan(rs, ks, vs, ws, p["u"], s0)
    y = _head_groupnorm(p["ln_x"], y.reshape(B, T, d), H).to(x.dtype)
    return dense(p["wo"], y * g, key, policy, tag + 5, f"{path}.wo"), s


def _channel_mix(p, x, x_prev, key, policy, tag=0x40, path="rwkv"):
    sx = x_prev - x
    xk = x + sx * p["cm_mu_k"]
    xr = x + sx * p["cm_mu_r"]
    k = torch.square(F.relu(dense(p["cm_wk"], xk, key, policy, tag + 1,
                                  f"{path}.cm_wk")))
    kv = dense(p["cm_wv"], k, key, policy, tag + 2, f"{path}.cm_wv")
    return torch.sigmoid(dense(p["cm_wr"], xr, key, policy, tag + 3,
                               f"{path}.cm_wr")) * kv


def _shift(x, first=None):
    """Token shift: x_{t-1} along T, with ``first`` (B, d) (zeros when
    ``None``) at t = 0.  x: (B, T, d)."""
    head = (torch.zeros_like(x[:, :1]) if first is None
            else first[:, None].to(x.dtype))
    return torch.cat([head, x[:, :-1]], dim=1)


def rwkv_layer(p, h, key, policy: QuantPolicy, cfg: ArchConfig,
               state: dict | None = None, path: str = "rwkv"):
    """Full-sequence RWKV-6 layer (train / prefill), from ``state`` (zeros
    when ``None``).  Returns (h, final_state)."""
    B = h.shape[0]
    s0 = (state["s"] if state is not None
          else init_rwkv_state(cfg, B, device=h.device)["s"])
    prev = {} if state is None else state
    x1 = layernorm(p["ln1"], h)
    att, s = _time_mix(p, x1, _shift(x1, prev.get("x_tm")), s0, key,
                       policy, cfg, path=path)
    h = h + att.to(h.dtype)
    x2 = layernorm(p["ln2"], h)
    h = h + _channel_mix(p, x2, _shift(x2, prev.get("x_cm")), key, policy,
                         path=path).to(h.dtype)
    return h, {"s": s, "x_tm": x1[:, -1], "x_cm": x2[:, -1]}


def rwkv_decode_step(p, h, state: dict, key, policy: QuantPolicy,
                     cfg: ArchConfig, path: str = "rwkv"):
    """One-token step.  h: (B, 1, d); O(1) in the sequence length."""
    x1 = layernorm(p["ln1"], h)
    att, s = _time_mix(p, x1, state["x_tm"][:, None].to(x1.dtype),
                       state["s"], key, policy, cfg, path=path)
    h = h + att.to(h.dtype)
    x2 = layernorm(p["ln2"], h)
    h = h + _channel_mix(p, x2, state["x_cm"][:, None].to(x2.dtype), key,
                         policy, path=path).to(h.dtype)
    return h, {"s": s, "x_tm": x1[:, 0], "x_cm": x2[:, 0]}
