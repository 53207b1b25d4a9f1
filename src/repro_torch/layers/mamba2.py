"""Mamba-2 (SSD) mixer block [arXiv:2405.21060], used by Zamba2.

Port of ``repro.layers.mamba2``.  Training and prefill use the chunked
SSD form (the block-matmul restatement of the selective-state
recurrence), decode the exact one-token recurrence.  The projections are
split (z / x / BC / dt) as in the reference, and all five are FQT linear
layers; the SSD state contractions act on tiny (headdim x d_state) blocks
interleaved with data-dependent decays and stay full precision
(``fp_exempt("mamba.ssd")``).

State per layer: ``h``       (B, H, hd, N)    SSM state (float32),
                 ``conv_x``  (B, k-1, d_inner) causal-conv tail,
                 ``conv_bc`` (B, k-1, 2N)      causal-conv tail.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..core import QuantPolicy
from ..core.exempt import fp_exempt
from .common import dense, init_dense, randn
from .norms import rmsnorm

__all__ = ["init_mamba2_layer", "mamba2_layer", "mamba2_decode_step",
           "init_mamba2_state"]

_SSD_REASON = ("SSD state contractions act on tiny (headdim x d_state) "
               "blocks interleaved with data-dependent decays and stay "
               "full precision (DESIGN.md Sec. 5); FQT covers the "
               "projection GEMMs")

_CHUNK = 128


def _dims(cfg: ArchConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    return d_inner, d_inner // cfg.ssm_headdim


def _fixed(values: torch.Tensor, lead, device) -> torch.Tensor:
    """A deterministic leaf: ``values`` repeated over the ``lead`` dims."""
    return values.to(device).expand(*lead, *values.shape).clone()


def init_mamba2_layer(gen: torch.Generator, cfg: ArchConfig,
                      lead=()) -> dict:
    """One Mamba2 layer, or a ``(*lead, ...)`` stack of them: the
    reference's leaves, its deterministic ``A_log``, ``D`` and ``dt_bias``
    (``linspace`` values), other random draws."""
    d = cfg.d_model
    d_inner, H = _dims(cfg)
    N, k = cfg.ssm_state, cfg.ssm_conv
    dev = gen.device
    ramp = torch.linspace(1.0, 16.0, H)
    dt = torch.linspace(1e-3, 0.1, H)
    return {
        "norm": {"g": torch.ones((*lead, d), device=dev)},
        "z_proj": init_dense(gen, d, d_inner, lead=lead),
        "x_proj": init_dense(gen, d, d_inner, lead=lead),
        "bc_proj": init_dense(gen, d, 2 * N, lead=lead),
        "dt_proj": init_dense(gen, d, H, lead=lead),
        "conv_x_w": randn(gen, (*lead, k, d_inner), 0.2),
        "conv_x_b": torch.zeros((*lead, d_inner), device=dev),
        "conv_bc_w": randn(gen, (*lead, k, 2 * N), 0.2),
        "conv_bc_b": torch.zeros((*lead, 2 * N), device=dev),
        "A_log": _fixed(torch.log(ramp), lead, dev),
        "D": torch.ones((*lead, H), device=dev),
        "dt_bias": _fixed(torch.log(torch.expm1(dt)), lead, dev),
        "out_norm": {"g": torch.ones((*lead, d_inner), device=dev)},
        "out_proj": init_dense(gen, d_inner, d, lead=lead),
    }


def init_mamba2_state(cfg: ArchConfig, batch: int, dtype=torch.float32,
                      lead=(), device=None) -> dict:
    """Zero state: ``h`` in float32 (the SSM state accumulates there),
    the conv tails in the stream ``dtype``."""
    d_inner, H = _dims(cfg)
    k = cfg.ssm_conv
    return {"h": torch.zeros((*lead, batch, H, cfg.ssm_headdim,
                              cfg.ssm_state), device=device),
            "conv_x": torch.zeros((*lead, batch, k - 1, d_inner),
                                  dtype=dtype, device=device),
            "conv_bc": torch.zeros((*lead, batch, k - 1, 2 * cfg.ssm_state),
                                   dtype=dtype, device=device)}


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``, no threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(w, b, x, tail, act=True):
    """Depthwise causal conv.  x: (B, T, C); tail: (B, k-1, C).

    Returns (y, new_tail)."""
    k, T = w.shape[0], x.shape[1]
    xp = torch.cat([tail.to(x.dtype), x], dim=1)                # (B, T+k-1, C)
    y = sum(w[j].to(x.dtype) * xp[:, j:j + T] for j in range(k))
    y = y + b.to(x.dtype)
    return (F.silu(y) if act else y), xp[:, -(k - 1):]


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Cumulative log-decay lower-triangular matrix: L[i, j] = sum over
    j < k <= i of a_k, -inf above the diagonal (masked before any
    ``exp``, whose gradient would otherwise be NaN there)."""
    T = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    L = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=a.device))
    return L.masked_fill(~mask, -math.inf)


def _ssd_chunked(x, dt, A_log, Bm, Cm, h0):
    """Chunked SSD.  x: (B, T, H, P); dt: (B, T, H); A_log: (H,); Bm/Cm:
    (B, T, N) (one group, shared across heads); h0: (B, H, P, N).

    Chunks of 128 tokens (one chunk for a shorter sequence); a longer
    sequence must be a whole number of chunks.  Returns (y (B, T, H, P),
    h_final)."""
    Bsz, T, H, P = x.shape
    N = Bm.shape[-1]
    cl = min(_CHUNK, T)
    if T % cl:
        raise ValueError(f"mamba2: a sequence of {T} tokens is not a whole "
                         f"number of {_CHUNK}-token SSD chunks")
    nc = T // cl
    a = dt * (-torch.exp(A_log))                                 # (B,T,H)
    xd = x * dt[..., None]
    ac = a.reshape(Bsz, nc, cl, H).permute(0, 1, 3, 2)          # (B,nc,H,cl)
    xc = xd.reshape(Bsz, nc, cl, H, P)
    Bc = Bm.reshape(Bsz, nc, cl, N)
    Cc = Cm.reshape(Bsz, nc, cl, N)

    with fp_exempt("mamba.ssd", _SSD_REASON):
        # 1) intra-chunk (diagonal block): Y = (C B^T . L) X
        L = torch.exp(_segsum(ac))                            # (B,nc,H,cl,cl)
        scores = torch.einsum("bcln,bcsn->bcls", Cc, Bc)         # (B,nc,cl,cl)
        y_diag = torch.einsum("bchls,bcls,bcshp->bclhp", L, scores, xc)

        # 2) chunk-final states: S_c = sum_s decay_to_end * B_s x_s
        a_cum = torch.cumsum(ac, dim=-1)                         # (B,nc,H,cl)
        decay_end = torch.exp(a_cum[..., -1:] - a_cum)
        S = torch.einsum("bchs,bcsn,bcshp->bchpn", decay_end, Bc, xc)

        # 3) inter-chunk recurrence: each chunk sees the state before it
        chunk_decay = torch.exp(a_cum[..., -1])                  # (B,nc,H)
        h, h_prevs = h0, []
        for c in range(nc):
            h_prevs.append(h)
            h = h * chunk_decay[:, c, :, None, None] + S[:, c]
        h_prevs = torch.stack(h_prevs, dim=1)                    # (B,nc,H,P,N)

        # 4) inter-chunk contribution: y += C_t * decay_in * h_prev
        decay_in = torch.exp(a_cum)
        y_off = torch.einsum("bcln,bchl,bchpn->bclhp", Cc, decay_in,
                             h_prevs)
        return (y_diag + y_off).reshape(Bsz, T, H, P), h


def _project(p, x, key, policy, tag, path):
    return (dense(p["z_proj"], x, key, policy, tag + 1, f"{path}.z_proj"),
            dense(p["x_proj"], x, key, policy, tag + 2, f"{path}.x_proj"),
            dense(p["bc_proj"], x, key, policy, tag + 3, f"{path}.bc_proj"),
            dense(p["dt_proj"], x, key, policy, tag + 4, f"{path}.dt_proj"))


def mamba2_layer(p, h, key, policy: QuantPolicy, cfg: ArchConfig,
                 state: dict | None = None, tag: int = 0x50,
                 path: str = "mamba"):
    """Full-sequence Mamba2 block (train / prefill), from ``state`` (zeros
    when ``None``).  Returns (h, final_state)."""
    B, T, _ = h.shape
    d_inner, H = _dims(cfg)
    P, N = cfg.ssm_headdim, cfg.ssm_state
    x = rmsnorm(p["norm"], h)
    z, xs, bc, dt_raw = _project(p, x, key, policy, tag, path)
    if state is None:
        state = init_mamba2_state(cfg, B, h.dtype, device=h.device)
    xs, conv_x_tail = _causal_conv(p["conv_x_w"], p["conv_x_b"], xs,
                                   state["conv_x"])
    bc, conv_bc_tail = _causal_conv(p["conv_bc_w"], p["conv_bc_b"], bc,
                                    state["conv_bc"])
    xs = xs.reshape(B, T, H, P).to(torch.float32)
    Bm, Cm = bc[..., :N].to(torch.float32), bc[..., N:].to(torch.float32)
    dt = _softplus(dt_raw.to(torch.float32) + p["dt_bias"])     # (B,T,H)
    y, h_fin = _ssd_chunked(xs, dt, p["A_log"], Bm, Cm, state["h"])
    y = y + p["D"][None, None, :, None] * xs
    y = y.reshape(B, T, d_inner).to(z.dtype)
    y = rmsnorm(p["out_norm"], y * F.silu(z))
    out = dense(p["out_proj"], y, key, policy, tag + 5, f"{path}.out_proj")
    return h + out, {"h": h_fin, "conv_x": conv_x_tail,
                     "conv_bc": conv_bc_tail}


def mamba2_decode_step(p, h, state: dict, key, policy: QuantPolicy,
                       cfg: ArchConfig, tag: int = 0x50,
                       path: str = "mamba"):
    """The exact one-token recurrence.  h: (B, 1, d).  Returns (h, new
    state)."""
    B = h.shape[0]
    d_inner, H = _dims(cfg)
    P, N = cfg.ssm_headdim, cfg.ssm_state
    x = rmsnorm(p["norm"], h)
    z, xs, bc, dt_raw = _project(p, x, key, policy, tag, path)
    xs, conv_x_tail = _causal_conv(p["conv_x_w"], p["conv_x_b"], xs,
                                   state["conv_x"])
    bc, conv_bc_tail = _causal_conv(p["conv_bc_w"], p["conv_bc_b"], bc,
                                    state["conv_bc"])
    xs = xs[:, 0].reshape(B, H, P).to(torch.float32)
    Bm = bc[:, 0, :N].to(torch.float32)
    Cm = bc[:, 0, N:].to(torch.float32)
    dt = _softplus(dt_raw[:, 0].to(torch.float32) + p["dt_bias"])
    with fp_exempt("mamba.ssd", _SSD_REASON):
        a = torch.exp(dt * (-torch.exp(p["A_log"])))
        hs = state["h"] * a[..., None, None] + torch.einsum(
            "bh,bhp,bn->bhpn", dt, xs, Bm)
        y = torch.einsum("bhpn,bn->bhp", hs, Cm) + p["D"][None, :, None] * xs
    y = y.reshape(B, 1, d_inner).to(z.dtype)
    y = rmsnorm(p["out_norm"], y * F.silu(z))
    out = dense(p["out_proj"], y, key, policy, tag + 5, f"{path}.out_proj")
    return h + out, {"h": hs, "conv_x": conv_x_tail, "conv_bc": conv_bc_tail}
