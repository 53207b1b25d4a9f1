"""Top-k MoE with capacity-based static dispatch.

Port of ``repro.layers.moe``.  Dispatch uses the classic capacity scheme
(GShard-style) over the full ``(E, C, d)`` buffer: unfilled capacity rows
are zeros, and every expert's FFN runs over all ``C`` rows of its buffer,
so each expert's per-tensor ``Q_f`` ranges, PSQ rows and BHQ blocks see
the zero rows exactly as the reference's vmapped experts do.  The experts
run one after another (one set of FQT GEMMs each); the reference vmaps
them.

Routing mirrors ``jax.lax.top_k``: among equal probabilities the lower
expert index ranks first (a stable descending sort).  A token's position
within its expert counts over the token-major ``(N * K)`` order, so the
later tokens of that order are the ones dropped at capacity.

Every gather and scatter here is deterministic: a kept slot has one
source, only the overflow row ``E * C`` collides and it is dropped, and
the ``K`` copies of a token sum in a fixed order in the backward.

Returns a Switch-style load-balance loss alongside the output.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import prng
from ..configs.base import ArchConfig
from ..core import QuantPolicy
from ..kernels.pack import PackedTensor
from .common import dense, init_dense, qkey
from .mlp import init_mlp, mlp

__all__ = ["init_moe", "moe_block", "expert_capacity", "moe_route"]


def expert_capacity(n_tokens: int, cfg: ArchConfig) -> int:
    c = int(cfg.moe_topk * n_tokens / cfg.moe_experts * cfg.moe_capacity)
    return max(c, 1)


def init_moe(gen: torch.Generator, cfg: ArchConfig, lead=()) -> dict:
    """``{"router": dense (d, E), "experts": mlp stacked (E, ...)}``, each
    leaf with the ``lead`` prefix (the layer stack)."""
    return {"router": init_dense(gen, cfg.d_model, cfg.moe_experts,
                                 lead=lead),
            "experts": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act,
                                lead=(*lead, cfg.moe_experts))}


def _unstack(tree, n: int) -> list:
    """The ``n`` slices of a stacked ``(n, ...)`` tree along its first axis
    (``torch.unbind``: one backward for the whole stack, not ``n``)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    if isinstance(tree, PackedTensor):
        return [tree[i] for i in range(n)]
    return list(torch.unbind(tree, 0))


def moe_route(probs: torch.Tensor, K: int, C: int):
    """Top-``K`` routing with capacity ``C`` over probabilities (N, E).

    Returns ``(top_p, top_i, pos, keep, dst)``: the renormalized top-K
    probabilities and their experts (N, K), each assignment's position
    within its expert, whether it fits, and its slot in the flat ``(E * C
    + 1)`` buffer (``E * C``, the overflow row, when dropped)."""
    E = probs.shape[-1]
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :K], top_i[:, :K]
    top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)
    flat_e = top_i.reshape(-1)                                   # (N*K,)
    onehot = F.one_hot(flat_e, E).to(torch.int32)                # (N*K, E)
    pos = torch.gather(torch.cumsum(onehot, dim=0, dtype=torch.int32) - 1,
                       1, flat_e[:, None])[:, 0]
    keep = pos < C
    dst = torch.where(keep, flat_e * C + pos,
                      torch.full_like(flat_e, E * C))
    return top_p, top_i, pos, keep, dst


def moe_block(p: dict, x: torch.Tensor, key, policy: QuantPolicy,
              cfg: ArchConfig, tag_base: int = 0x20, path: str = "moe"):
    """x: (B, T, d) -> (y, aux_loss).

    The router GEMM takes ``fold_in(key, tag_base)``; expert ``e`` takes
    ``split(fold_in(key, tag_base + 1), E)[e]`` and tags from ``tag_base +
    2`` inside its MLP.  ``key=None`` (serving) draws nothing."""
    B, T, d = x.shape
    N = B * T
    E, K = cfg.moe_experts, cfg.moe_topk
    C = expert_capacity(N, cfg)
    xt = x.reshape(N, d)

    logits = dense(p["router"], xt, key, policy, tag_base,
                   f"{path}.router")                              # (N, E)
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    top_p, top_i, _, keep, dst = moe_route(probs, K, C)

    # --- dispatch: kept assignment j fills slot dst[j] of (E, C, d) -------
    slot_src = torch.full((E * C + 1,), N * K, dtype=torch.int64,
                          device=x.device)
    slot_src[dst] = torch.arange(N * K, device=x.device)
    xr = xt[:, None, :].expand(N, K, d).reshape(N * K, d)        # repeat
    src = torch.cat([xr, xr.new_zeros((1, d))])                  # + zero row
    xe = F.embedding(slot_src[:E * C], src).reshape(E, C, d)

    # --- expert FFNs (per-expert quantizer stats over all C rows) ---------
    ekeys = (None if key is None
             else prng.split(qkey(key, tag_base + 1), E))
    experts = _unstack(p["experts"], E)
    ye = torch.stack([
        mlp(experts[e], xe[e], None if ekeys is None else ekeys[e], policy,
            cfg.act, tag_base + 2, f"{path}.expert") for e in range(E)])

    # --- combine ----------------------------------------------------------
    out_slots = F.embedding(dst, torch.cat([ye.reshape(E * C, d),
                                            ye.new_zeros((1, d))]))
    w = (top_p.reshape(-1) * keep.to(torch.float32))[:, None]
    y = torch.sum((out_slots.to(torch.float32) * w).reshape(N, K, d), dim=1)
    y = y.reshape(B, T, d).to(x.dtype)

    # Switch-style load-balance aux loss
    frac_tokens = torch.mean(F.one_hot(top_i[:, 0], E).to(torch.float32),
                             dim=0)
    frac_probs = torch.mean(probs, dim=0)
    aux = E * torch.sum(frac_tokens * frac_probs)
    return y, aux
