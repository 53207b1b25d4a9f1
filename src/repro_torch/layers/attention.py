"""GQA attention with FQT projections and the dense-lane decode KV cache.

Port of the dense path of ``repro.layers.attention``.  The four
projections are FQT linear layers; the attention math (scores, softmax,
value mix) stays full precision, as in the paper's transformer setting.
KV caches are stored flattened as ``(B, S, n_kv*head_dim)``.  The decode
step writes its new row into the cache in place, where the JAX package
builds an updated copy.
"""

from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..core import (QuantPolicy, get_quantizer, kv_fresh_code,
                    resolve_kv_cache_spec)
from .common import dense, init_dense
from .embeddings import apply_rope

__all__ = ["init_attention", "attention", "decode_attention",
           "init_kv_cache", "init_kv_cache_quant"]

_NEG = -1e30


def init_attention(gen: torch.Generator, cfg: ArchConfig, lead=()) -> dict:
    hd = cfg.hd
    return {
        "wq": init_dense(gen, cfg.d_model, cfg.n_heads * hd, cfg.qkv_bias,
                         lead=lead),
        "wk": init_dense(gen, cfg.d_model, cfg.n_kv_heads * hd, cfg.qkv_bias,
                         lead=lead),
        "wv": init_dense(gen, cfg.d_model, cfg.n_kv_heads * hd, cfg.qkv_bias,
                         lead=lead),
        "wo": init_dense(gen, cfg.n_heads * hd, cfg.d_model, False,
                         lead=lead),
    }


def _qkv(p, x, key, policy, cfg, positions, path="attn"):
    B, T, _ = x.shape
    hd, H, KV = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    q = dense(p["wq"], x, key, policy, 1, f"{path}.wq").reshape(B, T, H, hd)
    k = dense(p["wk"], x, key, policy, 2, f"{path}.wk").reshape(B, T, KV, hd)
    v = dense(p["wv"], x, key, policy, 3, f"{path}.wv").reshape(B, T, KV, hd)
    if cfg.rope == "standard":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    elif cfg.rope != "none":
        raise NotImplementedError(
            f"rope={cfg.rope!r} is not ported yet (the VLM family comes in a "
            f"later slice)")
    return q, k, v


def _sdpa(q, k, v, mask):
    """q: (B,T,KV,G,hd), k/v: (B,S,KV,hd), mask: broadcast (B,1,1,T,S).

    Plain ops, not ``scaled_dot_product_attention``: masking with -1e30 and
    an fp32 softmax are the reference's numerics."""
    scale = 1.0 / torch.sqrt(torch.tensor(q.shape[-1], dtype=q.dtype,
                                          device=q.device))
    scores = torch.einsum("btkgh,bskh->bkgts", q * scale, k)
    scores = torch.where(mask, scores, torch.tensor(_NEG, dtype=scores.dtype,
                                                    device=scores.device))
    probs = torch.softmax(scores.to(torch.float32), dim=-1).to(q.dtype)
    return torch.einsum("bkgts,bskh->btkgh", probs, v)


def attention(p: dict, x: torch.Tensor, key, policy: QuantPolicy,
              cfg: ArchConfig, positions: torch.Tensor,
              return_kv: bool = False, path: str = "attn"):
    """Full-sequence causal attention (prefill).  return_kv: also return
    the (rotated) k, v of shape (B, T, KV, hd) for cache initialization."""
    B, T, _ = x.shape
    hd, H, KV = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    G = H // KV
    q, k, v = _qkv(p, x, key, policy, cfg, positions, path)
    ar = torch.arange(T, device=x.device)
    mask = (ar[:, None] >= ar[None, :])[None, None, None]
    out = _sdpa(q.reshape(B, T, KV, G, hd), k, v, mask)
    y = dense(p["wo"], out.reshape(B, T, H * hd), key, policy, 4,
              f"{path}.wo")
    if return_kv:
        return y, (k, v)
    return y


def init_kv_cache(cfg: ArchConfig, batch: int, max_seq: int, lead=(),
                  device=None) -> dict:
    """fp32 KV cache: (*lead, batch, max_seq, n_kv*head_dim) per side."""
    shape = (*lead, batch, max_seq, cfg.n_kv_heads * cfg.hd)
    return {"k": torch.zeros(shape, device=device),
            "v": torch.zeros(shape, device=device)}


def init_kv_cache_quant(cfg: ArchConfig, batch: int, max_seq: int,
                        bits: int = 8, lead=(), device=None) -> dict:
    """int8 KV cache (core/kv_cache.py codec): shifted-signed codes plus
    one (scale, zero) pair per (batch, position) row.  Fresh rows
    dequantize to exact zeros (scale 1, zero 0, codes ``kv_fresh_code``)."""
    flat = cfg.n_kv_heads * cfg.hd
    fresh = kv_fresh_code(bits)

    def one():
        return {"codes": torch.full((*lead, batch, max_seq, flat), fresh,
                                    dtype=torch.int8, device=device),
                "scale": torch.ones((*lead, batch, max_seq),
                                    dtype=torch.float32, device=device),
                "zero": torch.zeros((*lead, batch, max_seq),
                                    dtype=torch.float32, device=device)}
    return {"k": one(), "v": one()}


def _is_quant_kv(cache: dict) -> bool:
    return isinstance(cache["k"], dict)


def decode_attention(p: dict, x: torch.Tensor, cache: dict,
                     index: torch.Tensor, key, policy: QuantPolicy,
                     cfg: ArchConfig, path: str = "attn", kv_quant=None):
    """One-token attention step.  x: (B, 1, d); ``index``: a scalar or
    ``(B,)`` per-slot positions.

    ``cache`` is one layer of the fp ``init_kv_cache`` layout or the int8
    ``init_kv_cache_quant`` layout; the new row is written in place
    (quantized for the int8 layout), then the resident cache is read — for
    int8 through the backend ``policy.backend`` selects (``kernel`` = the
    ``kv_dequant_rows`` CUDA kernel).  Each slot attends over positions
    <= its index.  Returns (y (B, 1, d), cache) — the same cache object,
    updated.
    """
    B = x.shape[0]
    hd, H, KV = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    G = H // KV
    pos = torch.as_tensor(index, dtype=torch.int64,
                          device=x.device).reshape(-1).expand(B)
    q, k_new, v_new = _qkv(p, x, key, policy, cfg, pos[:, None], path)
    flat = KV * hd
    bidx = torch.arange(B, device=x.device)
    rows_k = k_new.reshape(B, flat)
    rows_v = v_new.reshape(B, flat)
    if _is_quant_kv(cache):
        spec = resolve_kv_cache_spec(True if kv_quant is None else kv_quant)
        qz = get_quantizer(spec.name)
        bits = spec.bits or 8
        for side, rows in (("k", rows_k), ("v", rows_v)):
            codes, scale, zero = qz.quantize_rows(rows, bits)
            cache[side]["codes"][bidx, pos] = codes
            cache[side]["scale"][bidx, pos] = scale
            cache[side]["zero"][bidx, pos] = zero
        S = cache["k"]["codes"].shape[1]

        def get(side):
            rows = qz.dequant_rows(side["codes"], side["scale"],
                                   side["zero"], bits,
                                   backend=policy.backend)
            return rows.reshape(B, S, KV, hd).to(x.dtype)
        k, v = get(cache["k"]), get(cache["v"])
    else:
        cache["k"][bidx, pos] = rows_k.to(cache["k"].dtype)
        cache["v"][bidx, pos] = rows_v.to(cache["v"].dtype)
        S = cache["k"].shape[1]
        k = cache["k"].reshape(B, S, KV, hd).to(x.dtype)
        v = cache["v"].reshape(B, S, KV, hd).to(x.dtype)
    mask = (torch.arange(S, device=x.device)[None, :] <= pos[:, None])
    mask = mask[:, None, None, None, :]                      # (B,1,1,1,S)
    out = _sdpa(q.reshape(B, 1, KV, G, hd), k, v, mask)
    y = dense(p["wo"], out.reshape(B, 1, H * hd), key, policy, 4,
              f"{path}.wo")
    return y, cache
