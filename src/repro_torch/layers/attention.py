"""GQA attention with FQT projections, cross-attention, the dense-lane
decode KV cache and the paged int8 KV pool.

Port of ``repro.layers.attention``, with standard RoPE, Qwen2-VL's M-RoPE
(positions ``(3, B, T)``) or none (Whisper).  The four
projections are FQT linear layers; the attention math (scores, softmax,
value mix) stays full precision, as in the paper's transformer setting.
KV caches are stored flattened as ``(B, S, n_kv*head_dim)``, paged pools
as ``(n_pages, page_size, n_kv*head_dim)``.  The decode steps write their
new rows into the cache or pool in place, where the JAX package builds an
updated copy.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ArchConfig
from ..core import (QuantPolicy, get_quantizer, kv_fresh_code,
                    resolve_kv_cache_spec)
from ..core.exempt import fp_exempt
from ..kernels.kv_gather import kv_gather_pages_kv, kv_gather_pages_kv_plain
from .common import dense, init_dense
from .embeddings import apply_mrope, apply_rope

__all__ = ["init_attention", "attention", "cross_attention_kv",
           "decode_attention", "init_kv_cache", "init_kv_cache_quant",
           "init_paged_kv_pool", "paged_write_index", "last_write",
           "paged_decode_attention"]

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


def _rotate(x, positions, cfg):
    """``x`` (B, T, heads, hd) rotated by the config's positional scheme."""
    if cfg.rope == "standard":
        return apply_rope(x, positions, cfg.rope_theta)
    if cfg.rope == "mrope":
        return apply_mrope(x, positions, cfg.rope_theta)
    if cfg.rope != "none":
        raise ValueError(f"unknown rope {cfg.rope!r}")
    return x


def _qkv(p, x, key, policy, cfg, positions, path="attn"):
    B, T, _ = x.shape
    hd, H, KV = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    q = dense(p["wq"], x, key, policy, 1, f"{path}.wq").reshape(B, T, H, hd)
    k = dense(p["wk"], x, key, policy, 2, f"{path}.wk").reshape(B, T, KV, hd)
    v = dense(p["wv"], x, key, policy, 3, f"{path}.wv").reshape(B, T, KV, hd)
    return _rotate(q, positions, cfg), _rotate(k, positions, cfg), v


def _step_positions(cfg: ArchConfig, offs: torch.Tensor) -> torch.Tensor:
    """A decode step's rotary positions from its (B, C) offsets: broadcast
    to the three M-RoPE axes, (3, B, C), for an ``mrope`` model."""
    return offs.expand(3, *offs.shape) if cfg.rope == "mrope" else offs


def _sdpa(q, k, v, mask):
    """q: (B,T,KV,G,hd), k/v: (B,S,KV,hd), mask: broadcast (B,1,1,T,S).

    Plain ops, not ``scaled_dot_product_attention``: masking with -1e30 and
    an fp32 softmax are the reference's numerics."""
    with fp_exempt("attn.sdpa",
                   "attention scores/probs GEMMs stay full precision — the "
                   "paper quantizes only linear layers (Sec. 2.1 setting)"):
        scale = 1.0 / torch.sqrt(torch.tensor(q.shape[-1], dtype=q.dtype,
                                              device=q.device))
        scores = torch.einsum("btkgh,bskh->bkgts", q * scale, k)
        scores = torch.where(mask, scores, torch.tensor(
            _NEG, dtype=scores.dtype, device=scores.device))
        probs = torch.softmax(scores.to(torch.float32), dim=-1).to(q.dtype)
        return torch.einsum("bkgts,bskh->btkgh", probs, v)


def attention(p: dict, x: torch.Tensor, key, policy: QuantPolicy,
              cfg: ArchConfig, positions: torch.Tensor, causal: bool = True,
              kv_override: Optional[tuple] = None, return_kv: bool = False,
              path: str = "attn"):
    """Full-sequence attention (training, prefill, an encoder).

    ``causal=False``: every query sees every key (an all-true mask).
    ``kv_override``: the (k, v) of shape (B, S, KV, hd) to attend over
    (cross-attention); only ``wq`` (tag 1) and ``wo`` (tag 4) are then
    quantized GEMMs, and q is rotated as in self-attention.
    ``return_kv``: also return the (rotated) k, v for cache
    initialization."""
    B, T, _ = x.shape
    hd, H, KV = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    G = H // KV
    if kv_override is None:
        q, k, v = _qkv(p, x, key, policy, cfg, positions, path)
    else:
        q = dense(p["wq"], x, key, policy, 1,
                  f"{path}.wq").reshape(B, T, H, hd)
        q = _rotate(q, positions, cfg)
        k, v = kv_override
    S = k.shape[1]
    if causal:
        mask = (torch.arange(T, device=x.device)[:, None]
                >= torch.arange(S, device=x.device)[None, :])
        mask = mask[None, None, None]
    else:
        mask = torch.ones((1, 1, 1, T, S), dtype=torch.bool, device=x.device)
    out = _sdpa(q.reshape(B, T, KV, G, hd), k, v, mask)
    y = dense(p["wo"], out.reshape(B, T, H * hd), key, policy, 4,
              f"{path}.wo")
    if return_kv:
        return y, (k, v)
    return y


def cross_attention_kv(p: dict, enc_out: torch.Tensor, key,
                       policy: QuantPolicy, cfg: ArchConfig,
                       path: str = "attn"):
    """The encoder-side K/V of a decoder's cross-attention, (B, S, KV, hd)
    each: ``wk`` (tag 2) and ``wv`` (tag 3) of ``enc_out``, unrotated."""
    B, S, _ = enc_out.shape
    hd, KV = cfg.hd, cfg.n_kv_heads
    k = dense(p["wk"], enc_out, key, policy, 2,
              f"{path}.wk").reshape(B, S, KV, hd)
    v = dense(p["wv"], enc_out, key, policy, 3,
              f"{path}.wv").reshape(B, S, KV, hd)
    return k, v


def init_kv_cache(cfg: ArchConfig, batch: int, max_seq: int,
                  dtype=torch.float32, lead=(), device=None) -> dict:
    """Float KV cache in ``dtype``: (*lead, batch, max_seq,
    n_kv*head_dim) per side."""
    shape = (*lead, batch, max_seq, cfg.n_kv_heads * cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


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


def init_paged_kv_pool(cfg: ArchConfig, n_pages: int, page_size: int,
                       bits: int = 8, lead=(), device=None) -> dict:
    """The shared page pool of the paged serving engine: the int8 codec of
    :func:`init_kv_cache_quant` laid out as ``n_pages`` pages of
    ``page_size`` rows, ``(*lead, n_pages, page_size, flat)`` per side.
    Fresh pages dequantize to exact zeros, so the garbage page every idle
    lane and unallocated block reads stays finite."""
    return init_kv_cache_quant(cfg, n_pages, page_size, bits, lead=lead,
                               device=device)


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
    ``kv_dequant_rows_kv`` CUDA kernel, K and V in one launch, where the
    codec has ``dequant_rows_kv``; else its ``dequant_rows`` a side).  Each
    slot attends over positions <= its index.  Returns (y (B, 1, d), cache) — the same cache object,
    updated.
    """
    B = x.shape[0]
    hd, H, KV = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    G = H // KV
    pos = torch.as_tensor(index, dtype=torch.int64,
                          device=x.device).reshape(-1).expand(B)
    q, k_new, v_new = _qkv(p, x, key, policy, cfg,
                           _step_positions(cfg, pos[:, None]), path)
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
        sides = [(c["codes"], c["scale"], c["zero"])
                 for c in (cache["k"], cache["v"])]
        if hasattr(qz, "dequant_rows_kv"):
            rows = qz.dequant_rows_kv(*sides, bits, backend=policy.backend)
        else:
            rows = [qz.dequant_rows(*side, bits, backend=policy.backend)
                    for side in sides]
        k, v = (r.reshape(B, S, KV, hd).to(x.dtype) for r in rows)
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


def last_write(flat: torch.Tensor, size: int) -> torch.Tensor:
    """For each write to the flat targets ``flat`` (in ``[0, size)``), the
    index of the last write to the same target.  Writes that take their
    value through it all carry one value, so a CUDA scatter, which lets
    any of them win, leaves what an in-order scatter leaves."""
    order = torch.arange(flat.numel(), device=flat.device)
    last = torch.full((size,), -1, dtype=torch.int64, device=flat.device)
    return last.scatter_reduce_(0, flat, order, reduce="amax")[flat]


def paged_write_index(table: torch.Tensor, start: torch.Tensor, C: int,
                      n_pages: int, P: int):
    """Where a ``C``-token paged step writes into a pool of ``n_pages``
    pages of ``P`` rows: ``(offs, pids, rows, src)``.

    ``offs`` (B, C): the positions ``start + c``; ``pids``/``rows`` (B, C):
    the page and row of each, positions clamped to ``nb * P - 1``.  Rows of
    one step can share a target: padding rows of a chunk that fall in
    unallocated blocks all land on the garbage page, and at ``C = 1``
    every idle lane writes page 0, row 0.  Their values can differ (a MoE
    layer's capacity drops idle lanes' tokens unequally), and a CUDA
    scatter lets any of them win, so ``src`` (B*C,) names, for every
    write, the last write (in ``(b, c)`` order) to its target
    (:func:`last_write`): the pool is then the same from run to run, as
    after the reference's in-order scatter.
    """
    B, nb = table.shape
    dev = table.device
    start = torch.as_tensor(start, device=dev).to(torch.int64).reshape(B)
    offs = start[:, None] + torch.arange(C, device=dev)[None, :]
    offs_w = torch.clamp_max(offs, nb * P - 1)
    pids = torch.gather(table.to(torch.int64), 1, offs_w // P)
    rows = offs_w % P
    src = last_write((pids * P + rows).reshape(-1), n_pages * P)
    return offs, pids, rows, src


def paged_decode_attention(p: dict, x: torch.Tensor, pool: dict,
                           table: torch.Tensor, start: torch.Tensor, key,
                           policy: QuantPolicy, cfg: ArchConfig,
                           path: str = "attn", kv_quant=None, write=None):
    """Multi-token attention step over a paged int8 KV pool.  x: (B, C, d).

    ``C = 1`` is continuous-batching decode, ``C = chunk`` one chunked-
    prefill slab, ``C = k + 1`` the speculative verify.  ``pool``: one
    layer of :func:`init_paged_kv_pool`; ``table``: (B, nb) int32 page ids
    in logical block order (unallocated blocks point at the garbage page);
    ``start``: (B,) position of each row's first token; ``write``: the
    step's :func:`paged_write_index`, computed here when not given.  Row
    ``c`` is quantized and written at position ``start + c`` of its page
    (in place; where rows share a target the last one's value wins), then
    the whole table is gathered and dequantized — K and V in one launch of
    the ``kv_gather_pages_kv`` CUDA kernel on the ``kernel`` backend, its
    plain version otherwise — and position ``start + c`` attends over every
    position ``<= start + c``.  A ``C = 1`` step is arithmetically the
    dense-lane :func:`decode_attention` step.  Positions clamp to the
    table's span ``nb * P - 1``: padding rows write the last row, which
    stays masked until a real token is written there.

    Returns (y (B, C, d), pool) — the same pool object, updated.
    """
    B, C, _ = x.shape
    hd, H, KV = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    G = H // KV
    n_pages, P = pool["k"]["codes"].shape[:2]
    S = table.shape[1] * P
    dev = x.device
    offs, pids, rows, src = (write if write is not None else
                             paged_write_index(table, start, C, n_pages, P))
    q, k_new, v_new = _qkv(p, x, key, policy, cfg,
                           _step_positions(cfg, offs), path)

    spec = resolve_kv_cache_spec(True if kv_quant is None else kv_quant)
    qz = get_quantizer(spec.name)
    bits = spec.bits or 8
    flat = KV * hd
    for side, new in (("k", k_new), ("v", v_new)):
        codes, scale, zero = qz.quantize_rows(new.reshape(B * C, flat), bits)
        codes, scale, zero = codes[src], scale[src], zero[src]
        pool[side]["codes"][pids, rows] = codes.reshape(B, C, flat)
        pool[side]["scale"][pids, rows] = scale.reshape(B, C)
        pool[side]["zero"][pids, rows] = zero.reshape(B, C)

    gather = (kv_gather_pages_kv if policy.backend == "kernel"
              else kv_gather_pages_kv_plain)
    rows_f = gather(*((c["codes"], c["scale"], c["zero"])
                      for c in (pool["k"], pool["v"])), table, bits)
    k, v = (r.reshape(B, S, KV, hd).to(x.dtype) for r in rows_f)
    mask = (torch.arange(S, device=dev)[None, None, :]
            <= offs[:, :, None])                                   # (B, C, S)
    out = _sdpa(q.reshape(B, C, KV, G, hd), k, v, mask[:, None, None])
    y = dense(p["wo"], out.reshape(B, C, H * hd), key, policy, 4,
              f"{path}.wo")
    return y, pool
