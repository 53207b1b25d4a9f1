"""Decoder-only LM: the dense, MoE, VLM, Zamba2-hybrid and RWKV6
families.  Init, training loss, prefill, one-token decode and the paged
multi-token decode.

Port of ``repro.models.lm``.  Per-layer parameters stay stacked ``(L,
...)`` with the JAX package's leaf names (the hybrid model's Mamba2
layers ``(n_outer, period, ...)``), and the stack runs as a Python loop
over layer views (the counterpart of ``lax.scan``).  The training loss
threads a PRNG key through the stack as the reference does (layer ``i``
takes ``split(key, n_layers)[i]``; the hybrid model's outer block ``o``
takes ``okey = split(key, n_outer)[o]``, its inner layer ``i``
``split(okey, period + 1)[i]`` and its fuse and shared block the last;
the head takes ``key``, or ``fold_in(key, chunk)`` per loss chunk): the
backward's stochastic quantizers draw from it.  The forward quantizers
are deterministic, so prefill and decode draw no randomness: their key
is ``None``.  A MoE layer's ``moe_block`` takes the layer's key in place
of the MLP and adds its load-balance loss to the stack's ``aux``.  A VLM
batch carries ``embeds`` (the stub vision frontend's output) and M-RoPE
``positions`` (3, B, T) in place of tokens.  The audio family
(whisper-medium, an encoder-decoder) runs through ``models/encdec.py``;
the entry points here refuse it.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import prng
from ..configs.base import ArchConfig
from ..core import QuantPolicy
from ..core.fqt import recomputed
from ..layers import (apply_norm, attention, decode_attention, dense, embed,
                      init_attention, init_embedding, init_kv_cache,
                      init_kv_cache_quant, init_lm_head, init_mamba2_layer,
                      init_mamba2_state, init_mlp, init_moe, init_norm,
                      init_paged_kv_pool, init_rwkv_layer, init_rwkv_state,
                      lm_head, mamba2_decode_step, mamba2_layer, mlp,
                      moe_block, paged_decode_attention, paged_write_index,
                      rwkv_decode_step, rwkv_layer)
from ..layers.common import randn
from ..sharding import data

__all__ = ["init_lm_params", "lm_loss", "lm_prefill", "lm_decode",
           "init_lm_cache", "init_lm_cache_quant", "init_lm_paged_pool",
           "lm_paged_decode", "cross_entropy", "chunked_head_loss",
           "layer_view", "check_ported", "has_kv_cache", "remat_call",
           "cache_dtype"]


def check_ported(cfg: ArchConfig) -> None:
    """Raise unless ``cfg`` is a decoder LM of a family this module runs:
    dense, MoE (``moe_experts`` > 0), VLM, the Mamba2 hybrid or RWKV6.
    The audio family is an encoder-decoder: ``build_model`` routes it to
    ``models/encdec.py``."""
    ported = {"dense": not cfg.moe_experts and not cfg.ssm_kind,
              "moe": cfg.moe_experts > 0 and not cfg.ssm_kind,
              "vlm": not cfg.ssm_kind,
              "hybrid": cfg.ssm_kind == "mamba2" and cfg.hybrid_period > 0,
              "ssm": cfg.ssm_kind == "rwkv6"}
    if cfg.family == "audio":
        raise ValueError(
            f"{cfg.name}: the audio family is an encoder-decoder; its "
            f"entry points are models/encdec.py's (build_model routes "
            f"there), not the decoder LM's")
    if not ported.get(cfg.family):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not a decoder LM family "
            f"of the port (dense, MoE, VLM, Mamba2-hybrid, RWKV6)")


def has_kv_cache(cfg: ArchConfig) -> bool:
    """Whether the model keeps a transformer KV cache in every layer (not
    the recurrent state of the RWKV6 and hybrid families): the reference's
    ``quantizable``."""
    return not (cfg.family == "hybrid" or cfg.ssm_kind == "rwkv6")


def _refuse_recurrent(cfg: ArchConfig, what: str) -> None:
    if not has_kv_cache(cfg):
        raise ValueError(
            f"{cfg.name}: {what} need a transformer KV cache; "
            f"family={cfg.family!r}/ssm_kind={cfg.ssm_kind!r} keeps dense "
            f"recurrent state")


def layer_view(tree, i: int):
    """Layer ``i`` of a stacked ``(L, ...)`` tree, as views."""
    if isinstance(tree, dict):
        return {k: layer_view(v, i) for k, v in tree.items()}
    return tree[i]


def remat_call(remat: bool, fn, *args):
    """``fn(*args)``, recomputed in the backward when ``remat`` (the
    reference's ``jax.checkpoint`` of a layer body): non-reentrant
    ``torch.utils.checkpoint``, so only ``args`` stay alive between the
    forward and the backward.  The forward draws no randomness (its
    quantizers are deterministic, the SR bits are drawn in the backward
    from the layer's key), so the recomputation is the forward bit for
    bit."""
    if not remat:
        return fn(*args)
    from torch.utils.checkpoint import checkpoint
    return checkpoint(_recomputed, fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def _recomputed(fn, *args):
    with recomputed():
        return fn(*args)


def _tx_params(gen: torch.Generator, cfg: ArchConfig, lead=()) -> dict:
    """A transformer block's parameters (pre-norm attention + MLP/MoE), a
    ``(*lead, ...)`` stack of them."""
    dev = gen.device
    p = {"ln1": init_norm(cfg.d_model, cfg.norm, lead=lead, device=dev),
         "attn": init_attention(gen, cfg, lead=lead),
         "ln2": init_norm(cfg.d_model, cfg.norm, lead=lead, device=dev)}
    if cfg.moe_experts:
        p["moe"] = init_moe(gen, cfg, lead=lead)
    else:
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act, lead=lead)
    return p


def _n_outer(cfg: ArchConfig) -> int:
    return cfg.n_layers // cfg.hybrid_period


def init_lm_params(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """Random parameters on the generator's device (same distributions as
    ``repro.models.lm.init_lm_params``, other draws).  The hybrid model:
    ``layers`` its Mamba2 stack ``(n_outer, period, ...)``, ``fuse`` the
    ``(n_outer, 2d, d)`` projections of ``concat(h, h0)`` and ``shared``
    ONE transformer block; RWKV6: ``layers`` ``(L, ...)``."""
    check_ported(cfg)
    dev = gen.device
    # draw order: embedding, head, then the layers
    params = {
        "embed": init_embedding(gen, cfg),
        "final_norm": init_norm(cfg.d_model, cfg.norm, device=dev),
        "lm_head": init_lm_head(gen, cfg),
    }
    d = cfg.d_model
    if cfg.family == "hybrid":
        n_outer = _n_outer(cfg)
        params["layers"] = init_mamba2_layer(
            gen, cfg, lead=(n_outer, cfg.hybrid_period))
        params["fuse"] = {"w": randn(gen, (n_outer, 2 * d, d),
                                     0.5 / d ** 0.5)}
        params["shared"] = _tx_params(gen, cfg)
    elif cfg.ssm_kind == "rwkv6":
        params["layers"] = init_rwkv_layer(gen, cfg, lead=(cfg.n_layers,))
    else:
        params["layers"] = _tx_params(gen, cfg, lead=(cfg.n_layers,))
    return params


def _ffn(p, x, key, policy, cfg, path="layers"):
    """The layer's MLP, or its MoE block.  Returns (y, aux)."""
    if cfg.moe_experts:
        return moe_block(p["moe"], x, key, policy, cfg, path=f"{path}.moe")
    return mlp(p["mlp"], x, key, policy, cfg.act, path=f"{path}.mlp"), 0.0


def _tx_layer(p, h, key, policy, cfg, positions, want_kv: bool,
              path="layers"):
    """Pre-norm attention + MLP/MoE.  Returns (h, aux, kv or None)."""
    x = apply_norm(p["ln1"], h, cfg.norm)
    kv = None
    if want_kv:
        att, (k, v) = attention(p["attn"], x, key, policy, cfg, positions,
                                return_kv=True, path=f"{path}.attn")
        B, S = k.shape[0], k.shape[1]
        kv = {"k": k.reshape(B, S, -1), "v": v.reshape(B, S, -1)}
    else:
        att = attention(p["attn"], x, key, policy, cfg, positions,
                        path=f"{path}.attn")
    h = h + att.to(h.dtype)
    x = apply_norm(p["ln2"], h, cfg.norm)
    y, aux = _ffn(p, x, key, policy, cfg, path)
    return h + y.to(h.dtype), aux, kv


def _stack(trees: list):
    """Per-layer trees of tensors stacked leaf by leaf into one tree."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _forward_seq(params, h, key, policy: QuantPolicy, cfg: ArchConfig,
                 positions, want_cache: bool, remat: bool = False):
    """Run the layer stack over a full sequence.  Returns (h, aux, cache):
    ``aux`` the layers' summed MoE load-balance loss (0.0 but for a MoE
    model); cache, when ``want_cache``, the transformer's ``{"k", "v"}``
    stacked (L, B, T, flat), RWKV6's states stacked (L, ...) or the
    hybrid's ``(mamba states (n_outer, period, ...), kv (n_outer, ...))``.
    ``key``: ``None`` (forward only) or the key layer ``i`` splits off as
    ``split(key, n_layers)[i]`` (the hybrid: see :func:`_forward_hybrid`).
    ``remat``: each layer (the hybrid: each outer block) recomputed in the
    backward (:func:`remat_call`).
    """
    check_ported(cfg)
    if cfg.family == "hybrid":
        return _forward_hybrid(params, h, key, policy, cfg, positions,
                               want_cache, remat)
    keys = (None if key is None else prng.split(key, cfg.n_layers))

    def rwkv(lp, h, lk):
        return rwkv_layer(lp, h, lk, policy, cfg, path="layers.rwkv")

    def tx(lp, h, lk):
        return _tx_layer(lp, h, lk, policy, cfg, positions, want_cache)

    outs, aux = [], 0.0
    for i in range(cfg.n_layers):
        lp, lk = layer_view(params["layers"], i), (
            None if keys is None else keys[i])
        if cfg.ssm_kind == "rwkv6":
            h, out = remat_call(remat, rwkv, lp, h, lk)
        else:
            h, a, out = remat_call(remat, tx, lp, h, lk)
            aux = aux + a
        outs.append(out)
    return h, aux, (_stack(outs) if want_cache else None)


def _forward_hybrid(params, h, key, policy, cfg, positions, want_cache,
                    remat=False):
    """Zamba2: ``n_outer`` blocks of ``hybrid_period`` Mamba2 layers, each
    followed by the ONE shared transformer block on ``fuse(concat(h,
    h0))``, ``h0`` the stack's input.  Outer block ``o`` keys its layers
    from ``split(split(key, n_outer)[o], period + 1)``: inner layer ``i``
    takes entry ``i``, the fuse and the shared block the last.  ``remat``
    recomputes each outer block whole, as the reference checkpoints its
    outer scan body."""
    n_outer, period = _n_outer(cfg), cfg.hybrid_period
    h0 = h
    okeys = None if key is None else prng.split(key, n_outer)

    def block(outer, fuse, shared, h, h0, okey):
        ikeys = (None if okey is None else prng.split(okey, period + 1))
        inner = []
        for i in range(period):
            h, st = mamba2_layer(layer_view(outer, i), h,
                                 None if ikeys is None else ikeys[i],
                                 policy, cfg, path="layers.mamba")
            inner.append(st)
        skey = None if ikeys is None else ikeys[-1]
        z = dense(fuse, torch.cat([h, h0], dim=-1), skey, policy, 0x70,
                  "layers.fuse")
        z2, _, kv = _tx_layer(shared, z, skey, policy, cfg, positions,
                              want_cache, path="shared")
        return (h + z2.to(h.dtype),
                _stack(inner) if want_cache else None, kv)

    msts, kvs = [], []
    for o in range(n_outer):
        h, mst, kv = remat_call(
            remat, block, layer_view(params["layers"], o),
            layer_view(params["fuse"], o), params["shared"], h, h0,
            None if okeys is None else okeys[o])
        msts.append(mst)
        kvs.append(kv)
    if not want_cache:
        return h, 0.0, None
    return h, 0.0, (_stack(msts), _stack(kvs))


def _mask_padded_vocab(logits: torch.Tensor, vocab_size: int):
    """Logits of the padded vocabulary entries set to -1e30 (no gradient
    flows to them)."""
    vp = logits.shape[-1]
    if vp <= vocab_size:
        return logits
    pad = torch.arange(vp, device=logits.device) >= vocab_size
    return logits.masked_fill(pad, -1e30)


def _token_ll(logits: torch.Tensor, labels: torch.Tensor, vocab_size: int):
    """Per-token log-likelihood of ``labels`` under the masked logits, in
    float32."""
    logp = torch.log_softmax(
        _mask_padded_vocab(logits, vocab_size).to(torch.float32), dim=-1)
    return torch.gather(logp, -1, labels[..., None].to(torch.int64))[..., 0]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab_size: int) -> torch.Tensor:
    """Mean next-token CE with padded-vocab masking."""
    return -torch.mean(_token_ll(logits, labels, vocab_size))


def chunked_head_loss(params, h, labels, key, policy, cfg,
                      n_chunks: int) -> torch.Tensor:
    """lm_head projection + CE, over ``n_chunks`` token chunks when they
    divide the tokens (each chunk's head GEMM keyed ``fold_in(key, c)``, so
    its SR draws are independent), else in one piece keyed ``key``.

    In a step's data group the chunks are the global batch's
    (``sharding.data.loss_chunks``): this rank runs its part of each chunk
    its rows meet, under the chunk's index and in the chunk's group.  The
    mean is over this rank's rows (the step weights it by its share)."""
    d = h.shape[-1]
    h2 = h.reshape(-1, d)
    y2 = labels.reshape(-1)
    R = h2.shape[0]
    pieces = data.loss_chunks(R, n_chunks)
    if pieces is None:
        logits = lm_head(params["lm_head"], h, key, policy)
        return cross_entropy(logits, labels, cfg.vocab_size)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c, lo, hi, group in pieces:
        with data.use_data_group(group or data.current()):
            logits = lm_head(params["lm_head"], h2[lo:hi],
                             None if key is None else prng.fold_in(key, c),
                             policy)
        total = total + torch.sum(_token_ll(logits, y2[lo:hi],
                                            cfg.vocab_size))
    return -total / R


def _input_embed(params, batch) -> torch.Tensor:
    """The stack's input: a VLM batch's ``embeds`` (the stub vision
    frontend), else the token embeddings."""
    if "embeds" in batch:
        return batch["embeds"]
    return embed(params["embed"], batch["tokens"])


def _positions(batch, cfg: ArchConfig, B: int, T: int, device):
    """The batch's ``positions``, else ``arange(T)`` per row, (B, T), or
    on each of the three M-RoPE axes, (3, B, T)."""
    if "positions" in batch:
        return torch.as_tensor(batch["positions"], device=device)
    pos = torch.arange(T, device=device).expand(B, T)
    return pos.expand(3, B, T) if cfg.rope == "mrope" else pos


def lm_loss(params, batch, key, policy: QuantPolicy, cfg: ArchConfig,
            remat: bool = False, dtype=None, loss_chunks: int = 1):
    """Full-sequence training loss (teacher forcing).  Returns
    ``(loss, {"ce": loss, "aux": aux})``; a MoE model adds ``0.01 * aux /
    n_layers`` to the loss (``aux`` summed over the layers), the other
    families report ``aux`` 0.0.  ``remat``: recompute each layer in the
    backward (:func:`remat_call`); ``dtype``: the activation stream's."""
    h = _input_embed(params, batch)
    if dtype is not None:
        h = h.to(dtype)
    B, T = h.shape[0], h.shape[1]
    pos = _positions(batch, cfg, B, T, h.device)
    h, aux, _ = _forward_seq(params, h, key, policy, cfg, pos,
                             want_cache=False, remat=remat)
    h = apply_norm(params["final_norm"], h, cfg.norm)
    loss = chunked_head_loss(params, h, batch["labels"], key, policy, cfg,
                             loss_chunks)
    if cfg.moe_experts:
        loss = loss + 0.01 * aux / cfg.n_layers
    return loss, {"ce": loss, "aux": aux}


def init_lm_cache(cfg: ArchConfig, batch: int, max_seq: int,
                  dtype=torch.float32, device=None) -> dict:
    """The decode cache in ``dtype``: the transformer's KV ``(L, B,
    max_seq, flat)``; RWKV6's ``{"state", "index"}`` (states ``(L,
    ...)``); the hybrid's ``{"mamba", "kv", "index"}`` (Mamba2 states
    ``(n_outer, period, ...)``, the shared block's KV ``(n_outer, ...)``).
    The recurrent states' accumulators stay float32, as the reference
    keeps them."""
    check_ported(cfg)
    index = torch.zeros((), dtype=torch.int32, device=device)
    if cfg.family == "hybrid":
        n_outer = _n_outer(cfg)
        return {"mamba": init_mamba2_state(
                    cfg, batch, dtype, lead=(n_outer, cfg.hybrid_period),
                    device=device),
                "kv": init_kv_cache(cfg, batch, max_seq, dtype,
                                    lead=(n_outer,), device=device),
                "index": index}
    if cfg.ssm_kind == "rwkv6":
        return {"state": init_rwkv_state(cfg, batch, dtype,
                                         lead=(cfg.n_layers,),
                                         device=device),
                "index": index}
    return {"kv": init_kv_cache(cfg, batch, max_seq, dtype,
                                lead=(cfg.n_layers,), device=device),
            "index": index}


def cache_dtype(cache: dict) -> torch.dtype:
    """The dtype a decode step runs in: that of the cache's first float
    leaf in the reference's flatten order (dict keys sorted), float32 when
    it has none (``_cache_dtype``).  An RWKV6 cache's first is its
    float32 WKV state."""
    def first(tree):
        for k in sorted(tree):
            v = tree[k]
            dt = (first(v) if isinstance(v, dict) else
                  v.dtype if v.dtype in (torch.bfloat16, torch.float32,
                                         torch.float16) else None)
            if dt is not None:
                return dt
        return None
    return first(cache) or torch.float32


def init_lm_cache_quant(cfg: ArchConfig, batch: int, max_seq: int,
                        device=None) -> dict:
    """int8 KV cache for serving decode; ``index`` is per slot.  The
    recurrent families (RWKV6, hybrid) raise: their state is read and
    written every step and stays full precision."""
    check_ported(cfg)
    _refuse_recurrent(cfg, "quantized KV caches")
    return {"kv": init_kv_cache_quant(cfg, batch, max_seq,
                                      lead=(cfg.n_layers,), device=device),
            "index": torch.zeros((batch,), dtype=torch.int32, device=device)}


def _pad_kv(kv: dict, max_seq: int) -> dict:
    """(..., B, T, flat) K and V zero-padded to ``max_seq`` positions."""
    T = kv["k"].shape[-2]
    if T == max_seq:
        return kv
    return {s: torch.nn.functional.pad(x, (0, 0, 0, max_seq - T))
            for s, x in kv.items()}


def lm_prefill(params, batch, policy: QuantPolicy, cfg: ArchConfig,
               max_seq: Optional[int] = None, dtype=None, last_pos=None):
    """Forward the prompt (``tokens``, or a VLM's ``embeds`` and
    ``positions``); return (last-position logits (B, 1, Vp), cache).

    ``dtype``: the activation stream's, and so the cache's (the
    recurrent states' accumulators stay float32).  ``last_pos``: optional
    ``(B,)`` — take each row's logits there instead of at ``T - 1`` (the
    serving engine right-pads prompts into buckets).
    """
    h = _input_embed(params, batch)
    if dtype is not None:
        h = h.to(dtype)
    B, T = h.shape[0], h.shape[1]
    max_seq = max_seq or T
    pos = _positions(batch, cfg, B, T, h.device)
    h, _, cache = _forward_seq(params, h, None, policy, cfg, pos,
                               want_cache=True)
    h = apply_norm(params["final_norm"], h, cfg.norm)
    if last_pos is None:
        h_last = h[:, -1:]
    else:
        last = torch.as_tensor(last_pos, device=h.device)
        h_last = h[torch.arange(B, device=h.device), last][:, None]
    logits = lm_head(params["lm_head"], h_last, None, policy)
    index = torch.tensor(T, dtype=torch.int32, device=h.device)
    if cfg.family == "hybrid":
        msts, kvs = cache
        return logits, {"mamba": msts, "kv": _pad_kv(kvs, max_seq),
                        "index": index}
    if cfg.ssm_kind == "rwkv6":
        return logits, {"state": cache, "index": index}
    return logits, {"kv": _pad_kv(cache, max_seq), "index": index}


def _copy_state(dst: dict, src: dict) -> None:
    """Write a layer's new recurrent state into its cache views."""
    for k, v in src.items():
        dst[k].copy_(v)


def _decode_tx(lp, h, kvc, index, policy, cfg, path, kv_quant=None):
    """One token through a transformer block with its KV cache (updated in
    place)."""
    x = apply_norm(lp["ln1"], h, cfg.norm)
    att, _ = decode_attention(lp["attn"], x, kvc, index, None, policy, cfg,
                              path=f"{path}.attn", kv_quant=kv_quant)
    h = h + att.to(h.dtype)
    x = apply_norm(lp["ln2"], h, cfg.norm)
    return h + _ffn(lp, x, None, policy, cfg, path)[0].to(h.dtype)


def lm_decode(params, cache, batch, policy: QuantPolicy, cfg: ArchConfig,
              positions=None, kv_quant=None):
    """One-token decode step: ``batch["tokens"]`` (B, 1), or a VLM's
    ``embeds`` (B, 1, d).

    ``positions``: optional ``(B,)`` per-slot positions overriding the
    cache's ``index``.  The step runs in :func:`cache_dtype`.  The cache
    (fp or int8 KV layout, or the recurrent states) is updated in place
    and returned with ``index + 1``.  Returns (logits (B, 1, Vp), cache).
    """
    check_ported(cfg)
    h = _input_embed(params, batch).to(cache_dtype(cache))
    index = cache["index"] if positions is None else positions
    if cfg.family == "hybrid":
        h0 = h
        for o in range(_n_outer(cfg)):
            outer, msts = (layer_view(params["layers"], o),
                           layer_view(cache["mamba"], o))
            for i in range(cfg.hybrid_period):
                st = layer_view(msts, i)
                h, new = mamba2_decode_step(layer_view(outer, i), h, st,
                                            None, policy, cfg,
                                            path="layers.mamba")
                _copy_state(st, new)
            z = dense(layer_view(params["fuse"], o),
                      torch.cat([h, h0], dim=-1), None, policy, 0x70,
                      "layers.fuse")
            h = h + _decode_tx(params["shared"], z,
                               layer_view(cache["kv"], o), index, policy,
                               cfg, "shared")
        new_cache = {"mamba": cache["mamba"], "kv": cache["kv"]}
    elif cfg.ssm_kind == "rwkv6":
        for i in range(cfg.n_layers):
            st = layer_view(cache["state"], i)
            h, new = rwkv_decode_step(layer_view(params["layers"], i), h, st,
                                      None, policy, cfg, path="layers.rwkv")
            _copy_state(st, new)
        new_cache = {"state": cache["state"]}
    else:
        for i in range(cfg.n_layers):
            h = _decode_tx(layer_view(params["layers"], i), h,
                           layer_view(cache["kv"], i), index, policy, cfg,
                           "layers", kv_quant)
        new_cache = {"kv": cache["kv"]}
    h = apply_norm(params["final_norm"], h, cfg.norm)
    logits = lm_head(params["lm_head"], h, None, policy)
    return logits, {**new_cache, "index": index + 1}


def init_lm_paged_pool(cfg: ArchConfig, n_pages: int, page_size: int,
                       device=None) -> dict:
    """Stacked ``(L, n_pages, page_size, ...)`` int8 KV page pool for the
    paged serving engine: page id ``i`` names row ``i`` of every layer's
    pool, so one block table serves all layers."""
    check_ported(cfg)
    _refuse_recurrent(cfg, "paged KV pools")
    return init_paged_kv_pool(cfg, n_pages, page_size, lead=(cfg.n_layers,),
                              device=device)


def lm_paged_decode(params, pool, batch, policy: QuantPolicy,
                    cfg: ArchConfig, table, start, kv_quant=None):
    """Paged multi-token forward, the paged engine's one compute primitive.

    batch: ``tokens (B, C)`` (or a VLM's ``embeds (B, C, d)``); ``table``:
    (B, nb) block tables; ``start``: (B,) position of each row's first
    token.  ``C = 1`` is decode,
    ``C = chunk`` chunked prefill, ``C = k + 1`` the speculative verify
    (:func:`~repro_torch.layers.paged_decode_attention`).  The pool is
    updated in place.  Returns (logits (B, C, Vp), pool).
    """
    check_ported(cfg)
    _refuse_recurrent(cfg, "paged KV pools")
    h = _input_embed(params, batch).to(torch.float32)
    table = torch.as_tensor(table, device=h.device).to(
        torch.int32).contiguous()
    n_pages, P = pool["k"]["codes"].shape[1:3]
    write = paged_write_index(table, start, h.shape[1], n_pages, P)
    for i in range(cfg.n_layers):
        lp = layer_view(params["layers"], i)
        x = apply_norm(lp["ln1"], h, cfg.norm)
        att, _ = paged_decode_attention(lp["attn"], x, layer_view(pool, i),
                                        table, None, None, policy, cfg,
                                        path="layers.attn", kv_quant=kv_quant,
                                        write=write)
        h = h + att.to(h.dtype)
        x = apply_norm(lp["ln2"], h, cfg.norm)
        h = h + _ffn(lp, x, None, policy, cfg)[0].to(h.dtype)
    h = apply_norm(params["final_norm"], h, cfg.norm)
    logits = lm_head(params["lm_head"], h, None, policy)
    return logits, pool
