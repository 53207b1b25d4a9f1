"""Decoder-only LM, dense family: init, training loss, prefill and
one-token decode.

Port of the dense branch of ``repro.models.lm``.  Per-layer parameters stay
stacked ``(L, ...)`` with the JAX package's leaf names, and the stack runs
as a Python loop over layer views (the counterpart of ``lax.scan``).  The
training loss threads a PRNG key through the stack as the reference does
(layer ``i`` takes ``split(key, n_layers)[i]``; the head takes ``key``, or
``fold_in(key, chunk)`` per loss chunk): the backward's stochastic
quantizers draw from it.  The forward quantizers are deterministic, so
prefill and decode draw no randomness: their key is ``None``.  MoE, RWKV6,
hybrid and VLM families come in later slices and raise here.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import prng
from ..configs.base import ArchConfig
from ..core import QuantPolicy
from ..layers import (apply_norm, attention, decode_attention, embed,
                      init_attention, init_embedding, init_kv_cache,
                      init_kv_cache_quant, init_lm_head, init_mlp, init_norm,
                      lm_head, mlp)

__all__ = ["init_lm_params", "lm_loss", "lm_prefill", "lm_decode",
           "init_lm_cache", "init_lm_cache_quant", "cross_entropy",
           "chunked_head_loss", "layer_view", "check_dense"]


def check_dense(cfg: ArchConfig) -> None:
    """Raise unless ``cfg`` is a dense-family token LM this slice serves."""
    if cfg.family != "dense" or cfg.moe_experts or cfg.ssm_kind:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet; this "
            f"slice of the port covers the dense transformer family")


def layer_view(tree, i: int):
    """Layer ``i`` of a stacked ``(L, ...)`` tree, as views."""
    if isinstance(tree, dict):
        return {k: layer_view(v, i) for k, v in tree.items()}
    return tree[i]


def init_lm_params(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """Random parameters on the generator's device (same distributions as
    ``repro.models.lm.init_lm_params``, other draws)."""
    check_dense(cfg)
    L, dev = (cfg.n_layers,), gen.device
    return {
        "embed": init_embedding(gen, cfg),
        "final_norm": init_norm(cfg.d_model, cfg.norm, device=dev),
        "lm_head": init_lm_head(gen, cfg),
        "layers": {
            "ln1": init_norm(cfg.d_model, cfg.norm, lead=L, device=dev),
            "attn": init_attention(gen, cfg, lead=L),
            "ln2": init_norm(cfg.d_model, cfg.norm, lead=L, device=dev),
            "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act, lead=L),
        },
    }


def _tx_layer(p, h, key, policy, cfg, positions, want_kv: bool,
              path="layers"):
    """Pre-norm attention + MLP.  Returns (h, kv or None)."""
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
    y = mlp(p["mlp"], x, key, policy, cfg.act, path=f"{path}.mlp")
    return h + y.to(h.dtype), kv


def _forward_seq(params, h, key, policy: QuantPolicy, cfg: ArchConfig,
                 positions, want_cache: bool):
    """Run the layer stack over a full sequence.  Returns (h, cache) with
    cache ``{"k", "v"}`` stacked (L, B, T, flat) or ``None``.  ``key``:
    ``None`` (forward only) or the key layer ``i`` splits off as
    ``split(key, n_layers)[i]``."""
    check_dense(cfg)
    keys = (None if key is None else prng.split(key, cfg.n_layers))
    kvs = []
    for i in range(cfg.n_layers):
        h, kv = _tx_layer(layer_view(params["layers"], i), h,
                          None if keys is None else keys[i], policy, cfg,
                          positions, want_cache)
        kvs.append(kv)
    if not want_cache:
        return h, None
    return h, {s: torch.stack([kv[s] for kv in kvs]) for s in ("k", "v")}


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
    its SR draws are independent), else in one piece keyed ``key``."""
    d = h.shape[-1]
    h2 = h.reshape(-1, d)
    y2 = labels.reshape(-1)
    R = h2.shape[0]
    if n_chunks <= 1 or R % n_chunks != 0:
        logits = lm_head(params["lm_head"], h, key, policy)
        return cross_entropy(logits, labels, cfg.vocab_size)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c, (h_c, y_c) in enumerate(zip(h2.chunk(n_chunks), y2.chunk(n_chunks))):
        logits = lm_head(params["lm_head"], h_c,
                         None if key is None else prng.fold_in(key, c),
                         policy)
        total = total + torch.sum(_token_ll(logits, y_c, cfg.vocab_size))
    return -total / R


def lm_loss(params, batch, key, policy: QuantPolicy, cfg: ArchConfig,
            remat: bool = False, dtype=None, loss_chunks: int = 1):
    """Full-sequence training loss (teacher forcing).  Returns
    ``(loss, {"ce": loss, "aux": 0.0})``.  ``remat`` is accepted and
    ignored: the port keeps every activation the backward needs."""
    del remat
    h = embed(params["embed"], batch["tokens"])
    if dtype is not None:
        h = h.to(dtype)
    B, T = h.shape[0], h.shape[1]
    pos = torch.arange(T, device=h.device).expand(B, T)
    h, _ = _forward_seq(params, h, key, policy, cfg, pos, want_cache=False)
    h = apply_norm(params["final_norm"], h, cfg.norm)
    loss = chunked_head_loss(params, h, batch["labels"], key, policy, cfg,
                             loss_chunks)
    return loss, {"ce": loss, "aux": 0.0}


def init_lm_cache(cfg: ArchConfig, batch: int, max_seq: int,
                  device=None) -> dict:
    check_dense(cfg)
    return {"kv": init_kv_cache(cfg, batch, max_seq, lead=(cfg.n_layers,),
                                device=device),
            "index": torch.zeros((), dtype=torch.int32, device=device)}


def init_lm_cache_quant(cfg: ArchConfig, batch: int, max_seq: int,
                        device=None) -> dict:
    """int8 KV cache for serving decode; ``index`` is per slot."""
    check_dense(cfg)
    return {"kv": init_kv_cache_quant(cfg, batch, max_seq,
                                      lead=(cfg.n_layers,), device=device),
            "index": torch.zeros((batch,), dtype=torch.int32, device=device)}


def lm_prefill(params, batch, policy: QuantPolicy, cfg: ArchConfig,
               max_seq: Optional[int] = None, last_pos=None):
    """Forward the prompt; return (last-position logits (B, 1, Vp), cache).

    ``last_pos``: optional ``(B,)`` — take each row's logits there instead
    of at ``T - 1`` (the serving engine right-pads prompts into buckets).
    """
    tokens = batch["tokens"]
    h = embed(params["embed"], tokens)
    B, T = h.shape[0], h.shape[1]
    max_seq = max_seq or T
    pos = torch.arange(T, device=h.device).expand(B, T)
    h, cache = _forward_seq(params, h, None, policy, cfg, pos,
                            want_cache=True)
    h = apply_norm(params["final_norm"], h, cfg.norm)
    if last_pos is None:
        h_last = h[:, -1:]
    else:
        last = torch.as_tensor(last_pos, device=h.device)
        h_last = h[torch.arange(B, device=h.device), last][:, None]
    logits = lm_head(params["lm_head"], h_last, None, policy)
    if T < max_seq:
        cache = {s: torch.nn.functional.pad(x, (0, 0, 0, max_seq - T))
                 for s, x in cache.items()}
    index = torch.tensor(T, dtype=torch.int32, device=h.device)
    return logits, {"kv": cache, "index": index}


def lm_decode(params, cache, batch, policy: QuantPolicy, cfg: ArchConfig,
              positions=None, kv_quant=None):
    """One-token decode step: ``batch["tokens"]`` (B, 1).

    ``positions``: optional ``(B,)`` per-slot positions overriding the
    cache's ``index``.  The cache (fp or int8 layout) is updated in place
    and returned with ``index + 1``.  Returns (logits (B, 1, Vp), cache).
    """
    check_dense(cfg)
    h = embed(params["embed"], batch["tokens"]).to(torch.float32)
    index = cache["index"] if positions is None else positions
    for i in range(cfg.n_layers):
        lp = layer_view(params["layers"], i)
        x = apply_norm(lp["ln1"], h, cfg.norm)
        att, _ = decode_attention(lp["attn"], x, layer_view(cache["kv"], i),
                                  index, None, policy, cfg,
                                  path="layers.attn", kv_quant=kv_quant)
        h = h + att.to(h.dtype)
        x = apply_norm(lp["ln2"], h, cfg.norm)
        h = h + mlp(lp["mlp"], x, None, policy, cfg.act,
                    path="layers.mlp").to(h.dtype)
    h = apply_norm(params["final_norm"], h, cfg.norm)
    logits = lm_head(params["lm_head"], h, None, policy)
    return logits, {"kv": cache["kv"], "index": index + 1}
