"""Whisper-style encoder-decoder (the audio family) [arXiv:2212.04356].

Port of ``repro.models.encdec``.  The conv/audio frontend is a stub, as in
the reference: a batch carries precomputed frame embeddings ``frames``
(B, enc_seq, d).  The bidirectional encoder adds fixed sinusoidal
positions; the decoder (learned positions, ``MAX_DECODER_POS`` of them)
runs causal self-attention, cross-attention over the encoder's output and
the MLP.  Every projection is an FQT GEMM.

Key tree (the reference's): the loss splits ``key`` into ``(ke, kd)``;
encoder layer ``i`` takes ``split(ke, enc_layers)[i]``, decoder layer
``i`` ``lk = split(kd, n_layers)[i]``, of which the self-attention takes
``fold_in(lk, 1)``, the cross-attention ``fold_in(lk, 2)`` (both use
qkey tags 1-4, so one key would alias their SR streams) and the MLP
``lk``; the head loss takes ``kd``.  The cross-attention's K/V are
projected from the encoder's output in every decoder layer, so their
gradient flows into the encoder.  Prefill and decode key everything from
``PRNGKey(0)``, as the reference does.

Caches: the self-attention's K/V ``(L, B, max_seq, flat)``, the
cross-attention's ``(L, B, enc_seq, flat)`` (not padded), in the cache's
dtype (float32 unless asked), and ``index``.
The family has no int8 cache, page pool or paged decode.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import prng
from ..configs.base import ArchConfig
from ..core import QuantPolicy
from ..layers import (apply_norm, attention, cross_attention_kv,
                      decode_attention, embed, init_attention,
                      init_embedding, init_kv_cache, init_lm_head, init_mlp,
                      init_norm, lm_head, mlp, sinusoidal_positions)
from ..layers.common import randn
from .lm import _pad_kv, _stack, chunked_head_loss, layer_view, remat_call

__all__ = ["init_encdec_params", "encdec_loss", "encdec_prefill",
           "encdec_decode", "init_encdec_cache", "MAX_DECODER_POS"]

MAX_DECODER_POS = 32_768


def _enc_layers(gen, cfg: ArchConfig, lead) -> dict:
    dev = gen.device
    return {"ln1": init_norm(cfg.d_model, cfg.norm, lead=lead, device=dev),
            "attn": init_attention(gen, cfg, lead=lead),
            "ln2": init_norm(cfg.d_model, cfg.norm, lead=lead, device=dev),
            "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act, lead=lead)}


def _dec_layers(gen, cfg: ArchConfig, lead) -> dict:
    dev = gen.device
    return {"ln1": init_norm(cfg.d_model, cfg.norm, lead=lead, device=dev),
            "self_attn": init_attention(gen, cfg, lead=lead),
            "ln_x": init_norm(cfg.d_model, cfg.norm, lead=lead, device=dev),
            "cross_attn": init_attention(gen, cfg, lead=lead),
            "ln2": init_norm(cfg.d_model, cfg.norm, lead=lead, device=dev),
            "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act, lead=lead)}


def init_encdec_params(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """Random parameters on the generator's device (the reference's tree
    and distributions, other draws): ``enc_layers`` ``(enc_layers, ...)``
    and ``dec_layers`` ``(n_layers, ...)`` stacks, ``enc_norm``,
    ``embed``, ``pos_embed`` (MAX_DECODER_POS, d) ~ N(0, 0.01^2),
    ``final_norm`` and ``lm_head``."""
    dev = gen.device
    return {
        "enc_layers": _enc_layers(gen, cfg, (cfg.enc_layers,)),
        "enc_norm": init_norm(cfg.d_model, cfg.norm, device=dev),
        "embed": init_embedding(gen, cfg),
        "pos_embed": randn(gen, (MAX_DECODER_POS, cfg.d_model), 0.01),
        "dec_layers": _dec_layers(gen, cfg, (cfg.n_layers,)),
        "final_norm": init_norm(cfg.d_model, cfg.norm, device=dev),
        "lm_head": init_lm_head(gen, cfg),
    }


def _layer_keys(key, n: int) -> list:
    return [None] * n if key is None else list(prng.split(key, n))


def _self_cross_keys(lk):
    """A decoder layer's (self-attention, cross-attention) keys."""
    if lk is None:
        return None, None
    return prng.fold_in(lk, 1), prng.fold_in(lk, 2)


def _encode(params, frames, key, policy, cfg, remat=False):
    """frames (B, S, d): the stub frontend's output -> the encoder's.
    ``remat``: each layer recomputed in the backward."""
    B, S, d = frames.shape
    h = frames + sinusoidal_positions(S, d, frames.device).to(frames.dtype)
    pos = torch.arange(S, device=frames.device).expand(B, S)

    def layer(lp, h, lk):
        x = apply_norm(lp["ln1"], h, cfg.norm)
        h = h + attention(lp["attn"], x, lk, policy, cfg, pos, causal=False,
                          path="encoder.layers.attn").to(h.dtype)
        x = apply_norm(lp["ln2"], h, cfg.norm)
        return h + mlp(lp["mlp"], x, lk, policy, cfg.act,
                       path="encoder.layers.mlp").to(h.dtype)

    for i, lk in enumerate(_layer_keys(key, cfg.enc_layers)):
        h = remat_call(remat, layer, layer_view(params["enc_layers"], i), h,
                       lk)
    return apply_norm(params["enc_norm"], h, cfg.norm)


def _decode_seq(params, tokens, enc_out, key, policy, cfg,
                want_cache=False, remat=False):
    """The decoder over the whole token sequence.  Returns (final-normed
    h, (self K/V, cross K/V) stacked (L, B, ., flat) when ``want_cache``,
    else None).  ``remat``: each layer recomputed in the backward."""
    B, T = tokens.shape
    h = (embed(params["embed"], tokens)
         + params["pos_embed"][:T]).to(enc_out.dtype)
    pos = torch.arange(T, device=h.device).expand(B, T)
    skvs, xkvs = [], []
    for i, lk in enumerate(_layer_keys(key, cfg.n_layers)):
        h, skv, xkv = remat_call(
            remat, _dec_layer, layer_view(params["dec_layers"], i), h,
            enc_out, lk, policy, cfg, pos, want_cache)
        skvs.append(skv)
        xkvs.append(xkv)
    h = apply_norm(params["final_norm"], h, cfg.norm)
    return h, ((_stack(skvs), _stack(xkvs)) if want_cache else None)


def _dec_layer(lp, h, enc_out, lk, policy, cfg, pos, want_cache):
    """One decoder layer: (h, its self K/V, its cross K/V), the K/V
    (B, ., flat) when ``want_cache``, else None."""
    B, T = h.shape[:2]
    Sx = enc_out.shape[1]
    lk_self, lk_cross = _self_cross_keys(lk)
    x = apply_norm(lp["ln1"], h, cfg.norm)
    path = "decoder.layers.self_attn"
    skv = xkv = None
    if want_cache:
        att, (k, v) = attention(lp["self_attn"], x, lk_self, policy, cfg,
                                pos, return_kv=True, path=path)
        skv = {"k": k.reshape(B, T, -1), "v": v.reshape(B, T, -1)}
    else:
        att = attention(lp["self_attn"], x, lk_self, policy, cfg, pos,
                        path=path)
    h = h + att.to(h.dtype)
    x = apply_norm(lp["ln_x"], h, cfg.norm)
    path = "decoder.layers.cross_attn"
    ck, cv = cross_attention_kv(lp["cross_attn"], enc_out, lk_cross, policy,
                                cfg, path=path)
    h = h + attention(lp["cross_attn"], x, lk_cross, policy, cfg, pos,
                      causal=False, kv_override=(ck, cv),
                      path=path).to(h.dtype)
    x = apply_norm(lp["ln2"], h, cfg.norm)
    h = h + mlp(lp["mlp"], x, lk, policy, cfg.act,
                path="decoder.layers.mlp").to(h.dtype)
    if want_cache:
        xkv = {"k": ck.reshape(B, Sx, -1), "v": cv.reshape(B, Sx, -1)}
    return h, skv, xkv


def encdec_loss(params, batch, key, policy: QuantPolicy, cfg: ArchConfig,
                remat: bool = False, dtype=None, loss_chunks: int = 1):
    """Teacher-forced training loss on ``frames``, ``tokens`` and
    ``labels``.  Returns ``(loss, {"ce": loss})``.  ``remat``: each
    encoder and decoder layer recomputed in the backward (the reference
    accepts the flag here and keeps every activation)."""
    ke, kd = (None, None) if key is None else prng.split(key)
    frames = batch["frames"]
    if dtype is not None:
        frames = frames.to(dtype)
    enc = _encode(params, frames, ke, policy, cfg, remat)
    h, _ = _decode_seq(params, batch["tokens"], enc, kd, policy, cfg,
                       remat=remat)
    loss = chunked_head_loss(params, h, batch["labels"], kd, policy, cfg,
                             loss_chunks)
    return loss, {"ce": loss}


def init_encdec_cache(cfg: ArchConfig, batch: int, max_seq: int,
                      dtype=torch.float32, device=None) -> dict:
    """Empty decode cache in ``dtype``: self-attention K/V ``(L, batch,
    max_seq, flat)``, cross-attention K/V ``(L, batch, enc_seq, flat)``
    and ``index`` 0."""
    lead = (cfg.n_layers,)
    return {"self_kv": init_kv_cache(cfg, batch, max_seq, dtype, lead=lead,
                                     device=device),
            "cross_kv": init_kv_cache(cfg, batch, cfg.enc_seq, dtype,
                                      lead=lead, device=device),
            "index": torch.zeros((), dtype=torch.int32, device=device)}


def encdec_prefill(params, batch, policy: QuantPolicy, cfg: ArchConfig,
                   max_seq: Optional[int] = None, dtype=None, last_pos=None):
    """Encode ``frames`` and teacher-force the prompt ``tokens``; return
    (logits (B, 1, Vp) at the last position, or at ``last_pos`` (B,) per
    row, and the cache with the self-attention K/V padded to
    ``max_seq``).  ``dtype``: the activation stream's (the frames are
    cast to it), and so the cache's."""
    key = prng.PRNGKey(0)
    frames = batch["frames"]
    if dtype is not None:
        frames = frames.to(dtype)
    enc = _encode(params, frames, key, policy, cfg)
    tokens = batch["tokens"]
    B, T = tokens.shape
    h, (skv, xkv) = _decode_seq(params, tokens, enc, key, policy, cfg,
                                want_cache=True)
    if last_pos is None:
        h_last = h[:, -1:]
    else:
        last = torch.as_tensor(last_pos, device=h.device)
        h_last = h[torch.arange(B, device=h.device), last][:, None]
    logits = lm_head(params["lm_head"], h_last, key, policy)
    return logits, {"self_kv": _pad_kv(skv, max_seq or T), "cross_kv": xkv,
                    "index": torch.tensor(T, dtype=torch.int32,
                                          device=h.device)}


def encdec_decode(params, cache, batch, policy: QuantPolicy,
                  cfg: ArchConfig, positions=None, kv_quant=None):
    """One-token decoder step on ``batch["tokens"]`` (B, 1).

    ``positions``: optional ``(B,)`` per-slot positions overriding the
    cache's scalar ``index``.  The self-attention K/V are written in place;
    returns (logits (B, 1, Vp), the cache with ``index + 1``)."""
    key = prng.PRNGKey(0)
    tokens = batch["tokens"]
    B = tokens.shape[0]
    index = cache["index"] if positions is None else positions
    index = torch.as_tensor(index, device=tokens.device)
    # a gather, not indexing by a 0-d tensor (that reads its value on the
    # host, which a meta tensor has not): (1, 1, d) or (B, 1, d)
    pe = torch.index_select(params["pos_embed"], 0,
                            index.to(torch.int64).reshape(-1))[:, None]
    h = (embed(params["embed"], tokens) + pe).to(cache["self_kv"]["k"].dtype)
    pos = (torch.zeros((B, 1), dtype=torch.int64, device=h.device)
           + index.to(torch.int64).reshape(-1, 1))
    for i, lk in enumerate(_layer_keys(key, cfg.n_layers)):
        lp = layer_view(params["dec_layers"], i)
        xkv = layer_view(cache["cross_kv"], i)
        lk_self, lk_cross = _self_cross_keys(lk)
        x = apply_norm(lp["ln1"], h, cfg.norm)
        att, _ = decode_attention(lp["self_attn"], x,
                                  layer_view(cache["self_kv"], i), index,
                                  lk_self, policy, cfg,
                                  path="decoder.layers.self_attn",
                                  kv_quant=kv_quant)
        h = h + att.to(h.dtype)
        x = apply_norm(lp["ln_x"], h, cfg.norm)
        Sx = xkv["k"].shape[1]
        ck = xkv["k"].reshape(B, Sx, cfg.n_kv_heads, cfg.hd).to(h.dtype)
        cv = xkv["v"].reshape(B, Sx, cfg.n_kv_heads, cfg.hd).to(h.dtype)
        h = h + attention(lp["cross_attn"], x, lk_cross, policy, cfg, pos,
                          causal=False, kv_override=(ck, cv),
                          path="decoder.layers.cross_attn").to(h.dtype)
        x = apply_norm(lp["ln2"], h, cfg.norm)
        h = h + mlp(lp["mlp"], x, lk, policy, cfg.act,
                    path="decoder.layers.mlp").to(h.dtype)
    h = apply_norm(params["final_norm"], h, cfg.norm)
    logits = lm_head(params["lm_head"], h, key, policy)
    return logits, {"self_kv": cache["self_kv"],
                    "cross_kv": cache["cross_kv"], "index": index + 1}
