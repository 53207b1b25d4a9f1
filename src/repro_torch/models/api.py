"""Unified model API: ``build_model(cfg)`` -> :class:`Model`.

Port of ``repro.models.api``: the decoder families (dense, MoE, VLM, the
Mamba2 hybrid, RWKV6; ``models/lm.py``) and the audio family's
encoder-decoder (``models/encdec.py``).  init / loss / prefill / decode /
paged decode plus the cache and page-pool constructors, ``quant_paths``
and ``input_specs`` (meta-device tensors in place of the reference's
``ShapeDtypeStruct``).  As in the reference, the recurrent families and
the encoder-decoder have no int8 cache, paged decode or page pool
(``None``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from ..configs.base import ArchConfig, ShapeSpec
from ..device import resolve_device
from ..layers.common import MetaGenerator
from . import encdec, lm

__all__ = ["Model", "build_model", "model_quant_paths"]

_ATTN = ("wq", "wk", "wv", "wo")


def model_quant_paths(cfg: ArchConfig) -> tuple:
    """The logical paths of every quantized GEMM of the model, the strings
    ``QuantPolicy.resolve`` and its overrides match against."""
    mlp_names = (("gate", "up", "down") if cfg.act == "swiglu"
                 else ("fc1", "fc2"))

    def block(prefix):
        return ([f"{prefix}.attn.{w}" for w in _ATTN]
                + ([f"{prefix}.moe.router"]
                   + [f"{prefix}.moe.expert.{n}" for n in mlp_names]
                   if cfg.moe_experts
                   else [f"{prefix}.mlp.{n}" for n in mlp_names]))

    if cfg.family == "audio":
        paths = ([f"encoder.layers.attn.{w}" for w in _ATTN]
                 + [f"encoder.layers.mlp.{n}" for n in mlp_names]
                 + [f"decoder.layers.self_attn.{w}" for w in _ATTN]
                 + [f"decoder.layers.cross_attn.{w}" for w in _ATTN]
                 + [f"decoder.layers.mlp.{n}" for n in mlp_names])
    elif cfg.family == "hybrid":
        paths = ([f"layers.mamba.{n}" for n in
                  ("z_proj", "x_proj", "bc_proj", "dt_proj", "out_proj")]
                 + ["layers.fuse"] + block("shared"))
    elif cfg.ssm_kind == "rwkv6":
        paths = [f"layers.rwkv.{n}" for n in
                 ("wr", "wk", "wv", "wg", "wo", "cm_wk", "cm_wv", "cm_wr")]
    else:
        paths = block("layers")
    return tuple(paths + ["lm_head"])


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    init_params: Callable      # (generator, cfg) -> params
    loss: Callable             # (params, batch, key, policy) -> (loss, metrics)
    prefill: Callable          # (params, batch, policy, max_seq) -> (logits, cache)
    decode: Callable           # (params, cache, batch, policy, [positions]) -> (logits, cache)
    init_cache: Callable       # (cfg, batch, max_seq, dtype, device) -> cache
    # the int8 cache and paged serving (serve/paged.py), None for the
    # recurrent families, which keep no transformer KV cache in every layer:
    # (cfg, batch, max_seq, device) -> int8 cache
    init_cache_quant: Optional[Callable]
    # (params, pool, batch, policy, table, start) -> (logits, pool)
    paged_decode: Optional[Callable]
    # (cfg, n_pages, page_size, device) -> pool
    init_paged_pool: Optional[Callable]

    def init(self, seed: int, device=None) -> dict:
        """Random parameters from ``seed`` on ``device`` (CUDA unless the
        caller asks otherwise; raises when CUDA is asked for and absent).
        On the meta device: their shapes and dtypes only."""
        dev = resolve_device(device)
        if dev.type == "meta":
            return self.init_params(MetaGenerator(), self.cfg)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        return self.init_params(gen, self.cfg)

    def quant_paths(self) -> tuple:
        """Logical paths of this model's quantized GEMMs (policy overrides
        resolve against these — see :func:`model_quant_paths`)."""
        return model_quant_paths(self.cfg)

    def input_specs(self, shape: ShapeSpec,
                    dtype=torch.float32) -> Dict[str, Any]:
        """Abstract inputs for one (arch x shape) cell, as meta-device
        tensors of the reference's shapes and dtypes: train -> kwargs for
        ``loss``; prefill -> kwargs for ``prefill``; decode -> kwargs for
        ``decode`` (the cache included, in ``dtype``)."""
        cfg = self.cfg
        B, T = shape.global_batch, shape.seq_len

        def tok(b, t):
            return torch.empty((b, t), dtype=torch.int32, device="meta")

        def inputs(b, t):
            if cfg.family == "audio":
                return {"frames": torch.empty((b, cfg.enc_seq, cfg.d_model),
                                              dtype=dtype, device="meta"),
                        "tokens": tok(b, t)}
            if cfg.family != "vlm":
                return {"tokens": tok(b, t)}
            return {"embeds": torch.empty((b, t, cfg.d_model), dtype=dtype,
                                          device="meta"),
                    "positions": torch.empty((3, b, t), dtype=torch.int32,
                                             device="meta")}

        if shape.kind == "train":
            return {"batch": {"labels": tok(B, T), **inputs(B, T)}}
        if shape.kind == "prefill":
            return {"batch": inputs(B, T)}
        cache = self.init_cache(cfg, B, T, dtype, device="meta")
        batch = inputs(B, 1)
        # decode steps rotate by index; the encoder ran at prefill
        batch.pop("positions", None)
        batch.pop("frames", None)
        return {"cache": cache, "batch": batch}


def build_model(cfg: ArchConfig) -> Model:
    if cfg.family == "audio":
        return Model(
            cfg=cfg,
            init_params=encdec.init_encdec_params,
            loss=lambda params, batch, key, policy, **kw:
                encdec.encdec_loss(params, batch, key, policy, cfg, **kw),
            prefill=lambda params, batch, policy, max_seq=None, **kw:
                encdec.encdec_prefill(params, batch, policy, cfg, max_seq,
                                      **kw),
            decode=lambda params, cache, batch, policy, **kw:
                encdec.encdec_decode(params, cache, batch, policy, cfg,
                                     **kw),
            init_cache=encdec.init_encdec_cache,
            init_cache_quant=None, paged_decode=None, init_paged_pool=None)
    lm.check_ported(cfg)
    kv = lm.has_kv_cache(cfg)
    return Model(
        cfg=cfg,
        init_params=lm.init_lm_params,
        loss=lambda params, batch, key, policy, **kw:
            lm.lm_loss(params, batch, key, policy, cfg, **kw),
        prefill=lambda params, batch, policy, max_seq=None, **kw:
            lm.lm_prefill(params, batch, policy, cfg, max_seq, **kw),
        decode=lambda params, cache, batch, policy, **kw:
            lm.lm_decode(params, cache, batch, policy, cfg, **kw),
        init_cache=lm.init_lm_cache,
        init_cache_quant=lm.init_lm_cache_quant if kv else None,
        paged_decode=(
            (lambda params, pool, batch, policy, table, start, **kw:
             lm.lm_paged_decode(params, pool, batch, policy, cfg, table,
                                start, **kw)) if kv else None),
        init_paged_pool=lm.init_lm_paged_pool if kv else None,
    )
