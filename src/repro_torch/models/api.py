"""Unified model API: ``build_model(cfg)`` -> :class:`Model`.

Port of ``repro.models.api`` for the dense and MoE families: init / loss /
prefill / decode / paged decode plus the cache and page-pool constructors,
``quant_paths`` and ``input_specs`` (meta-device tensors in place of the
reference's ``ShapeDtypeStruct``).  Other families raise until their
slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from ..configs.base import ArchConfig, ShapeSpec
from ..device import resolve_device
from ..layers.common import MetaGenerator
from . import lm

__all__ = ["Model", "build_model", "model_quant_paths"]

_ATTN = ("wq", "wk", "wv", "wo")


def model_quant_paths(cfg: ArchConfig) -> tuple:
    """The logical paths of every quantized GEMM of a dense or MoE model,
    the strings ``QuantPolicy.resolve`` and its overrides match against."""
    mlp_names = (("gate", "up", "down") if cfg.act == "swiglu"
                 else ("fc1", "fc2"))
    ffn = (["layers.moe.router"]
           + [f"layers.moe.expert.{n}" for n in mlp_names]
           if cfg.moe_experts else [f"layers.mlp.{n}" for n in mlp_names])
    return tuple([f"layers.attn.{w}" for w in _ATTN] + ffn + ["lm_head"])


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    loss: Callable             # (params, batch, key, policy) -> (loss, metrics)
    prefill: Callable          # (params, batch, policy, max_seq) -> (logits, cache)
    decode: Callable           # (params, cache, batch, policy, [positions]) -> (logits, cache)
    init_cache: Callable       # (cfg, batch, max_seq, device) -> cache
    init_cache_quant: Callable  # (cfg, batch, max_seq, device) -> int8 cache
    # paged serving (serve/paged.py)
    paged_decode: Callable      # (params, pool, batch, policy, table, start) -> (logits, pool)
    init_paged_pool: Callable   # (cfg, n_pages, page_size, device) -> pool

    def init(self, seed: int, device=None) -> dict:
        """Random parameters from ``seed`` on ``device`` (CUDA unless the
        caller asks otherwise; raises when CUDA is asked for and absent).
        On the meta device: their shapes and dtypes only."""
        dev = resolve_device(device)
        if dev.type == "meta":
            return lm.init_lm_params(MetaGenerator(), self.cfg)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        return lm.init_lm_params(gen, self.cfg)

    def quant_paths(self) -> tuple:
        """Logical paths of this model's quantized GEMMs (policy overrides
        resolve against these — see :func:`model_quant_paths`)."""
        return model_quant_paths(self.cfg)

    def input_specs(self, shape: ShapeSpec,
                    dtype=torch.float32) -> Dict[str, Any]:
        """Abstract inputs for one (arch x shape) cell, as meta-device
        tensors of the reference's shapes and dtypes: train -> kwargs for
        ``loss``; prefill -> kwargs for ``prefill``; decode -> kwargs for
        ``decode`` (cache included; the port's caches are float32)."""
        B, T = shape.global_batch, shape.seq_len

        def tok(b, t):
            return torch.empty((b, t), dtype=torch.int32, device="meta")

        if shape.kind == "train":
            return {"batch": {"labels": tok(B, T), "tokens": tok(B, T)}}
        if shape.kind == "prefill":
            return {"batch": {"tokens": tok(B, T)}}
        if dtype != torch.float32:
            raise ValueError(f"the port's caches are float32, not {dtype}")
        cache = self.init_cache(self.cfg, B, T, device="meta")
        return {"cache": cache, "batch": {"tokens": tok(B, 1)}}


def build_model(cfg: ArchConfig) -> Model:
    lm.check_ported(cfg)
    return Model(
        cfg=cfg,
        loss=lambda params, batch, key, policy, **kw:
            lm.lm_loss(params, batch, key, policy, cfg, **kw),
        prefill=lambda params, batch, policy, max_seq=None, **kw:
            lm.lm_prefill(params, batch, policy, cfg, max_seq, **kw),
        decode=lambda params, cache, batch, policy, **kw:
            lm.lm_decode(params, cache, batch, policy, cfg, **kw),
        init_cache=lm.init_lm_cache,
        init_cache_quant=lm.init_lm_cache_quant,
        paged_decode=lambda params, pool, batch, policy, table, start, **kw:
            lm.lm_paged_decode(params, pool, batch, policy, cfg, table,
                               start, **kw),
        init_paged_pool=lm.init_lm_paged_pool,
    )
