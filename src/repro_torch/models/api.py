"""Unified model API: ``build_model(cfg)`` -> :class:`Model`.

Port of ``repro.models.api`` for the dense family: init / loss / prefill /
decode plus the cache constructors.  Other families raise until their
slice.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from . import lm

__all__ = ["Model", "build_model", "model_quant_paths"]

_ATTN = ("wq", "wk", "wv", "wo")


def model_quant_paths(cfg: ArchConfig) -> tuple:
    """The logical paths of every quantized GEMM of a dense model, the
    strings ``QuantPolicy.resolve`` and its overrides match against."""
    mlp_names = (("gate", "up", "down") if cfg.act == "swiglu"
                 else ("fc1", "fc2"))
    return tuple([f"layers.attn.{w}" for w in _ATTN]
                 + [f"layers.mlp.{n}" for n in mlp_names] + ["lm_head"])


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    loss: Callable             # (params, batch, key, policy) -> (loss, metrics)
    prefill: Callable          # (params, batch, policy, max_seq) -> (logits, cache)
    decode: Callable           # (params, cache, batch, policy, [positions]) -> (logits, cache)
    init_cache: Callable       # (cfg, batch, max_seq, device) -> cache
    init_cache_quant: Callable  # (cfg, batch, max_seq, device) -> int8 cache

    def init(self, seed: int, device=None) -> dict:
        """Random parameters from ``seed`` on ``device`` (CUDA unless the
        caller asks otherwise; raises when CUDA is asked for and absent)."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        return lm.init_lm_params(gen, self.cfg)


def build_model(cfg: ArchConfig) -> Model:
    lm.check_dense(cfg)
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
    )
