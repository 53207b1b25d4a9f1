"""Config registry: ``get_config(name)`` / ``--arch <id>`` resolution."""

from .base import SHAPES, ArchConfig, ShapeSpec
from . import (command_r_35b, granite_3_2b, granite_moe_1b, minitron_4b,
               olmoe_1b_7b, qwen15_110b, qwen2_vl_2b, rwkv6_1_6b,
               statquant_tx, whisper_medium, zamba2_2_7b)

_REGISTRY = {
    m.CONFIG.name: m for m in (
        minitron_4b, command_r_35b, qwen15_110b, granite_3_2b, rwkv6_1_6b,
        whisper_medium, granite_moe_1b, olmoe_1b_7b, zamba2_2_7b, qwen2_vl_2b,
        statquant_tx,
    )
}

ARCH_NAMES = [n for n in _REGISTRY if n != "statquant-tx"]
ALL_NAMES = list(_REGISTRY)


def get_config(name: str, smoke: bool = False) -> ArchConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; choose from {ALL_NAMES}")
    mod = _REGISTRY[name]
    return mod.SMOKE if smoke else mod.CONFIG


def shape_grid(cfg: ArchConfig):
    """The assignment's shape cells applicable to this arch.

    long_500k only for sub-quadratic archs (DESIGN.md Sec. 5 skip list).
    """
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.is_subquadratic:
        names.append("long_500k")
    return [SHAPES[n] for n in names]


__all__ = ["ArchConfig", "ShapeSpec", "SHAPES", "get_config", "shape_grid",
           "ARCH_NAMES", "ALL_NAMES"]
