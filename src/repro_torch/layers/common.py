"""Shared layer utilities: key derivation, initializers, dense wrapper.

Parameters are plain dicts of tensors with the JAX package's leaf names.
Initializers take a ``lead`` shape prefix so a stack of layers is drawn as
one ``(L, ...)`` tensor, the layout ``repro`` keeps for ``lax.scan``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .. import prng
from ..core import QuantPolicy, fqt_matmul

__all__ = ["qkey", "init_dense", "dense", "randn", "MetaGenerator"]


class MetaGenerator:
    """Stands in for a ``torch.Generator`` on the meta device: the
    initializers then make the parameters' shapes and dtypes, no values
    (the restore target of a checkpoint, ``Model.input_specs``)."""

    device = torch.device("meta")


def qkey(key: Optional[torch.Tensor], tag: int) -> Optional[torch.Tensor]:
    """Stable per-call-site PRNG key for backward-pass quantizers (``None``
    stays ``None``: the forward quantizers draw no randomness)."""
    return None if key is None else prng.fold_in(key, tag)


def randn(gen: torch.Generator, shape, scale: float = 1.0) -> torch.Tensor:
    """Standard normal draw on the generator's device, times ``scale``."""
    if isinstance(gen, MetaGenerator):
        return torch.empty(tuple(shape), device=gen.device)
    return torch.randn(tuple(shape), generator=gen,
                       device=gen.device).mul_(scale)


def init_dense(gen: torch.Generator, d_in: int, d_out: int,
               bias: bool = False, scale: float = 1.0, lead=()) -> dict:
    """LeCun-normal kernel ``(*lead, d_in, d_out)`` (+ zero bias)."""
    p = {"w": randn(gen, (*lead, d_in, d_out), scale / math.sqrt(d_in))}
    if bias:
        p["b"] = torch.zeros((*lead, d_out), device=gen.device)
    return p


def dense(p: dict, x: torch.Tensor, key, policy: QuantPolicy, tag: int = 0,
          path: str = "") -> torch.Tensor:
    """FQT linear layer: the paper's quantized GEMM + fp bias add.

    ``path`` is the layer's logical position (e.g. ``"layers.mlp.up"``)
    that the policy's per-layer overrides resolve against.
    """
    y = fqt_matmul(x, p["w"], qkey(key, tag), policy, path=path)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y
