"""Token embeddings (padded vocab) and standard rotary embeddings.

The embedding gather and the rotary math stay full precision; the LM head
is a linear layer and therefore FQT-quantized.
"""

from __future__ import annotations

import math

import torch

from ..configs.base import ArchConfig
from ..core import QuantPolicy, fqt_matmul
from .common import qkey, randn

__all__ = ["init_embedding", "embed", "init_lm_head", "lm_head",
           "rope_freqs", "apply_rope"]


def init_embedding(gen: torch.Generator, cfg: ArchConfig) -> dict:
    return {"table": randn(gen, (cfg.padded_vocab, cfg.d_model), 0.02)}


def embed(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens]


def init_lm_head(gen: torch.Generator, cfg: ArchConfig) -> dict:
    return {"w": randn(gen, (cfg.d_model, cfg.padded_vocab),
                       1.0 / math.sqrt(cfg.d_model))}


def lm_head(p: dict, x: torch.Tensor, key, policy: QuantPolicy,
            path: str = "lm_head") -> torch.Tensor:
    """Final projection — a linear layer, quantized like every other."""
    return fqt_matmul(x, p["w"], qkey(key, 0x1ead), policy, path=path)


def rope_freqs(head_dim: int, theta: float = 10_000.0,
               device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def _rotate(x, cos, sin):
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, T, H, hd); positions: (B, T) int."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)            # (hd/2,)
    ang = positions[..., None].to(torch.float32) * freqs        # (B, T, hd/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    return _rotate(x, cos, sin).to(x.dtype)
