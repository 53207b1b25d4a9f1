"""Token embeddings (padded vocab), standard rotary embeddings,
Qwen2-VL's sectioned multimodal variant (M-RoPE) and Whisper's fixed
sinusoidal encoder positions.

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
           "rope_freqs", "apply_rope", "apply_mrope", "mrope_bounds",
           "sinusoidal_positions"]


def init_embedding(gen: torch.Generator, cfg: ArchConfig) -> dict:
    return {"table": randn(gen, (cfg.padded_vocab, cfg.d_model), 0.02)}


def embed(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.embedding(tokens, p["table"])


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


def mrope_bounds(n: int, sections=(16, 24, 24)) -> list:
    """The first frequency slot of each section after the first, for
    ``n = hd / 2`` slots: the sections scaled to ``n`` with Python's
    ``round`` (half to even, as the reference rounds them)."""
    total, bounds, acc = sum(sections), [], 0
    for s in sections[:-1]:
        acc += round(n * s / total)
        bounds.append(acc)
    return bounds


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections=(16, 24, 24)) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.  x: (B, T, H, hd); positions: (3, B, T)
    for the (t, h, w) axes.  Frequency slot ``j`` of the ``hd / 2`` takes
    its angle from the position of its section's axis."""
    hd = x.shape[-1]
    n = hd // 2
    freqs = rope_freqs(hd, theta, x.device)                      # (hd/2,)
    sec = torch.zeros((n,), dtype=torch.int64, device=x.device)
    slots = torch.arange(n, device=x.device)
    for b in mrope_bounds(n, sections):
        sec = sec + (slots >= b)
    pos = positions.to(x.device)[sec]                            # (n, B, T)
    ang = pos.permute(1, 2, 0).to(torch.float32) * freqs         # (B, T, n)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    return _rotate(x, cos, sin).to(x.dtype)


def sinusoidal_positions(seq: int, d: int, device=None) -> torch.Tensor:
    """Whisper's fixed encoder positions (seq, d): ``sin`` of ``pos /
    10000 ** (2i / d)`` in the even columns, ``cos`` in the odd ones, in
    float32 as the reference computes them.  The power is taken in
    float64 and rounded (XLA's float32 ``pow`` gives the correctly rounded
    value here, ``torch.pow`` in float32 does not at 4 of 512 exponents),
    and the division is a multiply by the float32 reciprocal, as XLA
    rewrites a division by a broadcast row."""
    dim = torch.arange(0, d, 2, dtype=torch.int32, device=device)
    exps = dim.to(torch.float32) / torch.tensor(float(d), device=device)
    denom = torch.pow(torch.tensor(10_000.0, dtype=torch.float64,
                                   device=device),
                      exps.to(torch.float64)).to(torch.float32)
    inv = torch.ones((), device=device) / denom
    pos = torch.arange(seq, dtype=torch.int32, device=device)
    ang = pos[:, None].to(torch.float32) * inv[None, :]
    out = torch.empty((seq, d), dtype=torch.float32, device=device)
    out[:, 0::2] = torch.sin(ang)
    out[:, 1::2] = torch.cos(ang)
    return out
