"""Feed-forward blocks: SwiGLU / GELU / squared-ReLU, all FQT GEMMs."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core import QuantPolicy
from .common import dense, init_dense

__all__ = ["init_mlp", "mlp"]


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, act: str,
             lead=()) -> dict:
    if act == "swiglu":
        return {"gate": init_dense(gen, d_model, d_ff, lead=lead),
                "up": init_dense(gen, d_model, d_ff, lead=lead),
                "down": init_dense(gen, d_ff, d_model, lead=lead)}
    return {"fc1": init_dense(gen, d_model, d_ff, lead=lead),
            "fc2": init_dense(gen, d_ff, d_model, lead=lead)}


def mlp(p: dict, x: torch.Tensor, key, policy: QuantPolicy, act: str,
        tag_base: int = 0x10, path: str = "mlp") -> torch.Tensor:
    if act == "swiglu":
        g = dense(p["gate"], x, key, policy, tag_base + 1, f"{path}.gate")
        u = dense(p["up"], x, key, policy, tag_base + 2, f"{path}.up")
        h = F.silu(g) * u
        return dense(p["down"], h, key, policy, tag_base + 3, f"{path}.down")
    h = dense(p["fc1"], x, key, policy, tag_base + 1, f"{path}.fc1")
    if act == "gelu":
        h = F.gelu(h, approximate="tanh")       # jax.nn.gelu's default
    elif act == "relu2":
        h = torch.square(F.relu(h))
    else:
        raise ValueError(f"unknown act {act}")
    return dense(p["fc2"], h, key, policy, tag_base + 2, f"{path}.fc2")
