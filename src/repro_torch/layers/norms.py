"""Normalization layers (full precision: only linear-layer GEMMs are
quantized in the paper's transformer setting)."""

from __future__ import annotations

import torch

__all__ = ["init_norm", "apply_norm", "rmsnorm", "layernorm"]

_EPS = 1e-5


def init_norm(d: int, kind: str = "rmsnorm", lead=(), device=None) -> dict:
    p = {"g": torch.ones((*lead, d), device=device)}
    if kind == "layernorm":
        p["b"] = torch.zeros((*lead, d), device=device)
    return p


def rmsnorm(p: dict, x: torch.Tensor) -> torch.Tensor:
    xf = x.to(torch.float32)                  # f32 stats, stream dtype out
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + _EPS) * p["g"]).to(x.dtype)


def layernorm(p: dict, x: torch.Tensor) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)  # as jnp.var
    out = (xf - mu) * torch.rsqrt(var + _EPS) * p["g"]
    if "b" in p:
        out = out + p["b"]
    return out.to(x.dtype)


def apply_norm(p: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    return layernorm(p, x) if kind == "layernorm" else rmsnorm(p, x)
