"""Interchange with the JAX package: its parameter pytree as numpy arrays
(``jax.tree.map(np.asarray, params)``) becomes the port's parameters.

Both packages keep per-layer parameters stacked ``(L, ...)`` under the same
leaf names, so the conversion is a copy of every leaf onto ``device``; the
same parameters then compute the same function in both.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_jax"]


def params_from_jax(np_tree, device) -> dict:
    """Nested dicts of numpy arrays -> the same tree of tensors on
    ``device`` (float arrays as float32)."""
    if isinstance(np_tree, dict):
        return {k: params_from_jax(v, device) for k, v in np_tree.items()}
    a = np.asarray(np_tree)
    if a.dtype.kind == "f":
        a = a.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)
