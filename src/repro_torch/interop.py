"""Interchange with the JAX package: its parameter pytree, or a whole
training state, as numpy arrays (``jax.tree.map(np.asarray, tree)``)
becomes the port's.

Both packages keep per-layer parameters stacked ``(L, ...)`` under the same
leaf names, so the conversion is a copy of every leaf onto ``device``; the
same parameters then compute the same function in both, and the same
state takes the same step.  A bit-packed leaf (the reference's
``PackedTensor`` with numpy fields, as ``pack_dense_weights`` makes it)
becomes the port's :class:`~repro_torch.kernels.pack.PackedTensor`.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_jax", "packed_from_jax", "train_state_from_jax"]


def packed_from_jax(pt, device):
    """A reference ``PackedTensor`` given as numpy (``packed``, ``scale``,
    ``zero`` arrays; ``bits``, ``kdim`` ints) -> the port's, on ``device``
    (its ``colsum`` computed from the packed codes)."""
    from .kernels.pack import PackedTensor

    def tensor(a, dtype):
        return torch.from_numpy(np.array(a, dtype)).to(device)
    return PackedTensor(packed=tensor(pt.packed, np.uint8),
                        scale=tensor(pt.scale, np.float32),
                        zero=tensor(pt.zero, np.float32), bits=int(pt.bits),
                        kdim=int(pt.kdim))


def params_from_jax(np_tree, device) -> dict:
    """Nested dicts of numpy arrays (and packed leaves) -> the same tree of
    tensors on ``device`` (float arrays as float32)."""
    if isinstance(np_tree, dict):
        return {k: params_from_jax(v, device) for k, v in np_tree.items()}
    if hasattr(np_tree, "packed") and hasattr(np_tree, "kdim"):
        return packed_from_jax(np_tree, device)
    a = np.asarray(np_tree)
    if a.dtype.kind == "f":
        a = a.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def train_state_from_jax(np_state, device):
    """A reference ``TrainState`` as numpy (``jax.tree.map(np.asarray,
    state)``: params, AdamW ``m``/``v``/``t`` or SGD ``mu``, ``step``,
    ``rng``) -> the port's :class:`~repro_torch.engine.TrainState`: tensors
    on ``device``, ``step`` and ``t`` as host ints, the key on the CPU."""
    from . import prng
    from .engine import TrainState
    opt = {k: (int(np.asarray(v)) if k == "t" else params_from_jax(v, device))
           for k, v in np_state.opt_state.items()}
    hi, lo = (int(w) for w in np.asarray(np_state.rng).astype(np.uint64))
    return TrainState(params=params_from_jax(np_state.params, device),
                      opt_state=opt, step=int(np.asarray(np_state.step)),
                      rng=prng.PRNGKey((hi << 32) | lo))
