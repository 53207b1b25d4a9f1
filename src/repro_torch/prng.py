"""Threefry-2x32 key algebra, bit-exact with ``jax.random``.

The JAX package draws every random number it needs (sampling, stochastic
rounding) from ``jax.random`` under ``jax_threefry_partitionable=True``.  For
the port to reproduce those draws bit for bit it carries its own copy of
the counter-based generator: a key is an int64 tensor of shape ``(..., 2)``
holding two uint32 words, and every operation here is plain integer
arithmetic on tensors, so it runs on the CPU or the card alike.  Leading
key dimensions batch (the counterpart of ``jax.vmap`` over keys).

Partitionable mode, which this module implements:

  * ``split(key, n)[i]``  = threefry(key, (0, i))
  * ``fold_in(key, d)``   = threefry(key, (0, d mod 2^32))
  * ``bits(key, shape)``  = ``b1 ^ b2`` of threefry(key, (hi, lo)) over the
    row-major flat index split into its high and low 32-bit words; with
    ``offset`` the indices start there, so a shard's bits are its slice
    of the whole tensor's draw (what a data-parallel rank draws).

uint32 words are held in int64 so that sums and shifts never leave the
supported integer types; every step masks back to 32 bits.

Keys are tiny; the training step keeps them on the CPU and draws bits
straight onto the card (``bits(key, shape, device=...)``): a single key's
two words then enter the hash as Python integers, so no key ever has to be
copied to the card and nothing waits on it.
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import torch

__all__ = ["PRNGKey", "threefry2x32", "fold_in", "split", "bits", "uniform",
           "normal", "randint", "gumbel", "categorical"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = torch.finfo(torch.float32).tiny
# the largest float32 below -1's neighbour towards 0: jax.random.normal
# draws its uniforms on [nextafter(-1, 0), 1)
_NORMAL_LO = -1.0 + 2.0 ** -24
# XLA's single-precision erf_inv (Giles, "Approximating the erfinv
# function"): a degree-8 polynomial in w - 2.5 for w = -log1p(-x^2) < 5,
# else in sqrt(w) - 3, highest power first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the seed's high and low 32-bit words."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 64:
        raise ValueError(f"seed {seed} must lie in [0, 2^64)")
    return torch.tensor([(seed >> 32) & _MASK, seed & _MASK],
                        dtype=torch.int64, device=device)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of counts ``(x1, x2)`` under key
    ``(k1, k2)``; all operands broadcast and hold uint32 values in int64."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def _host_words(key: torch.Tensor):
    """A single key on the CPU as its two words (Python ints), else None:
    the key algebra then runs on Python integers, a few microseconds a
    call instead of a hundred tensor operations."""
    if key.device.type == "cpu" and key.dim() == 1:
        k1, k2 = key.tolist()
        return k1, k2
    return None


def fold_in(key: torch.Tensor, data: Union[int, torch.Tensor]) -> torch.Tensor:
    """``jax.random.fold_in``: ``data`` is taken modulo 2^32 (so -1 folds
    in as 0xFFFFFFFF, as JAX's uint32 conversion does).  ``data`` may be a
    tensor broadcasting against the key's batch dimensions."""
    words = _host_words(key)
    if words is not None and not isinstance(data, torch.Tensor):
        return torch.tensor(threefry2x32(*words, 0, int(data) & _MASK),
                            dtype=torch.int64)
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _MASK
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(y1, y2), dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` of one key into ``num`` keys, shape (num, 2)."""
    words = _host_words(key)
    if words is not None:
        return torch.tensor([threefry2x32(*words, 0, i) for i in range(num)],
                            dtype=torch.int64).reshape(num, 2)
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    y1, y2 = threefry2x32(key[0], key[1], torch.zeros_like(i), i)
    return torch.stack([y1, y2], dim=-1)


def bits(key: torch.Tensor, shape: Sequence[int], device=None,
         offset: int = 0) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int64 values in
    [0, 2^32).  A key of shape (..., 2) gives (..., *shape).  ``device``
    (default: the key's) is where the bits are drawn; a single key on
    another device enters as two Python integers.  ``offset`` draws the
    flat indices ``offset + arange(prod(shape))``: bit-identical to the
    slice ``[offset, offset + n)`` of a larger draw under the same key.
    On the meta device: an empty tensor of the draw's shape."""
    shape = tuple(int(s) for s in shape)
    device = key.device if device is None else torch.device(device)
    if device.type == "meta":
        # no values to draw: the dry run needs the draw's shape only
        return torch.empty((*key.shape[:-1], *shape), dtype=torch.int64,
                           device=device)
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    if offset:
        idx = idx + int(offset)
    lead = key.shape[:-1]
    if key.device != device and not lead:
        k1, k2 = (int(v) for v in key.tolist())
    else:
        key = key.to(device)
        k1 = key[..., 0].reshape(*lead, 1)
        k2 = key[..., 1].reshape(*lead, 1)
    b1, b2 = threefry2x32(k1, k2, idx >> 32, idx & _MASK)
    return (b1 ^ b2).reshape(*lead, *shape)


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: the top 23 bits fill the mantissa
    of a float in [1, 2), shifted to [0, 1) and scaled to the range."""
    b = bits(key, shape)
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, f * (hi - lo) + lo)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` (not ``torch.erfinv``, which rounds
    differently for most inputs): Giles' polynomial, +-inf at +-1."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    coef = [torch.where(lt, torch.tensor(a, dtype=x.dtype, device=x.device),
                        torch.tensor(b, dtype=x.dtype, device=x.device))
            for a, b in zip(_ERFINV_LT5, _ERFINV_GE5)]
    p = coef[0]
    for c in coef[1:]:
        p = c + p * w
    return torch.where(x.abs() == 1.0, x * torch.finfo(x.dtype).max, p * x)


def normal(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.normal`` in float32: ``sqrt(2) * erf_inv(u)`` for ``u``
    uniform on ``[nextafter(-1, 0), 1)``."""
    u = uniform(key, shape, _NORMAL_LO, 1.0)
    return torch.tensor(math.sqrt(2.0), dtype=torch.float32,
                        device=u.device) * erf_inv(u)


def randint(key: torch.Tensor, shape: Sequence[int], minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint`` into int32, for ranges inside int32: two
    draws of 32 bits from ``split(key)`` combine, modulo the span, through
    the multiplier ``(2^32 mod span)^2 mod span``, in uint32 arithmetic
    (held in int64 and masked, as every word here)."""
    lo, hi = int(minval), int(maxval)
    if not -2 ** 31 <= lo <= 2 ** 31 - 1 or not -2 ** 31 <= hi <= 2 ** 31:
        raise ValueError(f"randint range [{lo}, {hi}) must lie in int32")
    k1, k2 = split(key)
    higher, lower = bits(k1, shape), bits(k2, shape)
    span = max(hi - lo, 1) if hi <= 2 ** 31 - 1 else hi - lo
    span &= _MASK
    mult = ((2 ** 16 % span) ** 2 & _MASK) % span
    off = (((higher % span) * mult) & _MASK) + (lower % span)
    off = (off & _MASK) % span
    return (lo + off).to(torch.int32)


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel`` (mode "low") in float32."""
    return -torch.log(-torch.log(uniform(key, shape, _F32_TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis (Gumbel-max).  A key of
    shape (..., 2) draws one sample per row of ``logits`` (..., V), as
    ``jax.vmap(jax.random.categorical)`` does."""
    g = gumbel(key, logits.shape[-1:])
    return torch.argmax(g + logits, dim=-1)
