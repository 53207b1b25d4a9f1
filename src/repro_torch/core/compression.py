"""Beyond-paper: unbiased quantized gradient all-reduce for data parallelism.

Port of ``repro.core.compression`` onto ``torch.distributed``.  The
paper's Theorem 1 only needs ``Q_b`` unbiased and independent across
sources of randomness.  A *communication* quantizer satisfies the same
contract: if every rank quantizes its chunk unbiasedly before the
exchange, the resulting SGD gradient remains an unbiased estimator of the
QAT gradient, and Theorem 2 gains one additive variance term (reported by
:func:`compression_variance_bound`).

Wire protocol (2-phase compressed all-reduce), as the reference's:

  1. range agreement: each rank's per-chunk min/max travel with its codes
     (negligible bytes);
  2. ``all_to_all_single`` of **int8** codes: rank j receives everyone's
     j-th chunk (no in-flight accumulation, so no overflow);
  3. local dequant + sum in fp32; re-quantize the *sum* (again unbiased);
  4. all-gather of the **int8** codes of the reduced chunks.

Both quantize stages are exactly ``quantize_sr_rows`` (the reference's
``_quantize_chunks`` is its arithmetic: ``scale = B / max(hi - lo,
1e-12)``, ``floor(t + bits * 2^-32)``, clip and shift) on the ``(n,
chunk)`` and ``(1, chunk)`` matrices with ``rbits = prng.bits(k,
shape)``: the CUDA kernel on the card, its plain version on the CPU.  The
keys are the reference's: ``k1, k2 = split(fold_in(key, rank))``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .. import prng
from ..kernels.quantize_sr import quantize_sr_rows
from ..optim import tree_leaves, tree_unflatten
from .quantizers import num_bins

__all__ = ["compressed_psum", "compressed_grad_allreduce",
           "compression_variance_bound"]


def _all_gather(out: torch.Tensor, x: torch.Tensor, group) -> None:
    """``all_gather_single`` where torch has it (``all_gather_into_tensor``
    is its deprecated name)."""
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    fn(out, x, group=group)


def _quantize_chunks(x: torch.Tensor, key, bits: int):
    """Per-chunk (per-row) affine stochastic quantize of ``x`` (n_chunks,
    chunk): ``(codes int8, scale (n, 1), lo (n, 1))``."""
    rbits = prng.bits(key, x.shape, x.device)
    return quantize_sr_rows(x, rbits, bits)


def _dequant(codes: torch.Tensor, scale: torch.Tensor, lo: torch.Tensor,
             bits: int) -> torch.Tensor:
    off = 1 << (bits - 1)
    return (codes.to(torch.float32) + off) / scale + lo


def compressed_psum(x: torch.Tensor, key, group=None,
                    bits: int = 8) -> torch.Tensor:
    """Unbiased int8 all-reduce (sum) of ``x`` over the ranks of
    ``group``.  ``x`` is this rank's gradient (the replica view, the same
    shape on every rank); ``key`` this rank's key."""
    n = dist.get_world_size(group)
    rank = dist.get_rank(group)
    size = x.numel()
    flat = torch.nn.functional.pad(x.reshape(-1).to(torch.float32),
                                   (0, (-size) % n))
    chunks = flat.reshape(n, -1).contiguous()          # row j -> rank j

    k1, k2 = prng.split(prng.fold_in(key, rank))
    codes, scale, lo = _quantize_chunks(chunks, k1, bits)

    # phase 2: int8 all-to-all -- rank j collects everyone's chunk j
    codes_t = torch.empty_like(codes)
    dist.all_to_all_single(codes_t, codes, group=group)
    meta = torch.cat([scale, lo], dim=1)                # (n, 2)
    meta_t = torch.empty_like(meta)
    dist.all_to_all_single(meta_t, meta, group=group)

    # phase 3: local dequant-sum, re-quantize the reduced chunk
    deq = _dequant(codes_t, meta_t[:, 0:1], meta_t[:, 1:2], bits)
    red = torch.sum(deq, dim=0, keepdim=True)           # (1, chunk)
    rcodes, rscale, rlo = _quantize_chunks(red, k2, bits)

    # phase 4: int8 all-gather of the reduced chunks + their (scale, lo)
    all_codes = torch.empty_like(codes)
    _all_gather(all_codes, rcodes, group)
    all_meta = torch.empty_like(meta)
    _all_gather(all_meta, torch.cat([rscale, rlo], dim=1), group)
    out = _dequant(all_codes, all_meta[:, 0:1], all_meta[:, 1:2], bits)
    return out.reshape(-1)[:size].reshape(x.shape)


def compressed_grad_allreduce(grads, mesh, axis_name: str, key,
                              bits: int = 8, mean: bool = True):
    """:func:`compressed_psum` of every leaf of a gradient tree (nested
    dicts) over ``axis_name`` of ``mesh``, the replica view: every rank
    of the axis holds the whole leaf.  Leaf ``i`` (in sorted-key order,
    as ``jax.tree.flatten``) takes ``split(key, n_leaves)[i]``, and rank
    ``r`` of the axis ``split(that, n)[r]``, as the reference's
    ``shard_map`` hands them out; ``mean`` divides by the axis size."""
    group = mesh.get_group(axis_name)
    n = dist.get_world_size(group)
    rank = dist.get_rank(group)
    leaves = tree_leaves(grads)
    keys = prng.split(key, len(leaves))
    out = []
    for g, k in zip(leaves, keys):
        r = compressed_psum(g, prng.split(k, n)[rank], group, bits)
        out.append(r / n if mean else r)
    return tree_unflatten(grads, out)


def compression_variance_bound(x: torch.Tensor, bits: int,
                               n_devices: int) -> torch.Tensor:
    """Additive Theorem-2 style variance from the 2-phase compression.

    Each of the two SR stages contributes <= size * R^2 / (4 B^2) per
    chunk; ranges shrink per chunk, so this is loose but cheap.
    ``n_devices`` is the reference's argument, unused there too."""
    del n_devices
    B = num_bins(bits)
    r = torch.max(x) - torch.min(x)
    return 2.0 * x.numel() * (r ** 2) / (4.0 * B * B)
