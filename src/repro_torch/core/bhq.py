"""Block Householder Quantizer (BHQ) — StatQuant Sec. 4.2 / Appendix D.4-D.5.

Port of ``repro.core.bhq`` in plain PyTorch (the JAX package runs it in
XLA on every backend, with no Pallas kernel):

  1. sort rows by magnitude ``M_i = ||g_i||_inf`` (descending, stable);
  2. pick the number of groups ``G`` by the refined Appendix-D.4 bound (or
     the paper's D.5 proxy), scored over the candidate G's at once;
  3. group ``i`` = the i-th largest row + ``~(N-G) * M_i / sum M`` small rows
     (largest-remainder integerization so sizes sum to N);
  4. scale rows by the Lagrangian-optimal ``s1``/``s2`` and apply the group
     Householder ``Q = I - 2 n n^T / ||n||^2``, ``n = 1/sqrt(m) - e1``, as
     segment sums, never as a matrix;
  5. stochastically round with a per-group zero point.

Row blocks of ``block_rows`` run as one batch dimension (the reference's
``vmap``); ragged row counts pad with zero rows that sort last and sit in
singleton groups.  ``segment_sum``/``segment_max``/``segment_min`` become
``torch.segment_reduce`` over the rows sorted by group: each group sums
its members in row order from zero, as the reference's scatter-add does,
and the order is the same on the CPU and the card (no atomics), so the
transform is deterministic.  Powers are taken in float64 and rounded to
float32, the closest match to XLA's float32 ``pow`` (it is not correctly
rounded, and the two may still differ in the last bit of a scale).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .. import meta, prng
from ..sharding import data
from .quantizers import num_bins, row_dynamic_range, sr_uniform

__all__ = ["BHQTensor", "quantize_bhq_stoch", "bhq_variance_bound",
           "bhq_exact_variance"]

_EPS = 1e-12


def _pow(x: torch.Tensor, e: float) -> torch.Tensor:
    """``x ** e`` for float32 ``x`` with the exponent rounded to float32 as
    JAX's weak typing rounds it."""
    e32 = torch.tensor(e, dtype=torch.float32).item()
    return torch.pow(x.to(torch.float64), e32).to(torch.float32)


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b, i]]`` for x (nb, n, ...) and idx (nb, n)."""
    if x.dim() == 2:
        return torch.gather(x, 1, idx)
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def _segment(x: torch.Tensor, seg: torch.Tensor, reduce: str) -> torch.Tensor:
    """Per-block ``jax.ops.segment_{sum,max,min}`` with ``num_segments =
    n``: x (nb, n[, D]), seg (nb, n) group ids in [0, n).  Each segment
    reduces its members in row order from the reduction's identity (0, -inf,
    +inf), so empty segments hold the identity, as in JAX."""
    nb, n = seg.shape
    order = torch.argsort(seg, dim=1, stable=True)
    lengths = torch.zeros((nb, n), dtype=torch.int64, device=seg.device)
    lengths.scatter_add_(1, seg, torch.ones_like(seg))
    data = _gather_rows(x, order).reshape(nb * n, *x.shape[2:])
    out = torch.segment_reduce(data, reduce, lengths=lengths.reshape(-1),
                               axis=0)
    return out.reshape(x.shape)


@dataclasses.dataclass(frozen=True)
class BHQTensor:
    """Quantized tensor under the block Householder transform.

    Dequantization is ``S^{-1}(codes + Z) = diag(1/s) Q (codes + Z)``
    where ``Q`` is the (involutory) per-group Householder mix.  All fields
    are over ``(n_blocks, block_rows, D)``.
    """

    codes: torch.Tensor        # (nb, n, D) uint8 in [0, B]
    zero: torch.Tensor         # (nb, n, 1) per-row zero (== its group zero)
    row_scale: torch.Tensor    # (nb, n, 1) s1 for large rows, s2 otherwise
    n_vec: torch.Tensor        # (nb, n, 1) Householder normal entry per row
    coef: torch.Tensor         # (nb, n, 1) 2/||n||^2 of the row's group
    seg: torch.Tensor          # (nb, n) group id per sorted row
    inv_perm: torch.Tensor     # (nb, n) sorted position -> original row
    bits: int
    shape: tuple

    @property
    def n_rows(self) -> int:
        """Real (unpadded) row count — blocks may carry zero-padding rows."""
        return math.prod(self.shape[:-1]) if len(self.shape) > 1 else 1

    def dequant(self) -> torch.Tensor:
        t = self.codes.to(torch.float32) + self.zero
        out = self.dequant_epilogue(t)
        return out.reshape(-1, self.shape[-1])[:self.n_rows].reshape(
            self.shape)

    @property
    def int8_codes(self) -> torch.Tensor:
        return (self.codes.to(torch.int16) - self.int8_offset).to(torch.int8)

    @property
    def int8_offset(self) -> int:
        return 1 << (self.bits - 1)

    def dequant_epilogue(self, t: torch.Tensor) -> torch.Tensor:
        """Apply ``S^{-1}`` and unpermute to ``t`` (the codes' row layout):
        the int GEMM of the dX path runs on raw codes and this mixes the
        *output* rows (``Q_b(g) @ W^T = S^{-1}((codes + Z) @ W^T)``)."""
        y = _apply_householder(t, self.seg, self.n_vec, self.coef)
        return _unpermute(y / self.row_scale, self.inv_perm)


def _apply_householder(x: torch.Tensor, seg: torch.Tensor,
                       n_vec: torch.Tensor, coef: torch.Tensor):
    """y = Q x per group: y_j = x_j - n_j * coef_g * (n^T x)_g.
    x (nb, n, D), seg (nb, n), n_vec/coef (nb, n, 1)."""
    ntx = _segment(n_vec * x, seg, "sum")                   # (nb, n, D)
    return x - n_vec * coef * _gather_rows(ntx, seg)


def _unpermute(x: torch.Tensor, inv_perm: torch.Tensor) -> torch.Tensor:
    idx = inv_perm[..., None].expand(-1, -1, x.shape[-1])
    return torch.zeros_like(x).scatter_(1, idx, x)


def _largest_remainder(weights: torch.Tensor, total: torch.Tensor,
                       valid: torch.Tensor) -> torch.Tensor:
    """Integerize ``total * weights`` per block (sums over valid to total).
    weights (nb, n) nonneg, zero where ~valid; total (nb,) float32."""
    n = weights.shape[1]
    wsum = torch.clamp_min(weights.sum(dim=1, keepdim=True), _EPS)
    raw = total[:, None] * weights / wsum
    base = torch.where(valid, torch.floor(raw).to(torch.int32), 0)
    rem = torch.where(valid, raw - base, -1.0)
    short = total - base.sum(dim=1)
    order = torch.argsort(-rem, dim=1, stable=True)
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(n, device=order.device).expand_as(order))
    return base + ((rank < short[:, None]) & valid).to(torch.int32)


def _g_candidates(n: int):
    """Candidate group counts: 1, 2, 4, ... n//2, and n (G = n is PSQ)."""
    cands, g = [], 1
    while g <= max(n // 2, 1):
        cands.append(g)
        g *= 2
    if n not in cands:
        cands.append(n)
    return cands


def _select_g(mag_s: torch.Tensor, rng_s: torch.Tensor, n: int,
              g_search: str, n_valid: torch.Tensor) -> torch.Tensor:
    """The number of groups G per block (``repro.core.bhq._select_g``):
    ``"refined"`` (default) scores each candidate with the full D.4 bound,
    ``"paper"`` with the D.5 proxy (the PSQ candidate G = n scored by its
    exact variance).  mag_s/rng_s (nb, n) sorted; n_valid (nb,)."""
    nv = n_valid.to(torch.float32)[:, None]
    dev = mag_s.device
    if g_search == "paper":
        csum = torch.cumsum(mag_s, dim=1)
        gs_idx = torch.arange(1, n, dtype=torch.float32, device=dev)
        score = csum[:, :-1] ** 2 / torch.clamp_min(nv - gs_idx, 1.0)
        score = torch.where(gs_idx < nv, score, torch.inf)
        score = torch.cat([score, (rng_s ** 2).sum(dim=1, keepdim=True)], 1)
        best = torch.argmin(score, dim=1).to(torch.int32)
        return torch.where(best == n - 1, nv[:, 0].to(torch.int32), best + 1)
    if g_search != "refined":
        raise ValueError(f"unknown g_search {g_search!r}; expected "
                         f"'refined' or 'paper'")
    idx = torch.arange(n, dtype=torch.float32, device=dev)
    lam1 = torch.clamp_min(rng_s, _EPS)
    l1_23 = _pow(lam1, 2 / 3)
    cands = _g_candidates(n)
    scores = []
    for G in cands:
        mask = idx < G
        msum = torch.clamp_min(torch.where(mask, mag_s, 0.0).sum(
            dim=1, keepdim=True), _EPS)
        m_i = 1.0 + torch.clamp_min(nv - G, 0.0) * mag_s / msum
        lam2 = 2.0 * (mag_s[:, G:G + 1] if G < n else 0.0) + _EPS
        lam2 = torch.as_tensor(lam2, dtype=torch.float32, device=dev)
        t = l1_23 * _pow(m_i, -1 / 3) + _pow(lam2, 2 / 3) * _pow(m_i, 2 / 3)
        term = t * (t * t)                        # lax.integer_pow(t, 3)
        score = torch.where(mask, term, 0.0).sum(dim=1)
        scores.append(torch.where(G <= nv[:, 0], score, torch.inf))
    best = torch.argmin(torch.stack(scores, dim=1), dim=1)
    return torch.tensor(cands, dtype=torch.int32, device=dev)[best]


def _bhq_transform(g: torch.Tensor, valid: torch.Tensor, bits: int,
                   g_search: str):
    """The deterministic part of BHQ over blocks g (nb, n, D): sort, group,
    scale, Householder.  Returns ``(y, zero, row_scale, n_vec, coef, seg,
    perm)``; ``y - zero`` is what the stochastic round consumes."""
    B = float(num_bins(bits))
    nb, n, _ = g.shape
    dev = g.device
    # step 1: sort rows by infinity-norm magnitude, descending (stable:
    # the zero padding rows tie)
    mag = torch.where(valid, torch.amax(torch.abs(g), dim=-1), -1.0)
    perm = torch.argsort(-mag, dim=1, stable=True)
    gs = _gather_rows(g, perm)
    mag_s = torch.clamp_min(torch.gather(mag, 1, perm), 0.0)
    n_valid = valid.to(torch.int32).sum(dim=1)

    # step 2: the number of groups G
    rng_s = row_dynamic_range(gs)
    G = torch.minimum(_select_g(mag_s, rng_s, n, g_search, n_valid),
                      n_valid)[:, None]

    idx = torch.arange(n, dtype=torch.int32, device=dev).expand(nb, n)
    is_large = idx < G
    is_pad = idx >= n_valid[:, None]

    # step 3: group sizes proportional to magnitude, largest remainder
    w = torch.where(is_large, mag_s, 0.0)
    n_small = torch.clamp_min(n_valid[:, None] - G, 0).to(torch.float32)
    extras = _largest_remainder(w, n_small[:, 0], is_large)
    cum = torch.cumsum(extras, dim=1, dtype=torch.int64)
    p = torch.clamp(idx - G, 0, n - 1).to(torch.int64)
    small_seg = torch.searchsorted(cum, p, right=True)
    seg = torch.where(is_large, idx.to(torch.int64),
                      torch.clamp(small_seg, 0, n - 1))
    seg = torch.where(is_pad, idx.to(torch.int64), seg)

    # step 4: optimal scales (Appendix D.4)
    lam1_g = torch.where(is_large, torch.clamp_min(rng_s, _EPS), 1.0)
    small_mag = torch.where(is_large, 0.0, mag_s)
    lam2_g = torch.clamp_min(2.0 * _segment(small_mag, seg, "max"), _EPS)
    m_g = torch.clamp_min(_segment(torch.ones_like(mag_s), seg, "sum"), 1.0)
    denom = (_pow(lam1_g, 2 / 3) * _pow(m_g, -1 / 3)
             + _pow(lam2_g, 2 / 3) * _pow(m_g, 2 / 3))
    m16 = _pow(m_g, 1 / 6)
    s1 = B * _pow(lam1_g, -1 / 3) * m16 / denom
    s2 = B * _pow(lam2_g, -1 / 3) * m16 / denom
    row_scale = torch.where(is_large, torch.gather(s1, 1, seg),
                            torch.gather(s2, 1, seg))[..., None]
    sqrt_mg = torch.sqrt(m_g)
    n_vec = (1.0 / torch.gather(sqrt_mg, 1, seg)
             - is_large.to(torch.float32))[..., None]
    coef_g = torch.where(m_g > 1.5, sqrt_mg / torch.clamp_min(sqrt_mg - 1.0,
                                                              _EPS), 0.0)
    coef = torch.gather(coef_g, 1, seg)[..., None]

    # step 5: transform and per-group zero
    y = _apply_householder(row_scale * gs, seg, n_vec, coef)
    zero_g = _segment(torch.amin(y, dim=-1), seg, "min")
    zero = torch.gather(zero_g, 1, seg)[..., None]
    return y, zero, row_scale, n_vec, coef, seg, perm


def _blocked_rows(x: torch.Tensor, block_rows: int):
    """Flatten to rows and zero-pad up to a ``block_rows`` multiple:
    ``(blocks (nb, blk, D), valid (nb, blk), n_real)``.  A single short
    input (n <= block_rows) stays one unpadded block."""
    rows = x.reshape(-1, x.shape[-1])
    n = rows.shape[0]
    blk = block_rows if n > block_rows else n
    n_pad = -(-n // blk) * blk
    if n_pad != n:
        rows = torch.nn.functional.pad(rows, (0, 0, 0, n_pad - n))
    nb = n_pad // blk
    valid = (torch.arange(n_pad, device=x.device) < n).reshape(nb, blk)
    return rows.reshape(nb, blk, x.shape[-1]), valid, n


def _meta_block_uniforms(key, nb: int, blk: int, d: int, device):
    """The ``(nb, blk, d)`` uniforms of :func:`quantize_bhq_stoch` on the
    meta device, counted as its loop over blocks is (``meta.py``): one
    block's draw scaled to ``nb``, the blocks held until stacked, the
    stack's read and write.  The loop splits the key on the host, one
    threefry a block of the whole batch, and has no values to draw."""
    with meta.scaled(nb):
        one = sr_uniform(key, (blk, d), device)
    blocks = meta.hold(nb * one.numel() * one.element_size(), device)
    u = meta.uncounted(torch.empty, (nb, blk, d), dtype=one.dtype,
                       device=device)
    meta.add_counts(2 * u.numel() * u.element_size())
    del blocks
    return u


def quantize_bhq_stoch(x: torch.Tensor, key: torch.Tensor, bits: int = 8,
                       block_rows: int = 1024,
                       g_search: str = "refined") -> BHQTensor:
    """BHQ over row blocks. x: (..., D) -> rows = prod(leading dims).
    Block ``b`` rounds with ``split(key, n_blocks)[b]``'s SR bits.  For a
    batch-spanning ``x`` in a data group (``sharding.data``), ``b`` and
    ``n_blocks`` are the global block index and the batch's block count;
    each rank's rows must be whole blocks."""
    gb, valid, n = _blocked_rows(x, block_rows)
    nb, blk, d = gb.shape
    first, total = data.bhq_blocks(n, block_rows, nb)
    y, zero, rs, nv, cf, seg, perm = _bhq_transform(gb, valid, bits,
                                                    g_search)
    if meta.is_meta(gb):
        u = _meta_block_uniforms(key, nb, blk, d, x.device)
    else:
        u = torch.stack([sr_uniform(k, (blk, d), x.device)
                         for k in prng.split(key, total)[first:first + nb]])
    codes = torch.clamp(torch.floor((y - zero) + u), 0.0,
                        float(num_bins(bits))).to(torch.uint8)
    return BHQTensor(codes=codes, zero=zero, row_scale=rs, n_vec=nv,
                     coef=cf, seg=seg, inv_perm=perm, bits=bits,
                     shape=tuple(x.shape))


def bhq_variance_bound(qt: BHQTensor) -> torch.Tensor:
    """Eq. (13): Var <= D/4 * ||S^{-1}||_F^2 = D/4 * sum_j (1/s_j)^2.

    (The Householder factor is orthogonal, so ||S^{-1}||_F = ||diag(1/s)||_F.)
    """
    d = qt.shape[-1]
    return d / 4.0 * torch.sum(1.0 / qt.row_scale ** 2)


def _block_exact_variance(gb: torch.Tensor, valid: torch.Tensor, *,
                          bits: int, g_search: str) -> torch.Tensor:
    """Exact conditional variance contributed by each (n, D) block of
    ``gb`` (nb, n, D); ``valid`` (nb, n) marks the real rows.

    The dequantized noise is ``S^{-1} eps = diag(1/s) Q eps`` with
    independent SR noise ``Var[eps_kd] = p(1-p)``, ``p = frac(y - zero)``
    (Proposition 4).  Summing over the retained (real) output rows j:

        Var = sum_k w_k * colnorm_k
        w_k       = sum_d p(1-p)_kd
        colnorm_k = ret_k (1 - 2 c n_k^2)/s_k^2 + c^2 n_k^2 sum_{j in g, ret} n_j^2/s_j^2

    using ``Q_jk = delta_jk - c n_j n_k`` within a group (0 across
    groups).  Returns the (nb,) per-block sums.
    """
    y, zero, row_scale, n_vec, coef, seg, perm = _bhq_transform(
        gb, valid, bits, g_search)
    t = y - zero
    p = t - torch.floor(t)
    w = torch.sum(p * (1.0 - p), dim=-1)                      # (nb, n)
    s = row_scale[..., 0]
    nv = n_vec[..., 0]
    c = coef[..., 0]
    ret = torch.gather(valid.to(torch.float32), 1, perm)      # sorted order
    a = _segment(ret * nv ** 2 / s ** 2, seg, "sum")
    colnorm = (ret * (1.0 - 2.0 * c * nv ** 2) / s ** 2
               + c ** 2 * nv ** 2 * torch.gather(a, 1, seg))
    return torch.sum(w * colnorm, dim=1)


def bhq_exact_variance(x: torch.Tensor, bits: int = 8,
                       block_rows: int = 1024,
                       g_search: str = "refined") -> torch.Tensor:
    """Exact conditional ``Var[Q_b(x) | x]`` summed over entries.

    The BHQ transform is deterministic given ``x``; only the stochastic
    rounding injects noise, so the exact variance is the SR ``sum p(1-p)``
    (Proposition 4) pushed through the ``S^{-1}`` columns — see
    :func:`_block_exact_variance`.  Exact modulo the (rare) code clipping
    at the bin boundaries, the caveat of
    :func:`~repro_torch.core.quantizers.sr_variance_exact`.
    """
    gb, valid, _ = _blocked_rows(x, block_rows)
    return torch.sum(_block_exact_variance(gb, valid, bits=bits,
                                           g_search=g_search))
