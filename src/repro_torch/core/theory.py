"""Statistical instrumentation for Theorems 1 & 2.

Port of ``repro.core.theory``: utilities to measure what the paper proves.

  * :func:`empirical_mean_and_variance` — Monte-Carlo E[Q(x)] and
    Var[Q(x)|x] for any stochastic quantizer (Theorem 1 / quantizer
    variance checks);
  * :func:`quantizer_variance` — exact conditional variance of the SR
    noise given the transform (sum of p(1-p) over entries, Proposition 4);
  * :func:`fqt_gradient_stats` — bias/variance of the FQT gradient of an
    arbitrary model relative to its QAT gradient (Theorems 1/2 end to end);
  * :func:`theorem2_path_norms` — the deterministic weights
    ``sum_k ||gamma^{(k,l)}||_2^2`` for a small MLP, via exact Jacobians.

Sample ``i`` is drawn under ``prng.split(key, n)[i]``, the reference's
``jax.random.split``, so a quantizer whose SR bits match the reference's
(all of the port's) gives the reference's samples.  Where the reference
stacks every sample (``lax.map``), the port keeps float64 running moments
(Welford's update), so memory stays that of one sample whatever ``n``:
a full statquant-tx gradient is about 92 MB in float32.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch

from .. import prng
from .bhq import bhq_exact_variance
from .quantizers import (dynamic_range, num_bins, range_scale,
                         row_dynamic_range, sr_variance_exact)

__all__ = [
    "empirical_mean_and_variance",
    "quantizer_variance",
    "fqt_gradient_stats",
    "theorem2_path_norms",
    "variance_of_tree",
    "RunningMoments",
]


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return next(it)


class RunningMoments:
    """Per-entry mean and variance of a stream of same-shaped trees of
    tensors, accumulated in float64 (Welford): ``add(tree)`` per sample,
    then ``mean()`` (float32 trees) and ``variance()`` (the sum over all
    entries of the per-entry population variance, ``jnp.var``'s)."""

    def __init__(self):
        self.n = 0
        self._tree = None
        self._mean = self._m2 = None

    def add(self, tree) -> None:
        xs = [x.detach().to(torch.float64) for x in _leaves(tree)]
        self.n += 1
        if self._mean is None:
            self._tree = tree
            self._mean = [x.clone() for x in xs]
            self._m2 = [torch.zeros_like(x) for x in xs]
            return
        for x, m, m2 in zip(xs, self._mean, self._m2):
            d = x - m
            m.add_(d / self.n)
            m2.add_(d * (x - m))

    def mean(self):
        return _rebuild(self._tree, iter(m.to(torch.float32)
                                         for m in self._mean))

    def variance(self) -> float:
        return float(sum(torch.sum(m2) for m2 in self._m2) / self.n)


def variance_of_tree(trees: Sequence) -> float:
    """Var[X] := sum of per-entry variances over a list of tree samples."""
    mom = RunningMoments()
    for t in trees:
        mom.add(t)
    return mom.variance()


def empirical_mean_and_variance(quant_fn: Callable, x: torch.Tensor, key,
                                n_samples: int = 256):
    """Monte-Carlo (E[Q(x)], Var[Q(x)|x]) for a stochastic quantizer.

    quant_fn(x, key) -> dequantized tensor; sample ``i`` draws under
    ``prng.split(key, n_samples)[i]``.  Returns (mean (float32), total
    variance (a float, accumulated in float64))."""
    mom = RunningMoments()
    for k in prng.split(key, n_samples):
        mom.add(quant_fn(x, k))
    return mom.mean(), mom.variance()


def quantizer_variance(x: torch.Tensor, quantizer: str = "ptq",
                       bits: int = 8, **params) -> torch.Tensor:
    """Exact conditional variance ``Var[Q_b(x) | x]`` summed over entries.

    Proposition 4: the stochastic round contributes ``p(1-p)`` per entry,
    ``p = frac(S(x - Z))``; dequantization pushes that noise through the
    transform's inverse, so

      * ``ptq``  —  ``sum p(1-p) / S^2``             (one scalar scale)
      * ``psq``  —  ``sum_i [sum_d p(1-p)]_i / s_i^2``  (per-row scales)
      * ``bhq``  —  the same sum through the ``S^{-1} = diag(1/s) Q`` column
                    norms (:func:`~repro_torch.core.bhq.bhq_exact_variance`);
                    accepts ``block_rows`` / ``g_search``.

    Exact modulo code clipping at the bin boundaries; deterministic (no
    key).  The scales divide as the quantizers do (``range_scale``)."""
    B = num_bins(bits)
    if quantizer == "ptq":
        scale = range_scale(B, dynamic_range(x))
        t = scale * (x - torch.amin(x))
        return sr_variance_exact(t) / scale ** 2
    if quantizer == "psq":
        rows = x.reshape(-1, x.shape[-1])
        scale = range_scale(B, row_dynamic_range(rows)[:, None])
        t = scale * (rows - torch.amin(rows, dim=-1, keepdim=True))
        p = t - torch.floor(t)
        return torch.sum(p * (1.0 - p) / scale ** 2)
    if quantizer == "bhq":
        return bhq_exact_variance(
            x, bits, block_rows=params.get("block_rows", 1024),
            g_search=params.get("g_search", "refined"))
    raise ValueError(f"unknown quantizer {quantizer!r}; "
                     "expected ptq | psq | bhq")


def fqt_gradient_stats(grad_fn: Callable, key,
                       n_samples: int = 64) -> Dict[str, object]:
    """Bias/variance of a stochastic gradient estimator.

    grad_fn(key) -> gradient tree (the FQT gradient with quantizer
    randomness keyed by ``key``; the batch is held fixed by the caller, so
    the stats are the conditional-on-batch quantities of Theorems 1/2).
    Sample ``i`` uses ``prng.split(key, n_samples)[i]``.  Returns
    ``{"mean": tree (float32), "variance": float}``."""
    mom = RunningMoments()
    for k in prng.split(key, n_samples):
        mom.add(grad_fn(k))
    return {"mean": mom.mean(), "variance": mom.variance()}


def _jacobian(f, arg: torch.Tensor) -> torch.Tensor:
    """d vec(f(arg)) / d vec(arg) as an (out, in) matrix."""
    j = torch.func.jacrev(f)(arg)
    return j.reshape(-1, arg.numel())


def theorem2_path_norms(layer_fns: Sequence[Callable], params: Sequence,
                        x0: torch.Tensor):
    """``sum_{k<=l} ||gamma^{(k,l)}||_2^2`` for a feed-forward chain.

    layer_fns[l](h, params[l]) -> h_next, ``params[l]`` a tensor or a
    (nested) dict of tensors.  Returns a list over l of the Theorem-2
    weight multiplying the layer-l quantizer variance in Eq. (8).

    gamma^{(k,l)} = (prod_{i=l..k+1} J^{(i)}) K^{(k)} with
    J^(i) = d vec(H^i)/d vec(H^{i-1}),  K^(k) = d vec(H^k)/d vec(Theta^k),
    by ``torch.func.jacrev`` — only feasible for small test networks."""
    L = len(layer_fns)
    hs = [x0]
    for l in range(L):
        hs.append(layer_fns[l](hs[-1], params[l]))

    js, ks = [], []
    for l in range(L):
        h_in, p = hs[l], params[l]
        js.append(_jacobian(lambda h, fn=layer_fns[l], p=p: fn(h, p), h_in))
        leaves = _leaves(p)
        flat = torch.cat([t.reshape(-1) for t in leaves])

        def unravel(pf, tree=p, leaves=leaves):
            parts, off = [], 0
            for t in leaves:
                parts.append(pf[off:off + t.numel()].reshape(t.shape))
                off += t.numel()
            return _rebuild(tree, iter(parts))
        ks.append(_jacobian(
            lambda pf, fn=layer_fns[l], h=h_in, un=unravel: fn(h, un(pf)),
            flat))

    # gamma^{(k,l)}: start from K^{(k)} and push forward through the J's
    # (column Jacobians: gamma^{(k,l)} = K^(k)^T prod J^T, the same norms)
    weights = []
    for l in range(L):
        total = 0.0
        for k in range(l + 1):
            gamma = ks[k].T                       # (theta_k, h_k)
            for i in range(k + 1, l + 1):
                gamma = gamma @ js[i].T           # push to h_l
            total = total + torch.linalg.matrix_norm(gamma, ord=2) ** 2
        weights.append(total)
    return weights
