"""Token sampling for the serving engine: greedy, temperature, top-k, top-p.

Port of ``repro.serve.sampling``.  Batched over decode slots with per-slot
parameters and per-slot PRNG keys from :func:`slot_keys`; the randomness is
a pure function of ``(seed, request id, token index)`` and, through the
threefry copy in ``repro_torch.prng``, the same draw the JAX package makes.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import prng

__all__ = ["slot_keys", "sample_tokens"]

_NEG = -1e30


def slot_keys(base_key: torch.Tensor, rids: torch.Tensor,
              counts: torch.Tensor) -> torch.Tensor:
    """Per-slot sampling keys ``fold_in(fold_in(base, rid), count)``, (B, 2).
    Inactive slots may pass any value (their samples are discarded)."""
    return prng.fold_in(prng.fold_in(base_key, rids), counts)


def sample_tokens(logits: torch.Tensor, keys: torch.Tensor,
                  temperature: torch.Tensor, top_k: torch.Tensor,
                  vocab_size: int,
                  top_p: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sample one token per slot.  logits: (B, Vp); keys: (B, 2);
    temperature/top_k/top_p: (B,) — ``temperature <= 0`` means greedy,
    ``top_k <= 0`` disables top-k, ``top_p`` outside ``(0, 1)`` (or
    ``None``) disables the nucleus filter.  Returns (B,) int64.

    Padded-vocab logits are masked first; filters compose as temperature,
    then top-k, then top-p, and the only randomness is
    ``categorical(key, ...)``.
    """
    B, vp = logits.shape
    logits = logits.to(torch.float32)
    if vp > vocab_size:
        logits = logits.clone()
        logits[:, vocab_size:] = _NEG
    greedy = torch.argmax(logits, dim=-1)

    k = torch.clamp(torch.where(top_k <= 0, vocab_size, top_k), 1, vocab_size)
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    thresh = torch.gather(sorted_desc, 1, (k - 1)[:, None].to(torch.int64))
    neg_inf = torch.tensor(float("-inf"), device=logits.device)
    filtered = torch.where(logits >= thresh, logits, neg_inf)

    temp = torch.clamp_min(temperature, 1e-6)[:, None]
    if top_p is not None:
        # nucleus cut on the post-top-k, temperature-scaled distribution:
        # keep the shortest descending-probability prefix whose cumulative
        # mass reaches top_p (ties at the cut probability are all kept)
        probs = torch.softmax(filtered / temp, dim=-1)
        sp = torch.sort(probs, dim=-1, descending=True).values
        cum = torch.cumsum(sp, dim=-1)
        n_keep = torch.sum((cum - sp) < top_p[:, None], dim=-1)
        p_thresh = torch.gather(sp, 1, torch.clamp_min(n_keep - 1, 0)[:, None])
        nucleus = torch.where(probs >= p_thresh, filtered, neg_inf)
        active = ((top_p > 0.0) & (top_p < 1.0))[:, None]
        filtered = torch.where(active, nucleus, filtered)

    sampled = prng.categorical(keys, filtered / temp)
    return torch.where(temperature > 0.0, sampled, greedy)
