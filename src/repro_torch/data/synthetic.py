"""Deterministic synthetic LM data.

Port of ``repro.data.synthetic``: a seeded token stream with a learnable
ramp (``token_{t+1} = token_t + 31 mod vocab``) and uniform noise at
``1 - easy_frac`` of the positions.  Batches are drawn with the port's
threefry copy (``prng.randint``/``prng.uniform``), so they equal the
reference's token for token; they are made on the CPU, where the keys
live, and the loader moves them to the training device.

Determinism contract: ``batch(step, host, n_hosts)`` is a pure function.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import prng
from ..configs.base import ArchConfig

__all__ = ["SyntheticLM", "make_batch_for"]


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    vocab_size: int
    seq_len: int
    batch_size: int                 # host-local batch
    seed: int = 0
    easy_frac: float = 0.7          # fraction of positions with learnable rule

    def batch(self, step: int, host: int = 0, n_hosts: int = 1) -> dict:
        key = prng.fold_in(prng.fold_in(prng.PRNGKey(self.seed), step), host)
        k1, k2, k3 = prng.split(key, 3)
        B, T, V = self.batch_size, self.seq_len, self.vocab_size
        base = prng.randint(k1, (B, 1), 0, V)
        steps = torch.arange(T + 1, dtype=torch.int32)
        seq = (base + 31 * steps[None, :]) % V              # learnable ramp
        noise = prng.randint(k2, (B, T + 1), 0, V)
        use_noise = prng.uniform(k3, (B, T + 1)) > self.easy_frac
        seq = torch.where(use_noise, noise, seq).to(torch.int32)
        return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}


def make_batch_for(cfg: ArchConfig, batch_size: int, seq_len: int,
                   step: int = 0, seed: int = 0, host: int = 0,
                   n_hosts: int = 1) -> dict:
    """Arch-aware batch; this slice covers token LMs (the dense family)."""
    if cfg.family in ("vlm", "audio"):
        raise NotImplementedError(
            f"{cfg.name}: batches of the {cfg.family!r} family (stub "
            f"frontends) come with that family's slice of the port")
    return SyntheticLM(cfg.vocab_size, seq_len, batch_size, seed).batch(
        step, host, n_hosts)
