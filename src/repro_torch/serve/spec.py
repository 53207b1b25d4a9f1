"""Self-speculative decoding: the draft model is the same parameters under
a more aggressive low-bit quantization policy.

Port of ``repro.serve.spec``.  ``QuantPolicy.overrides`` re-resolves every
forward GEMM of the target parameters at a lower width, so the draft
shares weights and KV pages with the target.  The paged engine
(serve/paged.py) runs the loop:

  1. **propose** — ``k`` sequential one-token paged decode steps under the
     draft policy, greedy, writing provisional KV rows at ``pos+1 ..
     pos+k``;
  2. **verify** — one ``(B, k+1)`` paged forward of ``[t0, d1 .. dk]``
     under the target policy, which overwrites those rows with target KV;
  3. **accept** — :func:`greedy_accept`: the target's greedy outputs are
     emitted while they confirm the draft, plus the first disagreeing
     target token, each exactly what plain target greedy decode would
     produce.

Rows past the accepted point hold KV of rejected draft tokens; they stay
masked until a real token is written there.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core import QuantPolicy, RoleOverride

__all__ = ["SpecStats", "default_draft_policy", "greedy_accept"]

# the draft's widths: 4-bit deterministic forward activations and weights
_DRAFT_ACT_SPEC = "ptq_det:4"
_DRAFT_WEIGHT_SPEC = "ptq_det:4"


def default_draft_policy(policy: QuantPolicy,
                         packed_weights: bool = False) -> QuantPolicy:
    """The self-draft policy: the target's with a catch-all override, last
    so it wins every path, that drops forward activations (and, unless the
    weights are bit-packed at a fixed width, forward weights) to 4 bits."""
    roles = {"fwd_act": _DRAFT_ACT_SPEC}
    if not packed_weights:
        roles["fwd_weight"] = _DRAFT_WEIGHT_SPEC
    return dataclasses.replace(
        policy,
        overrides=tuple(policy.overrides) + (("", RoleOverride.of(roles)),))


@dataclasses.dataclass
class SpecStats:
    """Acceptance accounting across an engine's lifetime."""

    proposed: int = 0          # draft tokens proposed (k per spec step/slot)
    accepted: int = 0          # of those, confirmed by the target
    emitted: int = 0           # tokens emitted by spec steps (incl. the +1)
    spec_steps: int = 0        # propose+verify rounds run
    fallback_steps: int = 0    # plain steps taken where spec didn't fit

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.proposed if self.proposed else 0.0

    def as_dict(self) -> dict:
        return {"proposed": self.proposed, "accepted": self.accepted,
                "emitted": self.emitted, "spec_steps": self.spec_steps,
                "fallback_steps": self.fallback_steps,
                "acceptance_rate": self.acceptance_rate}


def greedy_accept(drafted: np.ndarray, target_greedy: np.ndarray):
    """Exact greedy acceptance for one slot.

    drafted: (k,) proposals ``d1 .. dk``; target_greedy: (k+1,) the
    target's greedy picks ``g0 .. gk``, ``g_j`` conditioned on ``[.., t0,
    d1 .. d_j]``.  Returns ``g0 .. g_m`` with ``m`` the longest prefix on
    which the draft matched (``d_j == g_{j-1}``)."""
    k = len(drafted)
    out = [int(target_greedy[0])]
    for j in range(k):
        if int(drafted[j]) != int(target_greedy[j]):
            break
        out.append(int(target_greedy[j + 1]))
    return out
