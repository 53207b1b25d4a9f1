"""Serving: the continuous-batching dense-lane engine, the paged-pool
engine with prefix reuse and speculative decode, load-time weight packing,
and sampling."""

from .engine import (Completion, Request, ServeEngine, pack_dense_weights,
                     weight_nbytes)
from .paged import PagedServeEngine, PagePool, PrefixCache
from .sampling import sample_tokens, slot_keys
from .spec import SpecStats, default_draft_policy, greedy_accept

__all__ = ["ServeEngine", "Request", "Completion", "PagedServeEngine",
           "PagePool", "PrefixCache", "SpecStats", "default_draft_policy",
           "greedy_accept", "sample_tokens", "slot_keys",
           "pack_dense_weights", "weight_nbytes"]
