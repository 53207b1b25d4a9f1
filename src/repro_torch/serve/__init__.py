"""Serving: the continuous-batching dense-lane engine and sampling."""

from .engine import Completion, Request, ServeEngine
from .sampling import sample_tokens, slot_keys

__all__ = ["ServeEngine", "Request", "Completion", "sample_tokens",
           "slot_keys"]
