"""Models: the dense decoder-only LM and ``build_model``."""

from .api import Model, build_model
from .lm import (init_lm_cache, init_lm_cache_quant, init_lm_params,
                 lm_decode, lm_prefill)

__all__ = ["Model", "build_model", "init_lm_cache", "init_lm_cache_quant",
           "init_lm_params", "lm_decode", "lm_prefill"]
