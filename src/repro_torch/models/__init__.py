"""Models: the dense decoder-only LM and ``build_model``."""

from .api import Model, build_model, model_quant_paths
from .lm import (cross_entropy, init_lm_cache, init_lm_cache_quant,
                 init_lm_params, lm_decode, lm_loss, lm_prefill)

__all__ = ["Model", "build_model", "model_quant_paths", "cross_entropy",
           "init_lm_cache", "init_lm_cache_quant", "init_lm_params",
           "lm_decode", "lm_loss", "lm_prefill"]
