"""Models: the decoder-only LM families, the encoder-decoder and
``build_model``."""

from .api import Model, build_model, model_quant_paths
from .encdec import (encdec_decode, encdec_loss, encdec_prefill,
                     init_encdec_cache, init_encdec_params)
from .lm import (cross_entropy, init_lm_cache, init_lm_cache_quant,
                 init_lm_paged_pool, init_lm_params, lm_decode, lm_loss,
                 lm_paged_decode, lm_prefill)

__all__ = ["Model", "build_model", "model_quant_paths", "cross_entropy",
           "encdec_decode", "encdec_loss", "encdec_prefill",
           "init_encdec_cache", "init_encdec_params",
           "init_lm_cache", "init_lm_cache_quant", "init_lm_paged_pool",
           "init_lm_params", "lm_decode", "lm_loss", "lm_paged_decode",
           "lm_prefill"]
