"""Quantizer core: quantizers (deterministic, PTQ, PSQ, BHQ), registry,
policy, backends and the FQT matmul with its Eq. 6 backward."""

from .backend import (affine_factors, apply_epilogue, epilogue_coeffs,
                      fused_fqt_dw, fused_fqt_dx, fused_fqt_fwd, q8_gemm,
                      qt_gemm, qt_gemm_nt, qt_gemm_tn, requantize_det)
from .bhq import BHQTensor, quantize_bhq_stoch
from .fqt import fqt_matmul
from .kv_cache import dequant_kv_rows, kv_fresh_code, quantize_kv_rows
from .policy import QuantPolicy, RoleOverride
from .quantizers import (QTensor, num_bins, quantize_psq_stoch,
                         quantize_ptq_det, quantize_ptq_stoch,
                         row_dynamic_range, sr_uniform, stochastic_round,
                         tensor_min_max)
from .registry import (BACKENDS, ROLES, GemmQuantConfig, Quantizer,
                       QuantizerSpec, available_quantizers, get_quantizer,
                       register_quantizer, resolve_kv_cache_spec)

__all__ = ["affine_factors", "apply_epilogue", "epilogue_coeffs",
           "fused_fqt_dw", "fused_fqt_dx", "fused_fqt_fwd", "q8_gemm",
           "qt_gemm", "qt_gemm_nt", "qt_gemm_tn", "requantize_det",
           "BHQTensor", "quantize_bhq_stoch", "fqt_matmul",
           "dequant_kv_rows", "kv_fresh_code", "quantize_kv_rows",
           "QuantPolicy", "RoleOverride", "QTensor", "num_bins",
           "quantize_psq_stoch", "quantize_ptq_det", "quantize_ptq_stoch",
           "row_dynamic_range", "sr_uniform", "stochastic_round",
           "tensor_min_max", "BACKENDS", "ROLES", "GemmQuantConfig",
           "Quantizer", "QuantizerSpec", "available_quantizers",
           "get_quantizer", "register_quantizer", "resolve_kv_cache_spec"]
