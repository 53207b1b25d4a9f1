"""Quantizer core: quantizers (deterministic, PTQ, PSQ, BHQ), registry,
policy, backends and the FQT matmul with its Eq. 6 backward."""

from .backend import (affine_factors, apply_epilogue, epilogue_coeffs,
                      fused_fqt_dw, fused_fqt_dx, fused_fqt_fwd, q8_gemm,
                      qt_gemm, qt_gemm_nt, qt_gemm_tn, requantize_det)
from .bhq import (BHQTensor, bhq_exact_variance, bhq_variance_bound,
                  quantize_bhq_stoch)
from .exempt import (clear_exemptions, exemption_registry, fp_exempt,
                     key_scope, quant_scope)
from .fqt import fqt_matmul
from .kv_cache import (dequant_kv_rows, dequant_kv_rows_kv,
                       kv_cache_bytes_per_row, kv_fresh_code,
                       quantize_kv_rows)
from .policy import (EXACT, FQT8_BHQ, QAT, QuantPolicy, RoleOverride,
                     overrides_from_json, overrides_to_json)
from .quantizers import (QTensor, dynamic_range, num_bins,
                         psq_variance_bound, ptq_variance_bound,
                         quantize_psq_stoch, quantize_ptq_det,
                         quantize_ptq_stoch, row_dynamic_range,
                         sr_uniform, sr_variance_exact, stochastic_round,
                         tensor_min_max)
from .registry import (BACKENDS, ROLES, GemmQuantConfig, Quantizer,
                       QuantizerSpec, available_quantizers, get_quantizer,
                       register_quantizer, resolve_kv_cache_spec)

__all__ = ["affine_factors", "apply_epilogue", "epilogue_coeffs",
           "fused_fqt_dw", "fused_fqt_dx", "fused_fqt_fwd", "q8_gemm",
           "qt_gemm", "qt_gemm_nt", "qt_gemm_tn", "requantize_det",
           "BHQTensor", "bhq_exact_variance", "bhq_variance_bound",
           "quantize_bhq_stoch", "clear_exemptions", "exemption_registry",
           "fp_exempt", "key_scope", "quant_scope", "fqt_matmul",
           "dequant_kv_rows", "dequant_kv_rows_kv", "kv_cache_bytes_per_row",
           "kv_fresh_code", "quantize_kv_rows",
           "EXACT", "FQT8_BHQ", "QAT", "QuantPolicy", "RoleOverride",
           "overrides_from_json", "overrides_to_json", "QTensor", "dynamic_range", "num_bins",
           "psq_variance_bound", "ptq_variance_bound", "sr_variance_exact",
           "quantize_psq_stoch", "quantize_ptq_det", "quantize_ptq_stoch",
           "row_dynamic_range", "sr_uniform", "stochastic_round",
           "tensor_min_max", "BACKENDS", "ROLES", "GemmQuantConfig",
           "Quantizer", "QuantizerSpec", "available_quantizers",
           "get_quantizer", "register_quantizer", "resolve_kv_cache_spec"]
