"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions.

Each wrapper launches its kernel on a CUDA tensor and counts the launch in
its ``launches`` attribute; on a CPU tensor it runs the plain version,
and on a meta tensor (the dry run, ``launch/dryrun.py``) too.
"""

from .fused_fqt import (fused_qboth_tn_matmul, fused_qboth_tn_matmul_plain,
                        fused_qlhs_matmul, fused_qlhs_matmul_plain,
                        fused_qlhs_packed_matmul,
                        fused_qlhs_packed_matmul_plain)
from .kv_dequant import (kv_dequant_rows, kv_dequant_rows_kv,
                         kv_dequant_rows_kv_plain, kv_dequant_rows_plain)
from .kv_gather import (kv_gather_pages, kv_gather_pages_kv,
                        kv_gather_pages_kv_plain, kv_gather_pages_plain)
from .pack import PackedTensor, pack_codes, pack_qtensor, unpack_codes
from .q4_matmul import packed_matmul, packed_matmul_plain
from .q8_matmul import q8_matmul, q8_matmul_plain
from .quantize_sr import (quantize_sr_rows, quantize_sr_rows_plain,
                          quantize_sr_tensor, quantize_sr_tensor_plain)

__all__ = ["fused_qboth_tn_matmul", "fused_qboth_tn_matmul_plain",
           "fused_qlhs_matmul", "fused_qlhs_matmul_plain",
           "fused_qlhs_packed_matmul", "fused_qlhs_packed_matmul_plain",
           "kv_dequant_rows", "kv_dequant_rows_plain",
           "kv_dequant_rows_kv", "kv_dequant_rows_kv_plain",
           "kv_gather_pages", "kv_gather_pages_plain",
           "kv_gather_pages_kv", "kv_gather_pages_kv_plain",
           "PackedTensor", "pack_codes", "pack_qtensor", "unpack_codes",
           "packed_matmul", "packed_matmul_plain",
           "q8_matmul", "q8_matmul_plain",
           "quantize_sr_rows", "quantize_sr_rows_plain",
           "quantize_sr_tensor", "quantize_sr_tensor_plain"]
