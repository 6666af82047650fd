"""eXmY numerics, the quant API and quantized layers (port of
`cpd_tpu.quant`: every name it exports, and the port's cast bodies)."""

from .numerics import (HEALTH_FIELDS, cast_body, cast_body_sr, cast_oracle,
                       cast_oracle_sr, cast_to_format, cast_to_format_sr,
                       cast_to_format_sr_at, cast_to_format_stats,
                       kv_pool_bytes, max_finite, pack_exmy, quant_health,
                       unpack_exmy, wire_bytes)
from .quant_function import (float_quantize, float_quantize_stats, qgemm,
                             qgemm_stats, quant_gemm, quant_gemm_stats,
                             quantizer, quantizer_sr, quantizer_stats,
                             tree_quant_health)
from .quant_module import (QuantConv, QuantDense, QuantLinear, Quantizer,
                           quant_linear_fn)

__all__ = ["cast_to_format", "cast_to_format_sr", "cast_oracle",
           "cast_oracle_sr", "max_finite", "pack_exmy", "unpack_exmy",
           "wire_bytes", "quant_health", "cast_to_format_stats",
           "HEALTH_FIELDS", "float_quantize", "float_quantize_stats",
           "quantizer", "quantizer_sr", "quantizer_stats", "quant_gemm",
           "quant_gemm_stats", "qgemm", "qgemm_stats", "tree_quant_health",
           "Quantizer", "QuantDense", "QuantLinear", "QuantConv",
           "cast_body", "cast_body_sr", "cast_to_format_sr_at",
           "kv_pool_bytes", "quant_linear_fn"]
