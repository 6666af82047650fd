"""eXmY numerics, the quant API and quantized layers (port of
`cpd_tpu.quant`)."""

from .numerics import (HEALTH_FIELDS, cast_body, cast_body_sr,
                       cast_to_format, cast_to_format_sr,
                       cast_to_format_sr_at, cast_to_format_stats,
                       max_finite, pack_exmy, quant_health, unpack_exmy,
                       wire_bytes)
from .quant_function import float_quantize, qgemm, quant_gemm, quantizer
from .quant_module import QuantDense, QuantLinear, quant_linear_fn

__all__ = ["cast_body", "cast_body_sr", "cast_to_format",
           "cast_to_format_sr", "cast_to_format_sr_at", "HEALTH_FIELDS",
           "quant_health", "cast_to_format_stats", "max_finite",
           "pack_exmy", "unpack_exmy", "wire_bytes", "float_quantize",
           "qgemm", "quant_gemm", "quantizer", "QuantDense", "QuantLinear",
           "quant_linear_fn"]
