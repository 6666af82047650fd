"""eXmY numerics (port of `cpd_tpu.quant`)."""

from .numerics import (cast_body, cast_body_sr, cast_to_format,
                       cast_to_format_sr, cast_to_format_sr_at, max_finite,
                       pack_exmy, unpack_exmy, wire_bytes)

__all__ = ["cast_body", "cast_body_sr", "cast_to_format",
           "cast_to_format_sr", "cast_to_format_sr_at", "max_finite",
           "pack_exmy", "unpack_exmy", "wire_bytes"]
