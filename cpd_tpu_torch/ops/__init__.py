"""Kernels of the port and their plain PyTorch versions."""

from .quantize import (hop_pack, hop_pack_ref, quantize_add,
                       quantize_add_ref, quantize_add_sr, quantize_add_sr_ref,
                       quantize_cast, quantize_cast_ref, quantize_cast_sr,
                       quantize_cast_sr_ref, quantize_pack, quantize_pack_ref,
                       sr_bits, sr_bits_ref)
from .serve_attn import (fused_gather_attention, fused_gather_attention_ref,
                         paged_attention)

__all__ = ["fused_gather_attention", "fused_gather_attention_ref",
           "paged_attention", "quantize_cast", "quantize_cast_sr",
           "quantize_add", "quantize_add_sr", "quantize_pack", "hop_pack",
           "sr_bits", "quantize_cast_ref", "quantize_cast_sr_ref",
           "quantize_add_ref", "quantize_add_sr_ref", "quantize_pack_ref",
           "hop_pack_ref", "sr_bits_ref"]
