"""Kernels of the port and their plain PyTorch versions."""

from .attention import grouped_query_attention, local_attention
from .flash_gqa import (flash_gqa_bwd, flash_gqa_bwd_ref, flash_gqa_fwd,
                        flash_gqa_fwd_ref)
from .flash_mha import (flash_mha_bwd, flash_mha_bwd_ref, flash_mha_fwd,
                        flash_mha_fwd_ref)
from .qgemm import qgemm_faithful, qgemm_faithful_ref
from .quantize import (hop_pack, hop_pack_ref, quantize_add,
                       quantize_add_ref, quantize_add_sr, quantize_add_sr_ref,
                       quantize_cast, quantize_cast_ref, quantize_cast_sr,
                       quantize_cast_sr_ref, quantize_pack, quantize_pack_ref,
                       sr_bits, sr_bits_ref)
from .serve_attn import (fused_gather_attention, fused_gather_attention_ref,
                         paged_attention)

__all__ = ["grouped_query_attention", "local_attention", "flash_gqa_fwd",
           "flash_gqa_bwd", "flash_gqa_fwd_ref", "flash_gqa_bwd_ref",
           "flash_mha_fwd", "flash_mha_bwd",
           "flash_mha_fwd_ref", "flash_mha_bwd_ref",
           "qgemm_faithful", "qgemm_faithful_ref",
           "fused_gather_attention", "fused_gather_attention_ref",
           "paged_attention", "quantize_cast", "quantize_cast_sr",
           "quantize_add", "quantize_add_sr", "quantize_pack", "hop_pack",
           "sr_bits", "quantize_cast_ref", "quantize_cast_sr_ref",
           "quantize_add_ref", "quantize_add_sr_ref", "quantize_pack_ref",
           "hop_pack_ref", "sr_bits_ref"]
