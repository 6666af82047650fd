#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`cpd_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases; any failure exits non-zero:

1. build every CUDA kernel of the port from the sources in the checkout
   (``build/cuda/``, keyed by a hash of the sources, one nvcc per source,
   all started together) and print the card's name and power limit;
2. hold the fused attention kernel (K12) against its plain PyTorch
   version on the card, at the serving slice's shapes, over the KV formats
   (4,3), (5,2), (8,23), blocked (4,3) with block 32, and (4,3) with
   NaN-coded bytes past every slot's last live position: digests bitwise,
   attention within ``ATTN_ATOL``/``ATTN_RTOL``; time the kernel, the
   plain version and one library call (attention only — not the same
   function);
3. hold the quantize kernels (K1 cast, K3 add-and-cast, K6 first ring
   hop, K5 later ring hop) against their plain versions, BITWISE (fp32
   outputs, wire bytes, digests), at one ring chunk of the training slice
   and at an odd length, over the formats (5,2), (4,3), (5,7), (6,17) and,
   for K1/K3, (8,23) and (5,1); inputs at an APS-like scale plus a block
   of special values; time each kernel and its plain version over input
   sets that together hold twice the L2, so the inputs come from HBM;
4. serve a 16-request mixed trace end to end at the full width of the
   repo's transformer LM (vocab 32000, d_model 512, 4 layers, 8 heads,
   2 kv heads, d_ff 2048; random weights from a seeded generator) with
   ``fused_attn=True``, check every request finished and the kernel ran
   once per layer per decode step, then serve the same trace with the
   plain read path and require the same tokens and logits within
   ``LOGIT_ATOL``;
5. profile 30 engine steps of a fresh fused engine (device busy share,
   kernel launches and the heaviest kernels per step);
6. train full-width ResNet-18/CIFAR (11.2 M parameters, weights from
   seed 24) on a `LocalMesh` of 4 data-parallel ranks on the card, batch
   128 per rank on the synthetic CIFAR-10 with the port's sampler and
   augmentation: 5 steps of the APS (5,2) RTNE ring reduce through the
   kernels, then the same 5 steps from the same start through the plain
   versions — losses, weights and BN stats bitwise equal; one step's
   gradients through the ring equal `ring_oracle_sum` bitwise, and through
   the faithful reduce (K3 on the slice's buckets) equal with the kernels
   and with the plain versions; the kernels' launch counts as designed;
   then 3 iterations of the trainer CLI in faithful mode (K3);
7. hold the stochastic-rounding kernels (the `sr_bits` helper, K2, K4
   and the SR arms of K6/K5) against their plain versions, BITWISE, over
   the formats (5,2), (4,3), (5,7), (6,17) and, for K2/K4, (8,23), (5,1)
   and (2,1), at the ring chunk and an odd length, bits drawn from
   offsets that wrap past 2^32; time each as in phase 3 (``sr_bits``
   against the time its integer instructions take on their pipes, counted
   in the SASS of the build);
8. train the same slice with the SR ring: 3 steps of APS (5,2) with
   ``grad_rounding="stochastic"``, ``grad_seed=0`` through the kernels
   and through the plain versions — bitwise equal; one step's gradients
   through the SR ring equal `ring_oracle_sum(key=)`; the launch counts
   as designed; then the reduce matrix {faithful, ring} x {nearest,
   stochastic} x {Kahan off, on} on one step's gradients, kernels vs
   plain versions, bitwise; then 3 iterations of the trainer CLI with
   ``--mode faithful --use_APS --use_kahan --grad-rounding stochastic``;
9. the block-scaled, verified ring: (a) hold the blocked arms of K6 and
   K5 (RTNE and SR, with and without digests) against their plain
   versions, BITWISE (fp32 partials, every wire byte with the sidecar,
   digests), over the formats (4,3), (5,2), (5,7) and blocks 128, 1024
   and 65536, at the ring chunk and at an odd length whose last block is
   short, and K7 (`digest_rows`) at the gathered wire of the largest
   bucket (4 rows) and at W = 2 and 8 with an odd byte count; time them
   as in phase 3; (b) train 3 steps of APS (4,3) with ``block_scale``,
   block 128, ``verify_reduce`` through the kernels and through the
   plain versions — bitwise equal, ``reduce_ok`` 1 on every step — with
   the launches as designed, and hold one step's buckets through the
   blocked ring to ``ring_oracle_sum(block_scale=True)``; (c) one step
   each with a flip, stale and drop wire fault on rank 2: the metrics
   ``hop_bad 1, gather_bad 1, agree 0, ok 0`` through the kernels and the
   plain versions, and fault code 0 bitwise the clean step; (d) one SR
   step (seed 0), kernels == plain, the SR blocked ring == the oracle
   with the key; (e) 3 iterations of the trainer CLI with
   ``--mode ring --use_APS --grad_exp 4 --grad_man 3 --block-scale
   --block-size 128``;
10. the GQA transformer LM: (a) hold K8 (`qgemm_faithful`, the tile
   kernel of ``qgemm.cu``) against its plain scan, BITWISE, over the
   formats (4,3), (5,2), (5,10), (8,23) and (2,1) at odd shapes, shapes
   past its 32 x 32 output tile and a K past two 32-step chunks, and at
   e4m3 at the slice's four FFN GEMM shapes whole, with rows that
   saturate, land on the format's subnormals and carry past the max; the
   cast probe: K8 at K = 1 on all 2^32 fp32 bit patterns against the
   plain scan for each of those formats, and on boundary patterns
   (`qgemm.cast_probe_patterns`) for all 192 formats against the plain
   scan and the generic kernel it replaced; its registers and spills (no
   spills); time it at the four shapes in turns with the generic kernel
   (``qgemm.generic_launcher``), gated at ``QGEMM_SPEEDUP_FLOOR`` at the
   main shape and no slower at any, against the bound of the SASS
   instructions its Kahan step issues on the busiest pipe along the
   paths the timed data takes, its plain version at a small shape; (b)
   hold K9 and K10 against their
   plain versions within ``FLASH_ATOL`` / ``FLASH_GRAD_ATOL`` at the
   slice's shape (B=4, T=1024, H=8, H_kv=2, D=64, causal), with pad keys
   (T=1000), at rep 1 and 2, non-causal and at head_dim 32, two launches
   bitwise equal in each case (fp32: the 3xTF32 tensor-core kernels of
   ``flash_f32_tc.cu``); time them by device time in turns with the
   CUDA-core template they replace (``flash_gqa.core_launchers``), which
   they must beat ``F32_TC_SPEEDUP_FLOOR``-fold, beside their plain
   versions, their bound at 3xTF32's 165 TFLOP/s (fp32's 67 and one TF32
   product's 495 beside it), and `scaled_dot_product_attention` with
   ``enable_gqa`` and with K/V expanded to the query heads (each form's
   backend pinned and printed; forward, backward alone and forward +
   backward); time K9/K10's bf16 arm (the tensor-core kernels of
   ``flash_mha_tc.cu``) at the same shape in turns with ``flash_gqa.cu``'s
   bf16 templates, which it must beat ``TC_SPEEDUP_FLOOR``-fold, beside
   its plain version, its bf16 tensor-core bound and SDPA bf16 on K/V
   expanded; (c) train the LM at full
   width (vocab 32000, d_model 512, 4 layers, 8 heads, 2 kv heads, d_ff
   2048; seeded random weights) on a `LocalMesh` of 2 ranks, 4
   sequences of 1024 random tokens each, 3 steps of ``--attn-impl flash
   --flash-bwd pallas``, the e4m3 faithful FFN and the APS (5,2)
   faithful reduce: finite losses, step 0 within ``LM_LOSS_BAND`` of ln
   32000, launches as designed (per rank-step 24
   K8, 4 K9, 4 K10), tokens/s, the step's split and each kernel's device
   ms; K8 on the operands of one rank-step's 24 calls (the forward's
   activations, the backward's gradients) bitwise the generic kernel and
   timed in turns with it, the rank-step's sum each way; then 2 steps
   with the fast FFN; (d) one full-width step at ffn
   (8,23) through K9/K10 and through their plain versions: loss and
   weights within ``LM_LOSS_RTOL`` / ``LM_WEIGHT_ATOL``; (e) a small
   faithful LM, 2 steps through every kernel and through every plain
   version: losses within ``LM_SMALL_LOSS_RTOL``, and its FFN GEMMs on
   the run's own inputs bitwise; (f) 2 iterations of the LM trainer CLI
   at the slice's flags;
11. bench.py's bf16 MHA transformer LM: (a) hold K11 (`flash_mha_fwd`,
   `flash_mha_bwd`: the MHA flash kernel, forward with its LSE and its own
   backward; bf16 on the tensor-core kernels of ``flash_mha_tc.cu``,
   fp32 on the 3xTF32 tensor-core kernels of ``flash_f32_tc.cu``) against
   its plain version at head_dim 32, 64 and 128, fp32 and bf16, causal
   and not, at Tq != Tk either way and at the LM's shapes (fp32 within
   ``FLASH_ATOL`` / ``FLASH_GRAD_ATOL``, bf16 within ``BF16_RTOL`` /
   ``BF16_ATOL``), the
   bf16 forward at a Tq that is not a multiple of its 64-row tile, and
   K9/K10's bf16 arm over ``GQA_BF16_CASES`` (rep 1, 2, 4; head_dim 32,
   64, 128; causal and not; pad keys; Tq != Tk either way with a ragged
   Tq in the backward), two launches bitwise equal in every case; print
   both tensor-core libraries' registers, spills and shared memory
   (neither may spill); time K11 at (4,
   1024, 8, 64) in bf16 and fp32 and at (4, 1024, 4, 128) in bf16 beside
   its plain version, its bound, SDPA's forward and backward and, in
   turns, the CUDA-core template it replaces (``flash_gqa.cu`` at H_kv =
   H), which it must beat ``TC_SPEEDUP_FLOOR``-fold in bf16 and
   ``F32_TC_SPEEDUP_FLOOR``-fold in fp32 at the LM's shape;
   (b) train bench.py's LM arm (vocab 32000, d_model 512, 8 layers, 8
   heads, d_ff 2048, bf16 compute over fp32 weights, seeded random
   weights) through K11 on a `LocalMesh` of 2 ranks, 4 sequences of 1024
   random tokens each, 3 steps of the APS e5m2 faithful reduce and SGD
   momentum 0.9 at a constant rate: finite losses, step 0 within
   ``LM_LOSS_BAND`` of ln 32000, launches as designed (8 K11 forwards and
   8 backwards per rank-step), tokens/s, the step's split, peak memory
   and K11's device ms per step; the same steps through the plain K11
   (losses within ``BENCH_LOSS_RTOL``); one ``remat`` step (16 K11
   forwards per rank-step, the same loss); tokens/s of the xla and
   chunked arms; (c) 2 iterations of the LM CLI with ``--bf16 --attn-impl
   flash --remat`` at 2 layers; (d) bench.py's GQA flash arm, the same LM
   with 2 kv heads and ``flash_bwd="pallas"``, 3 steps through K9/K10's
   bf16 kernels: finite losses, step 0 within ``LM_LOSS_BAND`` of ln
   32000, 8 K9 and 8 K10 launches per rank-step, tokens/s, the step's
   split, peak memory and K9/K10's device ms per step; the same steps
   through the plain K9/K10 (losses within ``BENCH_LOSS_RTOL``);
12. print one JSON line ``{"kernels": [...]}`` and, last,
   ``{"ok": true, "device": {...}}``.

The script imports neither jax nor the JAX package.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import math
import subprocess
import sys

# -- tolerances ------------------------------------------------------------
# The kernel's attention sums (64-term dots, the online softmax over up to
# 512 keys) run in another order than the plain version's einsum/softmax,
# so fp32 round-off differs: about n * 2^-24 * max|V| for n <= 512 summed
# terms and |V| <= 4, i.e. ~1.2e-4 in the worst case.  Digests are integer
# arithmetic and must match bit for bit.
ATTN_ATOL = 2e-4
ATTN_RTOL = 1e-4
# Logits of the fused engine vs the plain engine: the attention difference
# above, carried through 4 layers and the tied 32000-way head.
LOGIT_ATOL = 2e-3

# the entry points' default device, as a user calls them
DEVICE = "cuda"

# the serving slice (the JAX engine's defaults at the LM's full width)
MODEL = dict(vocab_size=32000, d_model=512, n_layers=4, n_heads=8,
             n_kv_heads=2, d_ff=2048)
ENGINE = dict(n_slots=8, max_seq=512, page_size=16, prefill_chunk=32,
              kv_format=(4, 3))
TRACE = dict(n_requests=16, prompt_lens=(64, 128, 256), max_new=(64, 128),
             seed=0)

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 FLOP/s outside the
# tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
# 132 SMs at the 1.98 GHz at which 128 fp32 lanes per SM give the sheet's
# 67 TFLOP/s.  Per SM and clock (CUDA programming guide, throughput of
# compute capability 9.0): 64 results of 32-bit integer shift, compare
# and logic instructions (the ALU pipe), 64 of 32-bit integer
# multiply-add (IMAD, on the FMA pipe), 128 integer adds and moves, which
# either pipe executes, 128 fp32 adds and multiplies, 16 conversions
# between 32-bit integer and float, and 4 schedulers issuing one warp
# instruction each, 128 thread instructions of any kind
SMS, CLOCK_HZ = 132, 1.98e9
PIPE_LANES = {"alu": 64, "imad": 64, "alu+imad": 128, "fp32": 128,
              "cvt": 16, "issue": 128}
# SASS opcodes by the pipe that executes them; "either" goes to the ALU
# or the FMA pipe, as the compiler places it
SASS_ALU = {"SHF", "LOP3", "ISETP", "LEA", "SEL", "PRMT", "IMNMX", "IABS",
            "PLOP3", "FSEL", "FSETP", "FMNMX", "BMSK", "SGXT", "VIMNMX"}
SASS_IMAD = {"IMAD", "IMUL", "IDP"}
SASS_EITHER = {"IADD3", "VIADD", "MOV", "IMAD.IADD", "IMAD.MOV"}
# fp32 add/multiply (128 per SM and clock) and 32-bit conversions (16)
SASS_FP32 = {"FADD", "FMUL", "FFMA"}
SASS_CVT = {"I2F", "F2I", "F2F", "I2FP", "F2IP", "FRND"}

# the training slice: full-width ResNet-18/CIFAR, W ranks on the one card
TRAIN = dict(world=4, per_rank_batch=128, steps=5, fmt=(5, 2), seed=24,
             n_train=50000, n_test=10000, peak_lr=1.6, cli_iters=3)
# the SR slice: the same model and mesh, the SR ring for SR_STEPS steps
SR_STEPS = 3
SR_SEED = 0
QUANT_ODD_N = 1_000_003
WIRE_FORMATS = ((5, 2), (4, 3), (5, 7), (6, 17))
CAST_FORMATS = WIRE_FORMATS + ((8, 23), (5, 1))
SR_CAST_FORMATS = CAST_FORMATS + ((2, 1),)
# the blocked, verified slice: e4m3 with 128-element blocks (the JAX
# package's headline point for the blocked wire, its default block)
BLOCKED = dict(fmt=(4, 3), block=128, steps=3, fault_rank=2)
BLOCKED_FORMATS = ((4, 3), (5, 2), (5, 7))
BLOCK_SIZES = (128, 1024, 65536)
# the LM slice: transformer_lm()'s full width with 2 kv heads (as served),
# the GQA flash kernels for attention (K9 forward, K10 backward) and the
# e4m3 faithful eXmY-accumulator FFN (K8), 2 dp ranks of 4 sequences of
# 1024 tokens on the one card, the APS (5,2) faithful reduce, SGD at the
# trainer CLI's constant schedule (--base-lr 0.01, --warmup-iters 20)
LM_MODEL = dict(vocab_size=32000, d_model=512, n_layers=4, n_heads=8,
                n_kv_heads=2, d_ff=2048)
LM_PATH = dict(attn_impl="flash", flash_bwd="pallas", ffn_exp=4, ffn_man=3,
               ffn_mode="faithful")
LM_TRAIN = dict(world=2, per_rank_batch=4, seq=1024, steps=3, fmt=(5, 2),
                seed=0, base_lr=0.01, warmup=20, cli_iters=2)
# (e): the whole faithful path kernels vs plain, small: the plain qgemm
# launches ~150 kernels per k step
LM_SMALL = dict(vocab_size=1024, d_model=128, n_layers=1, n_heads=4,
                n_kv_heads=2, d_ff=512)
LM_SMALL_TRAIN = dict(world=2, per_rank_batch=2, seq=128, steps=2)
QGEMM_FORMATS = ((4, 3), (5, 2), (5, 10), (8, 23), (2, 1))
# phase 10a: K8's tile kernel against the generic kernel it replaced
# (qgemm.generic_launcher), timed in turns at the slice's four FFN GEMM
# shapes on the same card: at least this many times faster at the main
# shape (4096,512)x(512,2048), and at none slower
QGEMM_SPEEDUP_FLOOR = 1.5
# K8's cast probe: every fp32 bit pattern through K8 at K = 1 for each of
# QGEMM_FORMATS, in chunks of this many; and cast_probe_patterns' boundary
# patterns, this many mantissas per exponent field and sign (2^20 per
# format), for all 192 formats
QGEMM_PROBE_CHUNK = 1 << 27
QGEMM_PROBE_PER_EXPONENT = 2048
# the SASS names of K8's tile kernel on the main path (eb <= 7, mb <= 21:
# exmy::cast_fadd) and of the kept generic kernel
QGEMM_TILE_KERNEL = "qgemm_tile_kernelINS_8FaddCast"
QGEMM_GENERIC_KERNEL = "qgemm_generic_kernel"
# K8's bound counts the work of a quantized Kahan step, (ALU-pipe, fp32)
# instructions, at the fewest the tile kernel's formulation needs: five
# casts of exmy::cast_fadd's 6 ALU and 5 fp32 instructions and the step's
# five fp32 ops; a zero step (the product casts to a zero, s and c are
# ±0) its product's cast and its five fp32 ops, since every later cast
# passes ±0 through.  No loads, moves, loop control, flags or votes.
QGEMM_STEP_WORK = (30, 30)
QGEMM_ZERO_STEP_WORK = (6, 10)
# step 0's loss lies within this of ln(vocab): at init the tied head's
# logits are ~N(0, 1) (unit-variance LayerNorm output against N(0, 1/d)
# embeddings), so the expected CE is ~ln V + 1/2
LM_LOSS_BAND = 1.0
# K9/K10 against their plain versions on the card, fp32 both: the kernels
# sum the 64-term dots in another order and fold the softmax over 64-key
# blocks (plain: one max and sum over up to 1024 keys), ~1e-7 relative
# per term; outputs and LSE are O(1), gradients sum up to 4 heads x 1024
# queries of such terms
FLASH_ATOL = 1e-5
FLASH_GRAD_ATOL = 1e-4
# (d) one full-width step, ffn (8, 23), fp32 reduce at a constant lr:
# kernels vs plain versions differ by the attention's round-off only
LM_LOSS_RTOL = 1e-5
LM_WEIGHT_ATOL = 1e-6
# (e) the e4m3 FFN: an FFN input within round-off of an e4m3 rounding
# boundary casts to the neighbouring code (1/16) on one side, which moves
# a step's loss by up to ~2e-3 relative (tests/test_torch_lm.py)
LM_SMALL_LOSS_RTOL = 5e-3
# the TPU kernels K8-K10 replace (K9/K10 in fp32, the LM's dtype)
LM_KERNELS = {"qgemm_faithful": ("cpd_tpu/ops/qgemm.py:64",
                                 "cpd_tpu_torch/csrc/qgemm.cu"),
              "flash_gqa_fwd": ("cpd_tpu/ops/flash_gqa.py:151",
                                "cpd_tpu_torch/csrc/flash_f32_tc.cu"),
              "flash_gqa_bwd": ("cpd_tpu/ops/flash_gqa.py:298",
                                "cpd_tpu_torch/csrc/flash_f32_tc.cu")}
PEAK_TF32_FLOPS = 495e12
# fp32-accurate products on the TF32 tensor cores: 3xTF32 takes three
# TF32 products for one fp32 one
PEAK_3XTF32_FLOPS = PEAK_TF32_FLOPS / 3
# the fp32 attention kernels (flash_f32_tc.cu, 3xTF32) against the
# CUDA-core template they replace (flash_gqa.cu's fp32 arm), timed in
# turns on the same card: at least this many times faster, forward and
# backward, at the LM shapes of K11 (rep 1) and K9/K10 (rep 4)
F32_TC_SPEEDUP_FLOOR = 2.0
# the bf16 MHA LM slice: bench.py's LM arm (bench.py:505-540: vocab 32000,
# d_model 512, 8 layers, 8 heads, d_ff 2048, bf16 compute over fp32
# masters, seq 1024, 8 sequences per chip, SGD momentum 0.9, e5m2 APS)
# through the MHA flash kernel K11, 2 dp ranks of 4 sequences on the
# card, at a constant rate; the CLI at 2 layers
BENCH_LM = dict(vocab_size=32000, d_model=512, n_layers=8, n_heads=8,
                d_ff=2048)
BENCH_TRAIN = dict(world=2, per_rank_batch=4, seq=1024, steps=3, fmt=(5, 2),
                   seed=0, lr=0.01, arm_steps=2, cli_iters=2, cli_layers=2)
# H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
# K11 against its plain version: fp32 as K9/K10 (FLASH_ATOL,
# FLASH_GRAD_ATOL); bf16 within the JAX package's flash-vs-xla
# tolerance, rtol = atol = 2e-2 (tests/test_attention_lm.py): p, ds and
# each output are rounded to bf16 at values that the kernel's blocked sums
# and the plain whole-row sums leave one fp32 round-off apart
BF16_RTOL = BF16_ATOL = 2e-2
# the plain K11 steps against the kernel's: a bf16 rounding flipped by
# round-off moves the loss well inside this
BENCH_LOSS_RTOL = 1e-2
# the bf16 tensor-core kernels (flash_mha_tc.cu) against the CUDA-core
# template they replace (flash_gqa.cu's bf16 arm), timed in the same run
# on the same card: at least this many times faster, forward and
# backward, at the bf16 LMs' shapes of K11 (rep 1) and K9/K10 (rep 4)
TC_SPEEDUP_FLOOR = 3.0
MHA_KERNELS = {"flash_mha_fwd": "cpd_tpu/ops/attention.py:116",
               "flash_mha_bwd": "cpd_tpu/ops/attention.py:116"}
# bench.py's GQA flash arm (bench.py:541-578): the bf16 LM above with 2 kv
# heads through K9 and K10's own backward, on flash_mha_tc.cu
GQA_PATH = dict(n_kv_heads=2, flash_bwd="pallas")
GQA_BF16_KERNELS = {"flash_gqa_fwd": "cpd_tpu/ops/flash_gqa.py:151",
                    "flash_gqa_bwd": "cpd_tpu/ops/flash_gqa.py:298"}
# K9/K10 bf16 against their plain versions (phase 11a, two launches each,
# bitwise equal): (B, Tq, Tk, H, H_kv, D, causal) -- the GQA LM's shape;
# rep 1, 2, 4; head_dim 32, 64, 128, causal and not; pad keys (T = 1000);
# Tq < Tk and Tq > Tk with ragged Tq in the backward; both below a tile
GQA_BF16_CASES = [(4, 1024, 1024, 8, 2, 64, True),
                  (2, 256, 256, 4, 4, 64, True), (2, 256, 256, 4, 2, 64, True),
                  (2, 256, 256, 8, 2, 64, True),
                  (2, 256, 256, 8, 2, 64, False),
                  (2, 256, 256, 8, 2, 32, True),
                  (2, 256, 256, 8, 2, 128, True),
                  (2, 256, 256, 4, 2, 128, False),
                  (2, 1000, 1000, 8, 2, 64, True),
                  (2, 200, 256, 8, 2, 64, True),
                  (2, 200, 256, 4, 1, 128, False),
                  (2, 384, 128, 8, 2, 64, True),
                  (2, 384, 128, 8, 2, 32, False),
                  (1, 77, 33, 4, 2, 64, True)]
NO_LIBRARY_QGEMM = ("no PyTorch call computes a product whose every "
                    "step is re-cast to eXmY: torch.matmul is printed "
                    "beside it and is not the same function")

# K6/K5 blocked and K7: the TPU kernel each replaces, and the bytes one
# call moves for n elements, wb wire bytes, nb blocks (each input read
# once, each output written once; SR round bits are 4 bytes), and the
# fp32 operations per element (the exact power-of-two multiplies: the
# received unscale, the block scale, the cast, the unscale; the add)
BLOCKED_KERNELS = {
    "quantize_pack_blocked": ("cpd_tpu/ops/quantize.py:634 (block_size arm)",
                              lambda n, wb, nb: n * (8 + wb) + nb, 6),
    "quantize_pack_blocked_sr": (
        "cpd_tpu/ops/quantize.py:634 (block_size + rbits arm)",
        lambda n, wb, nb: n * (12 + wb) + nb, 6),
    "hop_pack_blocked": ("cpd_tpu/ops/quantize.py:512 (block_size arm)",
                         lambda n, wb, nb: 2 * (n * (4 + wb) + nb), 9),
    "hop_pack_blocked_sr": (
        "cpd_tpu/ops/quantize.py:512 (block_size + rbits arm)",
        lambda n, wb, nb: 2 * (n * (4 + wb) + nb) + 4 * n, 9),
}
# K7 at W rows of B bytes reads W * B bytes; its integer work is a
# multiply-add and a modulo per byte, below its bytes at 3.35 TB/s
DIGEST_ROWS = ("cpd_tpu/ops/quantize.py:582", "digest_rows_pallas")
# K1-K6 and the SR helper: the TPU kernel each replaces, and the bytes one
# element moves (each input read once, each output written once; wb =
# wire bytes; SR round bits are 4 bytes)
QUANT_KERNELS = {
    "quantize_cast": ("cpd_tpu/ops/quantize.py:69", lambda wb: 8),
    "quantize_cast_sr": ("cpd_tpu/ops/quantize.py:170", lambda wb: 12),
    "quantize_add": ("cpd_tpu/ops/quantize.py:107", lambda wb: 12),
    "quantize_add_sr": ("cpd_tpu/ops/quantize.py:137", lambda wb: 16),
    "quantize_pack": ("cpd_tpu/ops/quantize.py:634", lambda wb: 8 + wb),
    "quantize_pack_sr": ("cpd_tpu/ops/quantize.py:634 (rbits arm)",
                         lambda wb: 12 + wb),
    "hop_pack": ("cpd_tpu/ops/quantize.py:512", lambda wb: 2 * (4 + wb)),
    "hop_pack_sr": ("cpd_tpu/ops/quantize.py:512 (rbits arm)",
                    lambda wb: 12 + 2 * wb),
    "sr_bits": ("cpd_tpu/quant/numerics.py:240 (sr_bits_at; XLA, no TPU "
                "kernel)", lambda wb: 4),
}
# fp32 operations per element of the casts (the exact power-of-two
# multiplies and the adds); sr_bits is integer work, bounded by
# `sass_per_element` instead
QUANT_OPS = {"quantize_cast": 2, "quantize_cast_sr": 2, "quantize_add": 3,
             "quantize_add_sr": 3, "quantize_pack": 2,
             "quantize_pack_sr": 2, "hop_pack": 5, "hop_pack_sr": 5}
# profiler names of the kernels (template instantiations of quantize.cu)
KERNEL_NAMES = {"quantize_cast": "cast_kernel<false, false>",
                "quantize_cast_sr": "cast_kernel<false, true>",
                "quantize_add": "cast_kernel<true, false>",
                "quantize_add_sr": "cast_kernel<true, true>",
                "quantize_pack": "wire_kernel<true, false>",
                "quantize_pack_sr": "wire_kernel<true, true>",
                "hop_pack": "wire_kernel<false, false>",
                "hop_pack_sr": "wire_kernel<false, true>",
                "quantize_pack_blocked": "blocked_wire_kernel<true, false",
                "quantize_pack_blocked_sr": "blocked_wire_kernel<true, true",
                "hop_pack_blocked": "blocked_wire_kernel<false, false",
                "hop_pack_blocked_sr": "blocked_wire_kernel<false, true",
                "digest_rows": "digest_rows_kernel",
                "sr_bits": "sr_bits_kernel",
                "qgemm_faithful": "::qgemm_tile_kernel<",
                # fp32 on flash_f32_tc.cu, bf16 on flash_mha_tc.cu
                "flash_gqa_fwd": ("::f32tc_fwd_kernel<", "::fwd_kernel<"),
                "flash_gqa_bwd": ("::f32tc_dq_kernel<", "::f32tc_dkv_kernel<",
                                  "rep_sum_kernel", "::dq_kernel<",
                                  "::dkv_kernel<"),
                # K11 (bf16 flash_mha_tc.cu, fp32 flash_f32_tc.cu at rep =
                # 1) shares its kernels with K9/K10: a profile tells them
                # apart only in a run of one of them
                "flash_mha_fwd": ("::fwd_kernel<", "::f32tc_fwd_kernel<"),
                "flash_mha_bwd": ("::dq_kernel<", "::dkv_kernel<",
                                  "::f32tc_dq_kernel<",
                                  "::f32tc_dkv_kernel<")}
NO_LIBRARY = ("no PyTorch call computes the eXmY cast: .to(torch.float8_*) "
              "rounds and saturates differently, so it is not the same "
              "function")
NO_LIBRARY_DIGEST = ("no PyTorch call computes a position-weighted "
                     "Fletcher digest mod 65521")
NO_LIBRARY_BITS = ("no PyTorch call computes jax.random's threefry2x32 "
                   "bits: torch's generators are Philox and give other "
                   "numbers")

KV_CASES = (("e4m3", (4, 3), None, False),
            ("e5m2", (5, 2), None, False),
            ("e8m23", (8, 23), None, False),
            ("e4m3-blocked32", (4, 3), 32, False),
            ("e4m3-nan-tail", (4, 3), None, True))


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def card_line() -> str:
    """``name, power limit`` as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of one ``fn()`` call, from CUDA events around
    ``iters`` back-to-back calls after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, warmup: int = 3) -> float:
    """Device time of the kernels one ``fn()`` call launches, summed and
    averaged over ``iters`` calls under torch.profiler.  Unlike
    `time_ms`, host dispatch between back-to-back calls does not count.
    Every call launches at least one kernel; where the profiler records
    fewer kernels than calls (seen on the card late in a long run, when
    it kept one launch in twenty), the time comes from CUDA events
    (`time_ms`) and a line says so."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    if sum(e.count for e in kernels) < iters:
        print(f"  (torch.profiler recorded {sum(e.count for e in kernels)} "
              f"kernels for {iters} calls: timed with CUDA events instead)",
              flush=True)
        return time_ms(fn, iters, warmup=0)
    return sum(e.self_device_time_total for e in kernels) / 1e3 / iters


def queued_ms(fn, iters: int, warmup: int = 3) -> float:
    """Device time of one ``fn()`` call without the profiler: CUDA events
    around ``iters`` back-to-back calls queued behind a spin kernel
    (``torch.cuda._sleep``), so that host dispatch slower than the
    kernels does not count.  The spin is lengthened until it was still
    running when the last call had been queued."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles = 10_000_000                 # ~5 ms at the card's clock
    for _ in range(5):
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued = not start.query()      # the spin had not yet ended
        torch.cuda.synchronize()
        if queued:
            return start.elapsed_time(end) / iters
        cycles *= 4
    raise AssertionError(f"host dispatch of {iters} calls outlasted a spin "
                         f"of {cycles // 4} cycles")


def device_kernels_ms(fn, iters: int) -> dict:
    """Device ms per ``fn()`` call of each kernel it launches (by the
    profiler's name) over ``iters`` calls under torch.profiler, or ``{}``
    where the profile is not whole (a launch count that is not a whole
    number per call: the profiler drops records in a long run)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    n = sum(e.count for e in kernels)
    if n < iters or n % iters:
        return {}
    return {e.key: e.self_device_time_total / 1e3 / iters for e in kernels}


def kv_case(cfg, n_slots: int, max_pages: int, nan_tail: bool,
            generator, device):
    """Inputs of one fused-attention call at the slice's shapes: a pool of
    random K/V packed in ``cfg``'s format (so every byte is a valid code
    of it), trash-padded page tables of distinct pages per slot, random
    live lengths, decode queries.  ``nan_tail`` fills every position past
    a slot's last live one, and the trash page, with NaN codes."""
    import torch

    from cpd_tpu_torch.quant.numerics import pack_exmy
    from cpd_tpu_torch.serve.kvcache import pack_kv

    ps, hkv, hd = cfg.page_size, cfg.n_kv_heads, cfg.head_dim
    raw = torch.randn((cfg.n_pages, 2, ps, hkv, hd), generator=generator,
                      device=device)
    pool = pack_kv(raw, cfg)
    t_cap = max_pages * ps
    last = torch.randint(1, t_cap, (n_slots,), generator=generator,
                         device=device, dtype=torch.int32)
    perm = torch.randperm(cfg.n_pages - 1, generator=generator,
                          device=device) + 1
    rows = torch.zeros((n_slots, max_pages), dtype=torch.int32,
                       device=device)
    for s in range(n_slots):
        own = int(last[s]) // ps + 1
        rows[s, :own] = perm[s * max_pages:s * max_pages + own].to(torch.int32)
    if nan_tail:
        nan_code = pack_exmy(torch.tensor(float("nan"), device=device),
                             cfg.exp_bits, cfg.man_bits)
        pool[0] = nan_code
        for s in range(n_slots):
            lp = int(last[s])
            page = int(rows[s, lp // ps])
            pool[page, :, lp % ps + 1:] = nan_code
    q = torch.randn((n_slots, 1, MODEL["n_heads"], hd),
                    generator=generator, device=device)
    return pool, q, rows, last[:, None].contiguous(), last


def bound_ms(pool, q, rows, positions, last, cfg) -> tuple:
    """(least time in ms, "bytes" or "operations") for one fused call on
    these inputs: each distinct gathered page, q, the page table and the
    positions read once, attn and the digests written once; the
    operations of both attention contractions over each slot's unmasked
    keys, at fp32 peak."""
    import torch

    n_pages = int(torch.unique(rows).numel())
    n_bytes = (n_pages * cfg.page_bytes + q.numel() * 4 + rows.numel() * 4
               + positions.numel() * 4 + last.numel() * 4
               + q.numel() * 4 + rows.numel() * 4)
    keys = int((positions[:, 0].clamp(max=rows.shape[1] * cfg.page_size - 1)
                + 1).sum())
    h, d = q.shape[2], q.shape[3]
    ops = 4 * h * d * keys
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def library_attention_ms(pool, q, rows, positions, last, cfg) -> float:
    """`scaled_dot_product_attention` over K/V already gathered, unpacked
    and expanded to the query heads: attention only, not the same
    function (no gather, no decode, no digests)."""
    import torch
    import torch.nn.functional as F

    from cpd_tpu_torch.serve.kvcache import unpack_kv

    s_count, max_pages = rows.shape
    t_cap = max_pages * cfg.page_size
    kv = unpack_kv(pool[rows.long()], cfg)
    rep = q.shape[2] // cfg.n_kv_heads
    k = kv[:, :, 0].reshape(s_count, t_cap, cfg.n_kv_heads, cfg.head_dim)
    v = kv[:, :, 1].reshape(s_count, t_cap, cfg.n_kv_heads, cfg.head_dim)
    k = k.transpose(1, 2).repeat_interleave(rep, dim=1).contiguous()
    v = v.transpose(1, 2).repeat_interleave(rep, dim=1).contiguous()
    qh = q.transpose(1, 2).contiguous()                  # (S, H, 1, D)
    ki = torch.arange(t_cap, device=q.device)
    mask = (ki[None, :] <= positions.long())[:, None, None, :]
    return time_ms(lambda: F.scaled_dot_product_attention(
        qh, k, v, attn_mask=mask), iters=200)


def kernel_phase(device) -> dict:
    """Phase 2: the fused attention kernel against its plain version."""
    import torch

    from cpd_tpu_torch.ops import serve_attn
    from cpd_tpu_torch.serve.kvcache import KVCacheConfig

    max_pages = -(-ENGINE["max_seq"] // ENGINE["page_size"])
    n_pages = 1 + ENGINE["n_slots"] * max_pages
    gen = torch.Generator(device=device).manual_seed(1234)
    report = {"cases": {}}
    for name, fmt, block, nan_tail in KV_CASES:
        cfg = KVCacheConfig(
            n_layers=1, n_kv_heads=MODEL["n_kv_heads"],
            head_dim=MODEL["d_model"] // MODEL["n_heads"],
            page_size=ENGINE["page_size"], n_pages=n_pages,
            exp_bits=fmt[0], man_bits=fmt[1], block_scale=block is not None,
            block_size=block or 32)
        args = kv_case(cfg, ENGINE["n_slots"], max_pages, nan_tail, gen,
                       device)
        attn, dig = serve_attn.fused_gather_attention(*args, cfg=cfg)
        torch.cuda.synchronize()
        want, want_dig = serve_attn.fused_gather_attention_ref(*args, cfg=cfg)
        if not torch.equal(dig, want_dig):
            raise AssertionError(f"{name}: digests differ from the plain "
                                 f"version at {int((dig != want_dig).sum())}"
                                 " pages")
        if torch.isnan(attn).any() or torch.isnan(want).any():
            raise AssertionError(f"{name}: NaN in a live slot's attention")
        err = float((attn - want).abs().max())
        if not torch.allclose(attn, want, rtol=ATTN_RTOL, atol=ATTN_ATOL):
            raise AssertionError(f"{name}: attention differs from the "
                                 f"plain version by {err}")
        ms = time_ms(lambda: serve_attn.fused_gather_attention(*args,
                                                               cfg=cfg),
                     iters=200)
        plain_ms = time_ms(lambda: serve_attn.fused_gather_attention_ref(
            *args, cfg=cfg), iters=20)
        lib_ms = library_attention_ms(*args, cfg)
        b_ms, b_by = bound_ms(*args, cfg)
        report["cases"][name] = dict(max_abs_err=err, ms=ms,
                                     plain_ms=plain_ms, library_ms=lib_ms,
                                     bound_ms=b_ms, bound_by=b_by)
        print(f"kernel serve_attn [{name}]: digests bitwise, attn max abs "
              f"err {err:.3e} (atol {ATTN_ATOL}, rtol {ATTN_RTOL}); "
              f"kernel_ms {ms:.5f} plain_ms {plain_ms:.5f} bound_ms "
              f"{b_ms:.6f} ({b_by}) library_ms {lib_ms:.5f} (attention "
              "only; not the same function)", flush=True)
    return report


def same_bits(a, b) -> bool:
    """Bitwise equality of two tensors (NaN payloads and -0.0 count)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dim() == 0:
        return bool(a == b)
    return torch.equal(a.contiguous().view(torch.uint8),
                       b.contiguous().view(torch.uint8))


def max_abs_diff(a, b) -> float:
    """Largest ``|a - b|`` over the elements in float64; elements that are
    equal, or NaN in both, count 0 (a NaN against a number counts Inf)."""
    import torch

    a, b = a.to(torch.float64), b.to(torch.float64)
    d = torch.nan_to_num((a - b).abs(), nan=math.inf)
    d = torch.where((a == b) | (a.isnan() & b.isnan()), 0.0, d)
    return float(d.max()) if d.numel() else 0.0


def l2_bytes() -> int:
    """The card's L2 size (50 MB on an H100 SXM where torch does not say)."""
    import torch

    return int(getattr(torch.cuda.get_device_properties(0),
                       "L2_cache_size", 50 * 2**20))


def _sass_loops(library: str, kernel: str) -> tuple:
    """``kernel``'s SASS in ``library``'s build (`cuobjdump`): its
    opcodes in order; for each backward branch, the loop body it closes
    as (first index, branch index); and each branch's index -> (target
    index or None, whether it is guarded by a predicate)."""
    from cpd_tpu_torch.ops.build import sass

    return _parse_sass(sass(library), kernel)


def _parse_sass(text: str, kernel: str) -> tuple:
    """`_sass_loops` on ``cuobjdump -sass`` output ``text``."""
    import re

    insns, labels, raw, found = [], {}, {}, False
    for line in text.splitlines():
        if "Function :" in line:
            if found:
                break
            found = kernel in line
            continue
        label = re.match(r"\s*(\.L_x_\d+):", line)
        if found and label:
            labels[label.group(1)] = len(insns)
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)(.*)", line)
        if not (found and m):
            continue
        insns.append((int(m.group(1), 16), m.group(3)))
        if m.group(3).split(".")[0] == "BRA":
            to = re.search(r"(\.L_x_\d+|0x[0-9a-f]+)", m.group(4))
            # guarded: a predicate before it or among its operands
            # (``BRA.DIV UR4, target``, ``BRA.U !UP0, target``)
            raw[len(insns) - 1] = (to and to.group(1), bool(
                m.group(2)) or "," in m.group(4))
    if not insns:
        raise AssertionError(f"no SASS of {kernel} in the SASS given")
    at = {a: i for i, (a, _) in enumerate(insns)}
    branches, loops = {}, []
    for i, (to, guarded) in raw.items():
        target = (labels.get(to) if to and to.startswith(".")
                  else at.get(int(to, 16)) if to else None)
        branches[i] = (target, guarded)
        if target is not None and target < i:
            loops.append((target, i))
    return [op for _, op in insns], loops, branches


def _sass_pipe(op: str) -> str:
    if op.startswith(("IMAD.IADD", "IMAD.MOV")) or op in SASS_EITHER:
        return "either"
    base = op.split(".")[0]
    if base in SASS_EITHER:
        return "either"
    if base in SASS_ALU:
        return "alu"
    if base in SASS_IMAD:
        return "imad"
    if base in SASS_FP32:
        return "fp32"
    return "cvt" if base in SASS_CVT else "other"


def _by_pipe(ops: list, per: float) -> dict:
    """Instructions of ``ops`` by pipe, divided by ``per``."""
    count = {k: sum(_sass_pipe(op) == k for op in ops) / per
             for k in ("alu", "imad", "either", "fp32", "cvt")}
    out = {"alu": count["alu"], "imad": count["imad"],
           "alu+imad": count["alu"] + count["imad"] + count["either"],
           "fp32": count["fp32"], "cvt": count["cvt"],
           "issue": len(ops) / per}
    out["opcodes"] = {op: ops.count(op) for op in sorted(set(ops))}
    return out


def sass_per_element(library: str, kernel: str) -> dict:
    """Instructions one element of ``kernel`` issues, by pipe: the body
    of its grid-stride loop (its largest loop: from the target of a
    backward branch to the branch) in the SASS of ``library``'s build,
    divided by the global stores in it (one per element)."""
    insns, loops, _ = _sass_loops(library, kernel)
    start, end = max(loops, key=lambda se: se[1] - se[0], default=(0, -1))
    ops = insns[start:end + 1] if loops else insns
    stores = max(1, sum(op.split(".")[0] in ("STG", "ST") for op in ops))
    return _by_pipe(ops, stores)


def _inner_loops(loops: list) -> list:
    """The loop bodies that hold no other loop."""
    return [(s, e) for s, e in loops
            if not any(s < s2 <= e and (s2, e2) != (s, e)
                       for s2, e2 in loops)]


def _inner_loop(loops: list) -> tuple:
    """The largest loop body that holds no other loop."""
    inner = _inner_loops(loops)
    if not inner:
        raise AssertionError("no loop in the SASS")
    return max(inner, key=lambda se: se[1] - se[0])


def _fast_loop(insns: list, loops: list) -> tuple:
    """The largest innermost loop whose body converts nothing: K8's tile
    loop, and not the fallback loop beside it, whose reference cast
    rebuilds its value with an integer-to-float conversion."""
    fast = [(s, e) for s, e in _inner_loops(loops)
            if not any(_sass_pipe(op) == "cvt" for op in insns[s:e + 1])]
    if not fast:
        raise AssertionError("no innermost loop without conversions")
    return max(fast, key=lambda se: se[1] - se[0])


def loop_paths(insns: list, loop: tuple, branches: dict,
               steps: int = 1) -> dict:
    """The shortest and the longest path of instructions one pass of the
    loop ``loop`` (first index, closing branch) issues, from its first
    instruction to its closing branch, through the forward branches of its
    body (a guarded branch may fall through, an unguarded one may not; an
    edge that leaves the body is no path of a pass), by pipe and divided
    by the ``steps`` one pass computes: ``short`` and ``long``."""
    start, end = loop
    best = {}
    for i in range(end, start - 1, -1):
        if i == end:
            best[i] = ((1, [i]), (1, [i]))
            continue
        target, guarded = branches.get(i, (None, True))
        nxt = [j for j in ((i + 1) if guarded else None,
                           target if i in branches else None)
               if j is not None and i < j <= end]
        if not nxt:
            raise AssertionError(f"SASS {i}: no path on to the loop's "
                                 "closing branch")
        lo = min((best[j][0] for j in nxt), key=lambda c: c[0])
        hi = max((best[j][1] for j in nxt), key=lambda c: c[0])
        best[i] = ((lo[0] + 1, [i] + lo[1]), (hi[0] + 1, [i] + hi[1]))
    (_, short), (_, long) = best[start]
    return {"short": _by_pipe([insns[i] for i in short], steps),
            "long": _by_pipe([insns[i] for i in long], steps)}


def pipe_bound_s(per_element: dict, n: int) -> tuple:
    """(seconds, pipe): the least time ``n`` elements' instructions take
    on the busiest pipe of the card, the adds and moves placed on the
    ALU or the FMA pipe as best suits."""
    times = {pipe: per_element[pipe] * n / (lanes * SMS * CLOCK_HZ)
             for pipe, lanes in PIPE_LANES.items()}
    pipe = max(times, key=times.get)
    return times[pipe], pipe


def quant_inputs(n: int, fmt, generator, device):
    """Gradients at an APS-like scale (the format's top octaves down to
    2^-20 below them), with a block of special values at the front: ±0,
    ±Inf, NaN, fp32 subnormals, values at and just past the format max
    (which round up and carry)."""
    import torch

    from cpd_tpu_torch.quant.numerics import max_finite

    mf = max_finite(*fmt)
    ulp = 2.0 ** (math.floor(math.log2(mf)) - fmt[1])
    x = torch.randn(n, generator=generator, device=device) * (mf / 8)
    x = x * torch.exp2(torch.randint(-20, 1, (n,), generator=generator,
                                     device=device).float())
    special = torch.tensor(
        [0.0, -0.0, math.inf, -math.inf, math.nan, 1e-45, -1e-45, 2.0**-127,
         -(2.0**-130), 2.0**-126, mf, -mf, mf + ulp / 4, mf + ulp / 2,
         -(mf + ulp / 2), mf + ulp, 1.0, -1.5], dtype=torch.float64)
    k = min(n, special.numel())
    x[:k] = special[:k].to(torch.float32).to(device)
    return x


def ring_chunk_of_slice(device) -> int:
    """Elements of one ring chunk on the training slice's main path: the
    largest 4 Mi-element bucket of ResNet-18's gradients over W ranks."""
    from cpd_tpu_torch.models.resnet_cifar import resnet18_cifar
    from cpd_tpu_torch.parallel.overlap import (DEFAULT_BUCKET_ELEMS,
                                                bucket_layout)
    from cpd_tpu_torch.parallel.ring import ring_chunk_size

    sizes = [p.numel() for p in resnet18_cifar(device=device).parameters()]
    biggest = max(sum(sizes[i] for i in b)
                  for b in bucket_layout(sizes, DEFAULT_BUCKET_ELEMS))
    return ring_chunk_size(biggest, TRAIN["world"])


def quantize_phase(device) -> dict:
    """Phase 3: K1, K3, K6 and K5 against their plain versions, bitwise,
    over every format and size case; timed at (5, 2) on one ring chunk."""
    import torch

    from cpd_tpu_torch.ops import quantize as tq
    from cpd_tpu_torch.quant.numerics import wire_bytes

    chunk = ring_chunk_of_slice(device)
    gen = torch.Generator(device=device).manual_seed(99)
    cases = 0
    errs = dict.fromkeys(QUANT_KERNELS, 0.0)
    for n in (chunk, QUANT_ODD_N):
        for fmt in CAST_FORMATS:
            x = quant_inputs(n, fmt, gen, device)
            y = quant_inputs(n, fmt, gen, device).flip(0)
            pairs = [("quantize_cast", tq.quantize_cast(x, *fmt),
                      tq.quantize_cast_ref(x, *fmt)),
                     ("quantize_add", tq.quantize_add(x, y, *fmt),
                      tq.quantize_add_ref(x, y, *fmt))]
            if fmt in WIRE_FORMATS:
                first = tq.quantize_pack(x, *fmt, want_digest=True)
                pairs += [("quantize_pack", a, b) for a, b in zip(
                    first, tq.quantize_pack_ref(x, *fmt, want_digest=True))]
                pairs += [("quantize_pack", a, b) for a, b in zip(
                    tq.quantize_pack(x, *fmt),
                    tq.quantize_pack_ref(x, *fmt))]
                for dig in (True, False):
                    pairs += [("hop_pack", a, b) for a, b in zip(
                        tq.hop_pack(first[1], y, *fmt, want_digest=dig),
                        tq.hop_pack_ref(first[1], y, *fmt,
                                        want_digest=dig))]
            torch.cuda.synchronize()
            for name, got, want in pairs:
                if not same_bits(got, want):
                    raise AssertionError(f"{name} n={n} {fmt}: differs from "
                                         "its plain version")
                errs[name] = max(errs[name], max_abs_diff(got, want))
                cases += 1
    print(f"kernel quantize: {cases} outputs of K1/K3/K6/K5 bitwise equal "
          f"to their plain versions (n = {chunk} and {QUANT_ODD_N}; formats "
          f"{list(CAST_FORMATS)}, wire kernels on {list(WIRE_FORMATS)})",
          flush=True)

    fmt = TRAIN["fmt"]
    wb = wire_bytes(*fmt)
    sets = input_sets(chunk, fmt, 4 + 4 + wb, gen, device,
                      lambda x, y: (x, y, tq.quantize_pack(y, *fmt)[1]))
    # (the main path's call, its plain version, the digesting form)
    calls = {
        "quantize_cast": (lambda x, y, w: tq.quantize_cast(x, *fmt),
                          lambda x, y, w: tq.quantize_cast_ref(x, *fmt),
                          None),
        "quantize_add": (lambda x, y, w: tq.quantize_add(x, y, *fmt),
                         lambda x, y, w: tq.quantize_add_ref(x, y, *fmt),
                         None),
        "quantize_pack": (
            lambda x, y, w: tq.quantize_pack(x, *fmt),
            lambda x, y, w: tq.quantize_pack_ref(x, *fmt),
            lambda x, y, w: tq.quantize_pack(x, *fmt, want_digest=True)),
        "hop_pack": (
            lambda x, y, w: tq.hop_pack(w, x, *fmt),
            lambda x, y, w: tq.hop_pack_ref(w, x, *fmt),
            lambda x, y, w: tq.hop_pack(w, x, *fmt, want_digest=True)),
    }
    return {name: time_kernel(name, fmt, chunk, sets, *fns, errs[name])
            for name, fns in calls.items()}


def input_sets(n: int, fmt, set_bytes: int, generator, device,
               make) -> list:
    """Input sets ``make(x, y)`` of n elements that together hold at
    least twice the L2, so that timed launches cycling over them read
    their inputs from HBM, as the byte bound assumes."""
    n_sets = -(-2 * l2_bytes() // (set_bytes * n)) + 1
    return [make(quant_inputs(n, fmt, generator, device),
                 quant_inputs(n, fmt, generator, device))
            for _ in range(n_sets)]


def rotating(sets, fn):
    """``fn`` called on the next input set at every call."""
    it = itertools.cycle(sets)
    return lambda: fn(*next(it))


def time_kernel(name: str, fmt, n: int, sets, kernel, plain, digest,
                err: float) -> dict:
    """One kernel's card numbers: its device time (torch.profiler) and
    its plain version's, each timed launch on the next input set; the
    per-call time of back-to-back wrapper calls with host dispatch (CUDA
    events); the bound from its bytes and operations per element."""
    from cpd_tpu_torch.quant.numerics import wire_bytes

    t_bytes = QUANT_KERNELS[name][1](wire_bytes(*fmt)) * n / PEAK_BYTES_PER_S
    extra = {}
    if name == "sr_bits":
        per = sass_per_element("quantize", "sr_bits_kernel")
        t_ops, pipe = pipe_bound_s(per, n)
        extra = dict(sass_per_element=per, bound_pipe=pipe)
    else:
        t_ops = QUANT_OPS[name] * n / PEAK_FP32_FLOPS
    r = dict(n=n, input_sets=len(sets), max_abs_err=err,
             ms=device_ms(rotating(sets, kernel), iters=100),
             plain_ms=device_ms(rotating(sets, plain), iters=20),
             call_ms=time_ms(rotating(sets, kernel), iters=200),
             plain_call_ms=time_ms(rotating(sets, plain), iters=20),
             bound_ms=max(t_bytes, t_ops) * 1e3,
             bound_by="bytes" if t_bytes >= t_ops else "operations",
             **extra)
    if digest is not None:
        r["ms_with_digest"] = device_ms(rotating(sets, digest), iters=100)
    lib = NO_LIBRARY_BITS if name == "sr_bits" else NO_LIBRARY
    print(f"kernel {name} [{fmt}, n={n}, {len(sets)} input sets]: "
          f"kernel_ms {r['ms']:.5f} plain_ms {r['plain_ms']:.5f} "
          f"(device time) bound_ms {r['bound_ms']:.6f} ({r['bound_by']})"
          + (f" with digests {r['ms_with_digest']:.5f}"
             if "ms_with_digest" in r else "")
          + f"; per call with host dispatch {r['call_ms']:.5f}, plain "
          f"{r['plain_call_ms']:.5f}; library_ms null ({lib})"
          + (f"; per element {json.dumps(extra)}" if extra else ""),
          flush=True)
    return r


def sr_quantize_phase(device) -> dict:
    """Phase 7: the SR bit helper, K2, K4 and the SR arms of K6/K5
    against their plain versions, bitwise, over every format and size
    case; timed at (5, 2) on one ring chunk."""
    import torch

    from cpd_tpu_torch.ops import quantize as tq
    from cpd_tpu_torch.quant.numerics import wire_bytes

    chunk = ring_chunk_of_slice(device)
    gen = torch.Generator(device=device).manual_seed(98)
    names = ("sr_bits", "quantize_cast_sr", "quantize_add_sr",
             "quantize_pack_sr", "hop_pack_sr")
    errs = dict.fromkeys(names, 0.0)
    cases = 0
    for n in (chunk, QUANT_ODD_N):
        for fmt in SR_CAST_FORMATS:
            key = (fmt[0] * 1000 + fmt[1], n)
            start = 2**32 - n // 2           # offsets wrap past 2^32
            x = quant_inputs(n, fmt, gen, device)
            y = quant_inputs(n, fmt, gen, device).flip(0)
            rb = tq.sr_bits(key, x, offset_start=start)
            rb2 = tq.sr_bits(key[::-1], x, offset_start=7 * n)
            pairs = [("sr_bits", rb,
                      tq.sr_bits_ref(key, x, offset_start=start)),
                     ("sr_bits", rb2,
                      tq.sr_bits_ref(key[::-1], x, offset_start=7 * n)),
                     ("quantize_cast_sr", tq.quantize_cast_sr(x, *fmt, rb),
                      tq.quantize_cast_sr_ref(x, *fmt, rb)),
                     ("quantize_add_sr", tq.quantize_add_sr(x, y, *fmt, rb2),
                      tq.quantize_add_sr_ref(x, y, *fmt, rb2))]
            if fmt in WIRE_FORMATS:
                first = tq.quantize_pack_sr(x, *fmt, rb, want_digest=True)
                pairs += [("quantize_pack_sr", a, b) for a, b in zip(
                    first, tq.quantize_pack_ref(x, *fmt, rbits=rb,
                                                want_digest=True))]
                pairs += [("quantize_pack_sr", a, b) for a, b in zip(
                    tq.quantize_pack_sr(x, *fmt, rb),
                    tq.quantize_pack_ref(x, *fmt, rbits=rb))]
                for dig in (True, False):
                    pairs += [("hop_pack_sr", a, b) for a, b in zip(
                        tq.hop_pack_sr(first[1], y, *fmt, rb2,
                                       want_digest=dig),
                        tq.hop_pack_ref(first[1], y, *fmt, rbits=rb2,
                                        want_digest=dig))]
            torch.cuda.synchronize()
            for name, got, want in pairs:
                if not same_bits(got, want):
                    raise AssertionError(f"{name} n={n} {fmt}: differs from "
                                         "its plain version")
                errs[name] = max(errs[name], max_abs_diff(got, want))
                cases += 1
    print(f"kernel quantize SR: {cases} outputs of sr_bits/K2/K4/K6-SR/"
          f"K5-SR bitwise equal to their plain versions (n = {chunk} and "
          f"{QUANT_ODD_N}; formats {list(SR_CAST_FORMATS)}, wire kernels on "
          f"{list(WIRE_FORMATS)})", flush=True)

    fmt = TRAIN["fmt"]
    wb = wire_bytes(*fmt)
    key = (7, 11)

    def make(x, y):
        return (x, y, tq.quantize_pack(y, *fmt)[1],
                tq.sr_bits(key, x, offset_start=12345))

    sets = input_sets(chunk, fmt, 4 + 4 + 4 + wb, gen, device, make)
    calls = {
        "sr_bits": (
            lambda x, y, w, r: tq.sr_bits(key, x, offset_start=12345),
            lambda x, y, w, r: tq.sr_bits_ref(key, x, offset_start=12345),
            None),
        "quantize_cast_sr": (
            lambda x, y, w, r: tq.quantize_cast_sr(x, *fmt, r),
            lambda x, y, w, r: tq.quantize_cast_sr_ref(x, *fmt, r), None),
        "quantize_add_sr": (
            lambda x, y, w, r: tq.quantize_add_sr(x, y, *fmt, r),
            lambda x, y, w, r: tq.quantize_add_sr_ref(x, y, *fmt, r), None),
        "quantize_pack_sr": (
            lambda x, y, w, r: tq.quantize_pack_sr(x, *fmt, r),
            lambda x, y, w, r: tq.quantize_pack_ref(x, *fmt, rbits=r),
            lambda x, y, w, r: tq.quantize_pack_sr(x, *fmt, r,
                                                   want_digest=True)),
        "hop_pack_sr": (
            lambda x, y, w, r: tq.hop_pack_sr(w, x, *fmt, r),
            lambda x, y, w, r: tq.hop_pack_ref(w, x, *fmt, rbits=r),
            lambda x, y, w, r: tq.hop_pack_sr(w, x, *fmt, r,
                                              want_digest=True)),
    }
    return {name: time_kernel(name, fmt, chunk, sets, *fns, errs[name])
            for name, fns in calls.items()}


def run_engine(model, trace, fused: bool, device):
    import torch

    from cpd_tpu_torch.obs.timing import now
    from cpd_tpu_torch.serve import ServeEngine

    eng = ServeEngine(model, device=device, fused_attn=fused,
                      record_logits=True, **ENGINE)
    for req in trace:
        eng.submit(req)
    torch.cuda.synchronize()
    t0 = now()
    eng.run_until_drained()
    torch.cuda.synchronize()
    return eng, now() - t0


def ttft_steps(eng, trace) -> list:
    """Engine steps from each request's arrival to its first token."""
    first = {rid: step for kind, rid, step, _ in eng.events
             if kind == "first_token"}
    return [first[r.rid] - r.arrival for r in trace]


def serve_phase(device) -> dict:
    """Phase 3: the serving slice end to end, fused vs plain read path."""
    import numpy as np
    import torch

    from cpd_tpu_torch.models import transformer_lm
    from cpd_tpu_torch.ops import serve_attn
    from cpd_tpu_torch.serve import mixed_trace

    gen = torch.Generator(device=device).manual_seed(0)
    model = transformer_lm(**MODEL, device=device).init_weights(gen)
    trace = mixed_trace(TRACE["n_requests"], MODEL["vocab_size"],
                        prompt_lens=TRACE["prompt_lens"],
                        max_new=TRACE["max_new"], seed=TRACE["seed"])
    rids = sorted(r.rid for r in trace)

    serve_attn.fused_gather_attention.launches = 0
    fused, fused_s = run_engine(model, trace, True, device)
    launches = serve_attn.fused_gather_attention.launches
    if sorted(fused.finished) != rids or fused.unresolved():
        raise AssertionError(f"fused engine left requests unfinished: "
                             f"{fused.unresolved()}")
    steps = fused.counters["decode_steps"]
    if launches != steps * MODEL["n_layers"] or launches == 0:
        raise AssertionError(f"kernel launches {launches} != decode steps "
                             f"{steps} x {MODEL['n_layers']} layers")
    plain, plain_s = run_engine(model, trace, False, device)
    if dict(fused.finished.items()) != dict(plain.finished.items()):
        diff = [r for r in rids if fused.finished[r] != plain.finished[r]]
        raise AssertionError(f"fused and plain engines sampled different "
                             f"tokens for rids {diff}")
    f_rows = {(r, p): row for r, p, row in fused.logits_log}
    p_rows = {(r, p): row for r, p, row in plain.logits_log}
    if f_rows.keys() != p_rows.keys():
        raise AssertionError("fused and plain engines logged different "
                             "(rid, position) schedules")
    rows = np.stack([f_rows[k] for k in sorted(f_rows)])
    if not np.isfinite(rows).all() or rows.shape[1] != MODEL["vocab_size"]:
        raise AssertionError(f"logits not finite or of the wrong width "
                             f"{rows.shape}")
    logit_err = max(float(np.abs(f_rows[k] - p_rows[k]).max())
                    for k in f_rows)
    if logit_err > LOGIT_ATOL:
        raise AssertionError(f"fused vs plain logits differ by {logit_err} "
                             f"> {LOGIT_ATOL}")
    ttft = ttft_steps(fused, trace)
    gen_tokens = fused.counters["tokens_generated"]
    out = dict(
        tokens_generated=gen_tokens,
        decode_steps=steps, prefill_chunks=fused.counters["prefill_chunks"],
        engine_steps=fused.step_index, kernel_launches=launches,
        fused_wall_s=fused_s, plain_wall_s=plain_s,
        fused_tok_per_s=gen_tokens / fused_s,
        plain_tok_per_s=plain.counters["tokens_generated"] / plain_s,
        ttft_steps_p50=float(np.percentile(ttft, 50)),
        ttft_steps_p99=float(np.percentile(ttft, 99)),
        logit_max_abs_err=logit_err)
    print("serve: " + json.dumps(out), flush=True)
    return out


def profile_phase(device, steps: int = 30, warmup: int = 10) -> dict:
    """Where an engine step's time goes: a fresh fused engine on the same
    trace, ``steps`` engine steps under torch.profiler after ``warmup``
    untraced ones.  Device busy share = summed kernel time over the
    window's wall time (one stream, so kernels do not overlap)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cpd_tpu_torch.models import transformer_lm
    from cpd_tpu_torch.obs.timing import now
    from cpd_tpu_torch.serve import ServeEngine, mixed_trace

    gen = torch.Generator(device=device).manual_seed(0)
    model = transformer_lm(**MODEL, device=device).init_weights(gen)
    eng = ServeEngine(model, device=device, fused_attn=True, **ENGINE)
    for req in mixed_trace(TRACE["n_requests"], MODEL["vocab_size"],
                           prompt_lens=TRACE["prompt_lens"],
                           max_new=TRACE["max_new"], seed=TRACE["seed"]):
        eng.submit(req)
    for _ in range(warmup):
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = now()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_s = now() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    out = dict(
        steps=steps, wall_ms_per_step=wall_s * 1e3 / steps,
        device_busy_ms_per_step=busy_us / 1e3 / steps,
        device_busy_share=(busy_us / 1e6) / wall_s if busy_us else None,
        kernel_launches_per_step=sum(e.count for e in kernels) / steps,
        top_kernels=[dict(name=e.key[:60], ms_per_step=e.
                          self_device_time_total / 1e3 / steps,
                          launches_per_step=e.count / steps) for e in top])
    print("profile: " + json.dumps(out), flush=True)
    return out


def kernel_counters() -> dict:
    """The launch counters of every kernel wrapper of the port."""
    from cpd_tpu_torch.ops import flash_gqa as fl
    from cpd_tpu_torch.ops import flash_mha as fm
    from cpd_tpu_torch.ops import qgemm as qg
    from cpd_tpu_torch.ops import quantize as tq
    from cpd_tpu_torch.ops import serve_attn

    return {"serve_attn": serve_attn.fused_gather_attention,
            "qgemm_faithful": qg.qgemm_faithful,
            "flash_gqa_fwd": fl.flash_gqa_fwd,
            "flash_gqa_bwd": fl.flash_gqa_bwd,
            "flash_mha_fwd": fm.flash_mha_fwd,
            "flash_mha_bwd": fm.flash_mha_bwd,
            "quantize_cast": tq.quantize_cast,
            "quantize_cast_sr": tq.quantize_cast_sr,
            "quantize_add": tq.quantize_add,
            "quantize_add_sr": tq.quantize_add_sr,
            "quantize_pack": tq.quantize_pack,
            "quantize_pack_sr": tq.quantize_pack_sr,
            "hop_pack": tq.hop_pack, "hop_pack_sr": tq.hop_pack_sr,
            "quantize_pack_blocked": tq.quantize_pack_blocked,
            "quantize_pack_blocked_sr": tq.quantize_pack_blocked_sr,
            "hop_pack_blocked": tq.hop_pack_blocked,
            "hop_pack_blocked_sr": tq.hop_pack_blocked_sr,
            "digest_rows": tq.digest_rows,
            "sr_bits": tq.sr_bits}


def reset_counts() -> None:
    for fn in kernel_counters().values():
        fn.launches = 0


def read_counts() -> dict:
    """Launches since the last reset."""
    return {k: fn.launches for k, fn in kernel_counters().items()}


def reduce_design(mode: str, sr: bool, kahan: bool, w: int, leaves: int,
                  buckets: int) -> dict:
    """The launches one APS `sum_gradients` makes over a LocalMesh of w
    ranks: the pre-quantize casts one leaf per rank; a cast site runs W
    times per bucket in the faithful scan (once for all ranks, on the
    shared gathered stack) and W x W times in the ring (every rank at
    every hop), four times over with Kahan."""
    want = dict.fromkeys(read_counts(), 0)
    calls = (w * w if mode == "ring" else w) * buckets * (4 if kahan else 1)
    want["quantize_cast_sr" if sr else "quantize_cast"] = w * leaves
    if mode == "ring" and not kahan:
        sfx = "_sr" if sr else ""
        want["quantize_pack" + sfx] = w * buckets
        want["hop_pack" + sfx] = w * (w - 1) * buckets
    else:
        want["quantize_add_sr" if sr else "quantize_add"] = calls
    if sr:
        want["sr_bits"] = w * leaves + calls
    return want


def train_run(device, batches, mesh, fused, fmt=None, metrics_out=None,
              **step_kw):
    """Ring + APS steps, one per batch, from the seed-24 weights, in the
    format ``fmt`` (default the slice's); returns the model, the state,
    the step, the per-step losses and the per-step host seconds, and
    appends each step's metrics to ``metrics_out``."""
    import torch

    from cpd_tpu_torch.models.resnet_cifar import resnet18_cifar
    from cpd_tpu_torch.obs.timing import now
    from cpd_tpu_torch.train import (create_train_state, make_train_step,
                                     sgd, warmup_step_decay)

    gen = torch.Generator(device=device).manual_seed(TRAIN["seed"])
    model = resnet18_cifar(device=device).init_weights(gen)
    ipe = math.ceil(TRAIN["n_train"]
                    / (TRAIN["world"] * TRAIN["per_rank_batch"]))
    peak = TRAIN["peak_lr"]
    opt = sgd(warmup_step_decay(peak, 5 * ipe, [40 * ipe, 80 * ipe],
                                warmup_from=peak / 16.0),
              momentum=0.9, weight_decay=1e-4)
    state = create_train_state(model, opt)
    fmt = TRAIN["fmt"] if fmt is None else fmt
    step = make_train_step(model, opt, mesh, mode="ring", use_aps=True,
                           grad_exp=fmt[0], grad_man=fmt[1], fused=fused,
                           **step_kw)
    losses, secs = [], []
    for bx, by in batches:
        torch.cuda.synchronize()
        t0 = now()
        state, metrics = step(state, bx, by)
        torch.cuda.synchronize()
        secs.append(now() - t0)
        losses.append(metrics["loss"].clone())
        if metrics_out is not None:
            metrics_out.append({k: float(v) for k, v in metrics.items()})
    return model, state, step, losses, secs


def step_profile(step, state, batch) -> dict:
    """Device ms per step by kernel, summed kernel launches per step, over
    one profiled train step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(state, *batch)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    if not kernels:
        print("  (torch.profiler recorded no device time for this step: its "
              "per-kernel device ms are not measured)", flush=True)
        return dict(dict.fromkeys(KERNEL_NAMES), device_busy_ms=None,
                    kernel_launches=None)
    out = {k: sum(e.self_device_time_total for e in kernels
                  if any(n in e.key for n in
                         ((v,) if isinstance(v, str) else v))) / 1e3
           for k, v in KERNEL_NAMES.items()}
    out["device_busy_ms"] = sum(e.self_device_time_total
                                for e in kernels) / 1e3
    out["kernel_launches"] = sum(e.count for e in kernels)
    return out


def slice_batches(steps: int) -> list:
    """The training slice's first ``steps`` global batches: synthetic
    CIFAR-10, the port's sampler (seed 0) and augmentation."""
    from cpd_tpu_torch.data import (CIFAR10Pipeline,
                                    DistributedGivenIterationSampler,
                                    synthetic_cifar10)

    global_batch = TRAIN["world"] * TRAIN["per_rank_batch"]
    train_x, train_y, _, _ = synthetic_cifar10(TRAIN["n_train"],
                                               TRAIN["n_test"])
    pipe = CIFAR10Pipeline(train_x, train_y, global_batch, augment=True,
                           cutout=0)
    sampler = DistributedGivenIterationSampler(len(train_y), steps,
                                               global_batch, seed=0)
    return [pipe.batch(idx, seed=0) for idx in sampler.batches()]


def reduce_split(mesh, model, x, y, fmt=None, **reduce_kw) -> dict:
    """One step's forward + backward and its reduce, each timed on the
    host clock between synchronisations."""
    import torch

    from cpd_tpu_torch.obs.timing import now
    from cpd_tpu_torch.parallel.dist import sum_gradients
    from cpd_tpu_torch.train import fp32_numerics, local_gradients

    fmt = TRAIN["fmt"] if fmt is None else fmt
    with fp32_numerics():
        torch.cuda.synchronize()
        t0 = now()
        grads = local_gradients(model, x, y, mesh)[0]
        torch.cuda.synchronize()
        t1 = now()
        sum_gradients(grads, mesh, use_aps=True, grad_exp=fmt[0],
                      grad_man=fmt[1], mode="ring", **reduce_kw)
        torch.cuda.synchronize()
        t2 = now()
    return dict(fwd_bwd_ms=(t1 - t0) * 1e3, reduce_ms=(t2 - t1) * 1e3)


def train_phase(device) -> dict:
    """Phase 6: the training slice end to end, kernels vs plain versions,
    the ring vs its oracle, the launch design, then the trainer CLI."""
    import torch

    from cpd_tpu_torch.examples.resnet18_cifar import train as cli
    from cpd_tpu_torch.obs.timing import now
    from cpd_tpu_torch.ops import quantize as tq
    from cpd_tpu_torch.parallel.aps import (aps_max_exponents, aps_scale,
                                            aps_shift_factors)
    from cpd_tpu_torch.parallel.dist import sum_gradients
    from cpd_tpu_torch.parallel.mesh import data_parallel_mesh
    from cpd_tpu_torch.parallel.overlap import (DEFAULT_BUCKET_ELEMS,
                                                bucket_layout)
    from cpd_tpu_torch.parallel.ring import (ring_oracle_sum,
                                             ring_quantized_sum)
    from cpd_tpu_torch.quant.numerics import cast_body
    from cpd_tpu_torch.train import as_batch, fp32_numerics, local_gradients

    w, steps, fmt = TRAIN["world"], TRAIN["steps"], TRAIN["fmt"]
    global_batch = w * TRAIN["per_rank_batch"]
    batches = slice_batches(steps)
    mesh = data_parallel_mesh(w, device)

    reset_counts()
    model, state, step, losses, secs = train_run(device, batches, mesh, None)
    counts = read_counts()
    sizes = [p.numel() for p in model.parameters()]
    n_buckets = len(bucket_layout(sizes, DEFAULT_BUCKET_ELEMS))
    want = {k: steps * v for k, v in reduce_design(
        "ring", False, False, w, len(sizes), n_buckets).items()}
    if counts != want:
        raise AssertionError(f"kernel launches {counts} != the design's "
                             f"{want} ({steps} steps, W={w}, {n_buckets} "
                             f"buckets, {len(sizes)} leaves)")
    loss_f = [float(v) for v in losses]
    if not all(math.isfinite(v) for v in loss_f):
        raise AssertionError(f"non-finite training loss: {loss_f}")

    plain_model, _, _, plain_losses, plain_secs = train_run(
        device, batches, mesh, False)
    for i, (a, b) in enumerate(zip(losses, plain_losses)):
        if not same_bits(a, b):
            raise AssertionError(f"step {i}: loss {float(a)!r} with the "
                                 f"kernels, {float(b)!r} with the plain "
                                 "versions")
    for (name, a), b in zip(model.state_dict().items(),
                            plain_model.state_dict().values()):
        if not same_bits(a, b):
            raise AssertionError(f"after {steps} steps {name} differs "
                                 "between the kernel and the plain run")
    print(f"train: {steps} ring+APS {fmt} steps at W={w}: losses, weights "
          f"and BN stats bitwise equal with the kernels and with the plain "
          f"versions; losses {loss_f}", flush=True)

    # one step's gradients through the ring (kernels) vs the oracle
    x, y = as_batch(*batches[0], device)
    with fp32_numerics():
        grads = local_gradients(model, x, y, mesh)[0]
    shifts = mesh.max([aps_max_exponents(g, w) for g in grads])
    cast = [[cast_body(q, *fmt) for q in aps_scale(g, aps_shift_factors(
        s, fmt[0]))] for g, s in zip(grads, shifts)]
    for b in bucket_layout(sizes, DEFAULT_BUCKET_ELEMS):
        flats = [torch.cat([leaves[i].reshape(-1) for i in b])
                 for leaves in cast]
        oracle = ring_oracle_sum(torch.stack(flats), *fmt)
        for got in ring_quantized_sum(flats, mesh, *fmt):
            if not same_bits(got, oracle):
                raise AssertionError(f"bucket {b[0]}..{b[-1]}: the ring "
                                     "differs from ring_oracle_sum")
    print(f"train: one step's APS-cast gradients, {n_buckets} buckets: "
          "ring_quantized_sum on the card == ring_oracle_sum bitwise",
          flush=True)

    # K3 at the shapes its own path gives it: the same gradients through
    # the faithful reduce (W partials per bucket, one launch each) with
    # the kernels and with the plain versions
    kw = dict(use_aps=True, grad_exp=fmt[0], grad_man=fmt[1],
              mode="faithful")
    k3_before = tq.quantize_add.launches
    got = sum_gradients(grads, mesh, fused=None, **kw)[0]
    k3_launches = tq.quantize_add.launches - k3_before
    if k3_launches != w * n_buckets:
        raise AssertionError(f"faithful reduce launched K3 {k3_launches} "
                             f"times, not W x buckets = {w * n_buckets}")
    want_red = sum_gradients(grads, mesh, fused=False, **kw)[0]
    k3_err = 0.0
    for (name, _), a, b in zip(model.named_parameters(), got, want_red):
        if not same_bits(a, b):
            raise AssertionError(f"faithful reduce of {name}: the kernels "
                                 "differ from the plain versions")
        k3_err = max(k3_err, max_abs_diff(a, b))
    print(f"train: the same gradients through the faithful reduce, "
          f"{n_buckets} buckets x W={w} K3 launches: bitwise equal with "
          "the kernels and with the plain versions", flush=True)

    # the split of one step (host clock, synchronised between parts)
    split = reduce_split(mesh, model, x, y)
    prof = step_profile(step, state, batches[0])
    step_s = sum(secs[1:]) / (len(secs) - 1)
    out = dict(
        world=w, global_batch=global_batch, steps=steps, losses=loss_f,
        step_ms=step_s * 1e3, images_per_s=global_batch / step_s,
        plain_step_ms=sum(plain_secs[1:]) / (len(plain_secs) - 1) * 1e3,
        n_buckets=n_buckets, n_leaves=len(sizes),
        launches=counts, launches_per_step={k: v // steps
                                            for k, v in counts.items()},
        faithful_k3=dict(launches=k3_launches, max_abs_err=k3_err),
        **split, profile=prof)
    print("train: " + json.dumps(out), flush=True)

    reset_counts()
    t0 = now()
    rc = cli.main(["--mode", "faithful", "--use_APS", "--grad_exp",
                   str(fmt[0]), "--grad_man", str(fmt[1]), "--max-iter",
                   str(TRAIN["cli_iters"])])
    cli_counts = read_counts()
    if rc != 0 or cli_counts["quantize_add"] == 0:
        raise AssertionError(f"trainer CLI returned {rc}, launches "
                             f"{cli_counts}")
    out["cli"] = dict(rc=rc, seconds=now() - t0, launches=cli_counts,
                      quantize_add_per_iter=cli_counts["quantize_add"]
                      // TRAIN["cli_iters"])
    print("train cli: " + json.dumps(out["cli"]), flush=True)
    return out


def sr_train_phase(device, rtne: dict) -> dict:
    """Phase 8: the SR slice end to end, kernels vs plain versions, the
    SR ring vs its oracle, the launch design, the reduce matrix, then
    the trainer CLI with SR and Kahan."""
    import torch

    from cpd_tpu_torch.examples.resnet18_cifar import train as cli
    from cpd_tpu_torch.obs.timing import now
    from cpd_tpu_torch.parallel.aps import (aps_max_exponents, aps_scale,
                                            aps_shift_factors)
    from cpd_tpu_torch.parallel.dist import (_leaf_starts, grad_sr_key,
                                             quantize_tree_sr, sum_gradients)
    from cpd_tpu_torch.parallel.mesh import data_parallel_mesh
    from cpd_tpu_torch.parallel.overlap import (DEFAULT_BUCKET_ELEMS,
                                                bucket_layout)
    from cpd_tpu_torch.parallel.ring import (ring_oracle_sum,
                                             ring_quantized_sum)
    from cpd_tpu_torch.quant.prng import fold_in, split
    from cpd_tpu_torch.train import as_batch, fp32_numerics, local_gradients

    w, fmt = TRAIN["world"], TRAIN["fmt"]
    global_batch = w * TRAIN["per_rank_batch"]
    batches = slice_batches(SR_STEPS)
    mesh = data_parallel_mesh(w, device)
    sr_kw = dict(grad_rounding="stochastic", grad_seed=SR_SEED)

    reset_counts()
    model, state, step, losses, secs = train_run(device, batches, mesh, None,
                                                 **sr_kw)
    counts = read_counts()
    sizes = [p.numel() for p in model.parameters()]
    n_buckets = len(bucket_layout(sizes, DEFAULT_BUCKET_ELEMS))
    want = {k: SR_STEPS * v for k, v in reduce_design(
        "ring", True, False, w, len(sizes), n_buckets).items()}
    if counts != want:
        raise AssertionError(f"SR launches {counts} != the design's {want}")
    loss_f = [float(v) for v in losses]
    if not all(math.isfinite(v) for v in loss_f):
        raise AssertionError(f"non-finite training loss: {loss_f}")
    plain_model, _, _, plain_losses, plain_secs = train_run(
        device, batches, mesh, False, **sr_kw)
    for i, (a, b) in enumerate(zip(losses, plain_losses)):
        if not same_bits(a, b):
            raise AssertionError(f"SR step {i}: loss {float(a)!r} with the "
                                 f"kernels, {float(b)!r} with the plain "
                                 "versions")
    for (name, a), b in zip(model.state_dict().items(),
                            plain_model.state_dict().values()):
        if not same_bits(a, b):
            raise AssertionError(f"after {SR_STEPS} SR steps {name} differs "
                                 "between the kernel and the plain run")
    print(f"train sr: {SR_STEPS} SR ring+APS {fmt} steps at W={w}, "
          f"grad_seed {SR_SEED}: losses, weights and BN stats bitwise equal "
          f"with the kernels and with the plain versions; losses {loss_f}",
          flush=True)

    # one step's gradients through the SR ring (kernels) vs the oracle,
    # with the keys the next step would draw
    x, y = as_batch(*batches[0], device)
    with fp32_numerics():
        grads = local_gradients(model, x, y, mesh)[0]
    key = grad_sr_key(SR_SEED, state.step, 1)
    k_pre, k_sum, _ = split(key, 3)
    starts = _leaf_starts(grads[0])
    shifts = mesh.max([aps_max_exponents(g, w) for g in grads])
    cast = [quantize_tree_sr(aps_scale(g, aps_shift_factors(s, fmt[0])),
                             *fmt, fold_in(k_pre, r), starts, fused=False)
            for r, (g, s) in enumerate(zip(grads, shifts))]
    for b in bucket_layout(sizes, DEFAULT_BUCKET_ELEMS):
        flats = [torch.cat([leaves[i].reshape(-1) for i in b])
                 for leaves in cast]
        kw = dict(key=k_sum, offset_start=starts[b[0]])
        oracle = ring_oracle_sum(torch.stack(flats), *fmt, **kw)
        for got in ring_quantized_sum(flats, mesh, *fmt, **kw):
            if not same_bits(got, oracle):
                raise AssertionError(f"bucket {b[0]}..{b[-1]}: the SR ring "
                                     "differs from ring_oracle_sum(key=)")
    print(f"train sr: one step's SR-cast gradients, {n_buckets} buckets: "
          "the SR ring on the card == ring_oracle_sum(key=) bitwise",
          flush=True)

    # the reduce matrix on the same gradients: kernels vs plain versions
    matrix, errs = {}, {}
    for mode, sr, kahan in itertools.product(("faithful", "ring"),
                                             (False, True), (False, True)):
        kw = dict(use_aps=True, grad_exp=fmt[0], grad_man=fmt[1], mode=mode,
                  use_kahan=kahan,
                  rounding="stochastic" if sr else "nearest",
                  key=key if sr else None)
        cell = (f"{mode}/{'stochastic' if sr else 'nearest'}/"
                f"{'kahan' if kahan else 'plain'}")
        reset_counts()
        got = sum_gradients(grads, mesh, fused=None, **kw)[0]
        launched = read_counts()
        design = reduce_design(mode, sr, kahan, w, len(sizes), n_buckets)
        if launched != design:
            raise AssertionError(f"{cell}: launches {launched} != the "
                                 f"design's {design}")
        plain = sum_gradients(grads, mesh, fused=False, **kw)[0]
        err = 0.0
        for (name, _), a, b in zip(model.named_parameters(), got, plain):
            if not same_bits(a, b):
                raise AssertionError(f"{cell} reduce of {name}: the kernels "
                                     "differ from the plain versions")
            err = max(err, max_abs_diff(a, b))
        matrix[cell] = {k: v for k, v in launched.items() if v}
        for k in matrix[cell]:
            errs[k] = max(errs.get(k, 0.0), err)
    print("train sr: reduce matrix {faithful, ring} x {nearest, stochastic} "
          "x {Kahan off, on}, APS: kernels == plain versions bitwise, "
          "launches as designed: " + json.dumps(matrix), flush=True)

    split_ms = reduce_split(mesh, model, x, y, rounding="stochastic",
                            key=key)
    prof = step_profile(step, state, batches[0])
    step_s = sum(secs[1:]) / (len(secs) - 1)
    out = dict(
        world=w, global_batch=global_batch, steps=SR_STEPS, losses=loss_f,
        step_ms=step_s * 1e3, images_per_s=global_batch / step_s,
        plain_step_ms=sum(plain_secs[1:]) / (len(plain_secs) - 1) * 1e3,
        launches=counts, launches_per_step={k: v // SR_STEPS
                                            for k, v in counts.items()},
        **split_ms, profile=prof, matrix=matrix, matrix_max_abs_err=errs,
        rtne=dict(images_per_s=rtne["images_per_s"],
                  step_ms=rtne["step_ms"], reduce_ms=rtne["reduce_ms"],
                  launches_per_step=rtne["launches_per_step"]))
    print("train sr: " + json.dumps(out), flush=True)

    iters = TRAIN["cli_iters"]
    reset_counts()
    t0 = now()
    rc = cli.main(["--mode", "faithful", "--use_APS", "--use_kahan",
                   "--grad-rounding", "stochastic", "--grad-seed",
                   str(SR_SEED), "--grad_exp", str(fmt[0]), "--grad_man",
                   str(fmt[1]), "--max-iter", str(iters)])
    cli_counts = read_counts()
    design = {k: iters * v for k, v in reduce_design(
        "faithful", True, True, 1, len(sizes), n_buckets).items()}
    if rc != 0 or cli_counts != design:
        raise AssertionError(f"SR Kahan trainer CLI returned {rc}, "
                             f"launches {cli_counts} (design {design})")
    out["cli"] = dict(rc=rc, seconds=now() - t0, launches=cli_counts,
                      launches_per_iter={k: v // iters
                                         for k, v in cli_counts.items()})
    print("train sr cli: " + json.dumps(out["cli"]), flush=True)
    return out


def blocked_inputs(n: int, fmt, generator, device):
    """`quant_inputs` (APS-like values and the special values) times a
    per-16-element scale of 2^-30..2^30: block-structured magnitudes, the
    data per-block scaling exists for."""
    import torch

    x = quant_inputs(n, fmt, generator, device)
    regions = -(-n // 16)
    e = torch.randint(-30, 31, (regions,), generator=generator,
                      device=device).float()
    return x * torch.exp2(e).repeat_interleave(16)[:n]


def blocked_quantize_phase(device) -> dict:
    """Phase 9a: the blocked arms of K6/K5 (RTNE and SR, with and without
    digests) and K7 against their plain versions, bitwise; timed at the
    slice's shapes: (4, 3), block 128, one ring chunk; K7 on the largest
    bucket's gathered wire."""
    import torch

    from cpd_tpu_torch.ops import quantize as tq
    from cpd_tpu_torch.quant.numerics import sidecar_bytes, wire_bytes

    chunk = ring_chunk_of_slice(device)
    gen = torch.Generator(device=device).manual_seed(97)
    names = tuple(BLOCKED_KERNELS) + ("digest_rows",)
    errs = dict.fromkeys(names, 0.0)
    cases = 0
    for n in (chunk, QUANT_ODD_N):
        for fmt in BLOCKED_FORMATS:
            x = blocked_inputs(n, fmt, gen, device)
            y = blocked_inputs(n, fmt, gen, device).flip(0)
            rb = tq.sr_bits((fmt[0], n), x, offset_start=2**32 - n // 3)
            for b in BLOCK_SIZES:
                pairs = []
                for sr in (False, True):
                    r = rb if sr else None
                    k6 = "quantize_pack_blocked" + ("_sr" if sr else "")
                    k5 = "hop_pack_blocked" + ("_sr" if sr else "")
                    first = tq.quantize_pack(x, *fmt, rbits=r, block_size=b,
                                             want_digest=True)
                    pairs += [(k6, u, v) for u, v in zip(
                        first, tq.quantize_pack_ref(
                            x, *fmt, rbits=r, block_size=b,
                            want_digest=True))]
                    pairs += [(k6, u, v) for u, v in zip(
                        tq.quantize_pack(x, *fmt, rbits=r, block_size=b),
                        tq.quantize_pack_ref(x, *fmt, rbits=r,
                                             block_size=b))]
                    for dig in (True, False):
                        pairs += [(k5, u, v) for u, v in zip(
                            tq.hop_pack(first[1], y, *fmt, rbits=r,
                                        block_size=b, want_digest=dig),
                            tq.hop_pack_ref(first[1], y, *fmt, rbits=r,
                                            block_size=b, want_digest=dig))]
                torch.cuda.synchronize()
                for name, got, want in pairs:
                    if not same_bits(got, want):
                        raise AssertionError(
                            f"{name} n={n} {fmt} block {b}: differs from "
                            "its plain version")
                    errs[name] = max(errs[name], max_abs_diff(got, want))
                    cases += 1
    # K7 on the largest bucket's gathered wire and on odd rows
    fmt, block = BLOCKED["fmt"], BLOCKED["block"]
    wb = wire_bytes(*fmt)
    row_bytes = chunk * wb + sidecar_bytes(chunk, block)
    for w, nb in ((TRAIN["world"], row_bytes), (2, 100_001), (8, 333_333)):
        rows = torch.randint(0, 256, (w, nb), generator=gen, device=device,
                             dtype=torch.uint8)
        got, want = tq.digest_rows(rows), tq.digest_rows_ref(rows)
        if not same_bits(got, want):
            raise AssertionError(f"digest_rows ({w}, {nb}): differs from "
                                 "its plain version")
        cases += 1
    print(f"kernel blocked: {cases} outputs of K6/K5 blocked (RTNE, SR; "
          f"with and without digests) and K7 bitwise equal to their plain "
          f"versions (n = {chunk} and {QUANT_ODD_N}; formats "
          f"{list(BLOCKED_FORMATS)}; blocks {list(BLOCK_SIZES)}; K7 at "
          f"(4, {row_bytes}), (2, 100001), (8, 333333))", flush=True)

    nb_chunk = sidecar_bytes(chunk, block)
    key = (5, 9)

    def make(x, y):
        w0 = tq.quantize_pack(y, *fmt, block_size=block)[1]
        return (x, y, w0, tq.sr_bits(key, x, offset_start=777))

    sets = input_sets(chunk, fmt, 12 + 2 * wb, gen, device, make)
    calls = {
        "quantize_pack_blocked": (
            lambda x, y, w, r: tq.quantize_pack(x, *fmt, block_size=block),
            lambda x, y, w, r: tq.quantize_pack_ref(x, *fmt,
                                                    block_size=block),
            lambda x, y, w, r: tq.quantize_pack(x, *fmt, block_size=block,
                                                want_digest=True)),
        "quantize_pack_blocked_sr": (
            lambda x, y, w, r: tq.quantize_pack(x, *fmt, rbits=r,
                                                block_size=block),
            lambda x, y, w, r: tq.quantize_pack_ref(x, *fmt, rbits=r,
                                                    block_size=block),
            lambda x, y, w, r: tq.quantize_pack(x, *fmt, rbits=r,
                                                block_size=block,
                                                want_digest=True)),
        "hop_pack_blocked": (
            lambda x, y, w, r: tq.hop_pack(w, x, *fmt, block_size=block),
            lambda x, y, w, r: tq.hop_pack_ref(w, x, *fmt,
                                               block_size=block),
            lambda x, y, w, r: tq.hop_pack(w, x, *fmt, block_size=block,
                                           want_digest=True)),
        "hop_pack_blocked_sr": (
            lambda x, y, w, r: tq.hop_pack(w, x, *fmt, rbits=r,
                                           block_size=block),
            lambda x, y, w, r: tq.hop_pack_ref(w, x, *fmt, rbits=r,
                                               block_size=block),
            lambda x, y, w, r: tq.hop_pack(w, x, *fmt, rbits=r,
                                           block_size=block,
                                           want_digest=True)),
    }
    out = {}
    for name, (kernel, plain, digest) in calls.items():
        t_bytes = BLOCKED_KERNELS[name][1](chunk, wb, nb_chunk) \
            / PEAK_BYTES_PER_S
        t_ops = BLOCKED_KERNELS[name][2] * chunk / PEAK_FP32_FLOPS
        out[name] = blocked_timing(name, f"{fmt} block {block}, n={chunk}",
                                   sets, kernel, plain, digest, t_bytes,
                                   t_ops, errs[name])
    # K7: the gathered wire of the largest bucket, W rows
    row_sets = [(torch.randint(0, 256, (TRAIN["world"], row_bytes),
                               generator=gen, device=device,
                               dtype=torch.uint8),)
                for _ in range(-(-2 * l2_bytes()
                                 // (TRAIN["world"] * row_bytes)) + 1)]
    out["digest_rows"] = blocked_timing(
        "digest_rows", f"({TRAIN['world']}, {row_bytes}) u8", row_sets,
        tq.digest_rows, tq.digest_rows_ref, None,
        TRAIN["world"] * row_bytes / PEAK_BYTES_PER_S, 0.0,
        errs["digest_rows"])
    return out


def blocked_timing(name: str, shape: str, sets, kernel, plain, digest,
                   t_bytes: float, t_ops: float, err: float) -> dict:
    """`time_kernel` for the blocked kernels and K7, whose bytes are not
    a multiple of the element count: device ms of the kernel and its
    plain version (each timed launch on the next input set), per-call ms
    with host dispatch, and the bound."""
    r = dict(shape=shape, input_sets=len(sets), max_abs_err=err,
             ms=device_ms(rotating(sets, kernel), iters=100),
             plain_ms=device_ms(rotating(sets, plain), iters=20),
             call_ms=time_ms(rotating(sets, kernel), iters=200),
             plain_call_ms=time_ms(rotating(sets, plain), iters=20),
             bound_ms=max(t_bytes, t_ops) * 1e3,
             bound_by="bytes" if t_bytes >= t_ops else "operations")
    if digest is not None:
        r["ms_with_digest"] = device_ms(rotating(sets, digest), iters=100)
    lib = NO_LIBRARY_DIGEST if name == "digest_rows" else NO_LIBRARY
    print(f"kernel {name} [{shape}, {len(sets)} input sets]: kernel_ms "
          f"{r['ms']:.5f} plain_ms {r['plain_ms']:.5f} (device time) "
          f"bound_ms {r['bound_ms']:.6f} ({r['bound_by']})"
          + (f" with digests {r['ms_with_digest']:.5f}"
             if "ms_with_digest" in r else "")
          + f"; per call with host dispatch {r['call_ms']:.5f}, plain "
          f"{r['plain_call_ms']:.5f}; library_ms null ({lib})", flush=True)
    return r


def blocked_design(w: int, leaves: int, buckets: int, sr: bool,
                   distinct_gathers: int) -> dict:
    """The launches of one APS `sum_gradients` over the blocked, verified
    ring at block 128 on a LocalMesh of w ranks: K1 (or sr_bits + K2)
    per leaf per rank, K6-blocked once and K5-blocked W - 1 times per
    rank per bucket, sr_bits once per hop with SR, K7 once per distinct
    gathered stack (one per bucket, two in a bucket whose gather a fault
    hit)."""
    want = dict.fromkeys(read_counts(), 0)
    sfx = "_sr" if sr else ""
    want["quantize_cast_sr" if sr else "quantize_cast"] = w * leaves
    want["quantize_pack_blocked" + sfx] = w * buckets
    want["hop_pack_blocked" + sfx] = w * (w - 1) * buckets
    want["digest_rows"] = distinct_gathers
    if sr:
        want["sr_bits"] = w * leaves + w * w * buckets
    return want


def blocked_train_phase(device) -> dict:
    """Phase 9b-e: the blocked, verified ring training slice end to end,
    kernels vs plain versions, the ring vs its oracle, the faults, SR,
    the launch design, then the trainer CLI."""
    import torch

    from cpd_tpu_torch.examples.resnet18_cifar import train as cli
    from cpd_tpu_torch.obs.timing import now
    from cpd_tpu_torch.parallel.aps import (aps_max_exponents, aps_scale,
                                            aps_shift_factors)
    from cpd_tpu_torch.parallel.dist import (_leaf_starts, grad_sr_key,
                                             quantize_tree_sr)
    from cpd_tpu_torch.parallel.mesh import data_parallel_mesh
    from cpd_tpu_torch.parallel.overlap import (DEFAULT_BUCKET_ELEMS,
                                                bucket_layout)
    from cpd_tpu_torch.parallel.ring import (ring_oracle_sum,
                                             ring_quantized_sum)
    from cpd_tpu_torch.quant.prng import fold_in, split
    from cpd_tpu_torch.train import as_batch, fp32_numerics, local_gradients

    w, fmt, block = TRAIN["world"], BLOCKED["fmt"], BLOCKED["block"]
    steps = BLOCKED["steps"]
    global_batch = w * TRAIN["per_rank_batch"]
    batches = slice_batches(steps)
    mesh = data_parallel_mesh(w, device)
    kw = dict(fmt=fmt, block_scale=True, block_size=block,
              verify_reduce=True)

    # (b) 3 clean steps, kernels vs plain versions
    reset_counts()
    metrics = []
    model, state, step, losses, secs = train_run(
        device, batches, mesh, None, metrics_out=metrics, **kw)
    counts = read_counts()
    sizes = [p.numel() for p in model.parameters()]
    layout = bucket_layout(sizes, DEFAULT_BUCKET_ELEMS)
    n_buckets = len(layout)
    want = {k: steps * v for k, v in blocked_design(
        w, len(sizes), n_buckets, False, n_buckets).items()}
    if counts != want:
        raise AssertionError(f"blocked launches {counts} != the design's "
                             f"{want} ({steps} steps, W={w}, {n_buckets} "
                             f"buckets)")
    clean = {"reduce_ok": 1.0, "reduce_hop_bad": 0.0,
             "reduce_gather_bad": 0.0, "reduce_agree": 1.0}
    for i, m in enumerate(metrics):
        if {k: m[k] for k in clean} != clean:
            raise AssertionError(f"blocked step {i}: verify report {m}")
    loss_f = [float(v) for v in losses]
    if not all(math.isfinite(v) for v in loss_f):
        raise AssertionError(f"non-finite training loss: {loss_f}")
    plain_metrics = []
    plain_model, _, _, plain_losses, plain_secs = train_run(
        device, batches, mesh, False, metrics_out=plain_metrics, **kw)
    if plain_metrics != metrics:
        raise AssertionError(f"blocked metrics {metrics} with the kernels, "
                             f"{plain_metrics} with the plain versions")
    for (name, a), b in zip(model.state_dict().items(),
                            plain_model.state_dict().values()):
        if not same_bits(a, b):
            raise AssertionError(f"after {steps} blocked steps {name} "
                                 "differs between the kernel and the plain "
                                 "run")
    print(f"train blocked: {steps} blocked verified ring+APS {fmt} block "
          f"{block} steps at W={w}: losses, weights and BN stats bitwise "
          f"equal with the kernels and with the plain versions, reduce_ok 1 "
          f"on every step; losses {loss_f}", flush=True)

    # one step's buckets through the blocked ring (kernels) vs the oracle
    x, y = as_batch(*batches[0], device)
    with fp32_numerics():
        grads = local_gradients(model, x, y, mesh)[0]
    shifts = mesh.max([aps_max_exponents(g, w) for g in grads])
    starts = _leaf_starts(grads[0])
    cast = [quantize_tree_sr(aps_scale(g, aps_shift_factors(s, fmt[0])),
                             *fmt, None, starts, fused=False)
            for g, s in zip(grads, shifts)]
    key = grad_sr_key(SR_SEED, 0, 1)
    k_pre, k_sum, _ = split(key, 3)
    sr_cast = [quantize_tree_sr(aps_scale(g, aps_shift_factors(s, fmt[0])),
                                *fmt, fold_in(k_pre, r), starts, fused=False)
               for r, (g, s) in enumerate(zip(grads, shifts))]
    bkw = dict(block_scale=True, block_size=block)
    for leaves_of, skw in ((cast, {}), (sr_cast, {"key": k_sum})):
        for b in layout:
            flats = [torch.cat([leaves[i].reshape(-1) for i in b])
                     for leaves in leaves_of]
            okw = dict(offset_start=starts[b[0]], **skw, **bkw)
            oracle = ring_oracle_sum(torch.stack(flats), *fmt, **okw)
            vecs, rep = ring_quantized_sum(flats, mesh, *fmt, verify=True,
                                           **okw)
            if int(rep["ok"]) != 1:
                raise AssertionError(f"bucket {b[0]}..{b[-1]}: verify "
                                     f"report {rep}")
            for got in vecs:
                if not same_bits(got, oracle):
                    raise AssertionError(
                        f"bucket {b[0]}..{b[-1]} ({'SR' if skw else 'RTNE'})"
                        ": the blocked ring differs from ring_oracle_sum")
    print(f"train blocked: one step's APS-cast gradients, {n_buckets} "
          f"buckets: the verified blocked ring on the card == "
          f"ring_oracle_sum(block_scale=True) bitwise, RTNE and SR (key=)",
          flush=True)

    # (c) faults on rank 2 at step 0, and code 0, kernels and plain
    faults = {}
    rank = BLOCKED["fault_rank"]
    for code, name in ((1, "flip"), (2, "stale"), (3, "drop"), (0, "none")):
        runs = []
        for fused in (None, False):
            reset_counts()
            m = []
            f_model, _, _, f_losses, _ = train_run(
                device, batches[:1], mesh, fused, metrics_out=m,
                wire_fault_plan=([code], [rank]), **kw)
            runs.append((m[0], read_counts(), f_model))
        (m, launched, f_model), (pm, _, p_model) = runs
        want_rep = clean if code == 0 else {
            "reduce_ok": 0.0, "reduce_hop_bad": 1.0,
            "reduce_gather_bad": 1.0, "reduce_agree": 0.0}
        for label, got in (("kernels", m), ("plain", pm)):
            if {k: got[k] for k in want_rep} != want_rep:
                raise AssertionError(f"fault {name} ({label}): report "
                                     f"{got}, expected {want_rep}")
        design = blocked_design(w, len(sizes), n_buckets, False,
                                n_buckets + (code != 0))
        if launched != design:
            raise AssertionError(f"fault {name}: launches {launched} != "
                                 f"{design}")
        # a fault: the kernel run == the plain run; code 0: == a clean
        # step through the kernels
        ref_model = p_model if code else train_run(
            device, batches[:1], mesh, None, **kw)[0]
        for (pname, a), b in zip(f_model.state_dict().items(),
                                 ref_model.state_dict().values()):
            if not same_bits(a, b):
                raise AssertionError(f"fault {name}: {pname} differs "
                                     "between the kernel run and "
                                     + ("the plain run" if code
                                        else "the clean step"))
        faults[name] = dict(metrics={k: m[k] for k in want_rep},
                            digest_rows=launched["digest_rows"])
    print("train blocked faults (rank 2, step 0; kernels == plain): "
          + json.dumps(faults), flush=True)

    # (d) one SR step, kernels vs plain
    reset_counts()
    sr_m = []
    sr_model, _, _, sr_losses, _ = train_run(
        device, batches[:1], mesh, None, metrics_out=sr_m,
        grad_rounding="stochastic", grad_seed=SR_SEED, **kw)
    sr_counts = read_counts()
    design = blocked_design(w, len(sizes), n_buckets, True, n_buckets)
    if sr_counts != design:
        raise AssertionError(f"blocked SR launches {sr_counts} != {design}")
    psr_m = []
    psr_model = train_run(device, batches[:1], mesh, False,
                          metrics_out=psr_m, grad_rounding="stochastic",
                          grad_seed=SR_SEED, **kw)[0]
    if sr_m != psr_m or sr_m[0]["reduce_ok"] != 1.0:
        raise AssertionError(f"blocked SR step: {sr_m} with the kernels, "
                             f"{psr_m} with the plain versions")
    for (pname, a), b in zip(sr_model.state_dict().items(),
                             psr_model.state_dict().values()):
        if not same_bits(a, b):
            raise AssertionError(f"blocked SR step: {pname} differs between "
                                 "the kernel and the plain run")
    print(f"train blocked sr: one SR step (seed {SR_SEED}) bitwise equal "
          "with the kernels and with the plain versions, reduce_ok 1",
          flush=True)

    split_ms = reduce_split(mesh, model, x, y, fmt=fmt, verify=True, **bkw)
    prof = step_profile(step, state, batches[0])
    step_s = sum(secs[1:]) / (len(secs) - 1)
    out = dict(
        world=w, global_batch=global_batch, steps=steps, fmt=list(fmt),
        block=block, losses=loss_f, step_ms=step_s * 1e3,
        images_per_s=global_batch / step_s,
        plain_step_ms=sum(plain_secs[1:]) / (len(plain_secs) - 1) * 1e3,
        n_buckets=n_buckets, launches=counts,
        launches_per_step={k: v // steps for k, v in counts.items()},
        sr_launches_per_step=sr_counts, faults=faults, **split_ms,
        profile=prof)
    print("train blocked: " + json.dumps(out), flush=True)

    iters = TRAIN["cli_iters"]
    reset_counts()
    t0 = now()
    rc = cli.main(["--mode", "ring", "--use_APS", "--grad_exp", str(fmt[0]),
                   "--grad_man", str(fmt[1]), "--block-scale",
                   "--block-size", str(block), "--max-iter", str(iters)])
    cli_counts = read_counts()
    # the CLI's mesh is one rank: hop 0 only, one K6-blocked per bucket
    design = {k: iters * v for k, v in blocked_design(
        1, len(sizes), n_buckets, False, 0).items()}
    if rc != 0 or cli_counts != design:
        raise AssertionError(f"blocked trainer CLI returned {rc}, launches "
                             f"{cli_counts} (design {design})")
    out["cli"] = dict(rc=rc, seconds=now() - t0, launches=cli_counts,
                      launches_per_iter={k: v // iters
                                         for k, v in cli_counts.items()})
    print("train blocked cli: " + json.dumps(out["cli"]), flush=True)
    return out


@contextlib.contextmanager
def plain_kernels():
    """K8-K11 replaced by their plain versions, on CUDA tensors too, for
    a comparison run through the same code (their counters are the
    kernels' and do not move)."""
    from cpd_tpu_torch.ops import flash_gqa as fl
    from cpd_tpu_torch.ops import flash_mha as fm
    from cpd_tpu_torch.ops import qgemm as qg

    saved = (qg.qgemm_faithful, fl.flash_gqa_fwd, fl.flash_gqa_bwd,
             fm.flash_mha_fwd, fm.flash_mha_bwd)
    qg.qgemm_faithful = qg.qgemm_faithful_ref
    fl.flash_gqa_fwd, fl.flash_gqa_bwd = (fl.flash_gqa_fwd_ref,
                                          fl.flash_gqa_bwd_ref)
    fm.flash_mha_fwd, fm.flash_mha_bwd = (fm.flash_mha_fwd_ref,
                                          fm.flash_mha_bwd_ref)
    try:
        yield
    finally:
        (qg.qgemm_faithful, fl.flash_gqa_fwd, fl.flash_gqa_bwd,
         fm.flash_mha_fwd, fm.flash_mha_bwd) = saved


def qgemm_cases(fmt, shapes, generator, device) -> list:
    """K8's check inputs at one format and each (M, K, N) of ``shapes``,
    each with rows that saturate (x 2^10 the format's max), land on or
    below the format's subnormals (x 2^-12) and sit at the max (the
    carry)."""
    import torch

    from cpd_tpu_torch.quant.numerics import max_finite

    mf = max_finite(*fmt)
    out = []
    for m, k, n in shapes:
        a = torch.randn((m, k), generator=generator, device=device)
        b = torch.randn((k, n), generator=generator, device=device) / k**0.5
        a[0] *= 1024.0 * mf
        a[1] *= 2.0 ** -12
        a[2] = mf * (0.9 + 0.2 * torch.rand(
            (k,), generator=generator, device=device))
        b[:, 0] = 1.0
        out.append((f"{m}x{k}x{n}", a, b))
    return out


def lm_gemm_shapes() -> list:
    """(M, K, N) of the slice's FFN GEMMs at one rank's 4096 tokens: wi
    and wo_mlp forward, and the backward's grad_x and grad_W."""
    t = LM_TRAIN["per_rank_batch"] * LM_TRAIN["seq"]
    d, ff = LM_MODEL["d_model"], LM_MODEL["d_ff"]
    return [(t, d, ff), (t, ff, d), (d, t, ff), (ff, t, d)]


def step_census(pairs, exp_bits: int, man_bits: int) -> list:
    """For each (a, b) of ``pairs`` (64 x K and K x 64, any K), over the
    quantized Kahan scan of a @ b as K8's tile kernel runs it (a warp
    holds rows {2w, 2w + 1, 2w + 16, 2w + 17} x the 32 columns of a 32 x
    32 tile; a step is a zero step for the warp where the bound max|a| *
    max|b| of its products is below ``tiny`` and every s and c has been
    ±0 since the 32-step chunk began): the share of warp-steps that cast
    (are not zero steps), the share of warp-steps that would fall back to
    the reference cast (an input at or past the format's saturation, Inf,
    NaN, or an fp32-subnormal product), and the shares of the cast inputs
    (five per step) that are ±0, have a normal target, have a subnormal
    target, or are special (those the fallback takes).  One plain scan
    runs the pairs batched, each counted up to its own K."""
    import torch

    from cpd_tpu_torch.ops.qgemm import cast_constants
    from cpd_tpu_torch.quant.numerics import cast_body

    dev = pairs[0][0].device
    ks = [a.shape[1] for a, _ in pairs]
    n_p, kmax = len(pairs), max(ks)
    a_all = torch.zeros((n_p, 64, kmax), device=dev)
    b_all = torch.zeros((n_p, kmax, 64), device=dev)
    for i, (a, b) in enumerate(pairs):
        a_all[i, :, :ks[i]], b_all[i, :ks[i]] = a, b
    live = torch.tensor([[k < ki for ki in ks] for k in range(kmax)],
                        device=dev)
    f = cast_constants(exp_bits, man_bits)
    tiny = torch.tensor(f.tiny, dtype=torch.int32).view(torch.float32)
    # the zero-step bound per (sample, warp, k): warps in (tile row, w,
    # tile column) order
    amax = a_all.abs().reshape(n_p, 2, 2, 8, 2, kmax).amax((2, 4))
    bmax = b_all.abs().reshape(n_p, kmax, 2, 32).amax(-1)
    bound = (amax[:, :, :, None, :] * bmax.transpose(1, 2)[:, None, None]
             ).reshape(n_p, 32, kmax) < tiny.to(dev)

    def warps(x):
        # (P, 64, 64) -> (P, 32 warps, 128 outputs)
        x = x.reshape(n_p, 2, 2, 8, 2, 2, 32).permute(0, 1, 3, 5, 2, 4, 6)
        return x.reshape(n_p, 32, 128)

    def q(x, flags, on, product=False):
        u = x.view(torch.int32) & 0x7FFFFFFF
        special = (u >= f.sat) | ((u > 0) & (u < 0x800000))
        kinds.add_(torch.stack([
            u == 0, (u >= f.norm) & (u < f.sat),
            (u >= 0x800000) & (u < f.norm), special]).sum((2, 3)).T
            * on[:, None])
        flags |= warps(u >= f.sat).any(-1)
        if product:
            flags |= warps(special & (u < 0x800000)).any(-1)
        return cast_body(x, exp_bits, man_bits)

    s = torch.zeros((n_p, 64, 64), device=dev)
    c = torch.zeros_like(s)
    casts = torch.zeros(n_p, dtype=torch.int64, device=dev)
    falls = torch.zeros_like(casts)
    kinds = torch.zeros((n_p, 4), dtype=torch.int64, device=dev)
    for k in range(kmax):
        if k % 32 == 0:
            zeros = warps(((s.view(torch.int32) | c.view(torch.int32))
                           & 0x7FFFFFFF) == 0).all(-1)
        casting = ~(zeros & bound[:, :, k])
        zeros &= ~casting
        flags = torch.zeros((n_p, 32), dtype=torch.bool, device=dev)
        on = live[k]
        tmp = q(a_all[:, :, k, None] * b_all[:, None, k, :], flags, on,
                product=True)
        y = q(tmp - c, flags, on)
        t = q(s + y, flags, on)
        c = q(q(t - s, flags, on) - y, flags, on)
        s = t
        casts.add_(casting.sum(-1) * on)
        falls.add_((flags & casting).sum(-1) * on)
    return [(n / (32 * ki), m / (32 * ki),
             dict(zip(("zero", "normal_target", "subnormal_target",
                       "special"), (v / (5 * 64 * 64 * ki) for v in kd))))
            for n, m, kd, ki in zip(casts.tolist(), falls.tolist(),
                                    kinds.tolist(), ks)]


def cast_probe(device) -> dict:
    """K8's cast probe at K = 1, a = [[1]] (1 * x is exact: the first cast
    sees x itself): every fp32 bit pattern, chunk by chunk, against the
    plain scan for each of QGEMM_FORMATS; and `cast_probe_patterns` (every
    exponent field x both signs x mantissas at the format's round, sticky
    and lsb boundaries) for all 192 formats against the plain scan and the
    kept generic kernel, bitwise."""
    import time

    import torch

    from cpd_tpu_torch.ops import qgemm as qg

    one = torch.ones((1, 1), device=device)
    t0 = time.perf_counter()
    for fmt in QGEMM_FORMATS:
        for lo in range(-2**31, 2**31, QGEMM_PROBE_CHUNK):
            x = torch.arange(lo, lo + QGEMM_PROBE_CHUNK, dtype=torch.int32,
                             device=device).view(torch.float32)[None]
            if not same_bits(qg.qgemm_faithful(one, x, *fmt),
                             qg.qgemm_faithful_ref(one, x, *fmt)):
                raise AssertionError(f"K8 {fmt} at K = 1 differs from the "
                                     f"plain scan on the bit patterns "
                                     f"{lo & 0xFFFFFFFF:#010x} + "
                                     f"[0, {QGEMM_PROBE_CHUNK})")
    all_s = time.perf_counter() - t0
    generic = qg.generic_launcher()
    t0, n = time.perf_counter(), 0
    for eb in range(1, 9):
        for mb in range(24):
            bits = qg.cast_probe_patterns(eb, mb, QGEMM_PROBE_PER_EXPONENT)
            x = torch.from_numpy(bits.view("int32")).to(device).view(
                torch.float32)[None]
            got = qg.qgemm_faithful(one, x, eb, mb)
            if not (same_bits(got, generic(one, x, eb, mb))
                    and same_bits(got, qg.qgemm_faithful_ref(one, x, eb,
                                                             mb))):
                raise AssertionError(f"K8 ({eb}, {mb}) at K = 1 differs "
                                     "from the kept kernel or the plain "
                                     "scan on the boundary patterns")
            n += bits.size
    out = dict(all_patterns_formats=[list(f) for f in QGEMM_FORMATS],
               all_patterns_s=all_s, boundary_formats=192,
               boundary_per_format=n // 192,
               boundary_s=time.perf_counter() - t0)
    print(f"kernel qgemm cast probe: K8 at K = 1 bitwise the plain scan on "
          f"all 2^32 fp32 bit patterns for {list(QGEMM_FORMATS)} "
          f"({all_s:.1f} s), and bitwise the plain scan and the kept "
          f"generic kernel on {n // 192} boundary patterns for each of "
          f"the 192 formats ({out['boundary_s']:.1f} s)", flush=True)
    return out


def qgemm_phase(device) -> dict:
    """Phase 10a: K8 against its plain version, bitwise, over the formats
    at odd shapes, and at e4m3 at the slice's four FFN GEMM shapes whole;
    the cast probe (`cast_probe`); timed at those shapes in turns with the
    generic kernel it replaced (kept, kernel, kernel, kept) over input
    sets that together hold twice the L2, gated at QGEMM_SPEEDUP_FLOOR.
    Its bound counts the work (QGEMM_STEP_WORK, QGEMM_ZERO_STEP_WORK) on
    the busiest pipe, in the share of warp-steps that cast on this data
    (`step_census` on 64 x 64 outputs of the timed inputs).  Beside it,
    as issue efficiency only, the same figure from the SASS instructions
    of the tile kernel's own loop (one pass: 4 steps, the thread's 2 x 2
    outputs) along the paths this data takes: between the shortest path
    (a zero step) and the longest (a step that casts); the cast has no
    branch by kind of value, so its shortest and longest paths coincide.
    The generic kernel's counts are printed too."""
    import time

    import torch

    from cpd_tpu_torch.ops import qgemm as qg
    from cpd_tpu_torch.ops.build import build_log

    gen = torch.Generator(device=device).manual_seed(96)
    fmt = LM_PATH["ffn_exp"], LM_PATH["ffn_man"]
    checks = [(f, [(37, 29, 23), (300, 129, 200), (70, 65, 33)])
              for f in QGEMM_FORMATS]
    checks.append((fmt, lm_gemm_shapes()))
    cases, t0 = 0, time.perf_counter()
    for f, shapes in checks:
        for name, a, b in qgemm_cases(f, shapes, gen, device):
            got = qg.qgemm_faithful(a, b, *f)
            torch.cuda.synchronize()
            want = qg.qgemm_faithful_ref(a, b, *f)
            if not same_bits(got, want):
                raise AssertionError(f"qgemm {f} {name}: the kernel "
                                     "differs from its plain version")
            cases += 1
    print(f"kernel qgemm: {cases} products bitwise equal to the plain "
          f"scan (formats {list(QGEMM_FORMATS)} at odd shapes; {fmt} at "
          f"the slice's GEMMs {lm_gemm_shapes()}; saturating, subnormal "
          f"and carrying rows) in {time.perf_counter() - t0:.1f} s",
          flush=True)
    probe = cast_probe(device)

    build = {}
    for line in build_log("qgemm").splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "registers" in line:
            build.setdefault(name, {})["registers"] = int(
                line.split("Used ")[1].split()[0])
        elif "spill" in line:
            spills = [int(w) for w in line.split() if w.isdigit()]
            build.setdefault(name, {})["spill_bytes"] = spills[1] + spills[2]
    tile = {k: v for k, v in build.items() if "qgemm_tile_kernel" in k}
    if len(tile) != 2 or any(v.get("spill_bytes", 1) for v in tile.values()):
        raise AssertionError(f"qgemm build: tile kernels {tile} (both "
                             "instantiations, no spills expected)")
    print("kernel qgemm build: " + "; ".join(
        f"{'FaddCast' if 'FaddCast' in k else 'RefCast'} "
        f"{v['registers']} registers, {v['spill_bytes']} spill bytes"
        for k, v in tile.items()), flush=True)

    insns, loops, branches = _sass_loops("qgemm", QGEMM_TILE_KERNEL)
    loop = _fast_loop(insns, loops)
    whole = _by_pipe(insns[loop[0]:loop[1] + 1], 4)
    paths = loop_paths(insns, loop, branches, steps=4)
    lo, hi = paths["short"], paths["long"]
    g_insns, g_loops, g_branches = _sass_loops("qgemm", QGEMM_GENERIC_KERNEL)
    g_loop = _inner_loop(g_loops)
    old = dict(loop_paths(g_insns, g_loop, g_branches),
               whole=_by_pipe(g_insns[g_loop[0]:g_loop[1] + 1], 1))
    generic = qg.generic_launcher()
    shapes, samples = {}, []
    for m, k, n in lm_gemm_shapes():
        set_bytes = 4 * (m * k + k * n)
        sets = [(torch.randn((m, k), generator=gen, device=device),
                 torch.randn((k, n), generator=gen, device=device) / k**0.5)
                for _ in range(-(-2 * l2_bytes() // set_bytes) + 1)]
        if not same_bits(qg.qgemm_faithful(*sets[0], *fmt),
                         generic(*sets[0], *fmt)):
            raise AssertionError(f"qgemm {fmt} {m}x{k}x{n}: the kernel "
                                 "differs from the kept generic kernel")
        # ~13-50 ms a launch: CUDA events around back-to-back launches
        # give the device time, host dispatch hidden behind the kernels;
        # in turns with the kept kernel: kept, kernel, kernel, kept
        kern = rotating(sets, lambda x, y: qg.qgemm_faithful(x, y, *fmt))
        kept = rotating(sets, lambda x, y: generic(x, y, *fmt))
        t1, k1, k2, t2 = (time_ms(f, iters=len(sets), warmup=1)
                          for f in (kept, kern, kern, kept))
        a, b = sets[0]
        samples.append((a[:64], b[:, :64]))
        shapes[f"{m}x{k}x{n}"] = dict(
            ms=(k1 + k2) / 2, generic_ms=(t1 + t2) / 2,
            speedup=(t1 + t2) / (k1 + k2), input_sets=len(sets),
            loop_body_ms=pipe_bound_s(whole, m * n * k)[0] * 1e3,
            matmul_ms=time_ms(lambda: a @ b, iters=20))
        del sets
    t0 = time.perf_counter()
    census = step_census(samples, *fmt)
    census_s = time.perf_counter() - t0
    for (m, k, n), (share, fall, kinds) in zip(lm_gemm_shapes(), census):
        alu, fp32 = (z + share * (w - z) for w, z in zip(
            QGEMM_STEP_WORK, QGEMM_ZERO_STEP_WORK))
        work = {"alu": alu, "imad": 0.0, "alu+imad": alu, "fp32": fp32,
                "cvt": 0.0, "issue": alu + fp32}
        t_ops, pipe = pipe_bound_s(work, m * n * k)
        t_bytes = 4 * (m * k + k * n + m * n) / PEAK_BYTES_PER_S
        per = {p: lo[p] + share * (hi[p] - lo[p])
               for p in ("alu", "imad", "alu+imad", "fp32", "cvt", "issue")}
        r = shapes[f"{m}x{k}x{n}"]
        r.update(
            cast_share=share, fallback_share=fall,
            cast_inputs={kd: round(v, 4) for kd, v in kinds.items()},
            work_per_step={p: round(v, 3) for p, v in work.items()},
            per_step={p: round(v, 3) for p, v in per.items()},
            bound_ms=max(t_ops, t_bytes) * 1e3,
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            bound_pipe=pipe,
            sass_bound_ms=pipe_bound_s(per, m * n * k)[0] * 1e3)
        r["issue_efficiency"] = r["sass_bound_ms"] / r["ms"]
    small = (256, 64, 256)
    a = torch.randn(small[:2], generator=gen, device=device)
    b = torch.randn(small[1:], generator=gen, device=device)
    out = dict(cases=cases, probe=probe, build=tile, shapes=shapes,
               sass_loop_body=whole, sass_paths=paths,
               generic_sass=old, census_s=census_s, plain_shape=small,
               plain_ms=time_ms(lambda: qg.qgemm_faithful_ref(a, b, *fmt),
                                iters=2, warmup=1),
               small_ms=time_ms(lambda: qg.qgemm_faithful(a, b, *fmt),
                                iters=20))
    main = shapes["x".join(map(str, lm_gemm_shapes()[0]))]
    out.update(ms=main["ms"], bound_ms=main["bound_ms"],
               bound_by=main["bound_by"], generic_ms=main["generic_ms"],
               speedup=main["speedup"], sass_bound_ms=main["sass_bound_ms"],
               issue_efficiency=main["issue_efficiency"])
    for shape, r in shapes.items():
        print(f"kernel qgemm_faithful [{fmt}, {shape}, {r['input_sets']} "
              f"input sets]: kernel_ms {r['ms']:.3f} the kept generic "
              f"kernel {r['generic_ms']:.3f}, {r['speedup']:.2f}x the "
              f"kernel's time; bound_ms {r['bound_ms']:.3f} "
              f"({r['bound_by']}, {r['bound_pipe']} pipe; the work per "
              f"Kahan step {json.dumps(r['work_per_step'])}, "
              f"{r['cast_share']:.4f} of warp-steps cast, "
              f"{r['fallback_share']:.4f} of warp-steps fall back to the "
              f"reference cast; cast inputs by kind "
              f"{json.dumps(r['cast_inputs'])}); issue efficiency only: "
              f"this build's SASS per Kahan step "
              f"{json.dumps(r['per_step'])} (the cast has no branch by "
              f"kind of value, so its shortest and longest paths "
              f"coincide) take {r['sass_bound_ms']:.3f} ms, "
              f"{r['issue_efficiency']:.3f} of the kernel's time, the "
              f"whole loop body {r['loop_body_ms']:.3f}; library_ms null "
              f"({NO_LIBRARY_QGEMM}: torch.matmul fp32 "
              f"{r['matmul_ms']:.4f})", flush=True)
    brief = {k: {p: v for p, v in d.items() if p != "opcodes"}
             for k, d in dict(paths, whole=whole).items()}
    brief_old = {k: {p: v for p, v in d.items() if p != "opcodes"}
                 for k, d in old.items()}
    print(f"kernel qgemm_faithful [{fmt}, {small}]: kernel_ms "
          f"{out['small_ms']:.4f} plain_ms {out['plain_ms']:.3f}; census "
          f"{census_s:.1f} s; SASS instructions per Kahan step of the tile "
          f"kernel {json.dumps(brief)}, of the kept generic kernel "
          f"{json.dumps(brief_old)}; the tile loop's longest path "
          f"opcodes {json.dumps(paths['long']['opcodes'])}", flush=True)
    slow = {k: r["speedup"] for k, r in shapes.items()
            if r["speedup"] < (QGEMM_SPEEDUP_FLOOR if r is main else 1.0)}
    if slow:
        raise AssertionError(f"K8 at {fmt}: only {slow}x the kept generic "
                             f"kernel's speed (floor {QGEMM_SPEEDUP_FLOOR}x "
                             "at the main shape, 1x at the others)")
    return out


def flash_flops(b, tq, tk, h, d, causal, products) -> int:
    """2 * products * B * H * (visible (query, key) pairs) * D."""
    pairs = (sum(min(i + 1, tk) for i in range(tq)) if causal
             else tq * tk)
    return 2 * products * b * h * pairs * d


def within(x, want, rtol: float, atol: float) -> float:
    """The largest ``|x - want| / (atol + rtol |want|)`` over the
    elements, in float64: at most 1 where every element is within
    tolerance."""
    import torch

    x, want = x.to(torch.float64), want.to(torch.float64)
    ratio = (x - want).abs() / (atol + rtol * want.abs())
    return float(torch.nan_to_num(ratio, nan=math.inf).max())


def attention_inputs(shape, dtype, generator, device) -> tuple:
    """Seeded q, k, v and an output gradient for (B, Tq, Tk, H, H_kv, D)
    in ``dtype``."""
    import torch

    b, tq, tk, h, hkv, d = shape

    def rand(*s):
        return torch.randn(s, generator=generator, device=device).to(dtype)

    return rand(b, tq, h, d), rand(b, tk, hkv, d), rand(b, tk, hkv, d), \
        rand(b, tq, h, d)


def attention_check(fwd, bwd, fwd_ref, bwd_ref, shape, dtype, causal,
                    generator, device, repeat: bool = False) -> dict:
    """One kernel pair against its plain pair on the same inputs: the
    largest error of (out, lse) and of (dq, dk, dv), absolute and as a
    share of the case's tolerance (fp32: FLASH_ATOL / FLASH_GRAD_ATOL;
    bf16: BF16_RTOL / BF16_ATOL).  ``repeat``: launch both again on the
    same inputs and raise unless every output is bitwise the first's."""
    import torch

    q, k, v, g = attention_inputs(shape, dtype, generator, device)
    out, lse = fwd(q, k, v, causal)
    grads = bwd(q, k, v, out, lse, g, causal)
    if repeat:
        again = (*fwd(q, k, v, causal), *bwd(q, k, v, out, lse, g, causal))
        if not all(same_bits(x, y)
                   for x, y in zip((out, lse, *grads), again)):
            raise AssertionError(f"{shape} {dtype} causal={causal}: two "
                                 "launches on the same inputs differ")
    torch.cuda.synchronize()
    r_out, r_lse = fwd_ref(q, k, v, causal)
    r_grads = bwd_ref(q, k, v, r_out, r_lse, g, causal)
    fp32 = dtype == torch.float32
    res = {}
    for part, pairs, atol in (("fwd", ((out, r_out), (lse, r_lse)),
                               FLASH_ATOL),
                              ("bwd", tuple(zip(grads, r_grads)),
                               FLASH_GRAD_ATOL)):
        if any(x.dtype != w.dtype or x.shape != w.shape for x, w in pairs):
            raise AssertionError(f"{part} {shape} {dtype}: kernel and plain "
                                 "outputs differ in dtype or shape")
        res[f"{part}_err"] = max(max_abs_diff(x, w) for x, w in pairs)
        res[f"{part}_share"] = max(
            within(x, w, 0.0, atol) if fp32
            else within(x, w, BF16_RTOL, BF16_ATOL) for x, w in pairs)
    return res


def sdpa_backend(fn) -> str:
    """The backend `scaled_dot_product_attention` runs ``fn()`` on: the
    first of the dispatcher's priority order that takes the call pinned
    alone with `torch.nn.attention.sdpa_kernel`."""
    import warnings

    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel

    members = {int(b): b for b in SDPBackend.__members__.values()}
    order = [members[b] for b in torch._C._get_sdp_priority_order()
             if b in members]
    for backend in order:
        try:
            # a backend that does not take the call warns why, then raises
            with warnings.catch_warnings(), sdpa_kernel([backend]):
                warnings.simplefilter("ignore")
                fn()
        except RuntimeError:
            continue
        return backend.name
    raise AssertionError("no SDPA backend takes the call")


def attention_bounds(flops: int, n_bytes: int) -> dict:
    """The fp32 attention's least time at 3xTF32's 165 TFLOP/s (or its
    bytes at 3.35 TB/s, the larger), and beside it at fp32's 67 TFLOP/s
    on the CUDA cores and one TF32 product's 495 TFLOP/s."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_3XTF32_FLOPS
    return dict(bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                fp32_bound_ms=max(flops / PEAK_FP32_FLOPS, t_bytes) * 1e3,
                tf32_bound_ms=max(flops / PEAK_TF32_FLOPS, t_bytes) * 1e3)


def flash_phase(device) -> dict:
    """Phase 10b: K9 and K10 in fp32 against their plain versions at the
    slice's shape, with pad keys (T = 1000), at rep 1 and 2, non-causal,
    and at head_dim 32 (the small model's), each launched twice and
    bitwise equal; timed at the slice's shape in turns with the CUDA-core
    template they replace (`flash_gqa.core_launchers`), beside their plain
    versions and SDPA with enable_gqa and with K/V expanded to the query
    heads (forward, backward alone, forward + backward); then the bf16
    arm (flash_mha_tc.cu; held to its plain version in phase 11a) timed
    the same way against the bf16 templates and SDPA bf16."""
    import torch
    import torch.nn.functional as F

    from cpd_tpu_torch.ops import flash_gqa as fl

    gen = torch.Generator(device=device).manual_seed(95)
    b0, t0 = LM_TRAIN["per_rank_batch"], LM_TRAIN["seq"]
    h0, hkv0 = LM_MODEL["n_heads"], LM_MODEL["n_kv_heads"]
    d0 = LM_MODEL["d_model"] // h0
    cases = [(b0, t0, h0, hkv0, d0, True), (2, 1000, h0, hkv0, d0, True),
             (2, 256, 4, 4, d0, True), (2, 256, 4, 2, d0, True),
             (2, 512, h0, hkv0, d0, False), (2, 128, 4, 2, 32, True)]
    err_f = err_b = 0.0
    for bb, t, h, hkv, d, causal in cases:
        r = attention_check(fl.flash_gqa_fwd, fl.flash_gqa_bwd,
                            fl.flash_gqa_fwd_ref, fl.flash_gqa_bwd_ref,
                            (bb, t, t, h, hkv, d), torch.float32, causal,
                            gen, device, repeat=True)
        if max(r["fwd_share"], r["bwd_share"]) > 1.0:
            raise AssertionError(
                f"flash {(bb, t, h, hkv, d, causal)}: forward/LSE err "
                f"{r['fwd_err']} (atol {FLASH_ATOL}), gradient err "
                f"{r['bwd_err']} (atol {FLASH_GRAD_ATOL})")
        err_f, err_b = max(err_f, r["fwd_err"]), max(err_b, r["bwd_err"])
    print(f"kernel flash_gqa: K9 out/LSE within {err_f:.3e} (atol "
          f"{FLASH_ATOL}) and K10 dq/dk/dv within {err_b:.3e} (atol "
          f"{FLASH_GRAD_ATOL}) of their plain versions over {len(cases)} "
          "cases, two launches bitwise equal in each", flush=True)

    shape = cases[0]
    bb, t, h, hkv, d, causal = shape
    q = torch.randn((bb, t, h, d), generator=gen, device=device)
    k = torch.randn((bb, t, hkv, d), generator=gen, device=device)
    v = torch.randn((bb, t, hkv, d), generator=gen, device=device)
    out, lse = fl.flash_gqa_fwd(q, k, v, causal)
    g = torch.randn(out.shape, generator=gen, device=device)
    core_fwd, core_bwd = fl.core_launchers()
    qt, kt, vt, gt = (x.transpose(1, 2).contiguous() for x in (q, k, v, g))
    # SDPA both ways: GQA-native, and on K/V expanded to the query heads
    sdpa = {}
    for form, kv, kw in (
            ("enable_gqa", (kt, vt), dict(is_causal=True, enable_gqa=True)),
            ("expanded", tuple(x.repeat_interleave(h // hkv, dim=1)
                               for x in (kt, vt)), dict(is_causal=True))):
        leaves = (qt.detach().requires_grad_(),
                  *(x.detach().requires_grad_() for x in kv))
        o_lib = F.scaled_dot_product_attention(*leaves, **kw)

        def fwd_bwd(leaves=leaves, kw=kw):
            o = F.scaled_dot_product_attention(*leaves, **kw)
            torch.autograd.grad(o, leaves, gt)

        sdpa[form] = dict(
            backend=sdpa_backend(
                lambda kv=kv, kw=kw: F.scaled_dot_product_attention(qt, *kv,
                                                                    **kw)),
            fwd_ms=queued_ms(lambda kv=kv, kw=kw:
                             F.scaled_dot_product_attention(qt, *kv, **kw),
                             iters=20),
            # the backward alone: one stored forward, its graph kept
            bwd_ms=queued_ms(lambda o=o_lib, leaves=leaves:
                             torch.autograd.grad(o, leaves, gt,
                                                 retain_graph=True),
                             iters=20),
            fwd_bwd_ms=queued_ms(fwd_bwd, iters=20))
        del o_lib, leaves
    print(f"kernel flash_gqa SDPA fp32 [{list(shape)}]: " + "; ".join(
        f"{form}: {r['backend']} forward {r['fwd_ms']:.4f} backward alone "
        f"{r['bwd_ms']:.4f} forward + backward {r['fwd_bwd_ms']:.4f} ms"
        for form, r in sdpa.items()), flush=True)

    n_bytes_f = 4 * (2 * q.numel() + k.numel() + v.numel() + lse.numel())
    # q, out, dout, dq; k, v, dk, dv; lse: each read or written once
    n_bytes_b = 4 * (4 * q.numel() + 4 * k.numel() + lse.numel())
    res = {}
    for name, fn, core, plain, products, n_bytes, part in (
            ("flash_gqa_fwd", lambda: fl.flash_gqa_fwd(q, k, v, causal),
             lambda: core_fwd(q, k, v, causal, "template"),
             lambda: fl.flash_gqa_fwd_ref(q, k, v, causal), 2, n_bytes_f,
             "fwd"),
            ("flash_gqa_bwd",
             lambda: fl.flash_gqa_bwd(q, k, v, out, lse, g, causal),
             lambda: core_bwd(q, k, v, out, lse, g, causal, "template"),
             lambda: fl.flash_gqa_bwd_ref(q, k, v, out, lse, g, causal), 5,
             n_bytes_b, "bwd")):
        flops = flash_flops(bb, t, t, h, d, causal, products)
        # device time by queued_ms, in turns with the CUDA-core template:
        # template, kernel, kernel, template
        t1, k1, k2, t2 = (queued_ms(f, iters=20) for f in (core, fn, fn,
                                                          core))
        ms, core_ms = (k1 + k2) / 2, (t1 + t2) / 2
        form = min(sdpa, key=lambda f: sdpa[f][f"{part}_ms"])
        res[name] = dict(
            ms=ms, cuda_core_ms=core_ms, speedup=core_ms / ms,
            call_ms=time_ms(fn, iters=20), plain_ms=time_ms(plain, iters=3),
            **attention_bounds(flops, n_bytes), gflop=flops / 1e9,
            max_abs_err=err_f if products == 2 else err_b,
            shape=list(shape),
            library_ms=sdpa[form][f"{part}_ms"],
            library_note=(f"scaled_dot_product_attention fp32 "
                          + ("forward" if part == "fwd" else
                             "backward alone (autograd.grad of a stored "
                             "forward)")
                          + f", the faster form: {form} "
                          f"({sdpa[form]['backend']})"),
            library_forms={f: {"backend": r["backend"],
                               "ms": r[f"{part}_ms"]}
                           for f, r in sdpa.items()},
            kernels_ms={k_: round(v_, 5) for k_, v_ in
                        device_kernels_ms(fn, iters=20).items()})
        if part == "bwd":
            res[name]["library_fwd_bwd_ms"] = min(
                r["fwd_bwd_ms"] for r in sdpa.values())
        r = res[name]
        print(f"kernel {name} [{shape}]: kernel_ms {ms:.4f} (device, "
              f"flash_f32_tc.cu; per call with host dispatch "
              f"{r['call_ms']:.4f}) the CUDA-core template (flash_gqa.cu) "
              f"{core_ms:.4f}, {r['speedup']:.2f}x the kernel's time; "
              f"plain_ms {r['plain_ms']:.4f} bound_ms {r['bound_ms']:.4f} "
              f"({r['bound_by']}, 3xTF32 165 TFLOP/s; fp32 67 TFLOP/s "
              f"{r['fp32_bound_ms']:.4f}; one TF32 product 495 TFLOP/s "
              f"{r['tf32_bound_ms']:.4f}) {r['gflop']:.3f} GFLOP; "
              f"library_ms {r['library_ms']:.4f} ({r['library_note']}); "
              f"by kernel {r['kernels_ms']}", flush=True)
    # K9/K10's bf16 arm (flash_mha_tc.cu's tensor-core kernels: the GQA
    # LM's --bf16 path, bench.py's GQA flash arm) at the same shape, in
    # turns with flash_gqa.cu's bf16 templates it replaced (gate
    # TC_SPEEDUP_FLOOR), beside its plain version, its bf16 tensor-core
    # bound and SDPA bf16 on K/V expanded to the query heads
    qb, kb, vb, gb = (x.to(torch.bfloat16) for x in (q, k, v, g))
    ob, lb = fl.flash_gqa_fwd(qb, kb, vb, causal)
    qbt, gbt = (x.transpose(1, 2).contiguous() for x in (qb, gb))
    kvb = tuple(x.transpose(1, 2).repeat_interleave(h // hkv, dim=1)
                .contiguous() for x in (kb, vb))
    leaves = (qbt.detach().requires_grad_(),
              *(x.detach().requires_grad_() for x in kvb))
    o_lib = F.scaled_dot_product_attention(*leaves, is_causal=True)
    backend = sdpa_backend(lambda: F.scaled_dot_product_attention(
        qbt, *kvb, is_causal=True))
    for name, fn, core, plain, lib_fn, products, n_bytes in (
            ("flash_gqa_fwd", lambda: fl.flash_gqa_fwd(qb, kb, vb, causal),
             lambda: core_fwd(qb, kb, vb, causal, "template"),
             lambda: fl.flash_gqa_fwd_ref(qb, kb, vb, causal),
             lambda: F.scaled_dot_product_attention(qbt, *kvb,
                                                    is_causal=True),
             2, 2 * (2 * qb.numel() + 2 * kb.numel()) + 4 * lb.numel()),
            ("flash_gqa_bwd",
             lambda: fl.flash_gqa_bwd(qb, kb, vb, ob, lb, gb, causal),
             lambda: core_bwd(qb, kb, vb, ob, lb, gb, causal, "template"),
             lambda: fl.flash_gqa_bwd_ref(qb, kb, vb, ob, lb, gb, causal),
             lambda: torch.autograd.grad(o_lib, leaves, gbt,
                                         retain_graph=True),
             5, 2 * (4 * qb.numel() + 4 * kb.numel()) + 4 * lb.numel())):
        flops = flash_flops(bb, t, t, h, d, causal, products)
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS, n_bytes / PEAK_BYTES_PER_S
        # template, kernel, kernel, template
        t1, k1, k2, t2 = (queued_ms(f, iters=20) for f in (core, fn, fn,
                                                          core))
        ms, core_ms = (k1 + k2) / 2, (t1 + t2) / 2
        r = res[name]["bf16"] = dict(
            ms=ms, cuda_core_ms=core_ms, speedup=core_ms / ms,
            call_ms=time_ms(fn, iters=20), plain_ms=time_ms(plain, iters=3),
            bound_ms=max(t_ops, t_bytes) * 1e3,
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            gflop=flops / 1e9, shape=list(shape),
            library_ms=queued_ms(lib_fn, iters=20),
            library_note=f"scaled_dot_product_attention bf16, K/V expanded "
                         f"({backend}), " + ("forward" if products == 2
                                             else "backward alone"),
            source="cpd_tpu_torch/csrc/flash_mha_tc.cu",
            kernels_ms={k_: round(v_, 5) for k_, v_ in
                        device_kernels_ms(fn, iters=20).items()})
        r["vs_library"] = ms / r["library_ms"]
        print(f"kernel {name} bf16 [{list(shape)}]: kernel_ms {ms:.4f} "
              f"(device, flash_mha_tc.cu; per call with host dispatch "
              f"{r['call_ms']:.4f}) the CUDA-core template (flash_gqa.cu) "
              f"{core_ms:.4f}, {r['speedup']:.2f}x the kernel's time; "
              f"plain_ms {r['plain_ms']:.4f} bound_ms {r['bound_ms']:.4f} "
              f"({r['bound_by']}, bf16 tensor cores 989 TFLOP/s; bytes at "
              f"3.35 TB/s) {r['gflop']:.3f} GFLOP; library_ms "
              f"{r['library_ms']:.4f} ({r['library_note']}), kernel/library "
              f"{r['vs_library']:.2f}; by kernel {r['kernels_ms']}",
              flush=True)
    del o_lib, leaves
    slow = {n: res[n]["bf16"]["speedup"] for n in GQA_BF16_KERNELS
            if res[n]["bf16"]["speedup"] < TC_SPEEDUP_FLOOR}
    if slow:
        raise AssertionError(f"K9/K10 bf16 at {list(shape)}: only {slow}x "
                             "faster than the CUDA-core template (floor "
                             f"{TC_SPEEDUP_FLOOR}x)")
    slow = {n: r["speedup"] for n, r in res.items()
            if r["speedup"] < F32_TC_SPEEDUP_FLOOR}
    if slow:
        raise AssertionError(f"K9/K10 fp32 at {list(shape)}: only {slow}x "
                             "faster than the CUDA-core template (floor "
                             f"{F32_TC_SPEEDUP_FLOOR}x)")
    return res


def lm_model(device, seed: int, cfg=None, **path):
    """A port LM at ``cfg`` (default the slice's width) with ``path``'s
    options, weights from a seeded generator."""
    import torch

    from cpd_tpu_torch.models import transformer_lm

    gen = torch.Generator(device=device).manual_seed(seed)
    return transformer_lm(**(cfg or LM_MODEL), **path,
                          device=device).init_weights(gen)


def lm_batches(vocab: int, steps: int, rows: int, seq: int, seed: int):
    """``steps`` global (rows, seq) token batches and their next-token
    targets, uniform over the vocabulary from a seeded numpy generator
    (bench.py's LM arm draws its tokens so)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        x = rng.randint(0, vocab, (rows, seq + 1)).astype(np.int64)
        out.append((x[:, :-1], x[:, 1:]))
    return out


def lm_design(n_layers: int, world: int, leaves: int, buckets: int) -> dict:
    """Launches of one faithful APS LM step over W ranks: per rank and
    layer, three K8 GEMMs for each of wi and wo_mlp (forward, grad_x,
    grad_W), one K9 and one K10; the reduce's K1 per leaf and rank and
    K3 per bucket and rank."""
    want = reduce_design("faithful", False, False, world, leaves, buckets)
    want.update(qgemm_faithful=6 * n_layers * world,
                flash_gqa_fwd=n_layers * world,
                flash_gqa_bwd=n_layers * world)
    return want


def lm_train(device, model, batches, world, opt=None, fmt=None, fused=None,
             seconds=None) -> tuple:
    """Steps of the LM slice's train step, one per batch; returns the
    state, the step and the per-step metrics (host floats)."""
    import torch

    from cpd_tpu_torch.obs.timing import now
    from cpd_tpu_torch.parallel.mesh import data_parallel_mesh
    from cpd_tpu_torch.train import (create_train_state, sgd,
                                     warmup_step_decay)
    from cpd_tpu_torch.train.lm import make_lm_train_step

    if opt is None:
        opt = sgd(warmup_step_decay(LM_TRAIN["base_lr"], LM_TRAIN["warmup"],
                                    [2 * len(batches)], warmup_from=0.0),
                  momentum=0.9)
    fmt = LM_TRAIN["fmt"] if fmt is None else fmt
    state = create_train_state(model, opt)
    step = make_lm_train_step(model, opt, data_parallel_mesh(world, device),
                              use_aps=fmt != (8, 23), grad_exp=fmt[0],
                              grad_man=fmt[1], fused=fused)
    metrics = []
    for toks, tgts in batches:
        torch.cuda.synchronize()
        t0 = now()
        state, m = step(state, toks, tgts)
        metrics.append({k: float(v) for k, v in m.items()})
        torch.cuda.synchronize()
        if seconds is not None:
            seconds.append(now() - t0)
    return state, step, metrics


def lm_split(model, batch, world, device) -> dict:
    """One step's per-rank forwards and backwards and its reduce, each
    timed on the host clock between synchronisations."""
    import torch

    from cpd_tpu_torch.obs.timing import now
    from cpd_tpu_torch.parallel.dist import sum_gradients
    from cpd_tpu_torch.parallel.mesh import data_parallel_mesh
    from cpd_tpu_torch.train import fp32_numerics
    from cpd_tpu_torch.train.lm import as_tokens, lm_local_gradients

    mesh = data_parallel_mesh(world, device)
    fmt = LM_TRAIN["fmt"]
    toks, tgts = as_tokens(*batch, device)
    with fp32_numerics():
        torch.cuda.synchronize()
        t0 = now()
        grads = lm_local_gradients(model, toks, tgts, mesh)[0]
        torch.cuda.synchronize()
        t1 = now()
        sum_gradients(grads, mesh, use_aps=True, grad_exp=fmt[0],
                      grad_man=fmt[1], mode="faithful")
        torch.cuda.synchronize()
        t2 = now()
    return dict(fwd_bwd_ms=(t1 - t0) * 1e3, reduce_ms=(t2 - t1) * 1e3)


def lm_operands(model, batch, world, device) -> list:
    """The (a, b) operands of rank 0's K8 calls in one step of the LM:
    for each layer's wi and wo_mlp the forward, then the backward's grad_x
    and grad_W (6 per layer), copied as they reach `qgemm_faithful`."""
    from cpd_tpu_torch.ops import qgemm as qg
    from cpd_tpu_torch.parallel.mesh import data_parallel_mesh
    from cpd_tpu_torch.train import fp32_numerics
    from cpd_tpu_torch.train.lm import as_tokens, lm_local_gradients

    calls, kernel = [], qg.qgemm_faithful
    per_rank = 6 * LM_MODEL["n_layers"]

    def record(a, b, exp_bits, man_bits):
        if len(calls) < per_rank:
            calls.append((a.detach().contiguous().clone(),
                           b.detach().contiguous().clone()))
        return kernel(a, b, exp_bits, man_bits)

    # the kernel counts its launches on the module's name, the recorder
    record.launches = kernel.launches
    qg.qgemm_faithful = record
    try:
        with fp32_numerics():
            lm_local_gradients(model, *as_tokens(*batch, device),
                               data_parallel_mesh(world, device))
    finally:
        qg.qgemm_faithful = kernel
        kernel.launches = record.launches
    return calls


def lm_operand_check(model, batch, world, device) -> dict:
    """K8 on the LM's own operands (`lm_operands`: one rank-step's 24
    calls): the tile kernel against the kept generic kernel, bitwise, each
    pair timed in turns (kept, kernel, kernel, kept) by CUDA events; the
    rank-step's sums each way, forward and backward apart.  This is the
    data-dependent figure: on the backward's gradients most products cast
    to a signed zero while s and c are ±0, and the tile kernel takes those
    steps as zero steps, its float ops without the casts."""
    from cpd_tpu_torch.ops import qgemm as qg

    fmt = LM_PATH["ffn_exp"], LM_PATH["ffn_man"]
    generic = qg.generic_launcher()
    calls = lm_operands(model, batch, world, device)
    n_fwd = 2 * LM_MODEL["n_layers"]
    rows = []
    for i, (a, b) in enumerate(calls):
        if not same_bits(qg.qgemm_faithful(a, b, *fmt),
                         generic(a, b, *fmt)):
            raise AssertionError(f"K8 on the LM's operand pair {i} "
                                 f"{tuple(a.shape)}x{tuple(b.shape)}: the "
                                 "kernel differs from the kept kernel")
        t1, k1, k2, t2 = (time_ms(lambda f=f: f(a, b, *fmt), iters=2,
                                  warmup=1)
                          for f in (generic, qg.qgemm_faithful,
                                    qg.qgemm_faithful, generic))
        rows.append(dict(kind="forward" if i < n_fwd else "backward",
                         shape=[*a.shape, b.shape[1]], ms=(k1 + k2) / 2,
                         generic_ms=(t1 + t2) / 2))
    out = dict(calls=len(rows), parity="bitwise the kept generic kernel "
                                       "on every pair")
    for kind in ("forward", "backward"):
        part = [r for r in rows if r["kind"] == kind]
        out[kind] = dict(calls=len(part), ms=sum(r["ms"] for r in part),
                         generic_ms=sum(r["generic_ms"] for r in part))
    out.update(ms=sum(r["ms"] for r in rows),
               generic_ms=sum(r["generic_ms"] for r in rows),
               per_call=[{k: (round(v, 4) if isinstance(v, float) else v)
                          for k, v in r.items()} for r in rows])
    out["speedup"] = out["generic_ms"] / out["ms"]
    print(f"kernel qgemm_faithful on the LM's operands ({len(rows)} calls "
          f"of one rank-step, {fmt}): bitwise the kept generic kernel; "
          f"rank-step sum {out['ms']:.3f} ms (forward "
          f"{out['forward']['ms']:.3f}, backward "
          f"{out['backward']['ms']:.3f}) against the kept kernel's "
          f"{out['generic_ms']:.3f} (forward "
          f"{out['forward']['generic_ms']:.3f}, backward "
          f"{out['backward']['generic_ms']:.3f}), {out['speedup']:.2f}x",
          flush=True)
    return out


def lm_phase(device) -> dict:
    """Phase 10c-f: the LM slice end to end at full width through K8, K9
    and K10 (and a fast-FFN step), kernels vs plain versions at full
    width without K8 and on a small model with it, then the trainer
    CLI."""
    import torch

    from cpd_tpu_torch.examples.lm import train as cli
    from cpd_tpu_torch.obs.timing import now
    from cpd_tpu_torch.ops import qgemm as qg
    from cpd_tpu_torch.parallel.overlap import (DEFAULT_BUCKET_ELEMS,
                                                bucket_layout)
    from cpd_tpu_torch.train import sgd

    w, steps = LM_TRAIN["world"], LM_TRAIN["steps"]
    rows, seq = w * LM_TRAIN["per_rank_batch"], LM_TRAIN["seq"]
    vocab, layers = LM_MODEL["vocab_size"], LM_MODEL["n_layers"]
    batches = lm_batches(vocab, steps, rows, seq, LM_TRAIN["seed"])

    # (c) the slice: 3 steps through K8, K9 and K10
    marks = [now()]
    model = lm_model(device, LM_TRAIN["seed"], **LM_PATH)
    sizes = [p.numel() for p in model.parameters()]
    n_buckets = len(bucket_layout(sizes, DEFAULT_BUCKET_ELEMS))
    secs = []
    reset_counts()
    state, step, metrics = lm_train(device, model, batches, w, seconds=secs)
    counts = read_counts()
    want = {k: steps * v for k, v in lm_design(layers, w, len(sizes),
                                               n_buckets).items()}
    if counts != want:
        raise AssertionError(f"LM launches {counts} != the design's {want}")
    losses = [m["loss"] for m in metrics]
    if not all(math.isfinite(v) for v in losses) or not (
            abs(losses[0] - math.log(vocab)) <= LM_LOSS_BAND):
        raise AssertionError(f"LM losses {losses}: not finite, or step 0 "
                             f"not within {LM_LOSS_BAND} of ln {vocab}")
    split = lm_split(model, batches[0], w, device)
    prof = step_profile(step, state, batches[0])
    step_s = sum(secs[1:]) / (len(secs) - 1)
    tokens = rows * seq
    out = dict(
        world=w, tokens_per_step=tokens, steps=steps, losses=losses,
        accuracies=[m["accuracy"] for m in metrics], step_ms=step_s * 1e3,
        tokens_per_s=tokens / step_s, n_leaves=len(sizes),
        n_buckets=n_buckets, launches=counts,
        launches_per_step={k: v // steps for k, v in counts.items() if v},
        **split,
        kernel_ms_per_step={k: prof[k] for k in LM_KERNELS},
        device_busy_ms=prof["device_busy_ms"],
        kernel_launches_profiled=prof["kernel_launches"])
    print("train lm: " + json.dumps(out), flush=True)
    out["real_operands"] = lm_operand_check(model, batches[0], w, device)

    # the same step with the fast FFN: fp32 product and one K1 cast
    fast = lm_model(device, LM_TRAIN["seed"], **dict(LM_PATH,
                                                     ffn_mode="fast"))
    f_secs = []
    reset_counts()
    _, _, f_metrics = lm_train(device, fast, batches[:2], w, seconds=f_secs)
    f_counts = read_counts()
    if f_counts["qgemm_faithful"] or not all(math.isfinite(m["loss"])
                                             for m in f_metrics):
        raise AssertionError(f"fast-FFN steps: launches {f_counts}, "
                             f"metrics {f_metrics}")
    out["fast"] = dict(step_ms=f_secs[1] * 1e3,
                       tokens_per_s=tokens / f_secs[1],
                       losses=[m["loss"] for m in f_metrics],
                       launches_per_step={k: v // 2 for k, v in
                                          f_counts.items() if v})
    print("train lm fast-ffn: " + json.dumps(out["fast"]), flush=True)
    del fast

    # (d) full width without K8: one step, ffn (8, 23), fp32 reduce at a
    # constant lr, through K9/K10 and then through their plain versions
    marks.append(now())
    path = dict(LM_PATH, ffn_exp=8, ffn_man=23)
    runs = []
    for plain in (False, True):
        m = lm_model(device, 1, **path)
        with contextlib.ExitStack() as stack:
            if plain:
                stack.enter_context(plain_kernels())
            _, _, met = lm_train(device, m, batches[:1], w,
                                 opt=sgd(lambda s: 0.01, momentum=0.9),
                                 fmt=(8, 23))
        runs.append((met[0]["loss"], m))
    (la, ma), (lb, mb) = runs
    w_err = max(max_abs_diff(a.detach(), b.detach())
                for a, b in zip(ma.parameters(), mb.parameters()))
    if abs(la - lb) > LM_LOSS_RTOL * abs(lb) or w_err > LM_WEIGHT_ATOL:
        raise AssertionError(f"full-width step: loss {la} (kernels) vs {lb} "
                             f"(plain), weights differ by {w_err}")
    out["full_width_vs_plain"] = dict(loss_kernels=la, loss_plain=lb,
                                      weight_max_abs_err=w_err)
    print(f"train lm: one full-width step at ffn (8, 23) through K9/K10 and "
          f"through their plain versions: loss {la} vs {lb} (rtol "
          f"{LM_LOSS_RTOL}), weights within {w_err:.3e} (atol "
          f"{LM_WEIGHT_ATOL})", flush=True)
    del runs, ma, mb

    # (e) the whole faithful path, small: all kernels vs all plain versions
    marks.append(now())
    sw = LM_SMALL_TRAIN["world"]
    s_batches = lm_batches(LM_SMALL["vocab_size"], LM_SMALL_TRAIN["steps"],
                           sw * LM_SMALL_TRAIN["per_rank_batch"],
                           LM_SMALL_TRAIN["seq"], 1)
    small = []
    for plain in (False, True):
        m = lm_model(device, 2, LM_SMALL, **LM_PATH)
        with contextlib.ExitStack() as stack:
            if plain:
                stack.enter_context(plain_kernels())
            _, _, met = lm_train(device, m, s_batches, sw,
                                 opt=sgd(lambda s: 0.01, momentum=0.9),
                                 fused=False if plain else None)
        small.append([x["loss"] for x in met])
    for a, b in zip(*small):
        if abs(a - b) > LM_SMALL_LOSS_RTOL * abs(b):
            raise AssertionError(f"small faithful LM: losses {small[0]} "
                                 f"(kernels) vs {small[1]} (plain)")
    # the FFN's own GEMMs on the inputs the kernel run gave them: bitwise
    fmt = LM_PATH["ffn_exp"], LM_PATH["ffn_man"]
    seen = []
    hook = m.blocks[0].wi.register_forward_hook(
        lambda mod, args, res: seen.append(args[0].detach()))
    with torch.no_grad():
        m(torch.as_tensor(s_batches[0][0], device=device))
    hook.remove()
    x2 = seen[0].reshape(-1, seen[0].shape[-1])
    g = torch.randn((x2.shape[0], LM_SMALL["d_ff"]), device=device)
    kern = m.blocks[0].wi.kernel.detach()
    for name, a, b in (("forward", x2, kern), ("grad_x", g, kern.t()),
                       ("grad_W", g.t(), x2)):
        if not same_bits(qg.qgemm_faithful(a, b, *fmt),
                         qg.qgemm_faithful_ref(a, b, *fmt)):
            raise AssertionError(f"small LM FFN {name} GEMM: K8 differs "
                                 "from its plain version")
    out["small_vs_plain"] = dict(losses_kernels=small[0],
                                 losses_plain=small[1])
    print(f"train lm small: {LM_SMALL_TRAIN['steps']} faithful e4m3 steps "
          f"at W={sw} through K8/K9/K10 and the kernels of the reduce vs all "
          f"plain versions: losses {small[0]} vs {small[1]} (rtol "
          f"{LM_SMALL_LOSS_RTOL}); the FFN's forward, grad_x and grad_W "
          "GEMMs on the run's own inputs bitwise", flush=True)

    # (f) the trainer CLI
    marks.append(now())
    iters = LM_TRAIN["cli_iters"]
    argv = ["--vocab-size", str(vocab), "--d-model",
            str(LM_MODEL["d_model"]), "--n-layers", str(layers),
            "--n-heads", str(LM_MODEL["n_heads"]), "--n-kv-heads",
            str(LM_MODEL["n_kv_heads"]), "--seq-len", str(seq),
            "--batch-size", str(LM_TRAIN["per_rank_batch"]), "--dp", str(w),
            "--attn-impl", "flash", "--flash-bwd", "pallas", "--ffn-exp",
            str(fmt[0]), "--ffn-man", str(fmt[1]), "--ffn-mode", "faithful",
            "--use_APS", "--grad_exp", str(LM_TRAIN["fmt"][0]),
            "--grad_man", str(LM_TRAIN["fmt"][1]), "--max-iter", str(iters),
            "--print-freq", "1"]
    reset_counts()
    t0 = now()
    rc = cli.main(argv)
    cli_counts = read_counts()
    # the steps, then one validation forward: 2 K8 and 1 K9 per layer and
    # rank
    design = {k: iters * v for k, v in lm_design(
        layers, w, len(sizes), n_buckets).items()}
    design["qgemm_faithful"] += 2 * layers * w
    design["flash_gqa_fwd"] += layers * w
    if rc != 0 or cli_counts != design:
        raise AssertionError(f"LM trainer CLI returned {rc}, launches "
                             f"{cli_counts} (design {design})")
    out["cli"] = dict(rc=rc, seconds=now() - t0, argv=" ".join(argv),
                      launches={k: v for k, v in cli_counts.items() if v})
    print("train lm cli: " + json.dumps(out["cli"]), flush=True)
    marks.append(now())
    out["seconds"] = dict(zip(("slice", "full_width_vs_plain",
                               "small_vs_plain", "cli"),
                              (b - a for a, b in zip(marks, marks[1:]))))
    print("train lm seconds: " + json.dumps(out["seconds"]), flush=True)
    return out


def lm_kernel_entries(qgemm: dict, flash: dict, lm: dict) -> list:
    """The ``kernels`` line's entries of K8-K10: their launches from the
    LM slice's faithful steps at W = 2 (counted from 0 around that run),
    their times and bounds from phases 10a-b."""
    timed = {"qgemm_faithful": dict(
        qgemm, max_abs_err=0.0, library_ms=None,
        library_note=NO_LIBRARY_QGEMM,
        generic_note="the kept generic kernel (qgemm.generic_launcher), "
                     "timed in turns with the kernel",
        real_operands={k: v for k, v in lm["real_operands"].items()
                       if k != "per_call"},
        parity="bitwise the plain scan in every format and shape case and "
               "at K = 1 on all 2^32 fp32 bit patterns for each of "
               f"{list(QGEMM_FORMATS)}; bitwise the plain scan and the "
               "kept generic kernel on boundary patterns for all 192 "
               "formats; bitwise the kept kernel on the LM's operands; "
               "and on the small LM's FFN GEMMs"), **flash}
    out = []
    for name, (replaces, source) in LM_KERNELS.items():
        k = timed[name]
        out.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=lm["launches"][name],
            launches_per_step=lm["launches_per_step"][name],
            max_abs_err=k["max_abs_err"], ms=k["ms"],
            plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
            bound_by=k["bound_by"], library_ms=k["library_ms"],
            **{f: k[f] for f in ("library_note", "shapes", "plain_shape",
                                 "small_ms", "tf32_bound_ms", "shape",
                                 "sass_bound_ms", "issue_efficiency",
                                 "library_fwd_bwd_ms",
                                 "fp32_bound_ms", "cuda_core_ms", "speedup",
                                 "call_ms", "library_forms", "kernels_ms",
                                 "generic_ms", "probe", "build",
                                 "real_operands")
               if f in k},
            parity=k.get("parity", f"within atol {FLASH_ATOL} (out, LSE) "
                                   f"and {FLASH_GRAD_ATOL} (gradients) of "
                                   "the plain version in every case; two "
                                   "launches bitwise equal"),
            **({"cuda_core_note": "flash_gqa.cu's fp32 CUDA-core template "
                                  "(flash_gqa.core_launchers), timed in "
                                  "turns with the kernel"}
               if "cuda_core_ms" in k else {})))
    return out


def mha_phase(device) -> dict:
    """Phase 11a: K11 and K9/K10's bf16 arm (flash_mha_tc.cu) against the
    plain versions over the cases, each launched twice and bitwise equal;
    the build's registers, spills and shared memory; then K11 timed at
    the bf16 LM's shape (bf16 and fp32) and at head_dim 128 in turns with
    the CUDA-core template it replaces, beside its plain version, its
    bound and SDPA."""
    import torch
    import torch.nn.functional as F

    from cpd_tpu_torch.ops import flash_gqa as fl
    from cpd_tpu_torch.ops import flash_mha as fm

    gen = torch.Generator(device=device).manual_seed(110)
    f32, b16 = torch.float32, torch.bfloat16
    b0, t0 = BENCH_TRAIN["per_rank_batch"], BENCH_TRAIN["seq"]
    h0 = BENCH_LM["n_heads"]
    d0 = BENCH_LM["d_model"] // h0
    # (B, Tq, Tk, H, H_kv, D)
    mha = [((2, 256, 256, 4, 4, d), dt, c) for d in (32, 64, 128)
           for dt in (f32, b16) for c in (True, False)]
    mha += [((2, tq, tk, 4, 4, 64), dt, True) for dt in (f32, b16)
            for tq, tk in ((128, 384), (384, 128))]
    mha += [(shape, dt, True) for shape in ((b0, t0, t0, h0, h0, d0),
                                            (b0, t0, t0, 4, 4, 128))
            for dt in (f32, b16)]
    gqa = [(case[:-1], b16, case[-1]) for case in GQA_BF16_CASES]
    gqa += [((2, 256, 256, 4, 2, 128), f32, False)]
    worst = {}
    for label, kernels, cases in (
            ("flash_mha", (fm.flash_mha_fwd, fm.flash_mha_bwd,
                           fm.flash_mha_fwd_ref, fm.flash_mha_bwd_ref), mha),
            ("flash_gqa", (fl.flash_gqa_fwd, fl.flash_gqa_bwd,
                           fl.flash_gqa_fwd_ref, fl.flash_gqa_bwd_ref), gqa)):
        for shape, dt, causal in cases:
            r = attention_check(*kernels, shape, dt, causal, gen, device,
                                repeat=True)
            if max(r["fwd_share"], r["bwd_share"]) > 1.0:
                raise AssertionError(
                    f"{label} {shape} {dt} causal={causal}: kernel vs plain "
                    f"{r} (shares of the tolerance above 1)")
            key = (label, str(dt).split(".")[-1])
            w = worst.setdefault(key, dict.fromkeys(r, 0.0))
            for k2, v2 in r.items():
                w[k2] = max(w[k2], v2)
        print(f"kernel {label}: {len(cases)} cases kernel vs plain, worst "
              + "; ".join(f"{dt}: out/lse {w['fwd_err']:.3e} ("
                          f"{w['fwd_share']:.3f} of tol), grads "
                          f"{w['bwd_err']:.3e} ({w['bwd_share']:.3f} of tol)"
                          for (lab, dt), w in worst.items() if lab == label)
              + f" (fp32 atol {FLASH_ATOL} / {FLASH_GRAD_ATOL}; bf16 rtol "
              f"{BF16_RTOL} atol {BF16_ATOL}); two launches bitwise equal "
              "in every case", flush=True)
    # the tensor-core forward masks rows past a Tq its tile does not divide
    ragged = 0.0
    for d in (64, 128):
        for causal in (True, False):
            q, k, v, _ = attention_inputs((2, 200, 256, 4, 4, d), b16, gen,
                                          device)
            got = fm.flash_mha_fwd(q, k, v, causal)
            want = fm.flash_mha_fwd_ref(q, k, v, causal)
            ragged = max(ragged, *(within(x, w, BF16_RTOL, BF16_ATOL)
                                   for x, w in zip(got, want)))
    if ragged > 1.0:
        raise AssertionError(f"flash_mha bf16 forward at Tq = 200: "
                             f"{ragged} of the tolerance")
    print(f"kernel flash_mha: bf16 forward at Tq = 200, Tk = 256 (D 64, "
          f"128; causal and not) within {ragged:.3f} of the tolerance",
          flush=True)
    tc = build_report("flash_mha_tc")
    f32tc = build_report("flash_f32_tc")
    core_fwd, core_bwd = fl.core_launchers()

    res = {}
    for shape, dt in (((b0, t0, t0, h0, h0, d0), b16),
                      ((b0, t0, t0, h0, h0, d0), f32),
                      ((b0, t0, t0, 4, 4, 128), b16)):
        b, tq, tk, h, _, d = shape
        q, k, v, g = attention_inputs(shape, dt, gen, device)
        out, lse = fm.flash_mha_fwd(q, k, v, True)
        qt, kt, vt, gt = (x.transpose(1, 2).contiguous()
                          for x in (q, k, v, g))
        kw = dict(is_causal=True, scale=1.0 / math.sqrt(d))
        leaves = tuple(x.detach().requires_grad_() for x in (qt, kt, vt))
        o_lib = F.scaled_dot_product_attention(*leaves, **kw)
        es = q.element_size()
        n_elem = q.numel()
        rate = ("3xTF32 tensor cores 165 TFLOP/s" if dt == f32 else
                "bf16 tensor cores 989 TFLOP/s")
        tag = f"{str(dt).split('.')[-1]} D={d}"
        for name, fn, plain, lib, template, products, n_bytes in (
                ("flash_mha_fwd", lambda: fm.flash_mha_fwd(q, k, v, True),
                 lambda: fm.flash_mha_fwd_ref(q, k, v, True),
                 lambda: F.scaled_dot_product_attention(qt, kt, vt, **kw),
                 lambda: core_fwd(q, k, v, True, "template"),
                 2, es * 4 * n_elem + 4 * lse.numel()),
                ("flash_mha_bwd",
                 lambda: fm.flash_mha_bwd(q, k, v, out, lse, g, True),
                 lambda: fm.flash_mha_bwd_ref(q, k, v, out, lse, g, True),
                 lambda: torch.autograd.grad(o_lib, leaves, gt,
                                             retain_graph=True),
                 lambda: core_bwd(q, k, v, out, lse, g, True, "template"),
                 5, es * 8 * n_elem + 4 * lse.numel())):
            flops = flash_flops(b, tq, tk, h, d, True, products)
            if dt == f32:
                bounds = attention_bounds(flops, n_bytes)
            else:
                t_ops = flops / PEAK_BF16_FLOPS
                t_bytes = n_bytes / PEAK_BYTES_PER_S
                bounds = dict(bound_ms=max(t_ops, t_bytes) * 1e3,
                              bound_by="operations" if t_ops >= t_bytes
                              else "bytes")
            # device time: at these sizes back-to-back calls are
            # host-bound, and CUDA events around them read the host's
            # dispatch; the profiler drops records in a long run.  The
            # CUDA-core template it replaces (flash_gqa.cu at rep = 1), in
            # turns with it: template, kernel, kernel, template
            t1, k1, k2, t2 = (queued_ms(f, iters=20)
                              for f in (template, fn, fn, template))
            ms, core = (k1 + k2) / 2, (t1 + t2) / 2
            r = dict(ms=ms, call_ms=time_ms(fn, iters=20),
                     plain_ms=time_ms(plain, iters=3),
                     library_ms=queued_ms(lib, iters=20), **bounds,
                     rate=rate, gflop=flops / 1e9, shape=list(shape),
                     dtype=str(dt).split(".")[-1],
                     source=("cpd_tpu_torch/csrc/flash_mha_tc.cu"
                             if dt == b16 else
                             "cpd_tpu_torch/csrc/flash_f32_tc.cu"),
                     cuda_core_ms=core, speedup=core / ms,
                     kernels_ms={k_: round(v_, 5) for k_, v_ in
                                 device_kernels_ms(fn, iters=20).items()})
            r["vs_library"] = r["ms"] / r["library_ms"]
            res.setdefault(name, {})[tag] = r
            what = ("forward" if name == "flash_mha_fwd" else
                    "backward alone: autograd.grad of a stored forward")
            vs = (f"; the CUDA-core template (flash_gqa.cu, rep = 1) "
                  f"{core:.4f} ms, {r['speedup']:.2f}x the kernel's time")
            if dt == f32:
                vs += (f"; fp32 67 TFLOP/s {r['fp32_bound_ms']:.4f}, one "
                       f"TF32 product 495 TFLOP/s {r['tf32_bound_ms']:.4f}")
            print(f"kernel {name} [{tag}, {list(shape)} causal, "
                  f"{r['source'].split('/')[-1]}]: kernel_ms {ms:.4f} "
                  f"(device; per call with host dispatch "
                  f"{r['call_ms']:.4f}) plain_ms {r['plain_ms']:.4f} bound_ms "
                  f"{r['bound_ms']:.4f} ({r['bound_by']}, {rate}; bytes at "
                  f"3.35 TB/s) {r['gflop']:.3f} GFLOP; library_ms "
                  f"{r['library_ms']:.4f} (scaled_dot_product_attention "
                  f"{what}, {r['dtype']}, is_causal, scale 1/sqrt(D)), "
                  f"kernel/library {r['vs_library']:.2f}{vs}; by kernel "
                  f"{r['kernels_ms']}", flush=True)
        del o_lib, leaves
    for name in res:
        # the main path's kernel is the bf16 one
        res[name]["max_abs_err"] = worst[("flash_mha", "bfloat16")][
            "fwd_err" if name == "flash_mha_fwd" else "bwd_err"]
        res[name]["fp32_max_abs_err"] = worst[("flash_mha", "float32")][
            "fwd_err" if name == "flash_mha_fwd" else "bwd_err"]
    res["gqa_bf16"] = worst[("flash_gqa", "bfloat16")]
    res["tc_build"] = tc
    res["f32tc_build"] = f32tc
    slow = {(n, tag): res[n][tag]["speedup"] for n in MHA_KERNELS
            for tag, floor in ((f"bfloat16 D={d0}", TC_SPEEDUP_FLOOR),
                               (f"float32 D={d0}", F32_TC_SPEEDUP_FLOOR))
            if res[n][tag]["speedup"] < floor}
    if slow:
        raise AssertionError(f"K11's tensor-core kernels: only {slow}x "
                             "faster than the CUDA-core template (floors: "
                             f"bf16 {TC_SPEEDUP_FLOOR}x, fp32 "
                             f"{F32_TC_SPEEDUP_FLOOR}x)")
    return res


# the tensor-core attention libraries: their typed loader, the extern "C"
# function that gives a kernel's dynamic shared memory, and how many
# kernels each builds (3 kinds x 3 head dims and the GQA rep sum)
TC_LIBRARIES = {"flash_mha_tc": ("cpd_tpu_torch.ops.flash_gqa", "tc_library",
                                 "flash_tc_smem_bytes", 10),
                "flash_f32_tc": ("cpd_tpu_torch.ops.flash_gqa",
                                 "f32tc_library", "flash_f32tc_smem_bytes",
                                 10)}


def build_report(name: str) -> dict:
    """Registers and spill bytes (``-Xptxas -v``) and dynamic shared
    memory of each kernel of the tensor-core library ``name``, printed
    and returned; neither library may spill."""
    import importlib
    import re

    from cpd_tpu_torch.ops.build import build_log

    module, loader, smem_fn, count = TC_LIBRARIES[name]
    smem = getattr(getattr(importlib.import_module(module), loader)(),
                   smem_fn)
    out, entry = {}, None
    for line in build_log(name).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(r"(fwd|dq|dkv)_kernelILi(\d+)E", m[1])
            entry = (f"{k[1]}_kernel<{k[2]}>" if k else
                     re.search(r"\d([a-z_]+_kernel)E", m[1])[1])
            out[entry] = dict(smem_bytes=smem(("fwd", "dq", "dkv").index(
                k[1]), int(k[2])) if k else 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and entry:
            out[entry].update(spill_stores=int(m[1]),
                              spill_loads=int(m[2]))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out[entry]["registers"] = int(m[1])
    if len(out) != count:
        raise AssertionError(f"{name}'s build log names {sorted(out)}, not "
                             f"its {count} kernels")
    print(f"kernel {name} build: " + "; ".join(
        f"{e}: {r.get('registers')} registers, spills "
        f"{r.get('spill_stores')}/{r.get('spill_loads')} bytes "
        f"(stores/loads), {r['smem_bytes']} bytes of shared memory"
        for e, r in sorted(out.items())), flush=True)
    spilled = {e: r.get("spill_stores") for e, r in out.items()
               if r.get("spill_stores") or r.get("spill_loads")}
    if spilled:
        raise AssertionError(f"{name} spills registers: {spilled}")
    return out


def bench_lm_model(device, seed: int, cfg=None, **kw):
    """bench.py's LM model in the port (``cfg``: its width by default),
    bf16 compute, seeded random weights."""
    import torch

    return lm_model(device, seed, cfg or BENCH_LM,
                    **dict(dict(attn_impl="flash", dtype=torch.bfloat16),
                           **kw))


def bench_train(device, model, batches, world, seconds=None) -> tuple:
    """bench.py's LM step on ``batches``: APS e5m2 faithful reduce, SGD
    momentum 0.9 at BENCH_TRAIN's constant rate."""
    from cpd_tpu_torch.train import sgd

    return lm_train(device, model, batches, world,
                    opt=sgd(lambda s: BENCH_TRAIN["lr"], momentum=0.9),
                    fmt=BENCH_TRAIN["fmt"], seconds=seconds)


def bench_batches() -> list:
    """BENCH_TRAIN's global token batches, from its seed."""
    w = BENCH_TRAIN["world"]
    return lm_batches(BENCH_LM["vocab_size"], BENCH_TRAIN["steps"],
                      w * BENCH_TRAIN["per_rank_batch"], BENCH_TRAIN["seq"],
                      BENCH_TRAIN["seed"])


def bench_slice(device, label: str, kernels: dict, **kw) -> dict:
    """BENCH_TRAIN's steps of bench.py's bf16 LM with the model keywords
    ``kw`` through its attention kernels (``kernels``: the forward's and
    the backward's wrapper names), counted from 0 around them: finite
    losses, step 0 within LM_LOSS_BAND of ln V, launches as designed (one
    forward and one backward per layer and rank), tokens/s, the step's
    split, peak memory and the kernels' device ms per step; then the same
    steps from the same weights through the plain versions (losses within
    BENCH_LOSS_RTOL).  Prints and returns ``train {label}: {...}``."""
    import torch

    from cpd_tpu_torch.obs.timing import now
    from cpd_tpu_torch.parallel.overlap import (DEFAULT_BUCKET_ELEMS,
                                                bucket_layout)

    w, steps = BENCH_TRAIN["world"], BENCH_TRAIN["steps"]
    vocab, layers = BENCH_LM["vocab_size"], BENCH_LM["n_layers"]
    batches = bench_batches()
    tokens = w * BENCH_TRAIN["per_rank_batch"] * BENCH_TRAIN["seq"]
    marks = [now()]
    model = bench_lm_model(device, BENCH_TRAIN["seed"], **kw)
    sizes = [p.numel() for p in model.parameters()]
    n_buckets = len(bucket_layout(sizes, DEFAULT_BUCKET_ELEMS))
    secs = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    state, step, metrics = bench_train(device, model, batches, w, secs)
    counts = read_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    want = reduce_design("faithful", False, False, w, len(sizes), n_buckets)
    want.update({k: layers * w for k in kernels})
    want = {k: steps * v for k, v in want.items()}
    if counts != want:
        raise AssertionError(f"{label} launches {counts} != the design's "
                             f"{want}")
    losses = [m["loss"] for m in metrics]
    if not all(math.isfinite(v) for v in losses) or not (
            abs(losses[0] - math.log(vocab)) <= LM_LOSS_BAND):
        raise AssertionError(f"{label} losses {losses}: not finite, or step "
                             f"0 not within {LM_LOSS_BAND} of ln {vocab}")
    split = lm_split(model, batches[0], w, device)
    prof = step_profile(step, state, batches[0])
    step_s = sum(secs[1:]) / (len(secs) - 1)
    out = dict(
        model=dict(BENCH_LM, dtype="bfloat16", attn_impl="flash", **kw),
        world=w, tokens_per_step=tokens, steps=steps, losses=losses,
        accuracies=[m["accuracy"] for m in metrics], step_ms=step_s * 1e3,
        tokens_per_s=tokens / step_s, peak_memory_gib=peak_gib,
        n_leaves=len(sizes), n_buckets=n_buckets,
        launches={k: v for k, v in counts.items() if v},
        launches_per_step={k: v // steps for k, v in counts.items() if v},
        launches_per_rank_step={k: counts[k] // (steps * w)
                                for k in kernels},
        **split,
        kernel_ms_per_step={k: prof[k] for k in kernels},
        device_busy_ms=prof["device_busy_ms"],
        kernel_launches_profiled=prof["kernel_launches"])
    print(f"train {label}: " + json.dumps(out), flush=True)
    del state, step

    # the same steps from the same weights through the plain versions
    marks.append(now())
    plain = bench_lm_model(device, BENCH_TRAIN["seed"], **kw)
    with plain_kernels():
        _, _, p_metrics = bench_train(device, plain, batches, w)
    p_losses = [m["loss"] for m in p_metrics]
    for a, b in zip(losses, p_losses):
        if abs(a - b) > BENCH_LOSS_RTOL * abs(b):
            raise AssertionError(f"{label} losses {losses} (kernels) vs "
                                 f"{p_losses} (plain versions)")
    out["vs_plain"] = dict(losses_plain=p_losses, max_rel_diff=max(
        abs(a - b) / abs(b) for a, b in zip(losses, p_losses)))
    print(f"train {label}: the same {steps} steps through the plain "
          f"{' and '.join(kernels)}: losses {p_losses} (rtol "
          f"{BENCH_LOSS_RTOL}: {out['vs_plain']['max_rel_diff']:.3e})",
          flush=True)
    del plain
    marks.append(now())
    out["seconds"] = dict(zip(("slice", "vs_plain"),
                              (b - a for a, b in zip(marks, marks[1:]))))
    return out


def bench_lm_phase(device) -> dict:
    """Phase 11b-c: bench.py's bf16 MHA LM through K11, the same steps
    through the plain K11, one remat step, the xla and chunked arms, then
    the CLI with ``--bf16 --attn-impl flash --remat``."""
    from cpd_tpu_torch.examples.lm import train as cli
    from cpd_tpu_torch.obs.timing import now

    w = BENCH_TRAIN["world"]
    rows, seq = w * BENCH_TRAIN["per_rank_batch"], BENCH_TRAIN["seq"]
    vocab, layers = BENCH_LM["vocab_size"], BENCH_LM["n_layers"]
    batches = bench_batches()
    tokens = rows * seq
    # (b) the slice through K11, then through the plain K11
    out = bench_slice(device, "bench lm", MHA_KERNELS)
    losses = out["losses"]
    marks = [now()]

    # one remat step: the forward kernels twice per layer, the same loss
    remat = bench_lm_model(device, BENCH_TRAIN["seed"], remat=True)
    reset_counts()
    _, _, r_metrics = bench_train(device, remat, batches[:1], w)
    r_counts = read_counts()
    r_want = {"flash_mha_fwd": 2 * layers * w, "flash_mha_bwd": layers * w}
    if ({k: r_counts[k] for k in r_want} != r_want
            or abs(r_metrics[0]["loss"] - losses[0]) > 1e-6 * losses[0]):
        raise AssertionError(f"remat step: launches {r_counts} (want "
                             f"{r_want}), loss {r_metrics[0]['loss']} vs "
                             f"{losses[0]}")
    out["remat"] = dict(loss=r_metrics[0]["loss"], launches_per_step=r_want)
    print(f"train bench lm remat: one step, K11 {r_want} launches, loss "
          f"{r_metrics[0]['loss']} (without remat {losses[0]})", flush=True)
    del remat

    # bench.py's xla and chunked arms of the same model
    marks.append(now())
    arms = {}
    for impl in ("xla", "chunked"):
        m = bench_lm_model(device, BENCH_TRAIN["seed"], attn_impl=impl)
        a_secs = []
        _, _, a_metrics = bench_train(
            device, m, batches[:BENCH_TRAIN["arm_steps"]], w, a_secs)
        arms[impl] = dict(step_ms=a_secs[-1] * 1e3,
                          tokens_per_s=tokens / a_secs[-1],
                          losses=[x["loss"] for x in a_metrics])
        del m
    out["arms"] = arms
    print("train bench lm arms: " + json.dumps(arms), flush=True)

    # (c) the CLI at a cut depth
    marks.append(now())
    iters = BENCH_TRAIN["cli_iters"]
    argv = ["--vocab-size", str(vocab), "--d-model", str(BENCH_LM["d_model"]),
            "--n-layers", str(BENCH_TRAIN["cli_layers"]), "--n-heads",
            str(BENCH_LM["n_heads"]), "--seq-len", str(seq), "--batch-size",
            str(BENCH_TRAIN["per_rank_batch"]), "--dp", str(w), "--bf16",
            "--attn-impl", "flash", "--remat", "--use_APS", "--grad_exp",
            str(BENCH_TRAIN["fmt"][0]), "--grad_man",
            str(BENCH_TRAIN["fmt"][1]), "--max-iter", str(iters),
            "--print-freq", "1"]
    reset_counts()
    t0 = now()
    rc = cli.main(argv)
    cli_counts = read_counts()
    # remat: 2 forwards per layer and rank in a step, then one validation
    # forward
    n = BENCH_TRAIN["cli_layers"] * w
    design = {"flash_mha_fwd": 2 * n * iters + n,
              "flash_mha_bwd": n * iters}
    if rc != 0 or {k: cli_counts[k] for k in design} != design:
        raise AssertionError(f"bf16 LM CLI returned {rc}, launches "
                             f"{cli_counts} (design {design})")
    out["cli"] = dict(rc=rc, seconds=now() - t0, argv=" ".join(argv),
                      launches={k: v for k, v in cli_counts.items() if v})
    print("train bench lm cli: " + json.dumps(out["cli"]), flush=True)
    marks.append(now())
    out["seconds"].update(zip(("remat", "arms", "cli"),
                              (b - a for a, b in zip(marks, marks[1:]))))
    print("train bench lm seconds: " + json.dumps(out["seconds"]),
          flush=True)
    return out


def gqa_bf16_kernel_entries(flash: dict, mha: dict, lm: dict) -> list:
    """The ``kernels`` line's entries of K9/K10's bf16 arm: launches from
    bench.py's GQA flash LM (phase 11d, counted from 0 around its steps),
    times and bounds from phase 10b, errors from phase 11a."""
    out = []
    for name, replaces in GQA_BF16_KERNELS.items():
        k = flash[name]["bf16"]
        err = mha["gqa_bf16"]["fwd_err" if name == "flash_gqa_fwd"
                              else "bwd_err"]
        out.append(dict(
            name=f"{name}_bf16", route="cuda", source=k["source"],
            replaces=replaces, launches=lm["launches"][name],
            launches_per_rank_step=lm["launches_per_rank_step"][name],
            max_abs_err=err, ms=k["ms"], plain_ms=k["plain_ms"],
            bound_ms=k["bound_ms"], bound_by=k["bound_by"],
            library_ms=k["library_ms"], library_note=k["library_note"],
            shape=k["shape"], dtype="bfloat16",
            rate="bf16 tensor cores 989 TFLOP/s",
            cuda_core_ms=k["cuda_core_ms"], speedup=k["speedup"],
            vs_library=k["vs_library"], call_ms=k["call_ms"],
            kernels_ms=k["kernels_ms"],
            cuda_core_note="flash_gqa.cu's bf16 CUDA-core template "
                           "(flash_gqa.core_launchers), timed in turns with "
                           "the kernel",
            build={e: r for e, r in mha["tc_build"].items()
                   if e.startswith("fwd" if name == "flash_gqa_fwd"
                                   else ("d", "rep"))},
            parity=f"within rtol {BF16_RTOL} atol {BF16_ATOL} of the plain "
                   f"version in {len(GQA_BF16_CASES)} cases; two launches "
                   f"bitwise equal; bench.py's GQA flash LM's losses within "
                   f"{BENCH_LOSS_RTOL} of the plain K9/K10's"))
    return out


def mha_kernel_entries(mha: dict, lm: dict) -> list:
    """The ``kernels`` line's entries of K11: launches from the bf16 LM's
    steps (counted from 0 around them), times and bounds from phase 11a
    at the main path's shape and dtype, the other arms beside them."""
    main = f"bfloat16 D={BENCH_LM['d_model'] // BENCH_LM['n_heads']}"
    out = []
    for name, replaces in MHA_KERNELS.items():
        k = mha[name][main]
        out.append(dict(
            name=name, route="cuda", source=k["source"], replaces=replaces,
            launches=lm["launches"][name],
            launches_per_rank_step=lm["launches_per_rank_step"][name],
            max_abs_err=mha[name]["max_abs_err"],
            fp32_max_abs_err=mha[name]["fp32_max_abs_err"],
            ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
            bound_by=k["bound_by"], library_ms=k["library_ms"],
            rate=k["rate"], shape=k["shape"], dtype=k["dtype"],
            cuda_core_ms=k["cuda_core_ms"], speedup=k["speedup"],
            vs_library=k["vs_library"],
            cuda_core_note="the CUDA-core template these kernels replace "
                           "(cpd_tpu_torch/csrc/flash_gqa.cu at rep = 1), "
                           "timed in turns with each arm",
            fp32_source="cpd_tpu_torch/csrc/flash_f32_tc.cu",
            build={e: r for e, r in mha["tc_build"].items()
                   if e.startswith("fwd" if name == "flash_mha_fwd"
                                   else "d")},
            fp32_build={e: r for e, r in mha["f32tc_build"].items()
                        if e.startswith("fwd" if name == "flash_mha_fwd"
                                        else ("d", "rep"))},
            library_note="torch.nn.functional.scaled_dot_product_attention"
                         + (" forward" if name == "flash_mha_fwd" else
                            " backward alone (autograd.grad of a stored "
                            "forward)") + ", is_causal, scale 1/sqrt(D)",
            call_ms=k["call_ms"], kernels_ms=k["kernels_ms"],
            arms={tag: {f: r[f] for f in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms", "source",
                                          "cuda_core_ms", "speedup", "rate",
                                          "fp32_bound_ms", "tf32_bound_ms")
                        if f in r}
                  for tag, r in mha[name].items()
                  if isinstance(r, dict) and "ms" in r and tag != main},
            parity=f"bf16 (tensor cores) within rtol {BF16_RTOL} atol "
                   f"{BF16_ATOL}, fp32 within atol {FLASH_ATOL} (out, lse) "
                   f"and {FLASH_GRAD_ATOL} (gradients), of the plain version "
                   f"in every case; two launches bitwise equal; the bf16 "
                   f"LM's losses within {BENCH_LOSS_RTOL} of the plain "
                   f"K11's"))
    return out


def main() -> int:
    try:
        import torch
    except ImportError as e:
        return fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False: this smoke run "
                    "needs an NVIDIA card")
    try:
        from cpd_tpu_torch.ops.build import build_all, build_log
    except ImportError as e:
        return fail(f"cpd_tpu_torch is not importable (run from the root "
                    f"of a checkout): {e}")
    from cpd_tpu_torch.obs.timing import now

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = DEVICE
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = now()
    build_all()
    print(f"build: all kernels in {now() - t0:.1f} s", flush=True)
    for name in ("serve_attn", "quantize", "qgemm", "flash_gqa",
                 "flash_mha_tc", "flash_f32_tc"):
        for line in build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}", flush=True)

    kern = kernel_phase(device)
    quant = quantize_phase(device)
    quant.update(sr_quantize_phase(device))
    serve = serve_phase(device)
    profile_phase(device)
    train = train_phase(device)
    sr_train = sr_train_phase(device, train)
    blocked = blocked_quantize_phase(device)
    blocked_train = blocked_train_phase(device)
    qgemm = qgemm_phase(device)
    flash = flash_phase(device)
    lm = lm_phase(device)
    mha = mha_phase(device)
    bench_lm = bench_lm_phase(device)
    # 11d: bench.py's GQA flash arm through K9/K10 bf16
    gqa_lm = bench_slice(device, "bench gqa lm", GQA_BF16_KERNELS,
                         **GQA_PATH)
    print("train bench gqa lm seconds: " + json.dumps(gqa_lm["seconds"]),
          flush=True)

    main_case = kern["cases"]["e4m3"]
    kernels = [dict(
        name="serve_attn", route="cuda",
        source="cpd_tpu_torch/csrc/serve_attn.cu",
        replaces="cpd_tpu/ops/serve_attn.py:47",
        launches=serve["kernel_launches"],
        max_abs_err=max(c["max_abs_err"] for c in kern["cases"].values()),
        ms=main_case["ms"], plain_ms=main_case["plain_ms"],
        bound_ms=main_case["bound_ms"], bound_by=main_case["bound_by"],
        library_ms=main_case["library_ms"],
        parity="digests bitwise; attn within atol "
               f"{ATTN_ATOL} rtol {ATTN_RTOL} in every case",
        cases={k: {"max_abs_err": c["max_abs_err"], "ms": c["ms"]}
               for k, c in kern["cases"].items()})]
    # each kernel's launches from the main path that runs it, counted from
    # 0 around that run: the RTNE ring training (K1, K6, K5), the faithful
    # CLI (K3), the SR ring training (sr_bits, K2, K6-SR, K5-SR) and the
    # SR Kahan faithful CLI (K4)
    runs = {"quantize_cast": (train, "launches_per_step"),
            "quantize_pack": (train, "launches_per_step"),
            "hop_pack": (train, "launches_per_step"),
            "quantize_add": (train["cli"], None),
            "sr_bits": (sr_train, "launches_per_step"),
            "quantize_cast_sr": (sr_train, "launches_per_step"),
            "quantize_pack_sr": (sr_train, "launches_per_step"),
            "hop_pack_sr": (sr_train, "launches_per_step"),
            "quantize_add_sr": (sr_train["cli"], "launches_per_iter")}
    for name, (replaces, _) in QUANT_KERNELS.items():
        q = quant[name]
        run, per_key = runs[name]
        launches = run["launches"][name]
        per_step = (run["quantize_add_per_iter"] if per_key is None
                    else run[per_key][name])
        err = q["max_abs_err"]
        parity = ("bitwise (fp32 outputs, wire bytes, digests) in every "
                  "format and size case")
        if name == "quantize_add":
            err = max(err, train["faithful_k3"]["max_abs_err"])
            parity += ", and on the faithful reduce's buckets at W=4"
        if name in sr_train["matrix_max_abs_err"]:
            err = max(err, sr_train["matrix_max_abs_err"][name])
            parity += "; and in the reduce matrix on one step's gradients"
        kernels.append(dict(
            name=name, route="cuda", source="cpd_tpu_torch/csrc/quantize.cu",
            replaces=replaces, launches=launches,
            launches_per_step=per_step, max_abs_err=err, ms=q["ms"],
            plain_ms=q["plain_ms"], call_ms=q["call_ms"],
            plain_call_ms=q["plain_call_ms"], bound_ms=q["bound_ms"],
            bound_by=q["bound_by"], library_ms=None,
            library_note=NO_LIBRARY_BITS if name == "sr_bits" else NO_LIBRARY,
            parity=parity,
            **{k: q[k] for k in ("ms_with_digest", "bound_pipe",
                                 "sass_per_element") if k in q}))
    # the blocked arms and K7: launches from the blocked verified training
    # run (RTNE, 3 steps) and its SR step
    for name in tuple(BLOCKED_KERNELS) + ("digest_rows",):
        q = blocked[name]
        sr = name.endswith("_sr")
        launches = (blocked_train["sr_launches_per_step"][name] if sr
                    else blocked_train["launches"][name])
        per_step = (launches if sr
                    else blocked_train["launches_per_step"][name])
        kernels.append(dict(
            name=name, route="cuda", source="cpd_tpu_torch/csrc/quantize.cu",
            replaces=(DIGEST_ROWS[0] if name == "digest_rows"
                      else BLOCKED_KERNELS[name][0]),
            launches=launches, launches_per_step=per_step,
            max_abs_err=q["max_abs_err"], ms=q["ms"], plain_ms=q["plain_ms"],
            call_ms=q["call_ms"], plain_call_ms=q["plain_call_ms"],
            bound_ms=q["bound_ms"], bound_by=q["bound_by"], library_ms=None,
            library_note=(NO_LIBRARY_DIGEST if name == "digest_rows"
                          else NO_LIBRARY),
            parity="bitwise (fp32 partials, wire bytes with the sidecar, "
                   "digests) in every format, block and size case; and "
                   "the blocked verified training kernels == plain",
            shape=q["shape"],
            **{k: q[k] for k in ("ms_with_digest",) if k in q}))
    kernels += lm_kernel_entries(qgemm, flash, lm)
    kernels += mha_kernel_entries(mha, bench_lm)
    kernels += gqa_bf16_kernel_entries(flash, mha, gqa_lm)
    print(card, flush=True)      # exactly as nvidia-smi gives it
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
