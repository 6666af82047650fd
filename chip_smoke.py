#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`cpd_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases; any failure exits non-zero:

1. build every CUDA kernel of the port from the sources in the checkout
   (``build/cuda/``, keyed by a hash of the sources, one nvcc per source,
   all started together) and print the card's name and power limit;
2. hold the fused attention kernel (K12, split-K over pages: a split
   kernel and an in-order combine) against its plain PyTorch version on
   the card, at the serving slice's shapes, over the KV formats (4,3),
   (5,2), (8,23), blocked (4,3) with block 32, and (4,3) with NaN-coded
   bytes past every slot's last live position, and at (4,3) over a long
   context (8 slots x 4096 positions), page 64 x head_dim 128 and GQA
   8:1: digests bitwise, attention within ``ATTN_ATOL``/``ATTN_RTOL``,
   two launches bitwise equal; time the kernel by device time in turns
   with the kept serial kernel it replaces (``serve_attn.core_launcher``;
   gate ``K12_SPEEDUP_FLOOR`` at the slice's e4m3 shape), beside the
   plain version and one library call (attention only — not the same
   function);
3. hold the quantize kernels (K1 cast, K3 add-and-cast, K6 first ring
   hop, K5 later ring hop) against their plain versions, BITWISE (fp32
   outputs, wire bytes, digests), at one ring chunk of the training slice
   and at an odd length, over the formats (5,2), (4,3), (5,7), (6,17) and,
   for K1/K3, (8,23) and (5,1); inputs at an APS-like scale plus a block
   of special values; K6/K5 (the streaming kernels) also at n = 1, 15,
   17 and on inputs 4 bytes past a 16-byte boundary, against the kept
   kernels they replaced too, and the path the ring's own calls take;
   time each kernel and its plain version over input sets that together
   hold twice the L2, so the inputs come from HBM, K6/K5 by device time
   in turns with the kept kernels, without and with digests (gate
   ``WIRE_SPEEDUP_FLOOR``);
4. serve a 16-request mixed trace end to end at the full width of the
   repo's transformer LM (vocab 32000, d_model 512, 4 layers, 8 heads,
   2 kv heads, d_ff 2048; random weights from a seeded generator) with
   ``fused_attn=True``, check every request finished and the kernel ran
   once per layer per decode step, then serve the same trace with the
   plain read path and require the same tokens and logits within
   ``LOGIT_ATOL``;
5. profile 15 engine steps of a fresh fused engine after 10 untraced
   ones (device busy share, kernel launches, K12's device ms and
   launches and the heaviest kernels per step; 30 steps until phase 19
   came: the profile's records of ~3000 launches a step cost most of
   the phase's ~46 s);
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
   offsets that wrap past 2^32, the SR arms of K6/K5 at the extra sizes
   and alignments of phase 3; time each as in phase 3 (``sr_bits``
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
   short, and at phase 3's extra sizes and alignments, and K7
   (`digest_rows`, one launch a call writing int64 digests) against its
   plain version and the kept two-launch kernel at the gathered wire of
   the largest bucket (4 rows), at W = 2 and 8 with an odd byte count,
   and at W in 1, 2, 4, 8 over rows of 1, 15, 16, 17 and 16k + 1..15
   bytes at a 16-byte boundary and 1-15 bytes past one, back to back
   and on two streams at once; time them as in phase 3, K7 by device time
   in turns with the kept kernel (gate ``K7_SPEEDUP_FLOOR``);
   (b) train 3 steps of APS (4,3) with ``block_scale``,
   block 128, ``verify_reduce`` through the kernels and through the
   plain versions — bitwise equal, ``reduce_ok`` 1 on every step — with
   the launches as designed (a profiled step holds one K7 launch per
   distinct gathered stack and no kept K7 fold), and hold one step's
   buckets through the
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
   saturate, land on the format's subnormals and carry past the max (the
   plain scan's step captured once as a CUDA graph and replayed,
   `graphed_scan`, itself held bitwise to the eager scan); the
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
   faithful LM, 1 step through every kernel and through every plain
   version: losses within ``LM_SMALL_LOSS_RTOL``, each leaf's update
   within ``LM_SMALL_UPDATE_SHARE`` of the plain update's norm, and
   its FFN GEMMs on the run's own inputs bitwise; (f) 2 iterations of the
   LM trainer CLI
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
   Tq in the backward), and K9-K11 at head_dim 48 and 96 (zero-padded to
   the tensor-core kernels' 64 and 128) and 256 (``flash_gqa.cu``'s
   templates) in both dtypes, causal and not, two launches bitwise equal
   in every case; print
   both tensor-core libraries' registers, spills and shared memory
   (neither may spill); time K11 at (4,
   1024, 8, 64) in bf16 and fp32 and at (4, 1024, 4, 128) in bf16 beside
   its plain version, its bound, SDPA's forward and backward and, in
   turns, the CUDA-core template it replaces (``flash_gqa.cu`` at H_kv =
   H), which it must beat ``TC_SPEEDUP_FLOOR``-fold in bf16 and
   ``F32_TC_SPEEDUP_FLOOR``-fold in fp32 at the LM's shape; and its D =
   256 arm at (4, 1024, 4, 256) in both dtypes beside SDPA, with no
   speed target; then past head_dim 256, on ``flash_gqa.cu``'s
   head_dim-split arm: K9/K10 (rep 4) at 320, 384 and 512 and K11 at 384
   and 512, fp32 and bf16, causal and not, at batch 2 x 512 positions,
   each within the tolerances above, two launches bitwise equal, timed
   beside its bound, its plain version and SDPA on K/V expanded;
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
12. bench.py's headline step through ``cpd_tpu_torch.bench``: ResNet-50
   (25.6 M parameters) in bf16 over fp32 weights from seed 0, batch 32
   at 224 x 224 on one rank, SGD, the APS e5m2 reduce in faithful and
   then fast mode, each from a fresh state, 3 warm and 10 timed steps:
   finite losses, step 0 within ``LM_LOSS_BAND`` of ln 1000, the K1 / K3
   launches per step as designed, a non-null images/s in each mode, the
   step's split, peak memory and a profiled step's device busy time and
   launches; at W = 2 one step's gradients through the faithful and the
   fast reduce with the kernels and with the plain versions, bitwise;
   one iteration of the ResNet CLI with ``--arch resnet50 --mode fast
   --use_APS``;
13. the flagship step's other arms: (a) the flat-index arm of the
   ``sr_bits`` kernel (``jax.random.bits``' stream) bitwise its plain
   version at the emulate cast's shapes and timed; full-width
   ResNet-18/CIFAR at W = 2 ranks x ``emulate_node`` 4 x 64 images (512
   a step), APS e5m2, ``quant_stats``, 3 steps of each arm — the
   faithful RTNE reduce with LARS, and the SR ring with the e4m3
   Kahan SR momentum buffer of ``quant_sgd``: finite losses, step 0
   within ``LM_LOSS_BAND`` of ln 10, launches per step as designed
   (`emulate_step_design`), ``prec_wire_total`` W x the parameter count,
   one step from the same start through the plain versions bitwise
   (weights, BN stats, optimizer buffers), one step's reduce bitwise
   with the stats on and off; images/s, the split (``fwd_bwd_ms``,
   ``emulate_ms``, ``reduce_ms``, ``update_ms``) and a profiled step;
   (b) 3 iterations of the ResNet CLI at ``--emulate_node 8 --batch_size
   64`` with ``--use_lars`` and with ``--opt_exp 4 --opt_man 3
   --opt_kahan``; (c) the golden APS ordering (`aps_golden`, e3m4, the
   tiny CNN on 8 ranks x ``emulate_node`` 2 x 8, 100 iterations, fast
   mode): APS Prec@1 at least no-APS + 10 and at least 60;
14. the process mesh (`parallel.mesh.ProcessMesh`, one rank per
   process over `torch.distributed`, `parallel.launch.spawn` starting
   the ranks with a deadline; a rank that raises or hangs fails the
   run): (a) 2 processes sharing the card over gloo (the wire staged
   through host memory), (b) one process per card over nccl, W = the
   card count up to 4 (W = 1 here).  In each, every rank runs the reduce
   matrix at ResNet-18/CIFAR's 62 leaves (11.17 M elements): APS e5m2
   faithful, ring and fast x RTNE, SR and Kahan, and the blocked (4, 3)
   b128 verified ring with each wire fault code on the last rank — its
   result bitwise the plain versions on the same mesh and a `LocalMesh`
   of the same W on its card, the reports equal (``reduce_ok`` per
   fault), the launches per rank as designed (`rank_design`); (a) then
   runs 2 iterations of the ResNet CLI under ``--dist --dist-backend
   gloo``; (b) checks the bytes each rank hands to the collectives
   against `ring_transport_bytes`/`gather_transport_bytes`, trains
   full-width ResNet-18 at W x 128 for 5 ring APS steps (images/s per
   card, the split, device busy and NCCL ms of a profiled step) and runs
   bench.py's headline (`bench.run` on the process mesh: ResNet-50 bf16,
   32 a card, faithful and fast, images/s per card);
15. the transport ladder and checkpoints through the ResNet CLI on
   full-width ResNet-18/CIFAR, APS e5m2, phase 14's 4096-image synthetic
   set, every checkpoint under a temporary directory: (a) a ladder drill
   at W = 4 x 128 on the card, ``--verify-reduce --reduce-retries 1
   --transport-probation 2 --fault-plan wire_flip@2:1`` over 10
   iterations (`LADDER_WANT`: 8 updates, the counters and the
   transitions ring -> faithful -> ring), every kept update's loss and
   the saved final state bitwise a replay of the same rung steps by hand
   over the batches that were not discarded, each rung's step ms and
   launches per step, the discarded steps' ms; (b) one step of the fp32
   rung (`StepTable`) bitwise the ``--mode fast`` (8, 23) step from the
   same state; (c) an unbroken 8-iteration run saved at 4 and 8, its
   step 4 resumed with ``--load-path --resume-opt`` to 8 bitwise
   (losses 5-8 and every array of step 8), save and restore ms and the
   bytes of a step, a bit-flipped newest step skipped by
   ``restore_latest_valid``, ``-e --export-torch`` then ``-e
   --init-from-torch`` giving the same validation numbers bitwise; (d) 2
   processes sharing the card over gloo under ``--dist`` (the tiny CNN)
   with ``wire_flip`` on rank 1 and a save, then a resume: both ranks'
   runs bitwise a third process's `LocalMesh` W = 2 run of the same
   argv, the ranks' digests equal after each resync, and every rank
   restoring the same bytes;
16. the step's remaining switches and the LM on the process mesh: (a)
   the LM slice's model and path (the serving width, GQA flash with the
   flash-backward kernels, the e4m3 faithful FFN) on a `LocalMesh` of 2
   ranks x ``emulate_node`` 2 x 2 sequences of 1024 seeded random
   tokens, APS e5m2, ``quant_stats``, SGD momentum 0.9: 3 steps through
   the kernels (finite losses, step 0 within ``LM_LOSS_BAND`` of ln
   32000, launches per step as designed (`lm_emulate_design`: K8, K9,
   K10, the emulate reduce's K1/K3, the reduce's K1/K3),
   ``prec_wire_total`` W x the parameter count), one step from the same
   start through the plain versions of the reduce kernels (metrics and
   the state's digest bitwise), the split (``fwd_bwd_ms``,
   ``emulate_ms``, ``reduce_ms``, ``update_ms``) and a profiled step;
   one SR step through the kernels (``sr_bits``, K2, K4) and the plain
   versions, bitwise; (b) 2 gloo processes sharing the card, each handed
   its rows, 2 steps of the faithful arm and of the RTNE ring arm with
   ``verify_reduce``, and one nccl process a card (W = the card count):
   2 steps of the faithful arm; every rank's metrics and state digests
   bitwise the `LocalMesh` of the same W; (c) the ResNet-18 CLI at W = 4
   x 128 with ``--clip-grad 1.0`` for 3 iterations (the global norm the
   clip read each step); the LM CLI under ``--dist --dist-backend nccl
   --optimizer adamw --emulate_node 2`` for 2 iterations in the nccl
   ranks at the serving width with a 256-token vocabulary; `all_finite`
   on the card (NaN, +Inf and -Inf in any leaf, its launches); a dynamic
   loss-scale drill on ResNet-18 at W = 4 x 128 over the e5m2 faithful
   reduce without APS, from a scale at which the wire overflows (DRILL):
   each step's scale and verdict, GradScaler's policy replayed, the
   params after the first applied steps bitwise a static-scale run;
17. overlap and ZeRO-1/2 on full-width ResNet-18/CIFAR, APS e5m2: the
   offset-array arm of ``sr_bits`` at ZeRO-2's shard shape (the scan's
   offsets with the pad sentinel, scattered offsets past 2^32) bitwise
   its plain version, two launches bitwise, timed beside its bound; (a)
   on a `LocalMesh` of 4 x 128 at ``bucket_elems`` 2^22, 2 steps of each
   arm (`ZERO_ARMS`): the faithful reduce and the verified blocked ring
   (RTNE; SR with Kahan), each with overlap on and off, ZeRO-1 SGD and
   LARS, ZeRO-2 SGD (RTNE, SR, Kahan, blocked SR) with overlap on and
   off, and their replicated references: finite losses, launches per
   step as designed (`zero_design`), the first step again through the
   plain versions bitwise, each pair of `ZERO_PAIRS` bitwise (weights,
   BN stats, momentum; LARS within ``LARS_TOL``), step ms and the
   momentum bytes a rank holds; a profiled faithful step with overlap
   on has a backward convolution or GEMM kernel after the first reduce
   kernel, and with overlap off none; the blocked ZeRO-2 reduce-scatter
   bitwise `zero2_oracle_flat`; (c) the ZeRO-2 overlap arm's W = 4
   state saved padded and portable: ``restore(world=2)`` of each bitwise
   `import_state` at W = 2; (b) one spawn: 2 gloo processes sharing the
   card run the ResNet CLI under ``--dist --zero2 --overlap-reduce
   --bucket-elems 2^20``, each rank's result and checkpoint bitwise a
   `LocalMesh` W = 2 process's run of the same argv, which then runs 2
   iterations of the LM CLI with ``--overlap-reduce --emulate_node 2``
   at the serving width; then one nccl process a card (W = the card
   count): 2 ZeRO-2 overlap steps, the bytes each rank hands to the
   all-to-alls equal to `zero2_transport_bytes`, its weights and shard
   bitwise a `LocalMesh` of the same W;
18. the rest of the quant package at ResNet-18/CIFAR's layer widths,
   batch 8, e5m2: K8's SR arm and its stats arm (RTNE and SR) against
   their plain scans, BITWISE with equal counts, over (4,3), (5,2),
   (8,23) and (2,1) at odd shapes with rows that saturate and underflow,
   the stats arm's products bitwise the arms without counting; the main
   path: the stem conv 3 -> 64, a stage-1 conv 64 -> 64, a stage-4 conv
   512 -> 512 (`QuantConv`, 3 x 3, padding 1) and the FC 512 -> 10
   (`QuantLinear`) forward and backward, round to nearest and SR, the
   `Quantizer` SR on the stage-1 activations and `qgemm_stats` on each
   layer's forward operands: finite values, launches as designed
   (``QUANT_LAYERS_DESIGN``), each stats product the layer's forward
   GEMM bitwise; the arms on the stem, stage-1 and FC forward operands
   against their plain scans, the stage-4 GEMMs (K = 4608) bitwise run to
   run; each arm timed by `queued_ms` beside the RTNE arm at the stage-1
   and stage-4 shapes against its bound; the SR and stats kernels'
   registers and spills; phase 6's CLI and the slice's pipeline made
   their batches through the native fused augment;
19. sequence parallelism on the serving-width GQA LM (vocab 32000,
   d_model 512, 4 layers, 8 q / 2 kv heads, d_ff 2048, fp32): (a) a
   `LocalMesh` of dp 2 x sp 2, 4 sequences a dp rank of T = 2048
   (T_local 1024), 2 steps of each `SP_ARMS` arm — ring attention with
   the APS e5m2 RTNE ring reduce, and Ulysses with the flash kernels
   (K9/K10 on the gathered sequence), dropout 0.1 and the SR ring
   reduce: step 0's loss within ``LM_LOSS_BAND`` of ln V, the first
   step's sp-summed gradients within ``SP["grad_rtol"]`` of the same
   model at sp = 1 (dropout off for that gate), the dp reduce bitwise its
   plain version on them, one layer's K9/K10 calls against their plain
   versions, one layer's dropout mask bitwise the CPU bits, launches as
   ``sp_design`` says; step ms, ``fwd_bwd_ms``, ``reduce_ms``, tokens/s;
   (b, run in phase 20's spawn) 2 gloo processes sharing the card run
   the LM CLI under ``--dist --sp 2`` in each mode: losses and weights bitwise the
   `LocalMesh` dp 1 x sp 2 run of the same argv, and the bytes each rank
   hands to the sp collectives equal the counts from the shapes; (c) with
   two cards or more, one nccl process a card at sp = the card count,
   bitwise the `LocalMesh` (extra evidence: the gates hold on one card);
20. tensor parallelism and scanned layers on 19's model, weights and
   batches: (a) a `LocalMesh` of dp 2 x sp 2 x tp 2 (Megatron-sharded
   blocks, each rank on its slices of the full weights), 2 steps of each
   `TP_ARMS` arm — ring attention with the APS e5m2 RTNE ring reduce, and
   Ulysses with the flash kernels on the local heads, the e4m3 faithful
   FFN (K8 at tp-local shapes), dropout 0.1 and the SR ring reduce:
   step 0's loss within ``LM_LOSS_BAND`` of ln V; the ring arm's sp- and
   tp-summed gradients, put back whole, within ``SP["grad_rtol"]`` of
   19a's tp = 1 gradients (dropout off), and the same arm on scanned
   layers with remat bitwise the unrolled arm (losses, weights
   restacked); each tp index's dp reduce bitwise its plain version; one
   recorded K8 call of each tp-local shape bitwise its plain scan, one
   layer's K9/K10 calls against their plain versions, one dropout mask
   bitwise the CPU bits; launches as ``tp_design`` says; step ms,
   ``fwd_bwd_ms``, ``reduce_ms``, tokens/s; (b) one spawn of 2 gloo
   processes sharing the card runs 19b, then the LM CLI under ``--dist
   --tp 2`` (dp 1 x tp 2): losses, weights and momentum bitwise the `LocalMesh`
   run's tp shards, the bytes a process holds and hands to the tp
   collectives equal to the counts from the shapes; (c) with two cards or
   more, one nccl process a card at dp = cards / 2 x tp 2, bitwise the
   `LocalMesh` (extra evidence);
21. print each phase's wall seconds (``phase seconds: {...}``, phase 10a
   split into its plain checks, cast probe, timed turns and census), one
   JSON line ``{"kernels": [...]}`` and, last,
   ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --overlap-nccl

times overlap on a `ProcessMesh` instead, and needs two cards or more:
one nccl process a card runs each arm of 17b's nccl ranks
(`ZERO_NCCL_ARMS`) for ``OVERLAP_NCCL["steps"]`` steps, then one
profiled step (`overlap_trace`: the device's busy and idle time, the
nccl kernels' time, the backward kernels after the first nccl kernel
and those that ran beside one, the host's synchronising calls and its
costliest CUDA runtime calls); each arm's losses bitwise its pair's
with overlap off.  It prints one JSON line of each arm's step ms and
every rank's trace.

The script imports neither jax nor the JAX package.
"""

from __future__ import annotations

import contextlib
import io
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

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
# one step (two until phase 19 came: the plain qgemm's second step cost
# ~26 s on the card); the update of that step is held leaf by leaf
LM_SMALL_TRAIN = dict(world=2, per_rank_batch=2, seq=128, steps=1)
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
# the shape at which phases 10a and 18 time K8's plain scans (eager)
QGEMM_PLAIN_SHAPE = (256, 64, 256)
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
# ... and moves a few elements' updates by up to one e4m3 step, which
# shows in norm as a small share of the leaf's update: each leaf's
# difference is held within this share of the plain update's norm, 4x
# the largest share a sound run gave on an H100 (0.00727, the same in
# every run: the data and the kernels are deterministic); planted on the
# kernel side alone, a dp reduce output scaled by 1.1 reads 0.100 and
# K9's forward output scaled by 1 + 2^-10 reads 0.152 (PERF.md)
LM_SMALL_UPDATE_SHARE = 0.03
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
# phase 11a's head dims past the kernels' own 32/64/128: 48 and 96 run
# zero-padded on the tensor-core kernels, 256 on flash_gqa.cu's templates
NEW_HEAD_DIMS = (48, 96, 256)
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
# K5/K6's streaming kernels (run_wire_kernel, run_blocked_kernel) against
# the kept kernels they replace (ops.quantize.core_wire_launcher), by
# queued_ms in turns at the ring chunk: at least this many times faster
# without digests and with them: regression floors just under the lowest
# ratios the arms measured (PERF.md section 6: 1.36x and 1.95x)
WIRE_SPEEDUP_FLOOR = {"plain": 1.3, "digest": 1.8}
# the wire kernels' ragged sizes, held besides the chunk and QUANT_ODD_N,
# each also on a view 4 bytes past a 16-byte boundary
WIRE_SMALL_N = (1, 15, 17)
# what the kernels line adds for the streaming K5/K6 arms (`wire_timing`)
# and K7 (`digest_rows_timing`)
WIRE_FIELDS = ("kernel", "kept_ms", "speedup", "kept_ms_with_digest",
               "speedup_with_digest", "share", "share_with_digest",
               "ms_no_fold", "digest_loop_ms", "fold_ms", "profiler_ms",
               "profiler_ms_with_digest", "profiler_other_kernels",
               "pipe_bound_ms", "kept_note", "launch_floor_ms")
# the SASS (mangled) names of the per-tensor streaming kernel's digesting
# instances at a 1-byte wire (512-thread CTAs), whose grid-stride loop the
# pipe bound is counted from, and the elements one pass of it computes
WIRE_RUN_SASS = {
    "quantize_pack": "run_wire_kernelILb1ELb0ELi1ELi512ELb1EE",
    "quantize_pack_sr": "run_wire_kernelILb1ELb1ELi1ELi512ELb1EE",
    "hop_pack": "run_wire_kernelILb0ELb0ELi1ELi512ELb1EE",
    "hop_pack_sr": "run_wire_kernelILb0ELb1ELi1ELi512ELb1EE"}
WIRE_RUN_ELEMENTS = 4
# K7 at W rows of B bytes reads W * B bytes and writes W int64 digests;
# its integer work (two __dp4a a word) is below its bytes at 3.35 TB/s
DIGEST_ROWS = ("cpd_tpu/ops/quantize.py:582", "digest_rows_pallas")
# K7's one-launch kernel (run_rows_kernel) against the kept two-launch
# kernel it replaces (ops.quantize.core_digest_launcher), by queued_ms in
# turns at the verified ring's gathered wire: at least this many times
# faster
K7_SPEEDUP_FLOOR = 2.5
# K7's parity cases besides the ring's: W rows of every size here, each
# at a 16-byte boundary and some bytes past one
K7_ROWS = (1, 2, 4, 8)
K7_SIZES = (1, 15, 16, 17) + tuple(16 * 40 + r for r in range(1, 16))
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
                "quantize_pack": "run_wire_kernel<true, false,",
                "quantize_pack_sr": "run_wire_kernel<true, true,",
                "hop_pack": "run_wire_kernel<false, false,",
                "hop_pack_sr": "run_wire_kernel<false, true,",
                "quantize_pack_blocked": "run_blocked_kernel<true, false,",
                "quantize_pack_blocked_sr": "run_blocked_kernel<true, true,",
                "hop_pack_blocked": "run_blocked_kernel<false, false,",
                "hop_pack_blocked_sr": "run_blocked_kernel<false, true,",
                "digest_rows": "run_rows_kernel",
                # the offset-indexed bits, their flat-index arm and their
                # offset-array arm
                "sr_bits": ("sr_bits_kernel", "flat_bits_kernel",
                            "offset_bits_kernel"),
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

# phase 2's K12 cases: (name, KV format, blocked codec block or None,
# NaN-coded bytes past every slot's last live position, shape) with shape
# (slots, positions per slot, page, head_dim, kv heads, query heads); the
# serving slice's shape unless named
SLICE_KV = (ENGINE["n_slots"], ENGINE["max_seq"], ENGINE["page_size"],
            MODEL["d_model"] // MODEL["n_heads"], MODEL["n_kv_heads"],
            MODEL["n_heads"])
KV_CASES = (("e4m3", (4, 3), None, False, SLICE_KV),
            ("e5m2", (5, 2), None, False, SLICE_KV),
            ("e8m23", (8, 23), None, False, SLICE_KV),
            ("e4m3-blocked32", (4, 3), 32, False, SLICE_KV),
            ("e4m3-nan-tail", (4, 3), None, True, SLICE_KV),
            # a long context: 8 slots x 4096 positions, 256 pages each
            ("e4m3-long4096", (4, 3), None, False, (8, 4096, 16, 64, 2, 8)),
            # page 64 x head_dim 128: a page's staging cut in two parts
            ("e4m3-page64-d128", (4, 3), None, False, (8, 512, 64, 128, 2, 8)),
            # GQA 8:1
            ("e4m3-rep8", (4, 3), None, False, (8, 512, 16, 64, 1, 8)))
# phase 12: bench.py's headline arms through `cpd_tpu_torch.bench` (its
# WORLD, BATCH and IMAGE_SIZE: ResNet-50 bf16, APS e5m2, faithful then
# fast, its warm and timed steps); the W = 2 reduce held kernels vs plain
# on one step's gradients; the CLI's --arch resnet50 --mode fast
HEADLINE_W2 = 2
HEADLINE_CLASSES = 1000
HEADLINE_CLI_BATCH = 32

# phase 13: the flagship step's other arms on full-width ResNet-18/CIFAR:
# W ranks x emulate_node micro-batches of micro_batch (512 images a step,
# the config's batch_size), APS e5m2, `steps` steps an arm; arm "a" the
# faithful RTNE reduce with LARS, arm "b" the SR ring with the e4m3 Kahan
# SR momentum buffer; both with the reduce's health telemetry
EMU = dict(world=2, emulate_node=4, micro_batch=64, steps=3, fmt=(5, 2),
           seed=24, grad_seed=0)
EMU_ARMS = {
    "a": dict(mode="faithful", grad_rounding="nearest", optimizer="lars",
              opt_kw={}),
    "b": dict(mode="ring", grad_rounding="stochastic",
              optimizer="quant_sgd",
              opt_kw=dict(opt_exp=4, opt_man=3, opt_kahan=True,
                          opt_rounding="stochastic", opt_seed=0)),
}
# 13b: the CLI at the reference quick-start's --emulate_node 8
EMU_CLI = ["--use_APS", "--grad_exp", "5", "--grad_man", "2",
           "--emulate_node", "8", "--batch_size", "64", "--max-iter", "3",
           "--val_freq", "3"]
EMU_CLI_ARMS = (["--use_lars"], ["--opt_exp", "4", "--opt_man", "3",
                                 "--opt_kahan"])
# 13c: tests/test_golden.py's settings and ordering
GOLDEN = dict(iters=100, batch_size=8, margin=10.0, floor=60.0)
GOLDEN_CONFIGS = [("e3m4_noaps", 3, 4, False), ("e3m4_aps", 3, 4, True)]
# the flat-index arm of the sr_bits kernel at the emulate cast's shapes:
# the largest ResNet-18 leaf stacked N = 4 times, and an odd length
FLAT_BITS_N = (4 * 512 * 512 * 3 * 3, QUANT_ODD_N)

# K12's kernels by the profiler's names
K12_KERNEL_NAMES = ("split_kernel", "combine_kernel")
# K12 at the slice's e4m3 shape against the kept serial kernel it replaces,
# by device time in the same run: at least this many times faster
K12_SPEEDUP_FLOOR = 5.0


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


# every checkpoint the ResNet CLI writes goes under one temporary root,
# made at the first use and removed when main returns
_SAVE_ROOT: list = []


def save_path(label: str) -> str:
    """A fresh checkpoint directory for one CLI run."""
    if not _SAVE_ROOT:
        _SAVE_ROOT.append(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    path = os.path.join(_SAVE_ROOT[0], label)
    shutil.rmtree(path, ignore_errors=True)
    return path


def _pool_main(rank: int, jobs, results) -> None:
    """One process of `RankPool`: runs jobs until it reads None.  A job
    is `parallel.launch.spawn`'s rank work: torchrun's variables and the
    job's own set, the card reset to the first (an nccl job leaves its
    rank's card current), ``fn(*args)``, the group destroyed, the card's
    cache freed and every name a job rebound in a module of the port
    bound back (rank functions patch samplers and hooks as a fresh
    process may); its result, or its traceback, goes back."""
    import importlib
    import pkgutil
    import traceback

    import torch
    import torch.distributed as dist

    import cpd_tpu_torch

    # every module loaded first, so that the bindings saved before a job
    # are the modules' own
    for info in pkgutil.walk_packages(cpd_tpu_torch.__path__,
                                      "cpd_tpu_torch."):
        importlib.import_module(info.name)
    while True:
        saved = {name: dict(vars(mod)) for name, mod in
                 list(sys.modules.items())
                 if name.split(".")[0] in ("cpd_tpu_torch", "__mp_main__")}
        job = jobs.get()
        if job is None:
            return
        fn, world, port, args, env = job
        os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world),
                           "LOCAL_RANK": str(rank),
                           "LOCAL_WORLD_SIZE": str(world),
                           "MASTER_ADDR": "localhost",
                           "MASTER_PORT": str(port)})
        os.environ.update(env or {})
        if torch.cuda.is_available():
            torch.cuda.set_device(0)
        try:
            results.put((rank, True, fn(*args)))
        except BaseException:
            results.put((rank, False, traceback.format_exc()))
        finally:
            if dist.is_available() and dist.is_initialized():
                dist.destroy_process_group()
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
            for name, before in saved.items():
                names = vars(sys.modules[name])
                for k, v in before.items():
                    if names.get(k) is not v:
                        names[k] = v


class RankPool:
    """`parallel.launch.spawn`'s contract (``fn(*args)`` in ``world``
    rank processes with torchrun's variables, results in rank order, any
    rank's failure or the deadline raises) on rank processes started
    once and kept for every phase that spawns: each fresh process takes
    seconds to import torch and reach the card, and phases 14-17 and 20
    spawn six times.  `main` starts them before the build.  Rank r of
    every job runs in process r; `close` stops them all."""

    def __init__(self):
        self.procs: list = []
        self.jobs: list = []
        self.results = None

    def start(self, n: int) -> None:
        """At least ``n`` processes, the new ones started now (they
        import while the caller goes on)."""
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        if self.results is None:
            self.results = ctx.SimpleQueue()
        while len(self.procs) < n:
            q = ctx.SimpleQueue()
            proc = ctx.Process(target=_pool_main,
                               args=(len(self.procs), q, self.results))
            proc.start()
            self.procs.append(proc)
            self.jobs.append(q)

    def spawn(self, fn, world: int, *, args=(), timeout: float = 600.0,
              env=None) -> list:
        from cpd_tpu_torch.obs.timing import now
        from cpd_tpu_torch.parallel.launch import _free_port

        self.start(world)
        port = _free_port()
        for r in range(world):
            self.jobs[r].put((fn, world, port, tuple(args), env))
        done: dict = {}
        deadline = now() + timeout
        while len(done) < world:
            if not self.results.empty():
                rank, ok, out = self.results.get()
                if not ok:
                    self.close()
                    raise RuntimeError(f"1 of {world} ranks failed:\nrank "
                                       f"{rank}: {out}")
                done[rank] = out
                continue
            dead = [r for r, p in enumerate(self.procs) if not p.is_alive()]
            if dead or now() > deadline:
                self.close()
                raise RuntimeError(
                    f"ranks {sorted(set(range(world)) - set(done))} of "
                    f"{world} gave no answer "
                    + (f"(processes {dead} died)" if dead else
                       f"within {timeout:.0f} s"))
            time.sleep(0.05)
        return [done[r] for r in range(world)]

    def close(self) -> None:
        for q, proc in zip(self.jobs, self.procs):
            if proc.is_alive():
                q.put(None)
        for proc in self.procs:
            proc.join(timeout=10)
            if proc.is_alive():
                proc.kill()
                proc.join()
        self.procs, self.jobs, self.results = [], [], None


POOL = RankPool()


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


def profiled_kernels(prof) -> list:
    """The device kernels of a torch.profiler run, by name."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]



def device_ms(fn, iters: int, warmup: int = 3) -> float:
    """Device time of the kernels one ``fn()`` call launches, summed and
    averaged over ``iters`` calls under torch.profiler.  Unlike
    `time_ms`, host dispatch between back-to-back calls does not count.
    Every call launches at least one kernel; where the profiler records
    fewer kernels than calls (seen on the card late in a long run, when
    it kept one launch in twenty), the time comes from CUDA events
    (`time_ms`) and a line says so."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = profiled_kernels(prof)
    if sum(e.count for e in kernels) < iters:
        print(f"  (torch.profiler recorded {sum(e.count for e in kernels)} "
              f"kernels for {iters} calls: timed with CUDA events instead)",
              flush=True)
        return time_ms(fn, iters, warmup=0)
    return sum(e.self_device_time_total for e in kernels) / 1e3 / iters


def named_device_ms(fn, iters: int, kernel: str) -> dict:
    """torch.profiler's device time of the kernel named ``kernel`` (a
    substring of its name), one launch per ``fn()`` call, over ``iters``
    calls: ``ms`` per call (None unless it recorded exactly ``iters``
    launches of it), ``records`` of it, and ``other``: the records of every
    other kernel in the same profile, which ``fn`` does not launch, as
    {name: [count, device ms]}.  The whole-profile sum of `device_ms`
    counts those too."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    mine = [e for e in profiled_kernels(prof) if kernel in e.key]
    other = {e.key[:80]: [e.count, e.self_device_time_total / 1e3]
             for e in profiled_kernels(prof) if kernel not in e.key}
    count = sum(e.count for e in mine)
    ms = (sum(e.self_device_time_total for e in mine) / 1e3 / iters
          if count == iters else None)
    return dict(ms=ms, records=count, other=other)


def without_fold(fn):
    """A digesting K6/K5 call ``fn`` whose streaming launch stops at the
    CTAs' partials (`ops.quantize._launch_wire` with ``fold=False``: no
    fence, ticket or last CTA's sum; its digests are not written).  Timed
    against ``fn`` it gives the fold's share of a digesting launch."""
    import functools

    from cpd_tpu_torch.ops import quantize as tq

    launch = tq._launch_wire

    def call(*args):
        tq._launch_wire = functools.partial(launch, fold=False)
        try:
            return fn(*args)
        finally:
            tq._launch_wire = launch
    return call


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.5f}"


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
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = profiled_kernels(prof)
    n = sum(e.count for e in kernels)
    if n < iters or n % iters:
        return {}
    return {e.key: e.self_device_time_total / 1e3 / iters for e in kernels}


def kv_case(cfg, n_slots: int, max_pages: int, nan_tail: bool,
            generator, device, n_heads: int = MODEL["n_heads"]):
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
    q = torch.randn((n_slots, 1, n_heads, hd),
                    generator=generator, device=device)
    return pool, q, rows, last[:, None].contiguous(), last


def bound_ms(pool, q, rows, positions, last, cfg) -> tuple:
    """(least time in ms, "bytes" or "operations") for one fused call on
    these inputs: each DISTINCT gathered page, q, the page table and the
    positions read once, attn (fp32) and the int64 digests written once;
    the operations of both attention contractions over each slot's
    unmasked keys, at fp32 peak."""
    import torch

    n_pages = int(torch.unique(rows).numel())
    n_bytes = (n_pages * cfg.page_bytes + q.numel() * 4 + rows.numel() * 4
               + positions.numel() * 4 + last.numel() * 4
               + q.numel() * 4 + rows.numel() * 8)
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
    return queued_ms(lambda: F.scaled_dot_product_attention(
        qh, k, v, attn_mask=mask), iters=50)


def kernel_phase(device) -> dict:
    """Phase 2: the fused attention kernel (K12, split-K) against its plain
    version over `KV_CASES`, two launches bitwise equal in each; timed by
    device time (`queued_ms`) in turns with the kept serial kernel it
    replaces (kept, kernel, kernel, kept; where the kept kernel takes the
    shape), beside the plain version and one library call (attention
    only: not the same function)."""
    import torch

    from cpd_tpu_torch.ops import serve_attn
    from cpd_tpu_torch.serve.kvcache import KVCacheConfig

    gen = torch.Generator(device=device).manual_seed(1234)
    kept = serve_attn.core_launcher()
    report = {"cases": {}}
    for name, fmt, block, nan_tail, shape in KV_CASES:
        slots, seq, page, hd, hkv, heads = shape
        max_pages = -(-seq // page)
        cfg = KVCacheConfig(
            n_layers=1, n_kv_heads=hkv, head_dim=hd, page_size=page,
            n_pages=1 + slots * max_pages, exp_bits=fmt[0],
            man_bits=fmt[1], block_scale=block is not None,
            block_size=block or 32)
        args = kv_case(cfg, slots, max_pages, nan_tail, gen, device,
                       n_heads=heads)
        attn, dig = serve_attn.fused_gather_attention(*args, cfg=cfg)
        again = serve_attn.fused_gather_attention(*args, cfg=cfg)
        torch.cuda.synchronize()
        if not (same_bits(attn, again[0]) and same_bits(dig, again[1])):
            raise AssertionError(f"{name}: two launches on the same inputs "
                                 "differ")
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

        def kernel():
            return serve_attn.fused_gather_attention(*args, cfg=cfg)

        def kept_kernel():
            return kept(*args, cfg)

        try:
            kept_kernel()
        except ValueError as e:           # outside the serial kernel's limits
            kept_kernel, why = None, str(e)
        if kept_kernel is None:
            ms = queued_ms(kernel, iters=50)
            kept_ms = None
        else:
            t1, k1, k2, t2 = (queued_ms(f, iters=50) for f in (
                kept_kernel, kernel, kernel, kept_kernel))
            ms, kept_ms = (k1 + k2) / 2, (t1 + t2) / 2
        plain_ms = time_ms(lambda: serve_attn.fused_gather_attention_ref(
            *args, cfg=cfg), iters=5)
        lib_ms = library_attention_ms(*args, cfg)
        b_ms, b_by = bound_ms(*args, cfg)
        unit, _, _ = serve_attn.split_plan(cfg, heads // hkv)
        # the split and combine kernels' device ms per call, by the
        # profiler's names ({} where the profile is not whole)
        by_kernel = ({k[:40]: round(v, 5) for k, v in
                      device_kernels_ms(kernel, iters=50).items()}
                     if name == "e4m3" else {})
        report["cases"][name] = dict(
            max_abs_err=err, ms=ms, kept_ms=kept_ms,
            speedup=None if kept_ms is None else kept_ms / ms,
            call_ms=time_ms(kernel, iters=50), plain_ms=plain_ms,
            library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
            shape=list(shape), parts_per_page=-(-page // unit),
            ctas=slots * max_pages * -(-page // unit), kernels_ms=by_kernel)
        r = report["cases"][name]
        vs = (f"the kept serial kernel {kept_ms:.5f}, {r['speedup']:.1f}x "
              "the kernel's time" if kept_ms is not None
              else f"the kept serial kernel does not take it ({why})")
        print(f"kernel serve_attn [{name}, {list(shape)}]: digests "
              f"bitwise, two launches bitwise, attn max abs err {err:.3e} "
              f"(atol {ATTN_ATOL}, rtol {ATTN_RTOL}); kernel_ms {ms:.5f} "
              f"(device, split {r['ctas']} CTAs, {r['parts_per_page']} "
              f"part(s) a page; per call with host dispatch "
              f"{r['call_ms']:.5f}); {vs}; plain_ms {plain_ms:.5f} "
              f"bound_ms {b_ms:.6f} ({b_by}) library_ms {lib_ms:.5f} "
              "(SDPA on K/V unpacked ahead: attention only; not the same "
              f"function); by kernel {by_kernel}", flush=True)
    speedup = report["cases"]["e4m3"]["speedup"]
    if speedup < K12_SPEEDUP_FLOOR:
        raise AssertionError(f"K12 at the slice's e4m3 shape: only "
                             f"{speedup:.2f}x the kept serial kernel (floor "
                             f"{K12_SPEEDUP_FLOOR}x)")
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


def sass_per_element(library: str, kernel: str, elements=None) -> dict:
    """Instructions one element of ``kernel`` issues, by pipe: the body
    of its grid-stride loop (its largest loop: from the target of a
    backward branch to the branch; every path of it counted) in the SASS
    of ``library``'s build, divided by the ``elements`` one pass computes
    (by default the global stores in it, one per element)."""
    insns, loops, _ = _sass_loops(library, kernel)
    start, end = max(loops, key=lambda se: se[1] - se[0], default=(0, -1))
    ops = insns[start:end + 1] if loops else insns
    if elements is None:
        elements = max(1, sum(op.split(".")[0] in ("STG", "ST") for op in ops))
    return _by_pipe(ops, elements)


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
    more, wire_errs = wire_parity(device, gen, sr=False, blocked=False)
    for name, e in wire_errs.items():
        errs[name] = max(errs[name], e)
    print(f"kernel quantize: {more} outputs of the streaming K6/K5 bitwise "
          f"equal to their plain versions and the kept kernels (n = "
          f"{list(WIRE_SMALL_N)}, and every n on inputs 4 bytes past a "
          f"16-byte boundary; formats {list(WIRE_FORMATS)}; with and "
          "without digests)", flush=True)

    print(f"kernel quantize: {two_stream_digests(device)} digesting "
          "K6/K5 launches queued on two streams at once (per tensor and "
          "block 128, four sizes each) bitwise equal to their plain "
          "versions, digests included", flush=True)

    fmt = TRAIN["fmt"]
    wb = wire_bytes(*fmt)
    path = ring_run_path(device, chunk, wb)
    print(f"kernel quantize: the ring's K5 calls at the slice's chunk take "
          f"the run path {json.dumps(path)} (vec bits 1 g, 2 rbits, 4 "
          f"wire_in, 8 res, 16 wire_out: 16-byte accesses)", flush=True)
    from cpd_tpu_torch.ops.build import build_log

    regs = wire_build_report(build_log("quantize"))
    print("kernel quantize build: streaming K6/K5 <first, sr, [warp,] wire "
          "bytes, threads, digest>: " + json.dumps(regs), flush=True)
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
    }
    out = {name: time_kernel(name, fmt, chunk, sets, *fns, errs[name])
           for name, fns in calls.items()}
    core = tq.core_wire_launcher()
    wire = {
        "quantize_pack": dict(
            new=lambda x, y, w: tq.quantize_pack(x, *fmt),
            kept=lambda x, y, w: core(None, x, *fmt),
            new_digest=lambda x, y, w: tq.quantize_pack(x, *fmt,
                                                        want_digest=True),
            kept_digest=lambda x, y, w: core(None, x, *fmt,
                                             want_digest=True),
            plain=lambda x, y, w: tq.quantize_pack_ref(x, *fmt)),
        "hop_pack": dict(
            new=lambda x, y, w: tq.hop_pack(w, x, *fmt),
            kept=lambda x, y, w: core(w, x, *fmt),
            new_digest=lambda x, y, w: tq.hop_pack(w, x, *fmt,
                                                   want_digest=True),
            kept_digest=lambda x, y, w: core(w, x, *fmt, want_digest=True),
            plain=lambda x, y, w: tq.hop_pack_ref(w, x, *fmt)),
    }
    for name, fns in wire.items():
        out[name] = wire_timing(
            name, f"{fmt}, n={chunk}", chunk, sets, fns,
            QUANT_KERNELS[name][1](wb) * chunk / PEAK_BYTES_PER_S,
            QUANT_OPS[name] * chunk / PEAK_FP32_FLOPS, errs[name])
    out["ring_path"] = path
    return out


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


def shifted(x):
    """A copy of ``x`` whose data starts 4 bytes past a 16-byte boundary
    (an fp32 view one element in, or bytes four in): the ring hands the
    kernels views at chunk offsets."""
    import torch

    flat = x.reshape(-1)
    lead = 4 // flat.element_size()
    buf = torch.empty(flat.numel() + lead, dtype=flat.dtype,
                      device=flat.device)
    out = buf[lead:].view(x.shape)
    out.copy_(x)
    if out.data_ptr() % 16 != 4:
        raise AssertionError("the shifted copy is not 4 bytes past a "
                             "16-byte boundary")
    return out


def wire_parity(device, generator, sr: bool, blocked: bool) -> tuple:
    """K6/K5's streaming kernels (RTNE or SR; per tensor over
    WIRE_FORMATS, or blocked over BLOCKED_FORMATS x BLOCK_SIZES) against
    their plain versions and the kept kernels, bitwise (partials, wire
    bytes with any sidecar, both digests), with and without digests: at
    n in WIRE_SMALL_N, and at every n (the chunk and QUANT_ODD_N too) with
    g, the round bits and the received wire 4 bytes past a 16-byte
    boundary.  Returns (outputs held, max abs err by counter name)."""
    from cpd_tpu_torch.ops import quantize as tq

    chunk = ring_chunk_of_slice(device)
    core = tq.core_wire_launcher()
    fmts = BLOCKED_FORMATS if blocked else WIRE_FORMATS
    blocks = BLOCK_SIZES if blocked else (None,)
    make = blocked_inputs if blocked else quant_inputs
    errs, cases = {}, 0
    for n in (chunk, QUANT_ODD_N) + WIRE_SMALL_N:
        for fmt in fmts:
            x0 = make(n, fmt, generator, device)
            y0 = make(n, fmt, generator, device).flip(0)
            rb0 = (tq.sr_bits((fmt[0], n), x0, offset_start=2**32 - 11)
                   if sr else None)
            for moved in ((False, True) if n in WIRE_SMALL_N else (True,)):
                x, y = (shifted(x0), shifted(y0)) if moved else (x0, y0)
                rb = shifted(rb0) if moved and sr else rb0
                for b in blocks:
                    kw = dict(rbits=rb, block_size=b)
                    sfx = ("_blocked" if blocked else "") + \
                        ("_sr" if sr else "")
                    names = ["quantize_pack" + sfx, "hop_pack" + sfx]
                    pairs = []
                    for dig in (True, False):
                        first = tq.quantize_pack(x, *fmt, want_digest=dig,
                                                 **kw)
                        for want in (tq.quantize_pack_ref(
                                x, *fmt, want_digest=dig, **kw),
                                core(None, x, *fmt, want_digest=dig, **kw)):
                            pairs += [(names[0], u, v)
                                      for u, v in zip(first, want)]
                        w_in = shifted(first[1]) if moved else first[1]
                        hop = tq.hop_pack(w_in, y, *fmt, want_digest=dig,
                                          **kw)
                        for want in (tq.hop_pack_ref(
                                w_in, y, *fmt, want_digest=dig, **kw),
                                core(w_in, y, *fmt, want_digest=dig, **kw)):
                            pairs += [(names[1], u, v)
                                      for u, v in zip(hop, want)]
                    for name, got, want in pairs:
                        if not same_bits(got, want):
                            raise AssertionError(
                                f"{name} n={n} {fmt} block {b} shifted="
                                f"{moved}: the streaming kernel differs "
                                "from its plain version or the kept kernel")
                        errs[name] = max(errs.get(name, 0.0),
                                         max_abs_diff(got, want))
                        cases += 1
    return cases, errs


def wire_build_report(log: str) -> dict:
    """Registers and spill bytes of each streaming K5/K6 instance in an
    nvcc ``-Xptxas -v`` log of quantize.cu, by its template arguments
    (first, sr, [warp,] wire bytes, threads, digest), and the CTAs an SM
    can hold by registers alone (65536 a SM)."""
    import re

    out, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(r"(run_wire_kernel|run_blocked_kernel)I((?:L[bi]"
                          r"\d+E)+)E", m[1])
            entry = (f"{k[1]}<{','.join(re.findall(r'L[bi](\d+)E', k[2]))}>"
                     if k else None)
            if entry:
                out[entry] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and entry:
            out[entry]["spill_stores"] = int(m[1])
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            regs = int(m[1])
            threads = int(entry.rstrip(">").split(",")[-2])
            out[entry].update(registers=regs,
                              ctas_by_registers=65536 // (
                                  -(-regs // 8) * 8 * threads))
    return out


def ring_run_path(device, chunk: int, wb: int) -> dict:
    """The path `quantize_run_head` picks for the ring's own K5 calls at
    the slice's chunk: g a view of the padded bucket at each chunk offset,
    the received wire, the round bits and the outputs fresh allocations
    (`parallel.ring`'s `local` and `next_hop`)."""
    import ctypes

    import torch

    from cpd_tpu_torch.ops import quantize as tq

    lib = tq._library()
    padded = torch.empty(TRAIN["world"] * chunk, device=device)
    recv = torch.empty((chunk, wb), dtype=torch.uint8, device=device)
    res = torch.empty(chunk, device=device)
    out = torch.empty((chunk, wb), dtype=torch.uint8, device=device)
    rb = torch.empty(chunk, dtype=torch.int32, device=device)
    paths = []
    for c in range(TRAIN["world"]):
        g = padded[c * chunk:(c + 1) * chunk]
        for r in (None, rb):
            vec = ctypes.c_int(0)
            head = lib.quantize_run_head(
                recv.data_ptr(), g.data_ptr(),
                None if r is None else r.data_ptr(), res.data_ptr(),
                out.data_ptr(), chunk, wb, ctypes.byref(vec))
            paths.append((head, vec.value))
    head, vec = max(paths)
    return dict(chunk=chunk, chunk_16_byte_aligned=chunk * 4 % 16 == 0,
                heads=sorted({p[0] for p in paths}), head=head,
                vec_bits=sorted({p[1] for p in paths}),
                runs=(chunk - head) // WIRE_RUN_ELEMENTS,
                scalar_elements=head + (chunk - head) % WIRE_RUN_ELEMENTS)


def two_stream_digests(device) -> int:
    """Digesting K6/K5 launches queued on two streams at once, each stream
    with its own digest scratch (`ops.quantize._wire_scratch`), against
    their plain versions: every output bitwise, digests included.  Returns
    the outputs compared."""
    import torch

    from cpd_tpu_torch.ops import quantize as tq

    fmt = (4, 3)
    gen = torch.Generator(device=device).manual_seed(97)
    x = quant_inputs(2_000_003, fmt, gen, device)
    y = quant_inputs(2_000_003, fmt, gen, device)
    cases = [(n, blk) for n in (2_000_003, 17, 100_003, 1_000)
             for blk in (None, 128)]
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    got = []
    for n, blk in cases * 3:
        for s in streams:
            with torch.cuda.stream(s):
                first = tq.quantize_pack(x[:n], *fmt, block_size=blk,
                                         want_digest=True)
                got.append((n, blk, first, tq.hop_pack(
                    first[1], y[:n], *fmt, block_size=blk,
                    want_digest=True)))
    torch.cuda.synchronize()
    compared = 0
    for n, blk, first, hop in got:
        want = tq.quantize_pack_ref(x[:n], *fmt, block_size=blk,
                                    want_digest=True)
        want_hop = tq.hop_pack_ref(want[1], y[:n], *fmt, block_size=blk,
                                   want_digest=True)
        for a, b in zip(first + hop, want + want_hop):
            if not same_bits(a, b):
                raise AssertionError(f"two streams, n={n} block {blk}: a "
                                     "digesting launch differs from its "
                                     "plain version")
            compared += 1
    return compared


def wire_timing(name: str, shape: str, n: int, sets, fns: dict,
                t_bytes: float, t_ops: float, err: float) -> dict:
    """One streaming K5/K6 arm's card numbers: by `queued_ms` in turns
    with the kept kernel (kept, new, new, kept), without and with
    digests; the torch.profiler device time beside them (the method of
    the earlier figures); the plain version; per-call time with host
    dispatch; the bound from the bytes one call moves (the digest adds
    none) and, for the per-tensor arms, the SASS pipe bound of the
    digesting loop.  ``fns``: new, kept, new_digest, kept_digest,
    plain."""
    r = dict(shape=shape, n=n, input_sets=len(sets), max_abs_err=err,
             kernel="run_blocked_kernel" if "blocked" in name
             else "run_wire_kernel",
             kept_note="the kept kernel it replaced (wire_kernel / "
                       "blocked_wire_kernel, with the zero-fill and the "
                       "fold launch: ops.quantize.core_wire_launcher), "
                       "timed in turns")
    k1, n1, n2, k2 = (queued_ms(rotating(sets, f), iters=50)
                      for f in (fns["kept"], fns["new"], fns["new"],
                                fns["kept"]))
    r.update(ms=(n1 + n2) / 2, kept_ms=(k1 + k2) / 2)
    # with digests, the fold-less form between: (kept, new, fold-less,
    # fold-less, new, kept)
    k1, n1, f1, f2, n2, k2 = (
        queued_ms(rotating(sets, f), iters=50)
        for f in (fns["kept_digest"], fns["new_digest"],
                  without_fold(fns["new_digest"]),
                  without_fold(fns["new_digest"]), fns["new_digest"],
                  fns["kept_digest"]))
    r.update(ms_with_digest=(n1 + n2) / 2, kept_ms_with_digest=(k1 + k2) / 2,
             ms_no_fold=(f1 + f2) / 2)
    r["fold_ms"] = r["ms_with_digest"] - r["ms_no_fold"]
    r["digest_loop_ms"] = r["ms_no_fold"] - r["ms"]
    others = {}
    for tag, new in (("", fns["new"]), ("_with_digest", fns["new_digest"])):
        r["speedup" + tag] = r["kept_ms" + tag] / r["ms" + tag]
        read = named_device_ms(rotating(sets, new), 100, r["kernel"])
        r["profiler_ms" + tag] = read["ms"]
        others["digest" if tag else "plain"] = {
            k: read[k] for k in ("records", "other")}
    r["profiler_other_kernels"] = others
    r.update(plain_ms=device_ms(rotating(sets, fns["plain"]), iters=20),
             call_ms=time_ms(rotating(sets, fns["new"]), iters=200),
             plain_call_ms=time_ms(rotating(sets, fns["plain"]), iters=20),
             bound_ms=max(t_bytes, t_ops) * 1e3,
             bound_by="bytes" if t_bytes >= t_ops else "operations")
    r["share"] = r["bound_ms"] / r["ms"]
    r["share_with_digest"] = r["bound_ms"] / r["ms_with_digest"]
    if name in WIRE_RUN_SASS:
        per = sass_per_element("quantize", WIRE_RUN_SASS[name],
                               WIRE_RUN_ELEMENTS)
        t_pipe, pipe = pipe_bound_s(per, n)
        r.update(pipe_bound_ms=t_pipe * 1e3, bound_pipe=pipe,
                 sass_per_element={k: v for k, v in per.items()
                                   if k != "opcodes"})
    print(f"kernel {name} [{shape}, {len(sets)} input sets] streaming vs "
          f"kept (queued_ms, in turns): new {r['ms']:.5f} kept "
          f"{r['kept_ms']:.5f} ({r['speedup']:.2f}x); with digests new "
          f"{r['ms_with_digest']:.5f} kept {r['kept_ms_with_digest']:.5f} "
          f"({r['speedup_with_digest']:.2f}x), of which the digest loop "
          f"and CTA partials {r['digest_loop_ms']:.5f} and the fold (fence, "
          f"ticket, last CTA's sum) {r['fold_ms']:.5f} (fold-less form "
          f"{r['ms_no_fold']:.5f}); bound_ms "
          f"{r['bound_ms']:.6f} ({r['bound_by']}), share {r['share']:.3f} "
          f"/ with digests {r['share_with_digest']:.3f}"
          + (f"; SASS pipe bound of the digesting loop "
             f"{r['pipe_bound_ms']:.6f} ms ({r['bound_pipe']})"
             if "pipe_bound_ms" in r else "")
          + f"; torch.profiler, {r['kernel']} records only: "
          f"{fmt_ms(r['profiler_ms'])} / with digests "
          f"{fmt_ms(r['profiler_ms_with_digest'])} (records of other kernels "
          f"in the same profiles: {json.dumps(others)}); plain_ms "
          f"{r['plain_ms']:.5f}; per call with host dispatch "
          f"{r['call_ms']:.5f}, plain {r['plain_call_ms']:.5f}; library_ms "
          f"null ({NO_LIBRARY})", flush=True)
    slow = {k: r["speedup" + t] for k, t in (("plain", ""),
                                             ("digest", "_with_digest"))
            if r["speedup" + t] < WIRE_SPEEDUP_FLOOR[k]}
    if slow:
        raise AssertionError(f"{name}: the streaming kernel is only {slow}x "
                             f"faster than the kept one (floors "
                             f"{WIRE_SPEEDUP_FLOOR})")
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
    more, wire_errs = wire_parity(device, gen, sr=True, blocked=False)
    for name, e in wire_errs.items():
        errs[name] = max(errs[name], e)
    print(f"kernel quantize SR: {more} outputs of the streaming K6-SR/K5-SR "
          f"bitwise equal to their plain versions and the kept kernels (n = "
          f"{list(WIRE_SMALL_N)}, and every n on inputs and round bits 4 "
          f"bytes past a 16-byte boundary; formats {list(WIRE_FORMATS)}; "
          "with and without digests)", flush=True)

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
    }
    out = {name: time_kernel(name, fmt, chunk, sets, *fns, errs[name])
           for name, fns in calls.items()}
    core = tq.core_wire_launcher()
    wire = {
        "quantize_pack_sr": dict(
            new=lambda x, y, w, r: tq.quantize_pack_sr(x, *fmt, r),
            kept=lambda x, y, w, r: core(None, x, *fmt, rbits=r),
            new_digest=lambda x, y, w, r: tq.quantize_pack_sr(
                x, *fmt, r, want_digest=True),
            kept_digest=lambda x, y, w, r: core(None, x, *fmt, rbits=r,
                                                want_digest=True),
            plain=lambda x, y, w, r: tq.quantize_pack_ref(x, *fmt,
                                                          rbits=r)),
        "hop_pack_sr": dict(
            new=lambda x, y, w, r: tq.hop_pack_sr(w, x, *fmt, r),
            kept=lambda x, y, w, r: core(w, x, *fmt, rbits=r),
            new_digest=lambda x, y, w, r: tq.hop_pack_sr(
                w, x, *fmt, r, want_digest=True),
            kept_digest=lambda x, y, w, r: core(w, x, *fmt, rbits=r,
                                                want_digest=True),
            plain=lambda x, y, w, r: tq.hop_pack_ref(w, x, *fmt, rbits=r)),
    }
    for name, fns in wire.items():
        out[name] = wire_timing(
            name, f"{fmt}, n={chunk}", chunk, sets, fns,
            QUANT_KERNELS[name][1](wb) * chunk / PEAK_BYTES_PER_S,
            QUANT_OPS[name] * chunk / PEAK_FP32_FLOPS, errs[name])
    return out


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


def profile_phase(device, steps: int = 15, warmup: int = 10) -> dict:
    """Where an engine step's time goes: a fresh fused engine on the same
    trace, ``steps`` engine steps under torch.profiler after ``warmup``
    untraced ones.  Device busy share = summed kernel time over the
    window's wall time (one stream, so kernels do not overlap)."""
    import torch
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
    kernels = profiled_kernels(prof)
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    # K12: its split and combine kernels (serve_attn.cu)
    k12 = [e for e in kernels if any(n in e.key for n in K12_KERNEL_NAMES)]
    out = dict(
        steps=steps, wall_ms_per_step=wall_s * 1e3 / steps,
        device_busy_ms_per_step=busy_us / 1e3 / steps,
        device_busy_share=(busy_us / 1e6) / wall_s if busy_us else None,
        kernel_launches_per_step=sum(e.count for e in kernels) / steps,
        k12_ms_per_step=sum(e.self_device_time_total for e in k12) / 1e3
        / steps if k12 else None,
        k12_launches_per_step=sum(e.count for e in k12) / steps,
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
            "qgemm_faithful_sr": qg.qgemm_faithful_sr,
            "qgemm_faithful_stats": qg.qgemm_faithful_stats,
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
            "sr_bits": tq.sr_bits, "sr_bits_offsets": tq.sr_bits_offsets}


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
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(state, *batch)
        torch.cuda.synchronize()
    kernels = profiled_kernels(prof)
    if not kernels:
        print("  (torch.profiler recorded no device time for this step: its "
              "per-kernel device ms are not measured)", flush=True)
        return dict(dict.fromkeys(KERNEL_NAMES), device_busy_ms=None,
                    kernel_launches=None)
    named = {k: [e for e in kernels
                 if any(n in e.key for n in
                        ((v,) if isinstance(v, str) else v))]
             for k, v in KERNEL_NAMES.items()}
    out = {k: sum(e.self_device_time_total for e in es) / 1e3
           for k, es in named.items()}
    out["kernel_records"] = {k: sum(e.count for e in es)
                             for k, es in named.items()}
    out["device_busy_ms"] = sum(e.self_device_time_total
                                for e in kernels) / 1e3
    out["kernel_launches"] = sum(e.count for e in kernels)
    # the kept K5/K6 kernels' second launch: none on a path since the
    # streaming kernels fold their digests in the launch
    out["wire_fold_launches"] = sum(e.count for e in kernels
                                    if "fold_kernel<4>" in e.key)
    # the kept K7's second launch: none since K7 folds in its launch
    out["digest_fold_launches"] = sum(e.count for e in kernels
                                      if "fold_kernel<2>" in e.key)
    out["top_kernels"] = [
        [e.key[:70], e.count, e.self_device_time_total / 1e3]
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]]
    return out


def no_wire_fold(prof: dict, label: str, per_step: dict) -> None:
    """Every digesting K5/K6 call is one launch: a profiled step shows no
    launch of the kept kernels' fold (where the profiler recorded it).
    Also sets ``prof["wire_records_whole"]``: whether the profile holds
    exactly the K5/K6 launches the wrappers counted in a step
    (``per_step``), so that its K5/K6 device ms are those launches'."""
    if prof.get("wire_fold_launches"):
        raise AssertionError(f"{label}: {prof['wire_fold_launches']} "
                             "fold_kernel<4> launches in a step: K5/K6 took "
                             "the kept two-launch path")
    wire = {k: (prof.get("kernel_records", {}).get(k), per_step.get(k, 0))
            for k in KERNEL_NAMES
            if k.startswith(("quantize_pack", "hop_pack"))}
    prof["wire_records_whole"] = all(a == b for a, b in wire.values())
    print(f"{label}: step profile {prof.get('kernel_launches')} kernel "
          f"launches, {prof.get('wire_fold_launches')} of them the kept "
          "K5/K6 digest fold; K5/K6 records (profile, wrappers' count): "
          f"{json.dumps({k: v for k, v in wire.items() if any(v)})}, "
          f"whole: {prof['wire_records_whole']}", flush=True)


_SLICE_PIPE: list = []


def slice_batches(steps: int) -> list:
    """The training slice's first ``steps`` global batches: synthetic
    CIFAR-10, the port's sampler (seed 0) and augmentation.  The
    augmenting pipeline (~3 s to normalise and pad the set) is built once
    for every phase that asks: its batches depend on the indices and the
    seed alone."""
    from cpd_tpu_torch.data import (CIFAR10Pipeline,
                                    DistributedGivenIterationSampler,
                                    synthetic_cifar10)

    global_batch = TRAIN["world"] * TRAIN["per_rank_batch"]
    if not _SLICE_PIPE:
        train_x, train_y, _, _ = synthetic_cifar10(TRAIN["n_train"],
                                                   TRAIN["n_test"])
        _SLICE_PIPE.append(CIFAR10Pipeline(train_x, train_y, global_batch,
                                           augment=True, cutout=0))
    pipe = _SLICE_PIPE[0]
    sampler = DistributedGivenIterationSampler(len(pipe.labels), steps,
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
    no_wire_fold(prof, "train", {k: v // steps for k, v in counts.items()})
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
    res = cli.run(cli.parse_args([
        "--mode", "faithful", "--use_APS", "--grad_exp", str(fmt[0]),
        "--grad_man", str(fmt[1]), "--max-iter", str(TRAIN["cli_iters"]),
        "--save_path", save_path("train_cli")]), device=device)
    rc = 3 if res.get("diverged") else 0
    cli_counts = read_counts()
    if rc != 0 or cli_counts["quantize_add"] == 0:
        raise AssertionError(f"trainer CLI returned {rc}, launches "
                             f"{cli_counts}")
    # its batches came through the native fused augment (data.augment)
    if res["augment_fused_calls"] < TRAIN["cli_iters"]:
        raise AssertionError(f"trainer CLI: {res['augment_fused_calls']} "
                             f"batches through the native fused augment "
                             f"for {TRAIN['cli_iters']} iterations")
    out["cli"] = dict(rc=rc, seconds=now() - t0, launches=cli_counts,
                      quantize_add_per_iter=cli_counts["quantize_add"]
                      // TRAIN["cli_iters"],
                      augment_fused_calls=res["augment_fused_calls"])
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
                   str(fmt[1]), "--max-iter", str(iters), "--save_path",
                   save_path("sr_cli")])
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
    print(f"kernel blocked: {cases} outputs of K6/K5 blocked (RTNE, SR; "
          f"with and without digests) bitwise equal to their plain "
          f"versions (n = {chunk} and {QUANT_ODD_N}; formats "
          f"{list(BLOCKED_FORMATS)}; blocks {list(BLOCK_SIZES)})",
          flush=True)
    # K7 on the largest bucket's gathered wire, on odd rows, at every
    # alignment, back to back and on two streams
    fmt, block = BLOCKED["fmt"], BLOCKED["block"]
    wb = wire_bytes(*fmt)
    row_bytes = chunk * wb + sidecar_bytes(chunk, block)
    k7_cases = digest_rows_parity(device, gen, row_bytes)
    print(f"kernel digest_rows: {k7_cases} outputs of the one-launch K7 "
          f"bitwise equal to its plain version and to the kept kernel, one "
          f"launch a call (the ring's ({TRAIN['world']}, {row_bytes}), (2, "
          f"100001), (8, 333333); W {list(K7_ROWS)} x rows of "
          f"{list(K7_SIZES)} bytes, each at a 16-byte boundary and 1-15 "
          f"bytes past one; back to back; on two streams at once)",
          flush=True)
    for sr in (False, True):
        more, wire_errs = wire_parity(device, gen, sr=sr, blocked=True)
        for name, e in wire_errs.items():
            errs[name] = max(errs[name], e)
        print(f"kernel blocked: {more} outputs of the streaming blocked "
              f"K6/K5 ({'SR' if sr else 'RTNE'}) bitwise equal to their "
              f"plain versions and the kept kernels (n = "
              f"{list(WIRE_SMALL_N)}, and every n on inputs 4 bytes past a "
              f"16-byte boundary; formats {list(BLOCKED_FORMATS)}; blocks "
              f"{list(BLOCK_SIZES)}; with and without digests)", flush=True)

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
    core = tq.core_wire_launcher()
    kept = {
        "quantize_pack_blocked": lambda dig: lambda x, y, w, r: core(
            None, x, *fmt, block_size=block, want_digest=dig),
        "quantize_pack_blocked_sr": lambda dig: lambda x, y, w, r: core(
            None, x, *fmt, rbits=r, block_size=block, want_digest=dig),
        "hop_pack_blocked": lambda dig: lambda x, y, w, r: core(
            w, x, *fmt, block_size=block, want_digest=dig),
        "hop_pack_blocked_sr": lambda dig: lambda x, y, w, r: core(
            w, x, *fmt, rbits=r, block_size=block, want_digest=dig),
    }
    out = {}
    for name, (kernel, plain, digest) in calls.items():
        t_bytes = BLOCKED_KERNELS[name][1](chunk, wb, nb_chunk) \
            / PEAK_BYTES_PER_S
        t_ops = BLOCKED_KERNELS[name][2] * chunk / PEAK_FP32_FLOPS
        out[name] = wire_timing(
            name, f"{fmt} block {block}, n={chunk}", chunk, sets,
            dict(new=kernel, kept=kept[name](False), new_digest=digest,
                 kept_digest=kept[name](True), plain=plain),
            t_bytes, t_ops, errs[name])
    # K7: the gathered wire of the largest bucket, W rows
    row_sets = [(torch.randint(0, 256, (TRAIN["world"], row_bytes),
                               generator=gen, device=device,
                               dtype=torch.uint8),)
                for _ in range(-(-2 * l2_bytes()
                                 // (TRAIN["world"] * row_bytes)) + 1)]
    out["digest_rows"] = digest_rows_timing(row_sets, errs["digest_rows"])
    return out


def offset_rows(w: int, nbytes: int, base: int, generator, device):
    """(w, nbytes) random bytes whose first byte sits ``base`` bytes past
    a 16-byte boundary: a slice of a larger buffer, as the ring's gathered
    stacks are views."""
    import torch

    buf = torch.randint(0, 256, (w * nbytes + 16,), generator=generator,
                        device=device, dtype=torch.uint8)
    lead = (base - buf.data_ptr()) % 16
    rows = buf[lead:lead + w * nbytes].view(w, nbytes)
    if rows.data_ptr() % 16 != base:
        raise AssertionError(f"rows at {rows.data_ptr() % 16}, not {base}, "
                             "past a 16-byte boundary")
    return rows


def digest_rows_parity(device, generator, row_bytes: int) -> int:
    """K7 (one launch a call, int64 digests) against its plain version
    and the kept kernel, bitwise: the ring's gathered wire, odd rows, W in
    K7_ROWS x K7_SIZES at a 16-byte boundary and 1-15 bytes past one,
    launches back to back and on two streams at once.  Returns the
    outputs compared."""
    import torch

    from cpd_tpu_torch.ops import quantize as tq

    core = tq.core_digest_launcher()
    cases = [(TRAIN["world"], row_bytes, 0), (2, 100_001, 0),
             (8, 333_333, 0)]
    cases += [(w, nb, base) for w in K7_ROWS for nb in K7_SIZES
              for base in (0, 1 + (nb + w) % 15)]
    rows = [offset_rows(w, nb, base, generator, device)
            for w, nb, base in cases]
    before = tq.digest_rows.launches
    back = [tq.digest_rows(r) for r in rows]       # back to back
    if tq.digest_rows.launches - before != len(rows):
        raise AssertionError(f"{len(rows)} digest_rows calls launched "
                             f"{tq.digest_rows.launches - before} times")
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    both = []
    for r in rows[:3] * 3:
        for s in streams:
            with torch.cuda.stream(s):
                both.append((r, tq.digest_rows(r)))
    torch.cuda.synchronize()
    compared = 0
    for (w, nb, base), r, got in zip(cases, rows, back):
        want = tq.digest_rows_ref(r)
        for label, other in (("plain", want), ("kept", core(r))):
            if got.dtype != torch.int64 or not same_bits(got, other):
                raise AssertionError(f"digest_rows ({w}, {nb}) {base} bytes "
                                     f"past a 16-byte boundary: differs "
                                     f"from the {label} version")
            compared += 1
    for r, got in both:
        if not same_bits(got, tq.digest_rows_ref(r)):
            raise AssertionError(f"digest_rows {tuple(r.shape)} on two "
                                 "streams: differs from its plain version")
        compared += 1
    return compared


def digest_rows_timing(sets, err: float) -> dict:
    """K7's card numbers at the ring's gathered wire: the one-launch
    kernel by `queued_ms` in turns with the kept kernel (kept, new, new,
    kept), gated at K7_SPEEDUP_FLOOR; torch.profiler's read of its own
    kernel beside it; the plain version; per-call time with host
    dispatch; the byte bound (rows read once, int64 digests written)."""
    from cpd_tpu_torch.ops import quantize as tq

    import torch

    rows = sets[0][0]
    w, nb = rows.shape
    core = tq.core_digest_launcher()
    k1, n1, n2, k2 = (queued_ms(rotating(sets, f), iters=50)
                      for f in (core, tq.digest_rows, tq.digest_rows, core))
    # what one launch of a one-kernel torch op takes, timed the same way
    tiny = torch.zeros(16, device=rows.device)
    floor = queued_ms(lambda: tiny.fill_(1.0), iters=50)
    t_bytes = (w * nb + 8 * w) / PEAK_BYTES_PER_S
    r = dict(shape=f"({w}, {nb}) u8", input_sets=len(sets), max_abs_err=err,
             kernel="run_rows_kernel", ms=(n1 + n2) / 2,
             kept_ms=(k1 + k2) / 2,
             kept_note="the kept kernel it replaced (digest_rows_kernel, "
                       "its fold_kernel<2> launch, the partials tensor and "
                       "the int64 widening: ops.quantize."
                       "core_digest_launcher), timed in turns",
             bound_ms=t_bytes * 1e3, bound_by="bytes",
             launch_floor_ms=floor)
    r["speedup"] = r["kept_ms"] / r["ms"]
    r["share"] = r["bound_ms"] / r["ms"]
    read = named_device_ms(rotating(sets, tq.digest_rows), 100,
                           "run_rows_kernel")
    r.update(profiler_ms=read["ms"],
             profiler_other_kernels={k: read[k] for k in ("records",
                                                          "other")},
             plain_ms=device_ms(rotating(sets, tq.digest_rows_ref),
                                iters=20),
             call_ms=time_ms(rotating(sets, tq.digest_rows), iters=200),
             plain_call_ms=time_ms(rotating(sets, tq.digest_rows_ref),
                                   iters=20))
    print(f"kernel digest_rows [{r['shape']}, {len(sets)} input sets] one "
          f"launch vs kept (queued_ms, in turns): new {r['ms']:.5f} kept "
          f"{r['kept_ms']:.5f} ({r['speedup']:.2f}x); bound_ms "
          f"{r['bound_ms']:.6f} (bytes), share {r['share']:.3f}; one "
          f"launch of a one-kernel fill_ {floor:.5f}; "
          f"torch.profiler, run_rows_kernel records only: "
          f"{fmt_ms(r['profiler_ms'])} (other kernels in the profile: "
          f"{json.dumps(r['profiler_other_kernels'])}); plain_ms "
          f"{r['plain_ms']:.5f}; per call with host dispatch "
          f"{r['call_ms']:.5f}, plain {r['plain_call_ms']:.5f}; library_ms "
          f"null ({NO_LIBRARY_DIGEST})", flush=True)
    if r["speedup"] < K7_SPEEDUP_FLOOR:
        raise AssertionError(f"digest_rows: the one-launch kernel is only "
                             f"{r['speedup']:.2f}x the kept one (floor "
                             f"{K7_SPEEDUP_FLOOR}x)")
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
    no_wire_fold(prof, "train blocked",
                 {k: v // steps for k, v in counts.items()})
    k7_records = prof.get("kernel_records", {}).get("digest_rows")
    print(f"train blocked: step profile: {k7_records} K7 (run_rows_kernel) "
          f"records for {n_buckets} distinct gathered stacks, "
          f"{prof.get('digest_fold_launches')} kept K7 fold launches",
          flush=True)
    if k7_records != n_buckets or prof.get("digest_fold_launches") != 0:
        raise AssertionError(f"blocked step profile: {k7_records} K7 "
                             f"launches (design {n_buckets}) and "
                             f"{prof.get('digest_fold_launches')} "
                             "fold_kernel<2> launches (design 0)")
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
                   "--block-size", str(block), "--max-iter", str(iters),
                   "--save_path", save_path("blocked_cli")])
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


def headline_design(mode: str, w: int, leaves: int, buckets: int) -> dict:
    """The quantize launches one step of bench.py's headline arm makes
    (APS e5m2, RTNE): K1 per leaf per rank for the APS cast, then the
    faithful scan's K3 (`reduce_design`), or fast mode's one K1 over the
    rank sum."""
    want = reduce_design("faithful", False, False, w, leaves, buckets)
    if mode == "fast":
        want = dict.fromkeys(want, 0)
        want["quantize_cast"] = w * leaves + 1
    return {k: v for k, v in want.items() if v}


def cudnn_cost(model, mesh, images, labels, reps: int = 3) -> dict:
    """The forward and backward of the headline step with cuDNN's
    deterministic algorithms (the step's `fp32_numerics`) and with its
    default ones (TF32 still off, no autotuning), in turns, on the host
    clock between synchronisations: what the step's bitwise
    reproducibility costs.  The port has no switch for it."""
    import torch

    from cpd_tpu_torch.obs.timing import now
    from cpd_tpu_torch.train import as_batch, fp32_numerics, local_gradients

    x, y = as_batch(images, labels, mesh.device)
    ms = {True: [], False: []}
    for det in (True, False, False, True) * reps:
        with fp32_numerics(), torch.backends.cudnn.flags(
                enabled=True, benchmark=False, deterministic=det,
                allow_tf32=False):
            torch.cuda.synchronize()
            t0 = now()
            local_gradients(model, x, y, mesh)
            torch.cuda.synchronize()
            ms[det].append((now() - t0) * 1e3)
    out = {"fwd_bwd_ms_deterministic": min(ms[True]),
           "fwd_bwd_ms_default": min(ms[False])}
    print("train headline cudnn: " + json.dumps(out), flush=True)
    return out


def headline_phase(device) -> dict:
    """Phase 12: bench.py's headline ResNet-50 bf16 step on the card
    through `cpd_tpu_torch.bench` (faithful and fast mode, each from a
    fresh state): finite losses, step 0 within LM_LOSS_BAND of ln 1000,
    the quantize launches as designed, a non-null value; images/s, the
    split, peak memory; a profiled step of each mode (device busy ms and
    launches); at W = HEADLINE_W2 one step's gradients through the
    faithful and the fast reduce with the kernels and with the plain
    versions, bitwise; one iteration of the ResNet CLI with ``--arch
    resnet50 --mode fast --use_APS``."""
    import torch

    from cpd_tpu_torch import bench
    from cpd_tpu_torch.examples.resnet18_cifar import train as cli
    from cpd_tpu_torch.obs.timing import now
    from cpd_tpu_torch.parallel.dist import sum_gradients
    from cpd_tpu_torch.parallel.mesh import data_parallel_mesh
    from cpd_tpu_torch.parallel.overlap import (DEFAULT_BUCKET_ELEMS,
                                                bucket_layout)
    from cpd_tpu_torch.train import as_batch, fp32_numerics, local_gradients

    marks = [now()]
    reset_counts()
    out = bench.run(device)
    out["launches"] = {k: v for k, v in read_counts().items() if v}
    marks.append(now())
    if not (out["launches"].get("quantize_cast")
            and out["launches"].get("quantize_add")):
        raise AssertionError(f"the headline run launched "
                             f"{out['launches']}: K1 and K3 must run")
    mesh = data_parallel_mesh(bench.WORLD, device)
    model = bench.headline_step("faithful", mesh)[0]
    sizes = [p.numel() for p in model.parameters()]
    n_buckets = len(bucket_layout(sizes, DEFAULT_BUCKET_ELEMS))
    if out["value"] is None or out["fast"] is None:
        raise AssertionError(f"bench value {out['value']}, fast "
                             f"{out['fast']}")
    x, y = bench.headline_batches(bench.WORLD, bench.BATCH,
                                  bench.IMAGE_SIZE, device, fuse=1)
    for mode, r in out["modes"].items():
        losses = r["losses"]
        if not all(math.isfinite(v) for v in losses) or not (
                abs(losses[0] - math.log(HEADLINE_CLASSES))
                <= LM_LOSS_BAND):
            raise AssertionError(f"headline {mode} losses {losses}: not "
                                 f"finite, or step 0 not within "
                                 f"{LM_LOSS_BAND} of ln {HEADLINE_CLASSES}")
        want = headline_design(mode, bench.WORLD, len(sizes),
                               n_buckets)
        if r["launches_per_step"] != want:
            raise AssertionError(f"headline {mode} launches per step "
                                 f"{r['launches_per_step']} != the "
                                 f"design's {want}")
        _, _, state, step = bench.headline_step(mode, mesh)
        step(state, x[0], y[0])
        prof = step_profile(step, state, (x[0], y[0]))
        r["profile"] = {k: prof.get(k) for k in (
            "device_busy_ms", "kernel_launches", "quantize_cast",
            "quantize_add", "top_kernels")}
        del state, step
    out["cudnn_deterministic_cost"] = cudnn_cost(model, mesh, x[0], y[0])
    print(f"card: {out['device']['card']}", flush=True)
    print("train headline: " + json.dumps(out), flush=True)
    print(f"train headline: ResNet-50 bf16 APS e5m2, W={bench.WORLD} x "
          f"{bench.BATCH} at {bench.IMAGE_SIZE}^2: faithful "
          f"{out['value']:.2f} img/s, fast {out['fast']:.2f} img/s; split "
          + json.dumps({m: {k: r[k] for k in ("step_ms", "fwd_bwd_ms",
                                              "reduce_ms", "update_ms",
                                              "peak_memory_gib")}
                        for m, r in out["modes"].items()}), flush=True)

    # W = 2: one step's gradients, kernels vs plain versions, bitwise
    mesh2 = data_parallel_mesh(HEADLINE_W2, device)
    model2 = bench.headline_step("faithful", mesh2)[0]
    x2, y2 = bench.headline_batches(HEADLINE_W2, bench.BATCH,
                                    bench.IMAGE_SIZE, device, fuse=1)
    xb, yb = as_batch(x2[0], y2[0], device)
    w2 = {}
    with fp32_numerics():
        grads = local_gradients(model2, xb, yb, mesh2)[0]
        for mode in ("faithful", "fast"):
            kw = dict(use_aps=True, grad_exp=bench.FMT[0],
                      grad_man=bench.FMT[1], mode=mode)
            reset_counts()
            got = sum_gradients(grads, mesh2, **kw)
            counts = {k: v for k, v in read_counts().items() if v}
            want = sum_gradients(grads, mesh2, fused=False, **kw)
            torch.cuda.synchronize()
            design = headline_design(mode, HEADLINE_W2, len(sizes),
                                     n_buckets)
            if counts != design:
                raise AssertionError(f"W={HEADLINE_W2} {mode} reduce "
                                     f"launches {counts} != {design}")
            for r in range(HEADLINE_W2):
                for i, (a, b) in enumerate(zip(got[r], want[r])):
                    if not same_bits(a, b):
                        raise AssertionError(
                            f"W={HEADLINE_W2} {mode} reduce, rank {r} leaf "
                            f"{i}: the kernels differ from the plain "
                            "versions")
            w2[mode] = counts
    print(f"train headline W={HEADLINE_W2}: one step's ResNet-50 bf16 "
          f"gradients through the APS e5m2 faithful and fast reduce: "
          f"kernels bitwise equal to the plain versions; launches "
          f"{json.dumps(w2)}", flush=True)
    del model2, grads, got, want
    marks.append(now())

    reset_counts()
    t0 = now()
    rc = cli.main(["--arch", "resnet50", "--mode", "fast", "--use_APS",
                   "--grad_exp", str(bench.FMT[0]), "--grad_man",
                   str(bench.FMT[1]), "--max-iter", "1", "--batch_size",
                   str(HEADLINE_CLI_BATCH), "--save_path",
                   save_path("headline_cli")])
    cli_counts = {k: v for k, v in read_counts().items() if v}
    design = headline_design("fast", 1, len(sizes), n_buckets)
    if rc != 0 or cli_counts != design:
        raise AssertionError(f"ResNet-50 fast CLI returned {rc}, launches "
                             f"{cli_counts} (design {design})")
    out["cli"] = dict(rc=rc, seconds=now() - t0, launches=cli_counts)
    print("train headline cli: " + json.dumps(out["cli"]), flush=True)
    marks.append(now())
    out["seconds"] = dict(zip(("bench", "w2", "cli"),
                              (b - a for a, b in zip(marks, marks[1:]))))
    out["n_buckets"] = n_buckets
    return out


def quant_sgd_design(leaves: int, sr: bool, kahan: bool) -> dict:
    """The launches one `quant_sgd` update makes: per leaf a cast of
    ``momentum * buf`` (K1, or a flat `sr_bits` + K2) and one add-cast
    (K3, or `sr_bits` + K4); with Kahan two casts and four add-casts."""
    casts, adds = (2, 4) if kahan else (1, 1)
    if sr:
        return {"quantize_cast_sr": casts * leaves,
                "quantize_add_sr": adds * leaves,
                "sr_bits": (casts + adds) * leaves}
    return {"quantize_cast": casts * leaves, "quantize_add": adds * leaves}


def emulate_design(n: int, sr: bool, sizes: list) -> dict:
    """The kernel launches one rank's `emulate_node_reduce` makes over
    leaves of ``sizes`` elements at N = ``n`` (none at N = 1): RTNE one
    K1 and N K3 a bucket of whole leaves; SR one flat `sr_bits` and one
    K2 a leaf, and N `sr_bits` + K4 a leaf for the sum."""
    from cpd_tpu_torch.parallel.overlap import (DEFAULT_BUCKET_ELEMS,
                                                bucket_layout)

    if n == 1 or not sizes:
        return {}
    if sr:
        leaves = len(sizes)
        return {"sr_bits": (n + 1) * leaves, "quantize_cast_sr": leaves,
                "quantize_add_sr": n * leaves}
    buckets = len(bucket_layout(list(sizes), DEFAULT_BUCKET_ELEMS))
    return {"quantize_cast": buckets, "quantize_add": n * buckets}


def emulate_step_design(arm: dict, w: int, n: int, sizes: list,
                        buckets: int) -> dict:
    """The kernel launches one phase-13 step makes: every rank's
    emulate-node reduce (`emulate_design`), the APS reduce
    (`reduce_design`; its health counters observe the APS cast and add
    none), and the optimizer (`quant_sgd_design`; LARS casts nothing)."""
    sr = arm["grad_rounding"] == "stochastic"
    want = reduce_design(arm["mode"], sr, False, w, len(sizes), buckets)
    for k, v in emulate_design(n, sr, sizes).items():
        want[k] += w * v
    if arm["optimizer"] == "quant_sgd":
        kw = arm["opt_kw"]
        for k, v in quant_sgd_design(
                len(sizes), kw.get("opt_rounding") == "stochastic",
                kw.get("opt_kahan", False)).items():
            want[k] += v
    return want


def emu_build(device, arm: dict, mesh, fused):
    """The seed-24 ResNet-18/CIFAR, the arm's optimizer (momentum 0.9,
    wd 1e-4, the CLI's warmup schedule at 512 images a step) and its
    `make_train_step` (APS e5m2, ``quant_stats``)."""
    import torch

    from cpd_tpu_torch.models.resnet_cifar import resnet18_cifar
    from cpd_tpu_torch.train import (create_train_state, make_optimizer,
                                     make_train_step, warmup_step_decay)

    gen = torch.Generator(device=device).manual_seed(EMU["seed"])
    model = resnet18_cifar(device=device).init_weights(gen)
    rows = EMU["world"] * EMU["emulate_node"] * EMU["micro_batch"]
    ipe = math.ceil(TRAIN["n_train"] / rows)
    peak = TRAIN["peak_lr"]
    opt = make_optimizer(arm["optimizer"], warmup_step_decay(
        peak, 5 * ipe, [40 * ipe, 80 * ipe], warmup_from=peak / 16.0),
        momentum=0.9, weight_decay=1e-4, **arm["opt_kw"])
    state = create_train_state(model, opt)
    step = make_train_step(
        model, opt, mesh, emulate_node=EMU["emulate_node"],
        mode=arm["mode"], use_aps=True, grad_exp=EMU["fmt"][0],
        grad_man=EMU["fmt"][1], grad_rounding=arm["grad_rounding"],
        grad_seed=EMU["grad_seed"], quant_stats=True, fused=fused)
    return model, opt, state, step


def opt_tensors(opt_state) -> list:
    """Every tensor of an optimizer state (buffers, Kahan residuals)."""
    out = []
    for v in opt_state:
        if isinstance(v, list):
            out += v
    return out


def flat_bits_check(device) -> dict:
    """The flat-index arm of the `sr_bits` kernel (``flat_bits_kernel``:
    ``jax.random.bits(key, shape)``'s bits, which the emulate cast and
    `quant_sgd` draw) against its plain version at the emulate cast's
    shapes, bitwise, and timed beside its bound."""
    import torch

    from cpd_tpu_torch.ops import quantize as tq

    err = 0.0
    for n in FLAT_BITS_N:
        like = torch.empty(n, device=device)
        for key in ((3, 17), (2**32 - 5, 9)):
            got = tq.sr_bits(key, like, flat=True)
            want = tq.sr_bits_ref(key, like, flat=True)
            if not same_bits(got, want):
                raise AssertionError(f"flat sr_bits n={n}: differs from its "
                                     "plain version")
            err = max(err, max_abs_diff(got, want))
    n = FLAT_BITS_N[0]
    like = torch.empty(n, device=device)
    per = sass_per_element("quantize", "flat_bits_kernel")
    t_ops, pipe = pipe_bound_s(per, n)
    t_bytes = 4 * n / PEAK_BYTES_PER_S
    out = dict(n=n, max_abs_err=err,
               ms=device_ms(lambda: tq.sr_bits((3, 17), like, flat=True),
                            iters=50),
               plain_ms=device_ms(lambda: tq.sr_bits_ref((3, 17), like,
                                                         flat=True),
                                  iters=5),
               bound_ms=max(t_ops, t_bytes) * 1e3,
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               bound_pipe=pipe, sass_per_element=per)
    print("kernel sr_bits flat arm: bitwise its plain version at n = "
          f"{list(FLAT_BITS_N)}; " + json.dumps(out), flush=True)
    return out


def emulate_arm(device, name: str, batches, mesh) -> dict:
    """13a for one arm: the 3 steps through the kernels (losses, launches
    against the design, images/s), one step from the same start through
    the plain versions (bitwise), stats on/off bitwise on one step's
    reduce, the split of a step and a profiled step."""
    import torch

    from cpd_tpu_torch.obs.timing import now
    from cpd_tpu_torch.parallel.dist import grad_sr_key, sum_gradients
    from cpd_tpu_torch.parallel.emulate import emulate_node_reduce
    from cpd_tpu_torch.parallel.overlap import (DEFAULT_BUCKET_ELEMS,
                                                bucket_layout)
    from cpd_tpu_torch.quant.prng import fold_in
    from cpd_tpu_torch.train import as_batch, fp32_numerics, local_gradients

    arm = EMU_ARMS[name]
    w, n, fmt = EMU["world"], EMU["emulate_node"], EMU["fmt"]
    sr = arm["grad_rounding"] == "stochastic"
    reset_counts()
    model, opt, state, step = emu_build(device, arm, mesh, None)
    sizes = [p.numel() for p in model.parameters()]
    n_buckets = len(bucket_layout(sizes, DEFAULT_BUCKET_ELEMS))
    losses, secs, metrics, after_one = [], [], [], None
    for i, (bx, by) in enumerate(batches):
        torch.cuda.synchronize()
        t0 = now()
        state, m = step(state, bx, by)
        torch.cuda.synchronize()
        secs.append(now() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
        losses.append(metrics[-1]["loss"])
        if i == 0:
            after_one = ([t.clone() for t in model.state_dict().values()]
                         + [t.clone() for t in opt_tensors(state.opt_state)])
    counts = read_counts()
    design = {k: len(batches) * v for k, v in emulate_step_design(
        arm, w, n, sizes, n_buckets).items()}
    if counts != design:
        raise AssertionError(f"emulate arm {name}: launches {counts} != the "
                             f"design's {design}")
    if not all(math.isfinite(v) for v in losses) or not (
            abs(losses[0] - math.log(10)) <= LM_LOSS_BAND):
        raise AssertionError(f"emulate arm {name}: losses {losses} not "
                             f"finite, or step 0 not within {LM_LOSS_BAND} "
                             "of ln 10")
    total = w * sum(sizes)
    for i, m in enumerate(metrics):
        if m["prec_wire_total"] != total or m["prec_aps_bad"] != 0:
            raise AssertionError(f"emulate arm {name} step {i}: "
                                 f"prec_wire_total {m['prec_wire_total']} "
                                 f"(design W x parameters = {total}), "
                                 f"prec_aps_bad {m['prec_aps_bad']}")

    # one step from the same start through the plain versions
    plain_model, _, plain_state, plain_step = emu_build(device, arm, mesh,
                                                        False)
    torch.cuda.synchronize()
    t0 = now()
    plain_state, _ = plain_step(plain_state, *batches[0])
    torch.cuda.synchronize()
    plain_s = now() - t0
    plain = (list(plain_model.state_dict().values())
             + opt_tensors(plain_state.opt_state))
    if len(plain) != len(after_one):
        raise AssertionError(f"emulate arm {name}: state sizes differ")
    for i, (a, b) in enumerate(zip(after_one, plain)):
        if not same_bits(a, b):
            raise AssertionError(f"emulate arm {name}: state tensor {i} "
                                 "after one step differs between the "
                                 "kernels and the plain versions")
    del plain_model, plain_state, plain_step, plain, after_one

    # one step's reduce with stats on and off, and the step's split
    x, y = as_batch(*batches[0], device)
    kw = dict(use_aps=True, grad_exp=fmt[0], grad_man=fmt[1],
              mode=arm["mode"], rounding=arm["grad_rounding"],
              key=grad_sr_key(EMU["grad_seed"], state.step, 1) if sr
              else None)
    emu_key = grad_sr_key(EMU["grad_seed"], state.step, 0)
    marks = []
    with fp32_numerics():
        torch.cuda.synchronize()
        marks.append(now())
        grads = local_gradients(model, x, y, mesh, n)[0]
        torch.cuda.synchronize()
        marks.append(now())
        local = [emulate_node_reduce(
            g, n, True, fmt[0], fmt[1], key=fold_in(emu_key, r) if sr
            else None, rounding=arm["grad_rounding"])
            for g, r in zip(grads, mesh.ranks)]
        del grads
        torch.cuda.synchronize()
        marks.append(now())
        red_on, report = sum_gradients(local, mesh, stats=True, **kw)
        torch.cuda.synchronize()
        marks.append(now())
        red_off = sum_gradients(local, mesh, **kw)
        for i, (a, b) in enumerate(zip(red_on[0], red_off[0])):
            if not same_bits(a, b):
                raise AssertionError(f"emulate arm {name} leaf {i}: the "
                                     "reduce differs with stats on and off")
        if float(report["wire_total"]) != total:
            raise AssertionError(f"emulate arm {name}: wire_total "
                                 f"{float(report['wire_total'])} != {total}")
        torch.cuda.synchronize()
        marks.append(now())
        opt.apply(red_on[0], state.opt_state, state.params)
        torch.cuda.synchronize()
        marks.append(now())
    del local, red_on, red_off
    split = dict(zip(("fwd_bwd_ms", "emulate_ms", "reduce_ms"),
                     ((b - a) * 1e3 for a, b in zip(marks, marks[1:4]))))
    split["update_ms"] = (marks[5] - marks[4]) * 1e3
    prof = step_profile(step, state, batches[0])
    rows = w * n * EMU["micro_batch"]
    timed = secs[1:]
    out = dict(
        arm=name, mode=arm["mode"], grad_rounding=arm["grad_rounding"],
        optimizer=arm["optimizer"], opt_kw=arm["opt_kw"], world=w,
        emulate_node=n, micro_batch=EMU["micro_batch"], global_batch=rows,
        steps=len(batches), losses=losses,
        step_ms=sum(timed) / len(timed) * 1e3,
        images_per_s=rows / (sum(timed) / len(timed)),
        plain_step_ms=plain_s * 1e3, n_leaves=len(sizes),
        n_buckets=n_buckets, launches=counts,
        launches_per_step={k: v // len(batches) for k, v in counts.items()
                           if v},
        health={k: v for k, v in metrics[-1].items()
                if k.startswith("prec_")},
        **split,
        profile={k: prof.get(k) for k in ("device_busy_ms",
                                          "kernel_launches",
                                          "top_kernels")})
    print(f"train emulate {name}: " + json.dumps(out), flush=True)
    print(f"train emulate {name}: {arm['mode']} {arm['grad_rounding']} "
          f"{arm['optimizer']}, W={w} x emulate_node {n} x {EMU['micro_batch']}"
          f": one step kernels == plain versions bitwise (weights, buffers, "
          "BN stats), launches per step as designed, stats on/off bitwise, "
          f"wire_total {total}; {out['images_per_s']:.1f} images/s",
          flush=True)
    return out


def emulate_phase(device) -> dict:
    """Phase 13: the flagship step's other arms (`emulate_node`, LARS,
    `quant_sgd`, the reduce's health telemetry): (a) the library step at
    full width, both arms; (b) the CLI with ``--emulate_node 8`` and
    LARS, then the e4m3 Kahan buffer; (c) the golden APS ordering."""
    import torch

    from cpd_tpu_torch.examples import aps_golden
    from cpd_tpu_torch.examples.resnet18_cifar import train as cli
    from cpd_tpu_torch.obs.timing import now
    from cpd_tpu_torch.parallel.mesh import data_parallel_mesh

    marks = [now()]
    flat = flat_bits_check(device)
    rows = EMU["world"] * EMU["emulate_node"] * EMU["micro_batch"]
    if rows != TRAIN["world"] * TRAIN["per_rank_batch"]:
        raise AssertionError("phase 13 reuses the slice's 512-image batches")
    batches = slice_batches(EMU["steps"])
    mesh = data_parallel_mesh(EMU["world"], device)
    arms = {name: emulate_arm(device, name, batches, mesh)
            for name in EMU_ARMS}
    marks.append(now())

    cli_runs = []
    for extra in EMU_CLI_ARMS:
        reset_counts()
        t0 = now()
        res = cli.run(cli.parse_args(EMU_CLI + extra + [
            "--save_path", save_path("emulate_cli")]), device=device)
        run = dict(flags=extra, seconds=now() - t0, loss=res["loss"],
                   best_prec1=res["best_prec1"],
                   launches={k: v for k, v in read_counts().items() if v})
        if (res["diverged"] or res["step"] != 3
                or not math.isfinite(res["loss"]) or not run["launches"]):
            raise AssertionError(f"CLI {EMU_CLI + extra}: {res}")
        cli_runs.append(run)
        print("train emulate cli: " + json.dumps(run), flush=True)
    marks.append(now())

    reset_counts()
    golden = aps_golden.run_experiment(
        iters=GOLDEN["iters"], batch_size=GOLDEN["batch_size"],
        configs=GOLDEN_CONFIGS, device=device)
    noaps = golden["e3m4_noaps"]["prec1"]
    aps = golden["e3m4_aps"]["prec1"]
    golden_launches = {k: v for k, v in read_counts().items() if v}
    print(f"golden: e3m4 on the tiny CNN, W={aps_golden.WORLD} x "
          f"emulate_node 2 x {GOLDEN['batch_size']}, {GOLDEN['iters']} "
          f"iterations, fast mode: no-APS Prec@1 {noaps:.2f}, APS Prec@1 "
          f"{aps:.2f}; launches {json.dumps(golden_launches)}", flush=True)
    if not (aps >= noaps + GOLDEN["margin"] and aps >= GOLDEN["floor"]):
        raise AssertionError(f"golden ordering: APS {aps} must reach no-APS "
                             f"{noaps} + {GOLDEN['margin']} and "
                             f"{GOLDEN['floor']}")
    marks.append(now())
    torch.cuda.synchronize()
    seconds = dict(zip(("library_step", "cli", "golden"),
                       (b - a for a, b in zip(marks, marks[1:]))))
    print("train emulate seconds: " + json.dumps(seconds), flush=True)
    return dict(flat_bits=flat, arms=arms, cli=cli_runs,
                golden=dict(noaps=noaps, aps=aps, launches=golden_launches,
                            **{k: golden[k] for k in golden}),
                seconds=seconds)


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


def replay_steps(feed, step, n: int, device) -> None:
    """``feed(k); step()`` for k < ``n``: a scan whose state lives in
    tensors that ``step`` updates in place and whose step-k inputs
    ``feed(k)`` copies into fixed tensors.  On a card step 0 runs as it
    is and the step is then captured once as a CUDA graph and replayed:
    the same kernels on the same data, without the host launching each
    of a step's hundreds of small ops again.  Elsewhere every step runs
    as it is."""
    import torch

    feed(0)
    step()
    if n <= 1:
        return
    if torch.device(device).type != "cuda":
        for k in range(1, n):
            feed(k)
            step()
        return
    graph = torch.cuda.CUDAGraph()
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        step()
    for k in range(1, n):
        feed(k)
        graph.replay()
    torch.cuda.synchronize()
    del graph


def graphed_scan(a, b, exp_bits: int, man_bits: int, key=None,
                 stats: bool = False):
    """`qgemm_faithful_ref` (RTNE, with ``key`` SR, with ``stats`` its
    counts) with its Kahan step replayed (`replay_steps`): the plain
    scan's torch ops, op for op; the SR bits of a step drawn for its
    five sites at once (the plain scan draws them for several steps at
    once; the bits are the same integers).  Held bitwise to
    `qgemm_faithful_ref` by `graphed_scan_check`."""
    import torch

    from cpd_tpu_torch.ops import qgemm as qg
    from cpd_tpu_torch.quant import prng
    from cpd_tpu_torch.quant.numerics import cast_body, cast_body_sr

    a = a.to(torch.float32)
    b = b.to(torch.float32)
    m, kdim, n = a.shape[0], a.shape[1], b.shape[1]
    dev = a.device
    s = torch.zeros((m, n), dtype=torch.float32, device=dev)
    c = torch.zeros_like(s)
    counts = torch.zeros(3, dtype=torch.int64, device=dev)
    a_cols = a.t().contiguous()
    ak = torch.empty((m, 1), dtype=torch.float32, device=dev)
    bk = torch.empty((1, n), dtype=torch.float32, device=dev)
    table = None if key is None else qg.site_keys(key, kdim, dev)
    kk = torch.empty((qg.SITES, 2), dtype=torch.int64, device=dev)
    flat = torch.arange(m * n, dtype=torch.int64, device=dev)

    def feed(k):
        ak.copy_(a_cols[k, :, None])
        bk.copy_(b[k:k + 1])
        if table is not None:
            kk.copy_(table[k])

    def step():
        bits = None
        if table is not None:
            x0, x1 = prng.threefry2x32(kk[:, 0, None], kk[:, 1, None], 0,
                                       flat)
            bits = x0 ^ x1

        def q(t, i):
            out = (cast_body(t, exp_bits, man_bits) if bits is None
                   else cast_body_sr(t, exp_bits, man_bits, bits[i]))
            if stats:
                counts.add_(qg._tally(t, out))
            return out

        tmp = q(ak * bk, 0)
        y = q(tmp - c, 1)
        t = q(s + y, 2)
        c_new = q(q(t - s, 3) - y, 4)
        c.copy_(c_new)
        s.copy_(t)

    if kdim:
        replay_steps(feed, step, kdim, dev)
    if not stats:
        return s
    total = torch.full((1,), qg.SITES * kdim * m * n, dtype=torch.int64,
                       device=dev)
    return s, torch.cat([counts, total])


def graphed_scan_check(device) -> int:
    """`graphed_scan` bitwise `qgemm_faithful_ref` (products and counts)
    for RTNE, SR and both with stats, at formats and shapes past the
    kernel's tile and chunk; the number of cases."""
    import torch

    from cpd_tpu_torch.ops import qgemm as qg

    gen = torch.Generator(device=device).manual_seed(7)
    cases = 0
    for fmt in ((4, 3), (5, 2), (8, 23)):
        for m, k, n in ((37, 29, 23), (70, 65, 33)):
            a = torch.randn((m, k), generator=gen, device=device) * 8
            b = torch.randn((k, n), generator=gen, device=device)
            a[0] *= 1e4
            for kw in (dict(), dict(key=(5, 9)), dict(stats=True),
                       dict(key=(5, 9), stats=True)):
                got = graphed_scan(a, b, *fmt, **kw)
                want = qg.qgemm_faithful_ref(a, b, *fmt, **kw)
                if kw.get("stats"):
                    ok = same_bits(got[0], want[0]) and torch.equal(got[1],
                                                                    want[1])
                else:
                    ok = same_bits(got, want)
                if not ok:
                    raise AssertionError(f"graphed_scan {fmt} {m}x{k}x{n} "
                                         f"{kw}: differs from "
                                         "qgemm_faithful_ref")
                cases += 1
    return cases


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
    # the scan's state and step-k inputs in fixed tensors (`replay_steps`)
    zeros = torch.zeros((n_p, 32), dtype=torch.bool, device=dev)
    flags = torch.zeros_like(zeros)
    bnd = torch.zeros_like(zeros)
    on = torch.zeros(n_p, dtype=torch.bool, device=dev)
    restart = torch.zeros((), dtype=torch.bool, device=dev)
    ak = torch.empty((n_p, 64, 1), device=dev)
    bk = torch.empty((n_p, 1, 64), device=dev)
    a_k = a_all.permute(2, 0, 1).contiguous()
    b_k = b_all.permute(1, 0, 2).contiguous()
    starts = torch.arange(kmax, device=dev) % 32 == 0
    bounds = bound.permute(2, 0, 1).contiguous()

    def feed(k):
        ak.copy_(a_k[k, :, :, None])
        bk.copy_(b_k[k, :, None, :])
        bnd.copy_(bounds[k])
        on.copy_(live[k])
        restart.copy_(starts[k])

    def step():
        # at a chunk's first step: is every s and c of the warp ±0
        zeros.copy_(torch.where(restart, warps((
            (s.view(torch.int32) | c.view(torch.int32)) & 0x7FFFFFFF)
            == 0).all(-1), zeros))
        casting = ~(zeros & bnd)
        zeros.logical_and_(~casting)
        flags.zero_()
        tmp = q(ak * bk, flags, on, product=True)
        y = q(tmp - c, flags, on)
        t = q(s + y, flags, on)
        c.copy_(q(q(t - s, flags, on) - y, flags, on))
        s.copy_(t)
        casts.add_(casting.sum(-1) * on)
        falls.add_((flags & casting).sum(-1) * on)

    replay_steps(feed, step, kmax, dev)
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


def qgemm_build() -> dict:
    """Each kernel of ``qgemm.cu``'s build by its mangled name: registers
    and spill bytes, as ptxas printed them."""
    from cpd_tpu_torch.ops.build import build_log

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
    return build


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

    gen = torch.Generator(device=device).manual_seed(96)
    fmt = LM_PATH["ffn_exp"], LM_PATH["ffn_man"]
    checks = [(f, [(37, 29, 23), (300, 129, 200), (70, 65, 33)])
              for f in QGEMM_FORMATS]
    checks.append((fmt, lm_gemm_shapes()))
    t0 = time.perf_counter()
    graphed = graphed_scan_check(device)
    cases = 0
    for f, shapes in checks:
        for name, a, b in qgemm_cases(f, shapes, gen, device):
            got = qg.qgemm_faithful(a, b, *f)
            torch.cuda.synchronize()
            want = graphed_scan(a, b, *f)
            if not same_bits(got, want):
                raise AssertionError(f"qgemm {f} {name}: the kernel "
                                     "differs from its plain version")
            cases += 1
    split = {"plain checks": time.perf_counter() - t0}
    print(f"kernel qgemm: {cases} products bitwise equal to the plain "
          f"scan (formats {list(QGEMM_FORMATS)} at odd shapes; {fmt} at "
          f"the slice's GEMMs {lm_gemm_shapes()}; saturating, subnormal "
          f"and carrying rows), the plain scan's step replayed as a CUDA "
          f"graph (bitwise the eager scan in {graphed} cases) in "
          f"{split['plain checks']:.1f} s", flush=True)
    t0 = time.perf_counter()
    probe = cast_probe(device)
    split["cast probe"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    build = qgemm_build()
    # the round-to-nearest arm's two instantiations (phase 18 reads the
    # SR and stats arms')
    tile = {k: v for k, v in build.items() if "qgemm_tile_kernel" in k
            and "SrCast" not in k and "Counted" not in k}
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
    split["timed turns"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    census = step_census(samples, *fmt)
    census_s = split["census"] = time.perf_counter() - t0
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
    small = QGEMM_PLAIN_SHAPE
    a = torch.randn(small[:2], generator=gen, device=device)
    b = torch.randn(small[1:], generator=gen, device=device)
    out = dict(cases=cases, probe=probe, build=tile, shapes=shapes,
               split_s=split, sass_loop_body=whole, sass_paths=paths,
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
        # the kept kernel one call a turn (the parity call warmed it),
        # the tile kernel two
        t1, k1, k2, t2 = (time_ms(lambda f=f: f(a, b, *fmt), iters=n,
                                  warmup=n - 1)
                          for f, n in ((generic, 1), (qg.qgemm_faithful, 2),
                                       (qg.qgemm_faithful, 2),
                                       (generic, 1)))
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


def lm_small_vs_plain(device) -> dict:
    """10e: a small faithful LM, ``LM_SMALL_TRAIN["steps"]`` steps through
    every kernel and through every plain version: the losses within
    ``LM_SMALL_LOSS_RTOL``, each leaf's update within
    ``LM_SMALL_UPDATE_SHARE`` of the plain update's norm, and the FFN's
    GEMMs on the run's own inputs bitwise."""
    import torch

    from cpd_tpu_torch.ops import qgemm as qg
    from cpd_tpu_torch.train import sgd

    sw = LM_SMALL_TRAIN["world"]
    s_batches = lm_batches(LM_SMALL["vocab_size"], LM_SMALL_TRAIN["steps"],
                           sw * LM_SMALL_TRAIN["per_rank_batch"],
                           LM_SMALL_TRAIN["seq"], 1)
    small, moved = [], []
    for plain in (False, True):
        m = lm_model(device, 2, LM_SMALL, **LM_PATH)
        start = [p.detach().clone() for p in m.parameters()]
        with contextlib.ExitStack() as stack:
            if plain:
                stack.enter_context(plain_kernels())
            _, _, met = lm_train(device, m, s_batches, sw,
                                 opt=sgd(lambda s: 0.01, momentum=0.9),
                                 fused=False if plain else None)
        small.append([x["loss"] for x in met])
        moved.append([p.detach() - p0 for p, p0 in zip(m.parameters(),
                                                       start)])
    for a, b in zip(*small):
        if abs(a - b) > LM_SMALL_LOSS_RTOL * abs(b):
            raise AssertionError(f"small faithful LM: losses {small[0]} "
                                 f"(kernels) vs {small[1]} (plain)")
    update_share = max(
        float((a - b).norm() / b.norm().clamp_min(1e-30))
        for a, b in zip(*moved))
    if not update_share <= LM_SMALL_UPDATE_SHARE:
        raise AssertionError(f"small faithful LM: an update through the "
                             f"kernels is {update_share} of the plain one's "
                             f"norm away from it")
    del moved
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
    print(f"train lm small: {LM_SMALL_TRAIN['steps']} faithful e4m3 steps "
          f"at W={sw} through K8/K9/K10 and the kernels of the reduce vs all "
          f"plain versions: losses {small[0]} vs {small[1]} (rtol "
          f"{LM_SMALL_LOSS_RTOL}), updates within {update_share:.3g} of "
          f"their norm (gate {LM_SMALL_UPDATE_SHARE:.3g}); the FFN's "
          "forward, grad_x and grad_W "
          "GEMMs on the run's own inputs bitwise", flush=True)
    return dict(losses_kernels=small[0], losses_plain=small[1],
                update_share=update_share)


def lm_phase(device) -> dict:
    """Phase 10c-f: the LM slice end to end at full width through K8, K9
    and K10 (and a fast-FFN step), kernels vs plain versions at full
    width without K8 and on a small model with it, then the trainer
    CLI."""
    import torch

    from cpd_tpu_torch.examples.lm import train as cli
    from cpd_tpu_torch.obs.timing import now
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
    out["small_vs_plain"] = lm_small_vs_plain(device)

    # (f) the trainer CLI
    marks.append(now())
    iters = LM_TRAIN["cli_iters"]
    argv = ["--vocab-size", str(vocab), "--d-model",
            str(LM_MODEL["d_model"]), "--n-layers", str(layers),
            "--n-heads", str(LM_MODEL["n_heads"]), "--n-kv-heads",
            str(LM_MODEL["n_kv_heads"]), "--seq-len", str(seq),
            "--batch-size", str(LM_TRAIN["per_rank_batch"]), "--dp", str(w),
            "--attn-impl", "flash", "--flash-bwd", "pallas", "--ffn-exp",
            str(LM_PATH["ffn_exp"]), "--ffn-man", str(LM_PATH["ffn_man"]),
            "--ffn-mode", "faithful",
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
    plain versions over the cases, each launched twice and bitwise equal,
    K9-K11 at `NEW_HEAD_DIMS` too; the build's registers, spills and
    shared memory; then K11 timed at the bf16 LM's shape (bf16 and fp32)
    and at head_dim 128 in turns with the CUDA-core template it replaces,
    and at head_dim 256 (the template itself), beside its plain version,
    its bound and SDPA."""
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
    # head dims the kernels are not built for (zero-padded to the next)
    # and 256 (flash_gqa.cu's templates), both dtypes, causal and not
    for d in NEW_HEAD_DIMS:
        mha += [((2, 256, 256, 4, 4, d), dt, c) for dt in (f32, b16)
                for c in (True, False)]
        gqa += [((2, 200, 256, 8, 2, d), dt, c) for dt in (f32, b16)
                for c in (True, False)]
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
                      ((b0, t0, t0, 4, 4, 128), b16),
                      ((b0, t0, t0, 4, 4, 256), b16),
                      ((b0, t0, t0, 4, 4, 256), f32)):
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
            # turns with it: template, kernel, kernel, template; at D =
            # 256 the template is the kernel
            if d in fl.TC_HEAD_DIMS:
                t1, k1, k2, t2 = (queued_ms(f, iters=20)
                                  for f in (template, fn, fn, template))
                ms, core = (k1 + k2) / 2, (t1 + t2) / 2
                source = ("cpd_tpu_torch/csrc/flash_mha_tc.cu" if dt == b16
                          else "cpd_tpu_torch/csrc/flash_f32_tc.cu")
            else:
                ms = core = queued_ms(fn, iters=20)
                source = "cpd_tpu_torch/csrc/flash_gqa.cu"
            r = dict(ms=ms, call_ms=time_ms(fn, iters=20),
                     plain_ms=time_ms(plain, iters=3),
                     library_ms=queued_ms(lib, iters=20), **bounds,
                     rate=rate, gflop=flops / 1e9, shape=list(shape),
                     dtype=str(dt).split(".")[-1], source=source,
                     cuda_core_ms=core, speedup=core / ms,
                     kernels_ms={k_: round(v_, 5) for k_, v_ in
                                 device_kernels_ms(fn, iters=20).items()})
            r["vs_library"] = r["ms"] / r["library_ms"]
            res.setdefault(name, {})[tag] = r
            what = ("forward" if name == "flash_mha_fwd" else
                    "backward alone: autograd.grad of a stored forward")
            vs = (f"; the CUDA-core template (flash_gqa.cu, rep = 1) "
                  f"{core:.4f} ms, {r['speedup']:.2f}x the kernel's time"
                  if d in fl.TC_HEAD_DIMS else
                  "; the kernel is flash_gqa.cu's template (no speed "
                  "target at D = 256)")
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


# phase 11a's head dims past 256, on flash_gqa.cu's head_dim-split arm:
# K9/K10 at (B, T, T, H, H_kv) = SPLIT_GQA (rep 4) and K11 at SPLIT_MHA,
# both dtypes, causal and not; 320 is zero-padded to 384
SPLIT_GQA_DIMS = (320, 384, 512)
SPLIT_MHA_DIMS = (384, 512)
SPLIT_GQA = (2, 512, 512, 8, 2)
SPLIT_MHA = (2, 512, 512, 4, 4)
SPLIT_KERNELS = {"flash_gqa_fwd": ("cpd_tpu/ops/flash_gqa.py:151 (D > 256; "
                                   "K11: cpd_tpu/ops/attention.py:116)",
                                   "split_fwd_kernel"),
                 "flash_gqa_bwd": ("cpd_tpu/ops/flash_gqa.py:298 (D > 256; "
                                   "K11: cpd_tpu/ops/attention.py:116)",
                                   ("split_dq_kernel", "split_dkv_kernel"))}


def sdpa_ms(q, k, v, g, causal: bool) -> dict:
    """`scaled_dot_product_attention` on K/V expanded to the query heads:
    the backend the dispatcher picks, the forward and the backward alone
    (autograd.grad of a stored forward) by `queued_ms`; null times and the
    reason where no backend takes the shape."""
    import torch
    import torch.nn.functional as F

    rep = q.shape[2] // k.shape[2]
    qt, kt, vt, gt = (x.transpose(1, 2).contiguous() for x in (
        q, k.repeat_interleave(rep, 2), v.repeat_interleave(rep, 2), g))
    kw = dict(is_causal=causal, scale=1.0 / math.sqrt(q.shape[-1]))
    try:
        backend = sdpa_backend(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, **kw))
    except AssertionError as e:
        return dict(backend=None, fwd_ms=None, bwd_ms=None, reason=str(e))
    leaves = tuple(x.detach().requires_grad_() for x in (qt, kt, vt))
    o = F.scaled_dot_product_attention(*leaves, **kw)
    out = dict(backend=backend,
               fwd_ms=queued_ms(lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, **kw), iters=5),
               bwd_ms=queued_ms(lambda: torch.autograd.grad(
                   o, leaves, gt, retain_graph=True), iters=5))
    del o, leaves
    return out


def split_head_dim_phase(device) -> dict:
    """Phase 11a past head_dim 256: K9/K10 (GQA, rep 4) at
    `SPLIT_GQA_DIMS` and K11 at `SPLIT_MHA_DIMS`, fp32 and bf16, causal
    and not, on flash_gqa.cu's head_dim-split arm: within the phase's
    tolerances of the plain versions, two launches bitwise equal, each
    case timed by `queued_ms` (forward; backward) beside its bound, its
    plain version and SDPA on K/V expanded (the backend printed)."""
    import torch

    from cpd_tpu_torch.ops import flash_gqa as fl
    from cpd_tpu_torch.ops import flash_mha as fm

    gen = torch.Generator(device=device).manual_seed(112)
    cases = [("flash_gqa", SPLIT_GQA + (d,), dt, c) for d in SPLIT_GQA_DIMS
             for dt in (torch.float32, torch.bfloat16) for c in (True, False)]
    cases += [("flash_mha", SPLIT_MHA + (d,), dt, c) for d in SPLIT_MHA_DIMS
              for dt in (torch.float32, torch.bfloat16)
              for c in (True, False)]
    fns = {"flash_gqa": (fl.flash_gqa_fwd, fl.flash_gqa_bwd,
                         fl.flash_gqa_fwd_ref, fl.flash_gqa_bwd_ref),
           "flash_mha": (fm.flash_mha_fwd, fm.flash_mha_bwd,
                         fm.flash_mha_fwd_ref, fm.flash_mha_bwd_ref)}
    before = {f: f.launches
              for f in fns["flash_gqa"][:2] + fns["flash_mha"][:2]}
    res, worst = {}, {}
    t0 = time.perf_counter()
    for label, shape, dt, causal in cases:
        if fl.launchers(dt, shape[-1])[0] is not fl._split_fwd:
            raise AssertionError(f"{label} D={shape[-1]}: not routed to the "
                                 "head_dim-split arm")
        r = attention_check(*fns[label], shape, dt, causal, gen, device,
                            repeat=True)
        if max(r["fwd_share"], r["bwd_share"]) > 1.0:
            raise AssertionError(f"{label} {shape} {dt} causal={causal}: "
                                 f"kernel vs plain {r} (shares of the "
                                 "tolerance above 1)")
        tag = str(dt).split(".")[-1]
        w = worst.setdefault(tag, dict.fromkeys(r, 0.0))
        for k2, v2 in r.items():
            w[k2] = max(w[k2], v2)
        b, tq, tk, h, hkv, d = shape
        q, k, v, g = attention_inputs(shape, dt, gen, device)
        fwd, bwd, fwd_ref, bwd_ref = fns[label]
        out, lse = fwd(q, k, v, causal)
        es = q.element_size()
        kv_elems = k.numel()
        times = dict(
            fwd_ms=queued_ms(lambda: fwd(q, k, v, causal), iters=5),
            bwd_ms=queued_ms(lambda: bwd(q, k, v, out, lse, g, causal),
                             iters=5),
            plain_fwd_ms=time_ms(lambda: fwd_ref(q, k, v, causal), iters=2),
            plain_bwd_ms=time_ms(
                lambda: bwd_ref(q, k, v, out, lse, g, causal), iters=2))
        for part, products, n_bytes in (
                ("fwd", 2, es * (2 * q.numel() + 2 * kv_elems)
                 + 4 * lse.numel()),
                ("bwd", 5, es * (4 * q.numel() + 4 * kv_elems)
                 + 8 * lse.numel())):
            flops = flash_flops(b, tq, tk, h, d, causal, products)
            peak = (PEAK_3XTF32_FLOPS if dt == torch.float32
                    else PEAK_BF16_FLOPS)
            t_ops, t_bytes = flops / peak, n_bytes / PEAK_BYTES_PER_S
            times[f"{part}_bound_ms"] = max(t_ops, t_bytes) * 1e3
            times[f"{part}_bound_by"] = ("operations" if t_ops >= t_bytes
                                         else "bytes")
        sd = sdpa_ms(q, k, v, g, causal)
        key = f"{label} {tag} D={d} {'causal' if causal else 'full'}"
        res[key] = dict(shape=list(shape), **r, **times,
                        sdpa_backend=sd["backend"], sdpa_fwd_ms=sd["fwd_ms"],
                        sdpa_bwd_ms=sd["bwd_ms"],
                        **({"sdpa_reason": sd["reason"]}
                           if "reason" in sd else {}))
        print(f"kernel {label} [{tag}, {list(shape)}, causal={causal}, "
              f"flash_gqa.cu head_dim-split]: fwd {times['fwd_ms']:.4f} ms "
              f"(bound {times['fwd_bound_ms']:.4f}, {times['fwd_bound_by']}), "
              f"bwd {times['bwd_ms']:.4f} ms (bound "
              f"{times['bwd_bound_ms']:.4f}); plain fwd "
              f"{times['plain_fwd_ms']:.4f} bwd {times['plain_bwd_ms']:.4f}; "
              f"SDPA ({sd['backend']}, K/V expanded) fwd {sd['fwd_ms']} bwd "
              f"{sd['bwd_ms']}" + (f" ({sd['reason']})" if "reason" in sd
                                   else "")
              + f"; out/lse err {r['fwd_err']:.3e} ({r['fwd_share']:.3f} of "
              f"tol), grads {r['bwd_err']:.3e} ({r['bwd_share']:.3f} of tol)",
              flush=True)
    launches = {f.__name__: f.launches - n for f, n in before.items()}
    if device != "cpu" and not all(launches.values()):
        raise AssertionError(f"head_dim-split cases launched {launches}")
    print(f"kernel head_dim-split: {len(cases)} cases within tolerance, two "
          f"launches bitwise equal in each; launches {json.dumps(launches)}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return dict(cases=res, worst=worst, launches=launches)


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


def split_kernel_entries(split: dict) -> list:
    """The ``kernels`` line's entries of flash_gqa.cu's head_dim-split arm
    (K9-K11 past head_dim 256): launches from phase 11a's cases (no
    training path of the port runs a head_dim past 256), times and
    bounds of its GQA bf16 causal case at D = 512."""
    main = "flash_gqa bfloat16 D=512 causal"
    c = split["cases"][main]
    out = []
    for name, (replaces, kernel) in SPLIT_KERNELS.items():
        part = "fwd" if name == "flash_gqa_fwd" else "bwd"
        mha_name = name.replace("gqa", "mha")
        out.append(dict(
            name=f"{name}_split", route="cuda",
            source="cpd_tpu_torch/csrc/flash_gqa.cu", kernel=kernel,
            replaces=replaces,
            launches=split["launches"][name] + split["launches"][mha_name],
            launches_from="phase 11a's head_dim > 256 cases (K9/K10 and "
                          "K11 calls)",
            max_abs_err=max(w[f"{part}_err"]
                            for w in split["worst"].values()),
            ms=c[f"{part}_ms"], plain_ms=c[f"plain_{part}_ms"],
            bound_ms=c[f"{part}_bound_ms"], bound_by=c[f"{part}_bound_by"],
            library_ms=c[f"sdpa_{part}_ms"],
            library_note=f"scaled_dot_product_attention ({c['sdpa_backend']}"
                         ", K/V expanded" + (", forward)" if part == "fwd"
                                             else ", backward alone)"),
            shape=c["shape"], dtype="bfloat16",
            cases={k: {f: v[f] for f in ("fwd_ms", "bwd_ms", "fwd_bound_ms",
                                         "bwd_bound_ms", "sdpa_backend",
                                         "sdpa_fwd_ms", "sdpa_bwd_ms")}
                   for k, v in split["cases"].items()},
            parity=f"fp32 within atol {FLASH_ATOL} / {FLASH_GRAD_ATOL}, "
                   f"bf16 within rtol {BF16_RTOL} atol {BF16_ATOL} of the "
                   f"plain versions in {len(split['cases'])} cases; two "
                   "launches bitwise equal"))
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


# -- phase 14: the process mesh ------------------------------------------
# 14a: W = DIST["world_a"] processes sharing the one card over gloo (the
# wire staged through host memory); 14b: one process per card over nccl,
# W = the card count (at most DIST["max_cards"]).  Each part is one
# spawn of W rank processes, killed at its deadline.
DIST = dict(world_a=2, max_cards=4, seed=41, deadline_a=300.0,
            deadline_b=480.0, per_rank_batch=128, steps=5, n_train=4096,
            n_test=1000, cli_iters=2)
DIST_FAULT_CODES = (0, 1, 2, 3)
DIST_CLEAN = {"hop_bad": 0, "gather_bad": 0, "agree": 1, "ok": 1}
DIST_FAULTED = {"hop_bad": 1, "gather_bad": 1, "agree": 0, "ok": 0}


def dist_arms() -> dict:
    """Phase 14's reduce matrix: name -> (`sum_gradients` keywords, SR,
    wire fault code or None).  APS e5m2 faithful, ring and fast x RTNE,
    SR and Kahan (fast mode has no scan to compensate), and the blocked
    (4, 3) b128 verified ring with each fault code on the last rank."""
    arms = {}
    for mode in ("faithful", "ring", "fast"):
        for arm in ("rtne", "sr", "kahan"):
            if (mode, arm) != ("fast", "kahan"):
                arms[f"{mode}-{arm}"] = (
                    dict(use_aps=True, grad_exp=5, grad_man=2, mode=mode,
                         use_kahan=arm == "kahan"), arm == "sr", None)
    for code in DIST_FAULT_CODES:
        arms[f"blocked-fault{code}"] = (
            dict(use_aps=True, grad_exp=BLOCKED["fmt"][0],
                 grad_man=BLOCKED["fmt"][1], mode="ring", block_scale=True,
                 block_size=BLOCKED["block"], verify=True), False, code)
    return arms


def rank_design(mode: str, sr: bool, kahan: bool, w: int, leaves: int,
                buckets: int, blocked: bool = False) -> dict:
    """The launches one APS `sum_gradients` makes on ONE rank of a
    ProcessMesh of w ranks: K1 (or sr_bits + K2) per leaf, fast mode one
    more for the sum; the faithful scan's W casts per bucket (K3, or
    sr_bits + K4; four each with Kahan), which every rank runs on its
    own gathered stack; the ring's K6 once and K5 W - 1 times per bucket
    (the blocked arms on the blocked wire, with one K7 per bucket), or
    with Kahan 4 W casts per bucket; sr_bits once per SR cast site."""
    sfx = "_sr" if sr else ""
    want = dict.fromkeys(read_counts(), 0)
    cast = leaves + (1 if mode == "fast" else 0)
    want["quantize_cast" + sfx] = cast
    bits = cast
    if blocked:
        want["quantize_pack_blocked" + sfx] = buckets
        want["hop_pack_blocked" + sfx] = (w - 1) * buckets
        want["digest_rows"] = buckets
        bits += w * buckets
    elif mode == "ring" and not kahan:
        want["quantize_pack" + sfx] = buckets
        want["hop_pack" + sfx] = (w - 1) * buckets
        bits += w * buckets
    elif mode != "fast":
        calls = w * buckets * (4 if kahan else 1)
        want["quantize_add" + sfx] = calls
        bits += calls
    if sr:
        want["sr_bits"] = bits
    return {k: v for k, v in want.items() if v}


def dist_grads(world: int, device) -> tuple:
    """Every rank's gradients at ResNet-18/CIFAR's leaves (its parameter
    shapes, 11.17 M elements), drawn in rank order from one seeded
    generator on ``device`` and scaled leaf by leaf by 10^(i mod 5 - 4):
    ``(shapes, grads)`` with ``grads[r]`` rank r's leaf list."""
    import torch

    from cpd_tpu_torch.models.resnet_cifar import resnet18_cifar

    shapes = [tuple(p.shape)
              for p in resnet18_cifar(device=device).parameters()]
    gen = torch.Generator(device=device).manual_seed(DIST["seed"])
    grads = [[torch.randn(s, generator=gen, device=device)
              * (10.0 ** (i % 5 - 4)) for i, s in enumerate(shapes)]
             for _ in range(world)]
    return shapes, grads


def dist_matrix(mesh, shapes, grads) -> dict:
    """Every arm of `dist_arms` on this rank: through the kernels (the
    launches counted from 0 around it, held to `rank_design`), through
    the plain versions on the same mesh, and on a `LocalMesh` of the same
    W on this rank's card from every rank's gradients — all three
    bitwise, reports equal."""
    import torch

    from cpd_tpu_torch.obs.timing import now
    from cpd_tpu_torch.parallel.dist import grad_sr_key, sum_gradients
    from cpd_tpu_torch.parallel.mesh import LocalMesh
    from cpd_tpu_torch.parallel.overlap import (DEFAULT_BUCKET_ELEMS,
                                                bucket_layout)

    w, rank = mesh.world, mesh.rank
    sizes = [math.prod(s) for s in shapes]
    buckets = len(bucket_layout(sizes, DEFAULT_BUCKET_ELEMS))
    local = LocalMesh(w, mesh.device)
    arms = {}
    for name, (kw, sr, code) in dist_arms().items():
        kw = dict(kw)
        if sr:
            kw.update(rounding="stochastic",
                      key=grad_sr_key(DIST["seed"], 0, 1))
        if code is not None:
            kw["wire_fault"] = (code, w - 1)
        verify = kw.get("verify", False)
        torch.cuda.synchronize()
        reset_counts()
        t0 = now()
        got = sum_gradients([grads[rank]], mesh, **kw)
        torch.cuda.synchronize()
        ms = (now() - t0) * 1e3
        counts = {k: v for k, v in read_counts().items() if v}
        plain = sum_gradients([grads[rank]], mesh, fused=False, **kw)
        ref = sum_gradients(grads, local, **kw)
        (got, rep), (plain, prep), (ref, lrep) = (
            r if verify else (r, None) for r in (got, plain, ref))
        for i, (a, b, c) in enumerate(zip(got[0], plain[0], ref[rank])):
            if not same_bits(a, b):
                raise AssertionError(f"rank {rank} {name} leaf {i}: the "
                                     "kernels differ from the plain "
                                     "versions")
            if not same_bits(a, c):
                raise AssertionError(f"rank {rank} {name} leaf {i}: the "
                                     f"process mesh differs from the "
                                     f"LocalMesh W={w}")
        design = rank_design(kw["mode"], sr, kw.get("use_kahan", False), w,
                             len(sizes), buckets,
                             blocked=kw.get("block_scale", False))
        if counts != design:
            raise AssertionError(f"rank {rank} {name}: launches {counts} "
                                 f"!= the design's {design}")
        entry = dict(ms=ms, launches=counts)
        if verify:
            rep, prep, lrep = ({k: int(v) for k, v in r.items()}
                               for r in (rep, prep, lrep))
            want = (DIST_FAULTED if code else DIST_CLEAN) if w > 1 else lrep
            if not rep == prep == lrep == want:
                raise AssertionError(f"rank {rank} {name}: reports "
                                     f"kernels {rep}, plain {prep}, "
                                     f"LocalMesh {lrep}, want {want}")
            entry["report"] = rep
        arms[name] = entry
    return dict(arms=arms, leaves=len(sizes), elements=sum(sizes),
                buckets=buckets)


def dist_bytes(mesh, own) -> dict:
    """The bytes this rank hands to the collectives (`ProcessMesh.log`)
    in one RTNE (5, 2) ring over its whole gradient and one faithful
    reduce without APS, against `ring_transport_bytes` and
    `gather_transport_bytes`; each timed on the host clock."""
    import torch

    from cpd_tpu_torch.obs.timing import now
    from cpd_tpu_torch.parallel.dist import sum_gradients
    from cpd_tpu_torch.parallel.ring import (gather_transport_bytes,
                                             ring_quantized_sum,
                                             ring_transport_bytes)

    w = mesh.world
    flat = torch.cat([g.reshape(-1) for g in own])
    n = flat.numel()

    def handed(fn) -> tuple:
        torch.cuda.synchronize()
        mesh.log = []
        t0 = now()
        fn()
        torch.cuda.synchronize()
        ms = (now() - t0) * 1e3
        log, mesh.log = mesh.log, None
        shift = sum(b for op, _, b in log if op == "ring_shift")
        gather = sum(b for op, _, b in log if op == "all_gather")
        return shift + (w - 1) * gather, ms

    ring, ring_ms = handed(lambda: ring_quantized_sum([flat], mesh, 5, 2))
    gather, gather_ms = handed(lambda: sum_gradients(
        [own], mesh, grad_exp=5, grad_man=2))
    out = dict(elements=n, ring_handed=ring,
               ring_table=ring_transport_bytes(n, w, 5, 2), ring_ms=ring_ms,
               gather_handed=gather,
               gather_table=gather_transport_bytes(n, w, 5, 2),
               faithful_ms=gather_ms)
    if (out["ring_handed"], out["gather_handed"]) != (out["ring_table"],
                                                      out["gather_table"]):
        raise AssertionError(f"rank {mesh.rank}: bytes handed to the "
                             f"collectives {out}")
    return out


def dist_slice_batches(mesh, steps: int) -> list:
    """``steps`` global batches of W x DIST["per_rank_batch"] augmented
    synthetic CIFAR-10 images (the port's sampler, seed 0), this
    process's rows of each."""
    from cpd_tpu_torch.data import (CIFAR10Pipeline,
                                    DistributedGivenIterationSampler,
                                    synthetic_cifar10)
    from cpd_tpu_torch.parallel.dist import local_rows

    global_batch = mesh.world * DIST["per_rank_batch"]
    x, y, _, _ = synthetic_cifar10(DIST["n_train"], DIST["n_test"])
    pipe = CIFAR10Pipeline(x, y, global_batch, augment=True, cutout=0)
    sampler = DistributedGivenIterationSampler(len(y), steps, global_batch,
                                               seed=0)
    return [tuple(local_rows(a, mesh) for a in pipe.batch(idx, seed=0))
            for idx in sampler.batches()]


def dist_train(mesh, buckets: int) -> dict:
    """The ResNet-18 CLI's step (`make_train_step` as ``--mode ring
    --use_APS --grad_exp 5 --grad_man 2`` builds it) at full width, W x
    128 images a step, DIST["steps"] steps from rank 0's seed-24
    weights: finite losses, step 0 within LM_LOSS_BAND of ln 10, the
    launches per step as designed; images/s per card over the steps after
    the first, one step split (`bench.step_split`) and one profiled step
    (device busy ms, the NCCL kernels' ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cpd_tpu_torch import bench
    from cpd_tpu_torch.models.resnet_cifar import resnet18_cifar
    from cpd_tpu_torch.obs.timing import now
    from cpd_tpu_torch.parallel.dist import replicate
    from cpd_tpu_torch.train import (create_train_state, make_train_step,
                                     sgd, warmup_step_decay)

    steps = DIST["steps"]
    batches = dist_slice_batches(mesh, steps + 2)
    gen = torch.Generator(device=mesh.device).manual_seed(TRAIN["seed"])
    model = replicate(resnet18_cifar(device=mesh.device).init_weights(gen),
                      mesh)
    ipe = math.ceil(DIST["n_train"] / (mesh.world * DIST["per_rank_batch"]))
    peak = TRAIN["peak_lr"]
    opt = sgd(warmup_step_decay(peak, 5 * ipe, [40 * ipe, 80 * ipe],
                                warmup_from=peak / 16.0),
              momentum=0.9, weight_decay=1e-4)
    state = create_train_state(model, opt)
    step = make_train_step(model, opt, mesh, mode="ring", use_aps=True,
                           grad_exp=5, grad_man=2)
    losses, secs = [], []
    reset_counts()
    for bx, by in batches[:steps]:
        torch.cuda.synchronize()
        t0 = now()
        state, m = step(state, bx, by)
        torch.cuda.synchronize()
        secs.append(now() - t0)
        losses.append(float(m["loss"]))
    counts = {k: v for k, v in read_counts().items() if v}
    per_step = {k: v // steps for k, v in counts.items()}
    n_leaves = len(list(model.parameters()))
    design = rank_design("ring", False, False, mesh.world, n_leaves,
                         buckets)
    if any(v % steps for v in counts.values()) or per_step != design:
        raise AssertionError(f"rank {mesh.rank} train: launches {counts} "
                             f"over {steps} steps, design {design} a step")
    if not all(math.isfinite(v) for v in losses) or abs(
            losses[0] - math.log(10)) > LM_LOSS_BAND:
        raise AssertionError(f"rank {mesh.rank} train losses {losses}")
    split = bench.step_split(model, opt, state, mesh, *batches[steps],
                             "ring")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(state, *batches[steps + 1])
        torch.cuda.synchronize()
    kernels = profiled_kernels(prof)
    busy = (sum(e.self_device_time_total for e in kernels) / 1e3
            if kernels else None)
    nccl = (sum(e.self_device_time_total for e in kernels
                if "nccl" in e.key.lower()) / 1e3 if kernels else None)
    per_rank = DIST["per_rank_batch"]
    ips = per_rank * (steps - 1) / sum(secs[1:])
    return dict(world=mesh.world, per_rank_batch=per_rank, steps=steps,
                losses=losses, step_ms=[s * 1e3 for s in secs],
                img_per_s_per_card=ips, img_per_s=ips * mesh.world,
                launches_per_step=per_step, device_busy_ms=busy,
                nccl_ms=nccl, **split)


def dist_headline(mesh) -> dict:
    """bench.py's headline arms (`bench.run`) on this process's rank:
    ResNet-50 bf16, batch 32 a card at 224^2, APS e5m2 faithful then
    fast: finite losses, step 0 within LM_LOSS_BAND of ln 1000, the
    launches per step as designed, images/s per card."""
    from cpd_tpu_torch import bench
    from cpd_tpu_torch.models.resnet import resnet50
    from cpd_tpu_torch.parallel.overlap import (DEFAULT_BUCKET_ELEMS,
                                                bucket_layout)

    out = bench.run(mesh=mesh)
    sizes = [p.numel() for p in resnet50(device=mesh.device).parameters()]
    buckets = len(bucket_layout(sizes, DEFAULT_BUCKET_ELEMS))
    for mode, r in out["modes"].items():
        losses = r["losses"]
        if not all(math.isfinite(v) for v in losses) or abs(
                losses[0] - math.log(HEADLINE_CLASSES)) > LM_LOSS_BAND:
            raise AssertionError(f"rank {mesh.rank} headline {mode} "
                                 f"losses {losses}")
        want = rank_design(mode, False, False, mesh.world, len(sizes),
                           buckets)
        if r["launches_per_step"] != want:
            raise AssertionError(f"rank {mesh.rank} headline {mode} "
                                 f"launches {r['launches_per_step']} != "
                                 f"{want}")
    return dict(value=out["value"], fast=out["fast"], config=out["config"],
                modes={m: {k: r[k] for k in (
                    "img_per_s", "step_ms", "fwd_bwd_ms", "reduce_ms",
                    "update_ms", "peak_memory_gib", "launches_per_step",
                    "losses")} for m, r in out["modes"].items()})


def dist_cifar_root() -> str:
    """A small CIFAR-10 pickle tree (DIST["n_train"] + DIST["n_test"]
    seeded random images) under the checkout's ``build/``, for the
    ``--dist`` CLI runs."""
    import os
    import pickle

    import numpy as np

    from cpd_tpu_torch.ops.build import build_dir

    root = os.path.join(os.path.dirname(build_dir()), "dist_cifar")
    folder = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(folder, exist_ok=True)
    rng = np.random.RandomState(DIST["seed"])
    per = DIST["n_train"] // 5
    files = [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]
    for name in files:
        n = DIST["n_test"] if name == "test_batch" else per
        with open(os.path.join(folder, name), "wb") as fh:
            pickle.dump({b"data": rng.randint(0, 256, (n, 3072),
                                              dtype=np.uint8),
                         b"labels": rng.randint(0, 10, n).tolist()}, fh)
    return root


def dist_cli(mesh, root: str, buckets: int, leaves: int, save: str) -> dict:
    """DIST["cli_iters"] iterations of the ResNet-18 CLI under ``--dist
    --dist-backend gloo`` (faithful APS e5m2, batch 128 a rank, its
    checkpoints in ``save``), this process one of its ranks: it
    finishes, the loss is finite, the launches are the design's per
    iteration."""
    from cpd_tpu_torch.examples.resnet18_cifar import train as cli
    from cpd_tpu_torch.obs.timing import now

    reset_counts()
    t0 = now()
    res = cli.run(cli.parse_args([
        "--dist", "--dist-backend", mesh.backend, "--mode", "faithful",
        "--use_APS", "--grad_exp", "5", "--grad_man", "2", "--max-iter",
        str(DIST["cli_iters"]), "--batch_size", str(DIST["per_rank_batch"]),
        "--data-root", root, "--save_path", save,
        "--print_freq", "1", "--val_freq", str(DIST["cli_iters"])]),
        device=mesh.device)
    seconds = now() - t0
    counts = {k: v for k, v in read_counts().items() if v}
    want = {k: v * DIST["cli_iters"] for k, v in rank_design(
        "faithful", False, False, mesh.world, leaves, buckets).items()}
    if (res["diverged"] or res["step"] != DIST["cli_iters"]
            or not math.isfinite(res["loss"]) or counts != want):
        raise AssertionError(f"rank {mesh.rank} --dist CLI: {res}, "
                             f"launches {counts} (design {want})")
    return dict(seconds=seconds, launches=counts, loss=res["loss"],
                best_prec1=res["best_prec1"])


def dist_rank(part: str, backend: str, device, root=None,
              save=None) -> dict:
    """One rank process of phase 14 (`parallel.launch.spawn` starts W):
    joins the group with ``backend``, its rank on ``device`` (under nccl
    its own card), then 14a (``part`` "a": the matrix and the ``--dist``
    CLI on the data under ``root``, checkpoints in ``save``) or 14b
    ("b": the matrix, the bytes, the ResNet-18 step and the headline)."""
    import torch

    from cpd_tpu_torch.obs.timing import now
    from cpd_tpu_torch.parallel.dist import dist_init
    from cpd_tpu_torch.parallel.mesh import ProcessMesh

    marks = [now()]
    rank, world = dist_init(backend)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = ProcessMesh(device)
    out = dict(rank=rank, world=world, backend=backend,
               device=str(mesh.device), staged=mesh.staged,
               card=torch.cuda.get_device_name(mesh.device))
    shapes, grads = dist_grads(world, mesh.device)
    marks.append(now())
    out["matrix"] = dist_matrix(mesh, shapes, grads)
    marks.append(now())
    names = ["init", "matrix"]
    buckets, leaves = out["matrix"]["buckets"], out["matrix"]["leaves"]
    if part == "a":
        out["cli"] = dist_cli(mesh, root, buckets, leaves, save)
        names.append("cli")
        marks.append(now())
    else:
        out["bytes"] = dist_bytes(mesh, grads[rank])
        del grads
        marks.append(now())
        out["train"] = dist_train(mesh, buckets)
        marks.append(now())
        out["headline"] = dist_headline(mesh)
        marks.append(now())
        names += ["bytes", "train", "headline"]
    out["seconds"] = dict(zip(names, (b - a for a, b in
                                      zip(marks, marks[1:]))))
    return out


def dist_phase(device, parts=("a", "b")) -> dict:
    """Phase 14: the process mesh.  14a spawns DIST["world_a"] processes
    on the one card over gloo; 14b one process per card over nccl, W =
    the card count (at most DIST["max_cards"]; W = 1 on a one-card
    machine, where NCCL's init and all-gathers still run).  Every rank's
    results are checked in the rank (`dist_matrix`, `dist_bytes`,
    `dist_train`, `dist_headline`, `dist_cli`); here the ranks must agree
    with each other.  A rank that raises or outlives its deadline fails
    the phase."""
    import torch

    from cpd_tpu_torch.obs.timing import now

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out = {}
    if "a" in parts:
        t0 = now()
        root = dist_cifar_root()
        ranks = POOL.spawn(dist_rank, DIST["world_a"],
                      args=("a", "gloo", device, root,
                            save_path("dist_cli")),
                      timeout=DIST["deadline_a"])
        out["a"] = dist_summary("14a", ranks, now() - t0)
    if "b" in parts:
        cards = min(torch.cuda.device_count(), DIST["max_cards"])
        t0 = now()
        ranks = POOL.spawn(dist_rank, cards, args=("b", "nccl", device),
                      timeout=DIST["deadline_b"],
                      env={"NCCL_DEBUG": "WARN"})
        out["b"] = dist_summary("14b", ranks, now() - t0)
    return out


def dist_summary(label: str, ranks: list, seconds: float) -> dict:
    """Print one part's figures, a line per sub-phase, after checking
    that the ranks agree: the same reports and launches in every arm,
    the same losses in every step."""
    r0 = ranks[0]
    w = r0["world"]
    for r in ranks[1:]:
        for name, e in r0["matrix"]["arms"].items():
            o = r["matrix"]["arms"][name]
            if (o["launches"], o.get("report")) != (e["launches"],
                                                      e.get("report")):
                raise AssertionError(f"{label} {name}: rank {r['rank']} "
                                     f"{o} != rank 0 {e}")
        if "train" in r0 and r["train"]["losses"] != r0["train"]["losses"]:
            raise AssertionError(f"{label} train: rank {r['rank']} losses "
                                 "differ from rank 0's")
    where = ("one card, gloo, wire staged through the host" if r0["staged"]
             else f"{w} card(s), {r0['backend']}")
    print(f"dist {label}: W={w} processes on {where} ({r0['card']}); "
          f"{seconds:.1f} s", flush=True)
    print(f"dist {label} matrix: ResNet-18/CIFAR's {r0['matrix']['leaves']}"
          f" leaves ({r0['matrix']['elements']} elements, "
          f"{r0['matrix']['buckets']} buckets), every rank bitwise the "
          f"plain versions and the LocalMesh W={w}; rank 0's host ms and "
          "launches per arm: " + json.dumps(
              {k: {"ms": round(v["ms"], 3), "launches": v["launches"],
                   **({"report": v["report"]} if "report" in v else {})}
               for k, v in r0["matrix"]["arms"].items()}), flush=True)
    if "cli" in r0:
        print(f"dist {label} cli: --dist --dist-backend {r0['backend']} "
              f"{DIST['cli_iters']} iterations on every rank: " +
              json.dumps([r["cli"] for r in ranks]), flush=True)
    if "bytes" in r0:
        print(f"dist {label} bytes: handed to the collectives == the "
              "transport tables on every rank; rank 0: " +
              json.dumps(r0["bytes"]), flush=True)
    if "train" in r0:
        t = r0["train"]
        print(f"dist {label} train: ResNet-18/CIFAR full width, W={w} x "
              f"{t['per_rank_batch']}, {t['steps']} ring APS e5m2 steps: "
              f"{t['img_per_s_per_card']:.2f} img/s per card, "
              f"{t['img_per_s']:.2f} in all; " + json.dumps(
                  {k: t[k] for k in ("losses", "step_ms", "fwd_bwd_ms",
                                     "reduce_ms", "update_ms",
                                     "device_busy_ms", "nccl_ms",
                                     "launches_per_step")}), flush=True)
    if "headline" in r0:
        h = r0["headline"]
        print(f"dist {label} headline: ResNet-50 bf16 APS e5m2, W={w} x "
              f"32 at 224^2, one process per card: faithful "
              f"{h['value']:.2f} img/s per card, fast {h['fast']:.2f}; " +
              json.dumps(h["modes"]), flush=True)
    print(f"dist {label} seconds per rank: " +
          json.dumps([r["seconds"] for r in ranks]), flush=True)
    return dict(world=w, seconds=seconds, ranks=ranks)


# phase 15: the transport ladder and checkpoints through the ResNet CLI,
# full-width ResNet-18/CIFAR on phase 14's synthetic set (`dist_cifar_root`)
# at W ranks x 128 on the card, APS e5m2; 15d: 2 gloo processes on the
# card, the tiny CNN at dist_batch a rank
LADDER = dict(world=4, per_rank_batch=128, fmt=(5, 2), iters=10,
              fault="wire_flip@2:1", retries=1, probation=2,
              ckpt_iters=8, ckpt_at=4, dist_world=2, dist_batch=32,
              dist_iters=6, dist_resume_iters=8, dist_deadline=300.0)
# 15a's ladder as the JAX trainer's loop runs it (tests/test_torch_ladder.py
# holds the port's CLI to the JAX CLI's on the same argv): 10 batches,
# the update-2 fault discarded twice (a retry, then a downgrade), two clean
# faithful updates and back to the ring
LADDER_WANT = dict(
    step=8, transitions=[(2, "ring", "faithful"), (3, "faithful", "ring")],
    counters={"wire_faults_detected": 2, "reduce_retries": 1,
              "transport_downgrades": 1, "resyncs": 1,
              "transport_upgrades": 1})
# the kernels of each rung's step that the kernels line reports per rung
LADDER_KERNELS = ("quantize_cast", "quantize_add", "quantize_pack",
                  "hop_pack")
# the kernels each rung's step must launch
LADDER_PATH = {"ring": ("quantize_cast", "quantize_pack", "hop_pack",
                        "digest_rows"),
               "faithful": ("quantize_cast", "quantize_add"),
               "fp32": ("quantize_cast",)}


def rung_of(mode: str, fmt) -> str:
    """The ladder rung a step's reduce mode and format belong to."""
    return "fp32" if mode == "fast" and tuple(fmt) == (8, 23) else mode


@contextlib.contextmanager
def recorded_steps(log: list):
    """Every train step built while open records, per call: its rung,
    the batch, the loss, the verdict, the host ms between
    synchronisations and the kernel launches (the steps the ResNet CLI
    builds included: it looks `make_train_step` up at each run)."""
    import numpy as np
    import torch

    import cpd_tpu_torch.train as ttrain
    from cpd_tpu_torch.obs.timing import now

    real = ttrain.make_train_step

    def build(model, opt, mesh, **kw):
        step = real(model, opt, mesh, **kw)
        rung = rung_of(kw.get("mode", "faithful"),
                       (kw.get("grad_exp", 8), kw.get("grad_man", 23)))

        def recorded(state, images, labels):
            before = read_counts()
            torch.cuda.synchronize()
            t0 = now()
            state, metrics = step(state, images, labels)
            torch.cuda.synchronize()
            ms = (now() - t0) * 1e3
            after = read_counts()
            log.append(dict(
                rung=rung, images=np.array(images), labels=np.array(labels),
                loss=metrics["loss"].clone(),
                ok=float(metrics.get("reduce_ok", 1.0)), ms=ms,
                launches={k: after[k] - before[k] for k in after
                          if after[k] != before[k]}))
            return state, metrics

        return recorded

    ttrain.make_train_step = build
    try:
        yield log
    finally:
        ttrain.make_train_step = real


def ladder_argv(root: str, iters: int, *extra) -> list:
    """The ResNet CLI at phase 15's width and data, the ring APS e5m2."""
    L = LADDER
    return ["--mode", "ring", "--use_APS", "--grad_exp", str(L["fmt"][0]),
            "--grad_man", str(L["fmt"][1]), "--batch_size",
            str(L["per_rank_batch"]), "--max-iter", str(iters),
            "--print_freq", "100", "--data-root", root, *extra]


def run_cli(argv: list, world: int, device) -> tuple:
    """The ResNet CLI's ``run``: (result, its ``=>`` lines)."""
    from cpd_tpu_torch.examples.resnet18_cifar import train as cli

    err = io.StringIO()
    with contextlib.redirect_stderr(err), \
            contextlib.redirect_stdout(io.StringIO()):
        res = cli.run(cli.parse_args(argv), device=device, world=world)
    return res, [ln for ln in err.getvalue().splitlines()
                 if ln.startswith("=>")]


def fresh_state(args, device, world: int) -> tuple:
    """(model, optimizer, state) as the ResNet CLI starts them for
    ``args`` on phase 15's data."""
    import torch

    from cpd_tpu_torch import models
    from cpd_tpu_torch.data import load_cifar10
    from cpd_tpu_torch.train import (create_train_state, make_optimizer,
                                     warmup_step_decay)

    n = len(load_cifar10(args.data_root)[1])
    ipe = math.ceil(n / (world * args.batch_size * args.emulate_node))
    schedule = warmup_step_decay(1.6, 5 * ipe, [40 * ipe, 80 * ipe],
                                 warmup_from=0.1)
    gen = torch.Generator(device=device).manual_seed(24)
    model = models.get_model(args.arch, device=device).init_weights(gen)
    opt = make_optimizer(args.opt_name, schedule, momentum=args.momentum,
                         weight_decay=args.weight_decay)
    return model, opt, create_train_state(model, opt)


def state_arrays(state) -> list:
    """Every tensor of a train state as host bytes (integrity order)."""
    from cpd_tpu_torch.parallel.integrity import tensor_leaves

    return [t.detach().cpu().clone() for t in tensor_leaves(state)]


def same_state(a: list, b: list, label: str) -> None:
    if len(a) != len(b):
        raise AssertionError(f"{label}: {len(a)} tensors vs {len(b)}")
    for i, (x, y) in enumerate(zip(a, b)):
        if x.shape != y.shape or x.dtype != y.dtype or not same_bits(x, y):
            raise AssertionError(f"{label}: tensor {i} differs")


def per_rung(log: list, label: str) -> dict:
    """rung -> the launches of one kept step (the same in every kept step
    of the rung) and the kept steps' host ms."""
    out: dict = {}
    for e in log:
        if e["ok"] != 1.0:
            continue
        r = out.setdefault(e["rung"], dict(launches=e["launches"], ms=[]))
        if e["launches"] != r["launches"]:
            raise AssertionError(f"{label} {e['rung']}: launches "
                                 f"{e['launches']} != {r['launches']}")
        r["ms"].append(e["ms"])
    return out


def ladder_drill(device, root: str) -> dict:
    """15a: the ladder through the CLI, then its replay by hand."""
    import torch

    from cpd_tpu_torch.examples.resnet18_cifar import train as cli
    from cpd_tpu_torch.parallel.mesh import data_parallel_mesh
    from cpd_tpu_torch.resilience import FaultPlan, level_reduce_kwargs
    from cpd_tpu_torch.train import make_train_step
    from cpd_tpu_torch.train.checkpoint import restore_latest

    L = LADDER
    save = save_path("ladder_15a")
    argv = ladder_argv(root, L["iters"], "--verify-reduce",
                       "--reduce-retries", str(L["retries"]),
                       "--transport-probation", str(L["probation"]),
                       "--fault-plan", L["fault"], "--val_freq",
                       str(LADDER_WANT["step"]), "--save_path", save)
    log: list = []
    reset_counts()
    with recorded_steps(log):
        res, lines = run_cli(argv, L["world"], device)
    counts = read_counts()
    got = dict(step=res["step"], transitions=res["transport"]["transitions"],
               counters={k: v for k, v in res["resilience"].items() if v})
    if got != LADDER_WANT or res["diverged"] or len(lines) != 3:
        raise AssertionError(f"15a ladder {got}, lines {lines} != "
                             f"{LADDER_WANT}")
    if len(log) != L["iters"]:
        raise AssertionError(f"15a: {len(log)} steps ran, not "
                             f"{L['iters']}")
    rungs = per_rung(log, "15a")
    for rung in ("ring", "faithful"):
        missing = [k for k in LADDER_PATH[rung]
                   if not rungs[rung]["launches"].get(k)]
        if missing:
            raise AssertionError(f"15a {rung} step launched none of "
                                 f"{missing}: {rungs[rung]['launches']}")

    # the replay: the same rung steps by hand over the kept batches
    args = cli.parse_args(argv)
    mesh = data_parallel_mesh(L["world"], device)
    model, opt, state = fresh_state(args, mesh.device, L["world"])
    plan = FaultPlan.parse(L["fault"]).wire_schedule(L["iters"])
    steps = {lv: make_train_step(
        model, opt, mesh, verify_reduce=True, use_aps=True,
        wire_fault_plan=plan if lv == "ring" else None,
        **level_reduce_kwargs(lv, *L["fmt"])) for lv in rungs}
    kept = [e for e in log if e["ok"] == 1.0]
    for i, e in enumerate(kept):
        state, m = steps[e["rung"]](state, e["images"], e["labels"])
        if float(m["reduce_ok"]) != 1.0 or not same_bits(m["loss"],
                                                          e["loss"]):
            raise AssertionError(f"15a update {i} ({e['rung']}): replay "
                                 f"loss {float(m['loss'])!r}, CLI "
                                 f"{float(e['loss'])!r}")
    want = state_arrays(state)
    model2, _, fresh = fresh_state(args, mesh.device, L["world"])
    saved = restore_latest(save, fresh)
    if saved is None or saved.step != LADDER_WANT["step"]:
        raise AssertionError(f"15a: no checkpoint of update "
                             f"{LADDER_WANT['step']} in {save}")
    same_state(want, state_arrays(saved), "15a saved state vs replay")
    del model, model2, state, saved, fresh, steps
    torch.cuda.empty_cache()
    out = dict(step=res["step"], lines=lines, counts=counts,
               batch=dict(images=kept[0]["images"],
                          labels=kept[0]["labels"], root=root),
               losses=[float(e["loss"]) for e in kept],
               discarded_ms=[e["ms"] for e in log if e["ok"] != 1.0],
               rungs={k: dict(launches=v["launches"], ms=v["ms"])
                      for k, v in rungs.items()})
    print(f"ladder 15a: W={L['world']} x {L['per_rank_batch']} "
          "ResNet-18/CIFAR, ring APS e5m2, "
          f"--fault-plan {L['fault']}: {res['step']} updates of "
          f"{L['iters']} batches, transitions {got['transitions']}, "
          f"counters {got['counters']}; every kept update's loss and the "
          "saved state bitwise the replay; " + json.dumps(
              {k: out[k] for k in ("losses", "discarded_ms", "rungs")}),
          flush=True)
    return out


def fp32_rung(device, batch) -> dict:
    """15b: the fp32 rung's step bitwise fast mode at (8, 23)."""
    from cpd_tpu_torch.examples.resnet18_cifar import train as cli
    from cpd_tpu_torch.obs.timing import now
    from cpd_tpu_torch.parallel.mesh import data_parallel_mesh
    from cpd_tpu_torch.resilience import StepTable, level_reduce_kwargs
    from cpd_tpu_torch.train import make_train_step

    import torch

    L = LADDER
    args = cli.parse_args(ladder_argv(batch["root"], L["iters"]))
    mesh = data_parallel_mesh(L["world"], device)
    model_a, opt_a, state_a = fresh_state(args, mesh.device, L["world"])
    model_b, opt_b, state_b = fresh_state(args, mesh.device, L["world"])
    table = StepTable(lambda lv: make_train_step(
        model_a, opt_a, mesh, verify_reduce=True, use_aps=True,
        **level_reduce_kwargs(lv, *L["fmt"])))
    fast = make_train_step(model_b, opt_b, mesh, mode="fast", grad_exp=8,
                           grad_man=23, use_aps=True)
    x, y = batch["images"], batch["labels"]
    reset_counts()
    state_a, ma = table["fp32"](state_a, x, y)
    launches = {k: v for k, v in read_counts().items() if v}
    state_b, mb = fast(state_b, x, y)
    if float(ma["reduce_ok"]) != 1.0 or not same_bits(ma["loss"],
                                                      mb["loss"]):
        raise AssertionError(f"15b: fp32 rung loss {float(ma['loss'])!r} "
                             f"vs fast (8, 23) {float(mb['loss'])!r}")
    same_state(state_arrays(state_a), state_arrays(state_b),
               "15b fp32 rung vs fast (8, 23)")
    missing = [k for k in LADDER_PATH["fp32"] if not launches.get(k)]
    if missing:
        raise AssertionError(f"15b: the fp32 rung launched none of "
                             f"{missing}: {launches}")
    ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = now()
        state_a, _ = table["fp32"](state_a, x, y)
        torch.cuda.synchronize()
        ms.append((now() - t0) * 1e3)
    del model_a, model_b, state_a, state_b, table, fast
    torch.cuda.empty_cache()
    out = dict(launches=launches, ms=ms)
    print("ladder 15b: one fp32-rung step bitwise the --mode fast "
          "(8, 23) step from the same state; " + json.dumps(out),
          flush=True)
    return out


def npz_arrays(step_dir: str) -> list:
    import numpy as np

    with np.load(os.path.join(step_dir, "state.npz")) as z:
        return [z[k] for k in sorted(z.files)]


def ckpt_drill(device, root: str) -> dict:
    """15c: resume bitwise, save/restore cost, a corrupt newest step,
    and the reference .pth round trip."""
    import numpy as np
    import torch

    from cpd_tpu_torch.examples.resnet18_cifar import train as cli
    from cpd_tpu_torch.obs.timing import now
    from cpd_tpu_torch.train.checkpoint import (CheckpointManager,
                                                checkpoint_digest)

    L = LADDER
    n, at = L["ckpt_iters"], L["ckpt_at"]
    argv = ladder_argv(root, n, "--val_freq", str(at))
    whole = save_path("ckpt_whole")
    log_w: list = []
    with recorded_steps(log_w):
        res_w, _ = run_cli(argv + ["--save_path", whole], L["world"], device)
    copy = save_path("ckpt_copy")
    shutil.copytree(whole, copy)
    shutil.rmtree(os.path.join(copy, str(n)))
    os.remove(os.path.join(copy, f"meta-{n}.json"))
    resumed = save_path("ckpt_resumed")
    log_r: list = []
    with recorded_steps(log_r):
        res_r, _ = run_cli(argv + ["--load-path", copy, "--resume-opt",
                                   "--save_path", resumed], L["world"],
                           device)
    if (res_w["step"], res_r["step"], len(log_r)) != (n, n, n - at):
        raise AssertionError(f"15c: steps {res_w['step']}, "
                             f"{res_r['step']}, {len(log_r)} resumed")
    for i, (a, b) in enumerate(zip(log_w[at:], log_r)):
        if not same_bits(a["loss"], b["loss"]):
            raise AssertionError(f"15c iteration {at + i + 1}: resumed "
                                 f"loss {float(b['loss'])!r}, unbroken "
                                 f"{float(a['loss'])!r}")
    want = npz_arrays(os.path.join(whole, str(n)))
    got = npz_arrays(os.path.join(resumed, str(n)))
    if len(want) != len(got) or not all(
            a.dtype == b.dtype and a.shape == b.shape
            and np.array_equal(a.view(np.uint8), b.view(np.uint8))
            for a, b in zip(want, got)):
        raise AssertionError("15c: the resumed step-8 checkpoint differs "
                             "from the unbroken run's")

    # save and restore of the full-width state, timed
    args = cli.parse_args(argv)
    model, _, template = fresh_state(args, device, L["world"])
    mgr = CheckpointManager(whole)
    torch.cuda.synchronize()
    t0 = now()
    state = mgr.restore(template)
    torch.cuda.synchronize()
    restore_ms = (now() - t0) * 1e3
    timed = CheckpointManager(save_path("ckpt_timed"))
    t0 = now()
    timed.save(n, state)
    save_ms = (now() - t0) * 1e3
    info = checkpoint_digest(os.path.join(timed.directory, str(n)))

    # a bit flip in the newest step: the scan takes the step before
    victim = os.path.join(whole, str(n), "state.npz")
    size = os.path.getsize(victim)
    with open(victim, "r+b") as fh:
        fh.seek(size // 2)
        byte = fh.read(1)
        fh.seek(size // 2)
        fh.write(bytes([byte[0] ^ 0xFF]))
    with contextlib.redirect_stderr(io.StringIO()):
        scan = mgr.restore_latest_valid(template)
    if scan is None or (scan.step, scan.skipped) != (at, (n,)):
        raise AssertionError(f"15c: restore_latest_valid after a bit flip "
                             f"in step {n}: {scan and scan[1:3]}")

    # the reference .pth: export, then evaluate from it
    pth = os.path.join(save_path("ckpt_pth"), "res18.pth")
    os.makedirs(os.path.dirname(pth))
    ev = ladder_argv(root, n, "-e", "--save_path", save_path("ckpt_eval"))
    v1, _ = run_cli(ev + ["--load-path", resumed, "--export-torch", pth],
                    L["world"], device)
    v2, _ = run_cli(ev + ["--init-from-torch", pth], L["world"], device)
    if v1 != v2:
        raise AssertionError(f"15c: -e from the checkpoint {v1} != -e "
                             f"--init-from-torch of its export {v2}")
    del model, template, state
    torch.cuda.empty_cache()
    out = dict(losses=[float(e["loss"]) for e in log_r],
               save_ms=save_ms, restore_ms=restore_ms, bytes=info["bytes"],
               files=info["files"], validation=v1)
    print(f"ladder 15c: {n} iterations saved at {at} and {n}; step {at} "
          f"resumed with --load-path --resume-opt: losses {at + 1}-{n} and "
          f"every array of step {n} bitwise the unbroken run; a bit flip "
          f"in step {n} skipped for step {at}; -e --export-torch then -e "
          "--init-from-torch: the same validation bitwise; " +
          json.dumps(out), flush=True)
    return out


class LadderStitched:
    """The global batches of a 15d ``--dist`` run over its processes:
    each process's sampler slice, in rank order."""

    def __init__(self, n, total_iter, batch, world_size=1, rank=0, seed=0,
                 last_iter=-1):
        from cpd_tpu_torch.data import samplers

        w = LADDER["dist_world"]
        self.parts = [samplers.DistributedGivenIterationSampler(
            n, total_iter, batch // w, world_size=w, rank=r, seed=seed,
            last_iter=last_iter) for r in range(w)]

    def batches(self):
        import numpy as np

        for parts in zip(*(p.batches() for p in self.parts)):
            yield np.concatenate(parts)


def ladder_dist_rank(root: str, base: str, device) -> dict:
    """One process of 15d: ranks 0 and 1 run the ladder and the resume
    under ``--dist --dist-backend gloo``; the last process runs the same
    argv on a `LocalMesh` of 2.  Each reports its runs, the digest and
    agreement after every resync, and the state it restores from the
    resumed run's checkpoint."""
    import torch

    import cpd_tpu_torch.data as tdata
    import cpd_tpu_torch.parallel.integrity as integ
    from cpd_tpu_torch.examples.resnet18_cifar import train as cli
    from cpd_tpu_torch.train.checkpoint import restore_latest

    L = LADDER
    local = int(os.environ["RANK"]) == L["dist_world"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    where = os.path.join(base, "local" if local else "dist")
    resyncs: list = []
    real = integ.make_consensus_fns

    def consensus(mesh):
        check, resync = real(mesh)

        def checked(tree):
            tree = resync(tree)
            resyncs.append(dict(
                agree=int(check(tree)),
                digest=int(integ.tree_digest(integ.tensor_leaves(tree)))))
            return tree

        return check, checked

    integ.make_consensus_fns = consensus
    if local:
        tdata.DistributedGivenIterationSampler = LadderStitched
    argv = ["--arch", "tiny", "--mode", "ring", "--use_APS", "--grad_exp",
            "5", "--grad_man", "2", "--batch_size", str(L["dist_batch"]),
            "--val_freq", "2", "--print_freq", "100", "--verify-reduce",
            "--reduce-retries", str(L["retries"]), "--transport-probation",
            str(L["probation"]), "--fault-plan", L["fault"],
            "--data-root", root]
    dist = [] if local else ["--dist", "--dist-backend", "gloo"]
    runs = []
    for extra in (["--max-iter", str(L["dist_iters"]), "--save_path",
                   os.path.join(where, "a")],
                  ["--max-iter", str(L["dist_resume_iters"]),
                   "--load-path", os.path.join(where, "a"), "--resume-opt",
                   "--save_path", os.path.join(where, "b")]):
        res, lines = run_cli(argv + extra + dist,
                             L["dist_world"] if local else 1, device)
        res["lines"] = lines
        runs.append(res)
    args = cli.parse_args(argv)
    _, _, fresh = fresh_state(args, device, L["dist_world"])
    state = restore_latest(os.path.join(where, "b"), fresh)
    return dict(runs=runs, resyncs=resyncs, restored_step=state.step,
                restored=[t.numpy() for t in state_arrays(state)])


def ladder_dist(device, root: str) -> dict:
    """15d: the ladder, a save and a resume on two gloo processes
    sharing the card, against a `LocalMesh` W = 2 in a third."""
    import numpy as np

    from cpd_tpu_torch.obs.timing import now

    L = LADDER
    w = L["dist_world"]
    t0 = now()
    base = save_path("ladder_15d")
    os.makedirs(base)
    out = POOL.spawn(ladder_dist_rank, w + 1, args=(root, base, device),
                timeout=L["dist_deadline"],
                env={"WORLD_SIZE": str(w), "LOCAL_WORLD_SIZE": str(w)})
    ranks, local = out[:w], out[w]
    first, resumed = local["runs"]
    if (first["step"], resumed["step"]) != (L["dist_iters"] - 2,
                                            L["dist_resume_iters"]):
        raise AssertionError(f"15d LocalMesh steps {first['step']}, "
                             f"{resumed['step']}")
    if first["transport"]["transitions"] != LADDER_WANT["transitions"]:
        raise AssertionError(f"15d transitions "
                             f"{first['transport']['transitions']}")
    for r, res in enumerate(ranks):
        for i, (want, got) in enumerate(zip(local["runs"], res["runs"])):
            for k in ("step", "loss", "accuracy", "diverged", "resilience",
                      "transport", "reduce_ok"):
                if got[k] != want[k]:
                    raise AssertionError(f"15d rank {r} run {i} {k}: "
                                         f"{got[k]} != LocalMesh "
                                         f"{want[k]}")
        if res["resyncs"] != ranks[0]["resyncs"] or not res["resyncs"] or \
                any(s["agree"] != 1 for s in res["resyncs"]):
            raise AssertionError(f"15d rank {r} resyncs {res['resyncs']} "
                                 f"vs rank 0 {ranks[0]['resyncs']}")
        if res["restored_step"] != resumed["step"] or len(
                res["restored"]) != len(local["restored"]) or not all(
                a.dtype == b.dtype and np.array_equal(
                    a.reshape(-1).view(np.uint8),
                    b.reshape(-1).view(np.uint8))
                for a, b in zip(local["restored"], res["restored"])):
            raise AssertionError(f"15d rank {r}: the restored state "
                                 "differs from the LocalMesh's")
    if ranks[0]["runs"][0]["lines"] != first["lines"] or \
            ranks[1]["runs"][0]["lines"]:
        raise AssertionError("15d: rank 0's ladder lines differ from the "
                             "LocalMesh's, or rank 1 printed")
    res = dict(seconds=now() - t0, steps=[first["step"], resumed["step"]],
               transitions=first["transport"]["transitions"],
               resyncs=ranks[0]["resyncs"])
    print(f"ladder 15d: 2 gloo processes on the card, --dist, the tiny CNN "
          f"at {L['dist_batch']} a rank, wire_flip on rank 1: both runs of "
          "both ranks bitwise the LocalMesh W=2 (losses, counters, "
          "transitions), digests equal after each resync, every rank "
          "restoring the same bytes; " + json.dumps(res), flush=True)
    return res


def ladder_phase(device) -> dict:
    """Phase 15: 15a-15d (module docstring)."""
    import torch

    from cpd_tpu_torch.obs.timing import now

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    marks = [now()]
    root = dist_cifar_root()
    out = {"a": ladder_drill(device, root)}
    marks.append(now())
    out["b"] = fp32_rung(device, out["a"].pop("batch"))
    marks.append(now())
    out["c"] = ckpt_drill(device, root)
    marks.append(now())
    out["d"] = ladder_dist(device, root)
    marks.append(now())
    out["seconds"] = dict(zip("abcd", (b - a for a, b in
                                       zip(marks, marks[1:]))))
    out["seconds"]["all"] = marks[-1] - marks[0]
    out["launches_per_step"] = {
        rung: out["a"]["rungs"][rung]["launches"] if rung in out["a"]["rungs"]
        else out["b"]["launches"] for rung in ("ring", "faithful", "fp32")}
    print("ladder seconds: " + json.dumps(out["seconds"]), flush=True)
    return out


# phase 16: the step's remaining switches and the LM on the process mesh.
# 16a: the LM slice's model and path (phase 10: the serving width, GQA
# flash with the flash-backward kernels, the e4m3 faithful FFN) at W = 2 x
# emulate_node 2 x 2 sequences of 1024 tokens (phase 10's 4 a rank, split
# in two micro-batches), APS e5m2, quant_stats, SGD momentum 0.9 at a
# constant rate (every step moves the weights); 16b: the same on 2 gloo
# processes sharing the card (faithful, and the RTNE ring verified) and on
# one nccl process a card; 16c: the ResNet CLI's --clip-grad, the LM CLI's
# --dist --optimizer adamw --emulate_node 2, a dynamic loss-scale drill
LM_EMU = dict(world=2, emulate_node=2, micro_batch=2, seq=1024, steps=3,
              fmt=(5, 2), seed=0, grad_seed=0, lr=0.01, dist_steps=2,
              deadline=300.0)
# the LM CLI in 16c: the serving width but a 256-token vocabulary: the
# Markov table of SyntheticText at 32000 costs ~17 s a process (phase 10f
# builds it once)
LM_EMU_CLI_VOCAB = 256
# 16c's drill: ResNet-18/CIFAR at the training slice's W x 128, SGD
# momentum 0.9 without weight decay at a constant power-of-two rate (the
# static run divides it by the scale exactly), the e5m2 faithful reduce
# WITHOUT APS: the configuration dynamic scaling is for (APS shifts each
# leaf itself).  In fp32 ResNet-18's gradients at init (largest ~0.1) reach
# fp32's max at no power-of-two scale; on the e5m2 wire every value from
# 2^16 up casts to Inf.  The scale starts 4x past the power of two at which
# the largest element of batch 0's per-rank gradients reaches 2^16, so the
# first steps overflow the wire
DRILL = dict(steps=8, growth_interval=2, lr=2.0 ** -4, fmt=(5, 2),
             overflow_at=2.0 ** 16, max_scale=2.0 ** 127)


def lm_emulate_design(n_layers: int, w: int, n: int, sizes: list,
                      buckets: int, sr: bool = False) -> dict:
    """The kernel launches one LM step makes at W ranks x N micro-batches:
    per rank and micro-batch and layer, three K8 GEMMs for each of wi and
    wo_mlp, one K9 and one K10; every rank's emulate-node reduce
    (`emulate_design`) and the faithful APS reduce (`reduce_design`; the
    health counters observe the APS cast and add none)."""
    want = reduce_design("faithful", sr, False, w, len(sizes), buckets)
    for k, v in emulate_design(n, sr, sizes).items():
        want[k] += w * v
    want.update(qgemm_faithful=6 * n_layers * w * n,
                flash_gqa_fwd=n_layers * w * n,
                flash_gqa_bwd=n_layers * w * n)
    return want


def lm_emu_batches(world: int, steps: int) -> list:
    """The global batches of phase 16 at ``world`` ranks: W x N x B
    sequences of seeded random tokens (phase 10's draw)."""
    E = LM_EMU
    return lm_batches(LM_MODEL["vocab_size"], steps,
                      world * E["emulate_node"] * E["micro_batch"],
                      E["seq"], E["seed"])


def lm_emu_build(device, mesh, fused=None, **step_kw):
    """The phase's LM (seed 0, LM_PATH), SGD momentum 0.9 at LM_EMU's
    constant rate and its step at ``emulate_node`` N, APS e5m2,
    ``quant_stats``."""
    from cpd_tpu_torch.train import create_train_state, sgd
    from cpd_tpu_torch.train.lm import make_lm_train_step

    E = LM_EMU
    model = lm_model(device, E["seed"], **LM_PATH)
    opt = sgd(lambda s: E["lr"], momentum=0.9)
    state = create_train_state(model, opt)
    kw = dict(emulate_node=E["emulate_node"], use_aps=True,
              grad_exp=E["fmt"][0], grad_man=E["fmt"][1],
              grad_seed=E["grad_seed"], quant_stats=True, fused=fused)
    kw.update(step_kw)
    return model, opt, state, make_lm_train_step(model, opt, mesh, **kw)


def state_digest(state) -> str:
    """sha256 of every tensor of a train state (weights, then the
    optimizer's), its bytes on the host."""
    import hashlib

    import torch

    from cpd_tpu_torch.parallel.integrity import tensor_leaves

    h = hashlib.sha256()
    for t in tensor_leaves(state):
        h.update(t.detach().contiguous().view(-1).view(
            torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def lm_emu_steps(device, mesh, batches, fused=None, digest_at=(-1,),
                 **step_kw) -> dict:
    """Steps of `lm_emu_build`'s step, one per batch, each process handed
    its rows (`local_rows`): the metrics of each step (host floats), the
    state's digest after the steps ``digest_at`` (indices into
    ``batches``; -1 the last), host seconds per step and the launches."""
    import torch

    from cpd_tpu_torch.obs.timing import now
    from cpd_tpu_torch.parallel.dist import local_rows

    model, opt, state, step = lm_emu_build(device, mesh, fused, **step_kw)
    reset_counts()
    out = dict(metrics=[], digests={}, secs=[])
    want = {i % len(batches) for i in digest_at}
    for i, (toks, tgts) in enumerate(batches):
        torch.cuda.synchronize()
        t0 = now()
        state, m = step(state, local_rows(toks, mesh),
                        local_rows(tgts, mesh))
        metrics = {k: float(v) for k, v in m.items()}
        torch.cuda.synchronize()
        out["secs"].append(now() - t0)
        out["metrics"].append(metrics)
        if i in want:
            out["digests"][i] = state_digest(state)
    out["launches"] = read_counts()
    out.update(model=model, opt=opt, state=state, step=step)
    return out


def lm_emu_library(device) -> dict:
    """16a: the library step at W = 2 x N = 2 through the kernels (the
    design's launches, finite losses within ``LM_LOSS_BAND`` of ln V at
    step 0, ``prec_wire_total`` W x the parameter count), one step from
    the same start through the plain versions of the reduce kernels
    (``fused=False``: the same metrics and state bitwise), the split and
    a profiled step; then one SR step, kernels vs plain, bitwise."""
    import torch

    from cpd_tpu_torch.obs.timing import now
    from cpd_tpu_torch.parallel.dist import sum_gradients
    from cpd_tpu_torch.parallel.emulate import emulate_node_reduce
    from cpd_tpu_torch.parallel.mesh import data_parallel_mesh
    from cpd_tpu_torch.parallel.overlap import (DEFAULT_BUCKET_ELEMS,
                                                bucket_layout)
    from cpd_tpu_torch.train import fp32_numerics
    from cpd_tpu_torch.train.lm import as_tokens, lm_local_gradients

    E = LM_EMU
    w, n, fmt = E["world"], E["emulate_node"], E["fmt"]
    layers, vocab = LM_MODEL["n_layers"], LM_MODEL["vocab_size"]
    mesh = data_parallel_mesh(w, device)
    batches = lm_emu_batches(w, E["steps"])
    marks = [now()]
    # digests after step 1 (the plain step's) and after 16b's last step
    run = lm_emu_steps(device, mesh, batches,
                       digest_at=(0, E["dist_steps"] - 1))
    marks.append(now())
    model, state = run["model"], run["state"]
    sizes = [p.numel() for p in model.parameters()]
    n_buckets = len(bucket_layout(sizes, DEFAULT_BUCKET_ELEMS))
    design = {k: E["steps"] * v for k, v in lm_emulate_design(
        layers, w, n, sizes, n_buckets).items()}
    if run["launches"] != design:
        raise AssertionError(f"16a launches {run['launches']} != the "
                             f"design's {design}")
    losses = [m["loss"] for m in run["metrics"]]
    if not all(math.isfinite(v) for v in losses) or not (
            abs(losses[0] - math.log(vocab)) <= LM_LOSS_BAND):
        raise AssertionError(f"16a losses {losses}: not finite, or step 0 "
                             f"not within {LM_LOSS_BAND} of ln {vocab}")
    total = w * sum(sizes)
    for i, m in enumerate(run["metrics"]):
        if m["prec_wire_total"] != total or m["prec_aps_bad"] != 0:
            raise AssertionError(f"16a step {i}: prec_wire_total "
                                 f"{m['prec_wire_total']} (design W x "
                                 f"parameters = {total}), prec_aps_bad "
                                 f"{m['prec_aps_bad']}")
    # one step from the same start through the plain versions
    plain = lm_emu_steps(device, mesh, batches[:1], fused=False)
    marks.append(now())
    plain_s = sum(plain["secs"])
    if (plain["metrics"][0], plain["digests"][0]) != (run["metrics"][0],
                                                      run["digests"][0]):
        raise AssertionError(f"16a: one step through the plain versions "
                             f"{plain['metrics'][0]} (state "
                             f"{plain['digests'][0][:16]}) differs from the "
                             f"kernels' {run['metrics'][0]} "
                             f"({run['digests'][0][:16]})")
    del plain

    # the split of a step (after the checks: it moves the weights)
    toks, tgts = as_tokens(*batches[0], device)
    split_marks = []
    with fp32_numerics():
        torch.cuda.synchronize()
        split_marks.append(now())
        grads = lm_local_gradients(model, toks, tgts, mesh, 0.0, n)[0]
        torch.cuda.synchronize()
        split_marks.append(now())
        local = [emulate_node_reduce(g, n, True, fmt[0], fmt[1])
                 for g in grads]
        del grads
        torch.cuda.synchronize()
        split_marks.append(now())
        red, _ = sum_gradients(local, mesh, use_aps=True, grad_exp=fmt[0],
                               grad_man=fmt[1], mode="faithful", stats=True)
        del local
        torch.cuda.synchronize()
        split_marks.append(now())
        run["opt"].apply(red[0], state.opt_state, state.params)
        torch.cuda.synchronize()
        split_marks.append(now())
    del red
    split = dict(zip(("fwd_bwd_ms", "emulate_ms", "reduce_ms", "update_ms"),
                     ((b - a) * 1e3 for a, b in zip(split_marks,
                                                    split_marks[1:]))))
    marks.append(now())
    prof = step_profile(run["step"], state, batches[0])
    del run["model"], run["state"], run["step"], run["opt"], model, state
    torch.cuda.empty_cache()
    marks.append(now())

    # one SR step, kernels vs the plain versions
    sr_runs = [lm_emu_steps(device, mesh, batches[:1], fused=fused,
                            grad_rounding="stochastic")
               for fused in (None, False)]
    marks.append(now())
    sr_design = lm_emulate_design(layers, w, n, sizes, n_buckets, sr=True)
    if sr_runs[0]["launches"] != sr_design:
        raise AssertionError(f"16a SR launches {sr_runs[0]['launches']} != "
                             f"the design's {sr_design}")
    if (sr_runs[0]["metrics"], sr_runs[0]["digests"]) != (
            sr_runs[1]["metrics"], sr_runs[1]["digests"]):
        raise AssertionError(f"16a SR step: kernels {sr_runs[0]['metrics']} "
                             f"vs plain {sr_runs[1]['metrics']}, states "
                             f"{[r['digests'] for r in sr_runs]}")
    del sr_runs[1]
    timed = run["secs"][1:]
    tokens = len(batches[0][0]) * E["seq"]
    out = dict(
        world=w, emulate_node=n, micro_batch=E["micro_batch"],
        seq=E["seq"], tokens_per_step=tokens, steps=E["steps"],
        losses=losses, step_ms=sum(timed) / len(timed) * 1e3,
        tokens_per_s=tokens / (sum(timed) / len(timed)),
        plain_step_ms=plain_s * 1e3, n_leaves=len(sizes),
        n_buckets=n_buckets, parameters=sum(sizes),
        launches_per_step={k: v // E["steps"]
                           for k, v in run["launches"].items() if v},
        sr_launches_per_step={k: v for k, v in
                              sr_runs[0]["launches"].items() if v},
        sr_loss=sr_runs[0]["metrics"][0]["loss"],
        health={k: v for k, v in run["metrics"][-1].items()
                if k.startswith("prec_")},
        **split,
        profile={k: prof.get(k) for k in ("device_busy_ms",
                                          "kernel_launches", "top_kernels")},
        seconds=dict(zip(("kernels", "plain", "split", "profile", "sr"),
                         (b - a for a, b in zip(marks, marks[1:])))),
        metrics=run["metrics"], digests=run["digests"])
    print("lm emulate 16a: " + json.dumps(
        {k: v for k, v in out.items() if k not in ("metrics", "digests")}),
        flush=True)
    print(f"lm emulate 16a: the serving-width LM at W={w} x emulate_node {n}"
          f" x {E['micro_batch']} x {E['seq']}: launches per step as "
          "designed (lm_emulate_design), one step kernels == the plain "
          "versions bitwise (metrics, prec_*, weights, momentum), "
          f"prec_wire_total {total}; one SR step kernels == plain bitwise; "
          f"step {out['step_ms']:.2f} ms, emulate_ms "
          f"{split['emulate_ms']:.2f}", flush=True)
    return out


def lm_dist_rank(device, ports: tuple, cards: int, cli_argv: list) -> dict:
    """One process of 16b (`parallel.launch.spawn` starts max(2, cards)):
    (a) processes 0 and 1 join a gloo group on ``ports[0]`` and run
    `LM_EMU`'s steps on their rows of the global batches, the faithful
    arm and the RTNE ring arm with ``verify_reduce``, sharing the card;
    then (b) processes 0..cards-1 join an nccl group on ``ports[1]``, one
    card each, run the faithful arm, and the LM CLI at ``cli_argv`` under
    ``--dist``.  Each group is destroyed after its part."""
    import torch
    import torch.distributed as dist

    from cpd_tpu_torch.obs.timing import now
    from cpd_tpu_torch.parallel.dist import dist_init
    from cpd_tpu_torch.parallel.mesh import ProcessMesh

    rank = int(os.environ["RANK"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = dict(rank=rank, parts={})
    for part, backend, w, port in (("a", "gloo", LM_EMU["world"], ports[0]),
                                   ("b", "nccl", cards, ports[1])):
        if rank >= w:
            continue
        marks = [now()]
        os.environ.update(WORLD_SIZE=str(w), LOCAL_WORLD_SIZE=str(w))
        dist_init(backend, rank=rank, world_size=w, local_rank=rank,
                  init_method=f"tcp://localhost:{port}")
        mesh = ProcessMesh(device)
        batches = lm_emu_batches(w, LM_EMU["dist_steps"])
        res = dict(world=w, backend=backend, staged=mesh.staged, arms={})
        marks.append(now())
        arms = {"faithful": {}}
        if part == "a":
            arms["ring-verify"] = dict(mode="ring", verify_reduce=True)
        for name, kw in arms.items():
            r = lm_emu_steps(device, mesh, batches, **kw)
            res["arms"][name] = dict(
                metrics=r["metrics"], digests=r["digests"], secs=r["secs"],
                launches={k: v for k, v in r["launches"].items() if v})
            del r
            marks.append(now())
        if part == "b":
            from cpd_tpu_torch.examples.lm import train as cli

            reset_counts()
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                cres = cli.run(cli.parse_args(cli_argv), device=mesh.device)
            res["cli"] = dict(cres, printed=text.getvalue(),
                              launches={k: v for k, v in
                                        read_counts().items() if v})
            marks.append(now())
        dist.destroy_process_group()
        res["seconds"] = [b - a for a, b in zip(marks, marks[1:])]
        out["parts"][part] = res
    return out


def lm_emu_cli_argv() -> list:
    """16c's LM CLI: the serving width at LM_EMU_CLI_VOCAB, phase 10f's
    path, ``--dist --dist-backend nccl --optimizer adamw --emulate_node
    2``, 2 iterations."""
    E = LM_EMU
    return ["--vocab-size", str(LM_EMU_CLI_VOCAB), "--d-model",
            str(LM_MODEL["d_model"]), "--n-layers",
            str(LM_MODEL["n_layers"]), "--n-heads", str(LM_MODEL["n_heads"]),
            "--n-kv-heads", str(LM_MODEL["n_kv_heads"]), "--seq-len",
            str(E["seq"]), "--batch-size", str(E["micro_batch"]),
            "--attn-impl", "flash", "--flash-bwd", "pallas", "--ffn-exp",
            str(LM_PATH["ffn_exp"]), "--ffn-man", str(LM_PATH["ffn_man"]),
            "--ffn-mode", "faithful", "--use_APS", "--grad_exp",
            str(E["fmt"][0]), "--grad_man", str(E["fmt"][1]),
            "--emulate_node", str(E["emulate_node"]), "--optimizer",
            "adamw", "--max-iter", "2", "--print-freq", "1", "--dist",
            "--dist-backend", "nccl"]


def lm_dist(device, library: dict) -> dict:
    """16b: one spawn of max(2, cards) processes (`lm_dist_rank`): 2 gloo
    ranks sharing the card, then one nccl rank a card, each rank's
    metrics and final state digest bitwise the `LocalMesh` of the same W
    on the same global batches (16a's steps for the gloo faithful arm,
    the others run here); the LM CLI under ``--dist`` (16c) in the nccl
    ranks."""
    import torch

    from cpd_tpu_torch.obs.timing import now
    from cpd_tpu_torch.parallel.launch import _free_port
    from cpd_tpu_torch.parallel.mesh import data_parallel_mesh

    E = LM_EMU
    steps = E["dist_steps"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    marks = [now()]
    last = steps - 1
    refs = {("faithful", E["world"]): dict(
        metrics=library["metrics"][:steps],
        digests={last: library["digests"][last]})}
    r = lm_emu_steps(device, data_parallel_mesh(E["world"], device),
                     lm_emu_batches(E["world"], steps), mode="ring",
                     verify_reduce=True)
    refs[("ring-verify", E["world"])] = dict(metrics=r["metrics"],
                                             digests=r["digests"])
    cards = min(torch.cuda.device_count(), DIST["max_cards"])
    r = lm_emu_steps(device, data_parallel_mesh(cards, device),
                     lm_emu_batches(cards, steps))
    refs[("faithful", cards)] = dict(metrics=r["metrics"],
                                     digests=r["digests"])
    del r
    torch.cuda.empty_cache()
    marks.append(now())
    ports = {_free_port()}
    while len(ports) < 2:
        # one rendezvous a group: the gloo pair's, then the nccl ranks'
        ports.add(_free_port())
    ranks = POOL.spawn(lm_dist_rank, max(E["world"], cards),
                  args=(device, tuple(sorted(ports)), cards,
                        lm_emu_cli_argv()),
                  timeout=E["deadline"], env={"NCCL_DEBUG": "WARN"})
    marks.append(now())
    out = dict(seconds=dict(references=marks[1] - marks[0],
                            spawn=marks[2] - marks[1]))
    for part in ("a", "b"):
        held = [rk["parts"][part] for rk in ranks if part in rk["parts"]]
        w, backend = held[0]["world"], held[0]["backend"]
        for r, got_part in enumerate(held):
            for name, got in got_part["arms"].items():
                want = refs[(name, w)]
                if (got["metrics"], got["digests"]) != (want["metrics"],
                                                        want["digests"]):
                    raise AssertionError(
                        f"16b {backend} rank {r} {name}: metrics "
                        f"{got['metrics']} (state {got['digests']}) differ "
                        f"from the LocalMesh W={w}'s {want['metrics']} "
                        f"({want['digests']})")
                if name == "ring-verify" and any(
                        m["reduce_ok"] != 1.0 for m in got["metrics"]):
                    raise AssertionError(f"16b rank {r}: the verified ring "
                                         f"failed {got['metrics']}")
                if got["launches"] != held[0]["arms"][name]["launches"]:
                    raise AssertionError(f"16b {backend} {name}: rank {r}'s "
                                         "launches differ from rank 0's")
        out[part] = dict(
            backend=backend, world=w, staged=held[0]["staged"],
            step_ms={name: [x * 1e3 for x in a["secs"]]
                     for name, a in held[0]["arms"].items()},
            launches_per_rank={name: {k: v // steps for k, v in
                                      a["launches"].items()}
                               for name, a in held[0]["arms"].items()},
            rank_seconds=[p["seconds"] for p in held])
        print(f"lm dist 16b{part}: W={w} {backend} process(es)"
              f"{' sharing the card' if held[0]['staged'] else ''}, "
              f"{steps} steps of each arm at the serving width, every rank's "
              f"metrics and state bitwise the LocalMesh W={w}; "
              + json.dumps(out[part]), flush=True)
    clis = [rk["parts"]["b"]["cli"] for rk in ranks if "b" in rk["parts"]]
    for c in clis:
        if (c["diverged"] or c["step"] != 2 or not math.isfinite(c["loss"])
                or (c["loss"], c["val"]) != (clis[0]["loss"],
                                             clis[0]["val"])):
            raise AssertionError("16c LM CLI under --dist nccl: " + str(
                [dict(x, printed=None) for x in clis]))
    if "Iter: [2/2]" not in clis[0]["printed"] or any(
            c["printed"] for c in clis[1:]):
        raise AssertionError("16c LM CLI: rank 0 did not print its "
                             "iterations, or another rank printed")
    out["cli"] = dict(argv=" ".join(lm_emu_cli_argv()),
                      loss=clis[0]["loss"], val=clis[0]["val"],
                      seconds=clis[0]["seconds"],
                      launches=clis[0]["launches"])
    print(f"lm cli 16c: --vocab-size {LM_EMU_CLI_VOCAB} (not 32000: its "
          "Markov table costs ~17 s a process) under --dist nccl "
          "--optimizer adamw --emulate_node 2: " + json.dumps(out["cli"]),
          flush=True)
    print("lm dist 16b seconds: " + json.dumps(out["seconds"]), flush=True)
    return out


def clip_cli(device, root: str) -> dict:
    """16c: the ResNet-18 CLI at the training slice's W x 128 on phase
    14's data, faithful APS e5m2 with ``--clip-grad 1.0``, 3 iterations:
    it finishes with a finite loss, its optimizer is the clip in front of
    SGD, and the global norm the clip read each step is printed with
    whether it clipped."""
    import cpd_tpu_torch.train as ttrain
    from cpd_tpu_torch.obs.timing import now
    from cpd_tpu_torch.train import optim as toptim

    norms: list = []
    built: list = []
    real_norm, real_make = toptim.global_norm, ttrain.make_optimizer

    def recorded_norm(grads):
        g = real_norm(grads)
        norms.append(float(g))
        return g

    def recorded_make(*a, **kw):
        built.append(real_make(*a, **kw))
        return built[-1]

    toptim.global_norm, ttrain.make_optimizer = recorded_norm, recorded_make
    reset_counts()
    t0 = now()
    try:
        res, _ = run_cli(
            ["--mode", "faithful", "--use_APS", "--grad_exp", "5",
             "--grad_man", "2", "--batch_size", str(TRAIN["per_rank_batch"]),
             "--max-iter", "3", "--clip-grad", "1.0", "--data-root", root,
             "--save_path", save_path("clip_cli"), "--print_freq", "1",
             "--val_freq", "3"], TRAIN["world"], device)
    finally:
        toptim.global_norm, ttrain.make_optimizer = real_norm, real_make
    seconds = now() - t0
    if (res["diverged"] or res["step"] != 3 or not math.isfinite(res["loss"])
            or len(built) != 1 or type(built[0]).__name__ !=
            "ClipByGlobalNorm" or built[0].max_norm != 1.0
            or len(norms) != 3):
        raise AssertionError(f"16c --clip-grad CLI: {res}, optimizers "
                             f"{built}, norms {norms}")
    out = dict(world=TRAIN["world"], seconds=seconds, loss=res["loss"],
               global_norms=norms, clipped=[g >= 1.0 for g in norms],
               launches={k: v for k, v in read_counts().items() if v})
    print("clip cli 16c: ResNet-18 CLI --clip-grad 1.0 at W="
          f"{TRAIN['world']} x {TRAIN['per_rank_batch']}, 3 iterations: "
          + json.dumps(out), flush=True)
    return out


def all_finite_check(device) -> dict:
    """16c: `train.scaling.all_finite` on the card (one multi-tensor
    ``_foreach_norm(inf)`` over the leaves, then one vector test) over
    ResNet-18/CIFAR's 62 gradient shapes: True on finite leaves (3e38
    among them), False with one NaN, +Inf or -Inf anywhere; its kernel
    launches (a profiled call) and device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cpd_tpu_torch.models.resnet_cifar import resnet18_cifar
    from cpd_tpu_torch.train.scaling import all_finite

    shapes = [p.shape for p in resnet18_cifar(device=device).parameters()]
    gen = torch.Generator(device=device).manual_seed(3)
    leaves = [torch.randn(s, generator=gen, device=device) for s in shapes]
    leaves[7].view(-1)[5] = 3e38
    if not bool(all_finite(leaves)):
        raise AssertionError("all_finite: finite leaves read non-finite")
    for bad in (math.nan, math.inf, -math.inf):
        for i in (0, 31, len(leaves) - 1):
            flat = leaves[i].view(-1)
            j = flat.numel() // 2 + 1
            keep = flat[j].clone()
            flat[j] = bad
            if bool(all_finite(leaves)):
                raise AssertionError(f"all_finite: {bad} in leaf {i} read "
                                     "finite")
            flat[j] = keep
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        all_finite(leaves)
        torch.cuda.synchronize()
    kernels = profiled_kernels(prof)
    out = dict(leaves=len(leaves), elements=sum(t.numel() for t in leaves),
               launches=sum(e.count for e in kernels) if kernels else None,
               kernels=[[e.key[:60], e.count] for e in kernels],
               ms=time_ms(lambda: all_finite(leaves), 20))
    print("all_finite 16c: " + json.dumps(out), flush=True)
    return out


def drill_batches(root: str, steps: int) -> list:
    """The first ``steps`` global batches of W x 128 over phase 14's
    CIFAR-10 tree at ``root``: the port's sampler (seed 0) and
    augmentation, as the CLI draws them."""
    from cpd_tpu_torch.data import (CIFAR10Pipeline,
                                    DistributedGivenIterationSampler,
                                    load_cifar10)

    global_batch = TRAIN["world"] * TRAIN["per_rank_batch"]
    train_x, train_y, _, _ = load_cifar10(root)
    pipe = CIFAR10Pipeline(train_x, train_y, global_batch, augment=True,
                           cutout=0)
    sampler = DistributedGivenIterationSampler(len(train_y), steps,
                                               global_batch, seed=0)
    return [pipe.batch(idx, seed=0) for idx in sampler.batches()]


def loss_scale_drill(device, root: str) -> dict:
    """16c: ``make_train_step(loss_scale="dynamic")`` on full-width
    ResNet-18/CIFAR at the training slice's W x 128 on phase 14's data
    under ``root``, the e5m2 faithful
    reduce without APS, SGD momentum 0.9 (no decay) at a power-of-two
    rate, the scale starting 4x past the power of two at which the
    largest element of batch 0's gradients casts to Inf (DRILL): each
    step's scale and whether it applied (the weights moved) printed; the
    scale and ``good_steps`` after every step as GradScaler's policy
    gives them from those verdicts, step 0 skipped, at least one applied
    step and one growth; the params after the first
    applied steps (at scale S) bitwise a static ``loss_scale=S`` run of
    the same batches from the same start whose rate is divided by S (the
    unscale by a power of two is exact)."""
    import torch

    from cpd_tpu_torch.models.resnet_cifar import resnet18_cifar
    from cpd_tpu_torch.obs.timing import now
    from cpd_tpu_torch.parallel.mesh import data_parallel_mesh
    from cpd_tpu_torch.train import (as_batch, create_train_state,
                                     fp32_numerics, local_gradients,
                                     make_train_step, sgd,
                                     with_dynamic_loss_scale)

    D = DRILL
    mesh = data_parallel_mesh(TRAIN["world"], device)
    batches = drill_batches(root, D["steps"])
    kw = dict(mode="faithful", grad_exp=D["fmt"][0], grad_man=D["fmt"][1])

    def build(opt, scale):
        gen = torch.Generator(device=device).manual_seed(TRAIN["seed"])
        model = resnet18_cifar(device=device).init_weights(gen)
        state = create_train_state(model, opt)
        return model, state, make_train_step(model, opt, mesh,
                                             loss_scale=scale, **kw)

    # the largest element of batch 0's per-rank gradients at scale 1
    probe, _, _ = build(sgd(lambda s: 0.0), 1.0)
    with fp32_numerics():
        grads = local_gradients(probe, *as_batch(*batches[0], device),
                                mesh)[0]
    top = max(float(g.abs().max()) for rank in grads for g in rank)
    del probe, grads
    over = math.ceil(math.log2(D["overflow_at"] / top))
    init_scale = 2.0 ** (over + 1)
    opt = with_dynamic_loss_scale(
        sgd(lambda s: D["lr"], momentum=0.9), init_scale=init_scale,
        growth_interval=D["growth_interval"], max_scale=D["max_scale"])
    model, state, step = build(opt, "dynamic")
    log, after = [], []
    for i, (bx, by) in enumerate(batches):
        before = [p.detach().clone() for p in model.parameters()]
        scale = state.opt_state.scale
        torch.cuda.synchronize()
        t0 = now()
        state, m = step(state, bx, by)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        ms = (now() - t0) * 1e3
        applied = not all(same_bits(a, b.detach()) for a, b in
                          zip(before, model.parameters()))
        after.append(([p.detach().clone() for p in model.parameters()],
                      [b.clone() for b in
                       state.opt_state.inner.momentum_buf]))
        log.append(dict(step=i, scale=scale, applied=applied, loss=loss,
                        ms=ms, scale_after=state.opt_state.scale,
                        good_steps=state.opt_state.good_steps))
        print(f"loss scale drill 16c: step {i} scale 2^"
              f"{math.log2(scale):g} {'applied' if applied else 'SKIPPED'}"
              f" loss {loss:.5f} -> scale 2^"
              f"{math.log2(state.opt_state.scale):g} good_steps "
              f"{state.opt_state.good_steps} ({ms:.2f} ms)", flush=True)
    del before
    # GradScaler's policy replayed from the verdicts
    s, g, grew = init_scale, 0, 0
    for e in log:
        if e["scale"] != s:
            raise AssertionError(f"drill step {e['step']}: scale "
                                 f"{e['scale']} != the policy's {s}")
        if e["applied"]:
            g += 1
            if g >= D["growth_interval"]:
                s, g, grew = min(s * 2, D["max_scale"]), 0, grew + 1
        else:
            s, g = max(s / 2, 1.0), 0
        if (e["scale_after"], e["good_steps"]) != (s, g):
            raise AssertionError(f"drill step {e['step']}: scale "
                                 f"{e['scale_after']} good {e['good_steps']}"
                                 f" != the policy's {s}, {g}")
    applied = [e for e in log if e["applied"]]
    if log[0]["applied"] or not applied or not grew:
        raise AssertionError(f"drill: step 0 applied, or no applied step "
                             f"or no growth in {log}")
    # the first applied steps at their scale S, against a static S run
    first = applied[0]
    s1, run = first["scale"], []
    for e in log[first["step"]:first["step"] + D["growth_interval"]]:
        if not e["applied"] or e["scale"] != s1:
            break
        run.append(e)
    dyn = after[run[-1]["step"]]
    del after
    sm, sstate, sstep = build(sgd(lambda s: D["lr"] / s1, momentum=0.9), s1)
    for e in run:
        sstate, _ = sstep(sstate, *batches[e["step"]])
    for i, (a, b) in enumerate(zip(dyn[0], sm.parameters())):
        if not same_bits(a, b.detach()):
            raise AssertionError(f"drill: param {i} after the first applied "
                                 f"steps differs from the static 2^"
                                 f"{math.log2(s1):g} run")
    for i, (a, b) in enumerate(zip(dyn[1], sstate.opt_state.momentum_buf)):
        if not same_bits(a * s1, b):
            raise AssertionError(f"drill: momentum {i} x S differs from the "
                                 "static run's")
    out = dict(world=TRAIN["world"], steps=len(log), log=log,
               fmt=D["fmt"], largest_gradient=top,
               overflow_scale_log2=over, init_scale_log2=over + 1,
               skips=len(log) - len(applied), growths=grew,
               first_applied=first["step"], first_scale_log2=math.log2(s1),
               static_steps=[e["step"] for e in run])
    print("loss scale drill 16c: " + json.dumps(
        {k: v for k, v in out.items() if k != "log"}) + "; the policy "
          "replayed exactly; the params after the first applied steps "
          "bitwise the static-scale run, its momentum S x the dynamic "
          "one's", flush=True)
    return out


def switches_phase(device) -> dict:
    """Phase 16: 16a, 16b and 16c (module docstring)."""
    import torch

    from cpd_tpu_torch.obs.timing import now

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    marks = [now()]
    out = {"a": lm_emu_library(device)}
    marks.append(now())
    out["b"] = lm_dist(device, out["a"])
    marks.append(now())
    root = dist_cifar_root()
    out["c"] = dict(clip=clip_cli(device, root),
                    all_finite=all_finite_check(device),
                    drill=loss_scale_drill(device, root))
    marks.append(now())
    out["seconds"] = dict(zip("abc", (b - a for a, b in
                                      zip(marks, marks[1:]))))
    out["seconds"]["all"] = marks[-1] - marks[0]
    print("switches seconds: " + json.dumps(out["seconds"]), flush=True)
    return out


# -- phase 17: overlap and ZeRO-1/2 ---------------------------------------

ZERO = dict(world=4, per_rank_batch=128, steps=2, fmt=(5, 2), seed=24,
            bucket_elems=1 << 22, cli_bucket_elems=1 << 20, block=128,
            grad_seed=0, dist_world=2, dist_batch=128, dist_iters=2,
            nccl_steps=2, deadline=420.0, offs_seed=7)
# the arms of 17a: name -> the step's keywords, the updater (None: the
# replicated optimizer) and the arm it is held to bitwise (LARS: within
# LARS_TOL); an arm named ``<x>+overlap`` runs <x> with overlap_reduce
_ZERO_BASE = {
    "faithful": dict(mode="faithful"),
    "ring": dict(mode="ring"),
    "ring-blocked": dict(mode="ring", block_scale=True, verify_reduce=True),
    "ring-blocked-sr-kahan": dict(mode="ring", block_scale=True,
                                  verify_reduce=True, use_kahan=True,
                                  grad_rounding="stochastic"),
    "faithful-sr": dict(mode="faithful", grad_rounding="stochastic"),
    "faithful-kahan": dict(mode="faithful", use_kahan=True),
    "faithful-lars": dict(mode="faithful", optimizer="lars"),
    "zero1": dict(mode="faithful", zero="zero1"),
    "zero1-lars": dict(mode="faithful", zero="zero1", optimizer="lars"),
    "zero2": dict(mode="faithful", zero="zero2"),
    "zero2-sr": dict(mode="faithful", zero="zero2",
                     grad_rounding="stochastic"),
    "zero2-kahan": dict(mode="faithful", zero="zero2", use_kahan=True),
    "zero2-blocked-sr": dict(mode="faithful", zero="zero2",
                             block_scale=True,
                             grad_rounding="stochastic"),
}
# arm -> (the arm it equals, bitwise or "lars")
ZERO_PAIRS = {
    "faithful+overlap": ("faithful", "bitwise"),
    "ring-blocked+overlap": ("ring-blocked", "bitwise"),
    "ring-blocked-sr-kahan+overlap": ("ring-blocked-sr-kahan", "bitwise"),
    "zero1": ("faithful", "bitwise"),
    "zero1-lars": ("faithful-lars", "lars"),
    "zero2": ("faithful", "bitwise"),
    "zero2+overlap": ("faithful", "bitwise"),
    "zero2-sr": ("faithful-sr", "bitwise"),
    "zero2-sr+overlap": ("faithful-sr", "bitwise"),
    "zero2-kahan": ("faithful-kahan", "bitwise"),
    "zero2-kahan+overlap": ("faithful-kahan", "bitwise"),
    "zero2-blocked-sr+overlap": ("zero2-blocked-sr", "bitwise"),
}
ZERO_ARMS = ("faithful", "ring-blocked", "ring-blocked-sr-kahan",
             "faithful-sr", "faithful-kahan", "faithful-lars",
             "zero2-blocked-sr") + tuple(ZERO_PAIRS)
# 17b's nccl ranks: the checked ZeRO-2 overlap arm last, the others timed
ZERO_NCCL_ARMS = ("faithful", "faithful+overlap", "ring", "ring+overlap",
                  "zero2", "zero2+overlap")
# the reference's ZeRO x LARS tolerance (tests/test_zero.py)
LARS_TOL = dict(rtol=1e-6, atol=1e-7)
# backward kernels (cuDNN convolutions and their GEMMs) by name
COMPUTE_MARKS = ("conv", "gemm", "xmma", "cutlass", "wgrad", "dgrad",
                 "implicit")


def shared_setup() -> tuple:
    """A trim of the whole run's shared setup: the synthetic CIFAR-10 set
    that phases and CLI runs regenerate (~5 s a time on the card's host)
    is made once per arguments, each caller handed its own copy; the LM
    corpus's Markov table at 32000 tokens (~17 s a build), which phases
    10f and 11c build, once; a library's SASS (`ops.build.sass`, one
    `cuobjdump` of the whole library) once a library.  Returns (the
    counts, a function that puts the Markov table back to one build a
    corpus and frees it)."""
    from cpd_tpu_torch import data as tdata
    from cpd_tpu_torch.data import cifar, lm_data
    from cpd_tpu_torch.ops import build

    counts = dict(cifar_made=0, cifar_reused=0, text_made=0,
                  text_reused=0, sass_made=0, sass_reused=0)
    real_sass = build.sass
    listings: dict = {}

    def shared_sass(name: str) -> str:
        if name in listings:
            counts["sass_reused"] += 1
        else:
            listings[name] = real_sass(name)
            counts["sass_made"] += 1
        return listings[name]

    build.sass = shared_sass
    real_cifar, real_text = cifar.synthetic_cifar10, lm_data.SyntheticText
    sets: dict = {}
    tables: dict = {}

    def shared_cifar(n_train: int = 50000, n_test: int = 10000,
                     seed: int = 0):
        key = (n_train, n_test, seed)
        if key in sets:
            counts["cifar_reused"] += 1
        else:
            sets[key] = real_cifar(n_train, n_test, seed)
            counts["cifar_made"] += 1
        return tuple(a.copy() for a in sets[key])

    class SharedText(real_text):
        """`SyntheticText` whose Markov table is built once a (vocabulary,
        seed)."""

        def __init__(self, n: int = 4096, seq_len: int = 128,
                     vocab_size: int = 256, seed: int = 0):
            key = (vocab_size, seed)
            if key in tables:
                counts["text_reused"] += 1
                super().__init__(n, seq_len, 1, seed)     # a 1-token table
                self.vocab_size, self._cum = vocab_size, tables[key]
            else:
                counts["text_made"] += 1
                super().__init__(n, seq_len, vocab_size, seed)
                tables[key] = self._cum

    cifar.synthetic_cifar10 = tdata.synthetic_cifar10 = shared_cifar
    lm_data.SyntheticText = SharedText

    def text_done():
        lm_data.SyntheticText = real_text
        tables.clear()

    return counts, text_done


def zero_arm(name: str) -> dict:
    """The keywords of one 17a arm (`_ZERO_BASE`, ``+overlap`` added)."""
    base, _, extra = name.partition("+")
    return dict(_ZERO_BASE[base], overlap_reduce=extra == "overlap")


def zero_design(arm: dict, w: int, leaves: int, sizes: list) -> dict:
    """The launches one 17a step makes on a LocalMesh of w ranks (the
    same with overlap on: the taps run the same reduces).  The
    replicated reduce and ZeRO-1's: `reduce_design` (faithful), or
    `blocked_design` (the blocked verified ring; with Kahan its hops are
    the plain blocked casts, their SR bits one `sr_bits` a site, 4 sites
    a hop, and its digests torch ops).  ZeRO-2 per bucket and rank: the
    APS pre-quantize per leaf (K1, or `sr_bits` + K2), then the scan of
    the W received rows, each step K3 (or the offset-array `sr_bits` +
    K4), four each with Kahan; blocked, the casts are torch ops and SR
    draws one offset-array `sr_bits` for the pre-quantize's (W, c)
    payload and one a scan step."""
    from cpd_tpu_torch.parallel.overlap import bucket_layout

    sr = arm.get("grad_rounding") == "stochastic"
    kahan = arm.get("use_kahan", False)
    buckets = len(bucket_layout(sizes, ZERO["bucket_elems"]))
    if arm.get("zero") != "zero2":
        if arm["mode"] == "ring":
            if kahan:
                want = dict.fromkeys(read_counts(), 0)
                want["quantize_cast_sr"] = w * leaves
                want["sr_bits"] = w * leaves + 4 * w * w * buckets
                return want
            return blocked_design(w, leaves, buckets, sr, buckets)
        return reduce_design("faithful", sr, kahan, w, leaves, buckets)
    want = dict.fromkeys(read_counts(), 0)
    scan = w * w * buckets * (4 if kahan else 1)
    if arm.get("block_scale"):
        if sr:
            want["sr_bits"] = want["sr_bits_offsets"] = w * buckets + scan
        return want
    sfx = "_sr" if sr else ""
    want["quantize_cast" + sfx] = w * leaves
    want["quantize_add" + sfx] = scan
    if sr:
        want["sr_bits"] = w * leaves + scan
        want["sr_bits_offsets"] = scan
    return want


def zero_build(device, name: str, mesh, fused, model=None, world=None):
    """The seed-24 ResNet-18/CIFAR (or ``model``), the arm's optimizer or
    ZeRO updater (momentum 0.9, wd 1e-4, the CLI's warmup schedule at
    W x 128 a step) and its step (APS e5m2 at ZERO["bucket_elems"]);
    returns (model, state, step, updater or None)."""
    import torch

    from cpd_tpu_torch.models.resnet_cifar import resnet18_cifar
    from cpd_tpu_torch.parallel import zero as zmod
    from cpd_tpu_torch.train import (TrainState, create_train_state,
                                     make_optimizer, make_train_step,
                                     warmup_step_decay)

    arm = zero_arm(name)
    if model is None:
        gen = torch.Generator(device=device).manual_seed(ZERO["seed"])
        model = resnet18_cifar(device=device).init_weights(gen)
    w = mesh.world
    ipe = math.ceil(TRAIN["n_train"] / (w * ZERO["per_rank_batch"]))
    peak = TRAIN["peak_lr"]
    schedule = warmup_step_decay(peak, 5 * ipe, [40 * ipe, 80 * ipe],
                                 warmup_from=peak / 16.0)
    opt_name = arm.get("optimizer", "sgd")
    kw = dict(mode=arm["mode"], use_aps=True, grad_exp=ZERO["fmt"][0],
              grad_man=ZERO["fmt"][1], use_kahan=arm.get("use_kahan", False),
              grad_rounding=arm.get("grad_rounding", "nearest"),
              grad_seed=ZERO["grad_seed"],
              verify_reduce=arm.get("verify_reduce", False),
              block_scale=arm.get("block_scale", False),
              block_size=ZERO["block"], bucket_elems=ZERO["bucket_elems"],
              overlap_reduce=arm["overlap_reduce"], fused=fused)
    if arm.get("zero"):
        maker = getattr(zmod, f"{arm['zero']}_{opt_name}")
        zkw = dict(momentum=0.9, weight_decay=1e-4)
        if arm["zero"] == "zero2":
            zkw["bucket_elems"] = ZERO["bucket_elems"]
        z = maker(schedule, w, **zkw)
        state = TrainState(0, model, z.init(list(model.parameters()), mesh))
        step = make_train_step(model, None, mesh, **kw, **z.step_kwargs())
        return model, state, step, z
    opt = make_optimizer(opt_name, schedule, momentum=0.9,
                         weight_decay=1e-4)
    return (model, create_train_state(model, opt),
            make_train_step(model, opt, mesh, **kw), None)


def zero_momentum(state, mesh) -> tuple:
    """(the momentum as one flat portable vector on the host, bytes a
    rank holds)."""
    import torch

    from cpd_tpu_torch.parallel.zero import Zero1State, portable_momentum

    opt = state.opt_state
    if isinstance(opt, Zero1State):
        return (portable_momentum(opt, mesh).cpu(),
                4 * opt.momentum[0].numel())
    flat = torch.cat([b.reshape(-1) for b in opt.momentum_buf])
    return flat.cpu(), 4 * flat.numel()


def zero_kernel_timeline(prof) -> list:
    """(start us, name) of every device kernel of a profile, in order."""
    from torch.autograd import DeviceType

    return sorted((e.time_range.start, e.name) for e in prof.events()
                  if e.device_type == DeviceType.CUDA)


def zero_evidence(timeline: list) -> dict:
    """The structural overlap gate on a profiled step: how many backward
    convolution or GEMM kernels start after the first kernel of the
    reduce (`KERNEL_NAMES`' quantize kernels, the `sr_bits` arms)."""
    reduce_marks = tuple(
        n for k, v in KERNEL_NAMES.items()
        if k.startswith(("quantize", "hop_pack", "digest_rows", "sr_bits"))
        for n in ((v,) if isinstance(v, str) else v))
    first = next((i for i, (_, n) in enumerate(timeline)
                  if any(m in n for m in reduce_marks)), None)
    compute = [i for i, (_, n) in enumerate(timeline)
               if any(m in n.lower() for m in COMPUTE_MARKS)]
    after = (0 if first is None else sum(1 for i in compute if i > first))
    return dict(kernels=len(timeline), compute=len(compute),
                first_reduce=first, compute_after_first_reduce=after)


def zero_offset_arm(device) -> dict:
    """The offset-array arm of `sr_bits` (``offset_bits_kernel``) at
    ZeRO-2's shard shape, ResNet-18's largest bucket at W = 4: the scan's
    offsets (a run with the pad's sentinel) and a scattered array that
    wraps past 2^32, bitwise its plain version (`prng.sr_bits_at`), two
    launches bitwise; timed by `queued_ms` (the run arm beside it) beside
    its bound (8 bytes an element; two threefry2x32 an element on the ALU
    pipes, counted in the SASS) and the plain version."""
    import torch

    from cpd_tpu_torch.models.resnet_cifar import resnet18_cifar
    from cpd_tpu_torch.ops import quantize as tq
    from cpd_tpu_torch.parallel.zero import zero2_sgd

    model = resnet18_cifar(device="cpu")
    z = zero2_sgd(lambda s: 0.0, ZERO["world"],
                  bucket_elems=ZERO["bucket_elems"])
    lay = z._layout(list(model.parameters()))
    b = max(range(len(lay.meta)), key=lambda i: lay.meta[i][2])
    a, _, c = lay.meta[b]
    gen = torch.Generator(device=device).manual_seed(ZERO["offs_seed"])
    cases = [lay.bucket_offsets(b, r, device) for r in range(ZERO["world"])]
    cases.append(torch.randint(0, 2**32, (c,), generator=gen,
                               device=device, dtype=torch.int64))
    like = torch.empty(c, device=device)
    err = 0.0
    for offs in cases:
        for key in ((3, 17), (2**32 - 5, 9)):
            got = tq.sr_bits(key, like, offsets=offs)
            again = tq.sr_bits(key, like, offsets=offs)
            want = tq.sr_bits_ref(key, like, offsets=offs)
            if not (same_bits(got, want) and same_bits(got, again)):
                raise AssertionError(f"offset-array sr_bits (n={c}): "
                                     "differs from its plain version")
            err = max(err, max_abs_diff(got, want))
    offs = tq.to_int32_bits(cases[0])
    per = sass_per_element("quantize", "offset_bits_kernel")
    t_ops, pipe = pipe_bound_s(per, c)
    t_bytes = 8 * c / PEAK_BYTES_PER_S
    out = dict(n=c, bucket=b, max_abs_err=err,
               ms=queued_ms(lambda: tq.sr_bits((3, 17), like, offsets=offs),
                            iters=50),
               plain_ms=device_ms(lambda: tq.sr_bits_ref(
                   (3, 17), like, offsets=offs), iters=5),
               run_arm_ms=queued_ms(lambda: tq.sr_bits(
                   (3, 17), like, offset_start=a), iters=50),
               bound_ms=max(t_ops, t_bytes) * 1e3,
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               bound_pipe=pipe, sass_per_element=per)
    print("kernel sr_bits offset arm: bitwise its plain version at ZeRO-2's "
          f"shard shape ({c} elements, bucket {b}, W = {ZERO['world']}) on "
          "every rank's scan offsets with the pad sentinel and on scattered "
          "offsets past 2^32, two launches bitwise; " + json.dumps(out),
          flush=True)
    return out


def zero_local(device) -> dict:
    """17a: every arm of ZERO_ARMS at W = 4 x 128: ZERO["steps"] steps
    through the kernels (losses, launches per step against
    `zero_design`, step ms, the momentum bytes a rank holds) and the
    first step again from the same start through the plain versions
    (bitwise the kernels' first step: weights, BN stats, momentum); each
    pair of ZERO_PAIRS held (bitwise; LARS within LARS_TOL); a profiled
    faithful step with overlap on and off (the overlap gate); the
    forward and backward alone; the blocked ZeRO-2 reduce-scatter on one
    step's gradients bitwise `zero2_oracle_flat`.  Returns the summary
    and the ZeRO-2 overlap arm's final state and updater (17c)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cpd_tpu_torch.obs.timing import now
    from cpd_tpu_torch.parallel.dist import grad_sr_key
    from cpd_tpu_torch.parallel.mesh import data_parallel_mesh
    from cpd_tpu_torch.parallel.zero import zero2_oracle_flat
    from cpd_tpu_torch.train import as_batch, fp32_numerics, local_gradients

    w = ZERO["world"]
    mesh = data_parallel_mesh(w, device)
    batches = slice_batches(ZERO["steps"])

    def snapshot(model, state) -> list:
        return [t.detach().cpu().clone() for t in list(model.parameters())
                + list(model.buffers())] + [zero_momentum(state, mesh)[0]]

    runs, kept = {}, None
    for name in ZERO_ARMS:
        model, state, step, z = zero_build(device, name, mesh, None)
        params = list(model.parameters())
        want = zero_design(zero_arm(name), w, len(params),
                           [p.numel() for p in params])
        losses, secs, first = [], [], None
        for bx, by in batches:
            reset_counts()
            torch.cuda.synchronize()
            t0 = now()
            state, m = step(state, bx, by)
            torch.cuda.synchronize()
            secs.append(now() - t0)
            got = read_counts()
            losses.append(float(m["loss"]))
            if got != want or not math.isfinite(losses[-1]) or float(
                    m.get("reduce_ok", 1.0)) != 1.0:
                raise AssertionError(f"17a {name}: loss {losses[-1]}, "
                                     f"metrics {m}, launches {got} "
                                     f"(design {want})")
            if first is None:
                first = snapshot(model, state)
        # the first step again through the plain versions
        pm, ps, pstep, _ = zero_build(device, name, mesh, False)
        pstep(ps, *batches[0])
        same_state(snapshot(pm, ps), first, f"17a {name} plain vs kernels")
        del pm, ps, pstep, first
        mom_bytes = zero_momentum(state, mesh)[1]
        runs[name] = dict(
            losses=losses, step_ms=[t * 1e3 for t in secs],
            launches_per_step={k: v for k, v in want.items() if v},
            momentum_bytes_per_rank=mom_bytes,
            state=snapshot(model, state))
        if name == "zero2+overlap":
            kept = (model, state, z)
        print(f"zero 17a {name}: losses {losses}, step_ms "
              f"{runs[name]['step_ms']}, launches per step as designed "
              f"{json.dumps(runs[name]['launches_per_step'])}, momentum "
              f"{mom_bytes} bytes a rank; the first step through the plain "
              "versions bitwise", flush=True)
        del model, state, step
    for name, (ref, kind) in ZERO_PAIRS.items():
        a, b = runs[name]["state"], runs[ref]["state"]
        if kind == "bitwise":
            same_state(a, b, f"17a {name} vs {ref}")
            continue
        worst = max(float(((x - y).abs() - LARS_TOL["rtol"] * y.abs())
                          .max()) for x, y in zip(a, b))
        if worst > LARS_TOL["atol"]:
            raise AssertionError(f"17a {name} vs {ref}: beyond {LARS_TOL} "
                                 f"by {worst}")
    # the overlap gate: a profiled faithful step with overlap on and off
    evidence = {}
    for name in ("faithful", "faithful+overlap"):
        model, state, step, _ = zero_build(device, name, mesh, None)
        step(state, *batches[0])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(state, *batches[1])
            torch.cuda.synchronize()
        evidence[name] = zero_evidence(zero_kernel_timeline(prof))
    if (evidence["faithful"]["compute_after_first_reduce"] != 0
            or evidence["faithful"]["first_reduce"] is None
            or evidence["faithful+overlap"]["compute_after_first_reduce"]
            < 1):
        raise AssertionError(f"17a overlap evidence: {evidence}")
    # the forward and backward alone, and the blocked reduce-scatter
    model, state, step, z = zero_build(device, "zero2-blocked-sr", mesh,
                                       None)
    x, y = as_batch(*batches[0], device)
    with fp32_numerics():
        local_gradients(model, x, y, mesh)
        torch.cuda.synchronize()
        t0 = now()
        grads = local_gradients(model, x, y, mesh)[0]
        torch.cuda.synchronize()
        fwd_bwd_ms = (now() - t0) * 1e3
    key = grad_sr_key(ZERO["grad_seed"], 0, 1)
    lay = z._layout(grads[0])
    shards = z._grad_shard(grads, grads[0], mesh, lay, use_aps=True,
                           grad_exp=ZERO["fmt"][0], grad_man=ZERO["fmt"][1],
                           mode="faithful", rounding="stochastic", key=key,
                           block_scale=True, block_size=ZERO["block"])
    oracle = zero2_oracle_flat(
        [torch.stack(g) for g in zip(*grads)], w, use_aps=True,
        grad_exp=ZERO["fmt"][0], grad_man=ZERO["fmt"][1], key=key,
        block_scale=True, block_size=ZERO["block"],
        bucket_elems=ZERO["bucket_elems"])
    if not same_bits(torch.cat(shards), oracle):
        raise AssertionError("17a: the blocked ZeRO-2 reduce-scatter "
                             "differs from zero2_oracle_flat")
    del grads, shards, oracle, model, state, step
    out = dict(arms={k: {f: v[f] for f in ("losses", "step_ms",
                                           "launches_per_step",
                                           "momentum_bytes_per_rank")}
                     for k, v in runs.items()},
               evidence=evidence, fwd_bwd_ms=fwd_bwd_ms,
               buckets=len(lay.meta), shard_elems=lay.shard_size)
    print("zero 17a: every pair bitwise (LARS within "
          f"{LARS_TOL}), the blocked reduce-scatter bitwise its oracle; "
          f"overlap evidence {json.dumps(evidence)}; fwd_bwd_ms "
          f"{fwd_bwd_ms:.2f}; " + json.dumps(
              {k: dict(step_ms=v["step_ms"],
                       momentum_bytes_per_rank=v["momentum_bytes_per_rank"])
               for k, v in runs.items()}), flush=True)
    return out, kept


class ZeroStitched:
    """The global batches of a 17b ``--dist`` run over its processes:
    each process's sampler slice, in rank order."""

    def __init__(self, n, total_iter, batch, world_size=1, rank=0, seed=0,
                 last_iter=-1):
        from cpd_tpu_torch.data import samplers

        w = ZERO["dist_world"]
        self.parts = [samplers.DistributedGivenIterationSampler(
            n, total_iter, batch // w, world_size=w, rank=r, seed=seed,
            last_iter=last_iter) for r in range(w)]

    def batches(self):
        import numpy as np

        for parts in zip(*(p.batches() for p in self.parts)):
            yield np.concatenate(parts)


def zero_cli_argv(root: str, save: str) -> list:
    """17b's ResNet-18 CLI: ``--zero2 --overlap-reduce --bucket-elems
    2^20``, faithful APS e5m2, 128 a rank, the phase-14 data."""
    return ["--mode", "faithful", "--use_APS", "--grad_exp",
            str(ZERO["fmt"][0]), "--grad_man", str(ZERO["fmt"][1]),
            "--batch_size", str(ZERO["dist_batch"]), "--max-iter",
            str(ZERO["dist_iters"]), "--val_freq", str(ZERO["dist_iters"]),
            "--print_freq", "100", "--zero2", "--overlap-reduce",
            "--bucket-elems", str(ZERO["cli_bucket_elems"]), "--data-root",
            root, "--save_path", save]


def zero_world_batches(world: int, steps: int) -> list:
    """The first ``steps`` batches at ``world`` x 128 of phase 14's
    synthetic set (DIST's size: the ranks make it in their own
    processes)."""
    from cpd_tpu_torch.data import (CIFAR10Pipeline,
                                    DistributedGivenIterationSampler,
                                    synthetic_cifar10)

    gb = world * ZERO["per_rank_batch"]
    train_x, train_y, _, _ = synthetic_cifar10(DIST["n_train"],
                                               DIST["n_test"])
    pipe = CIFAR10Pipeline(train_x, train_y, gb, augment=True, cutout=0)
    sampler = DistributedGivenIterationSampler(len(train_y), steps, gb,
                                               seed=0)
    return [pipe.batch(idx, seed=0) for idx in sampler.batches()]


def zero_saved(step_dir: str) -> list:
    """Every array of a checkpoint step, in its order."""
    import numpy as np

    with np.load(os.path.join(step_dir, "state.npz")) as z:
        return [z[k].copy() for k in sorted(z.files)]


def zero_dist_rank(device, root: str, base: str, ports: tuple,
                   cards: int) -> dict:
    """One process of 17b (`parallel.launch.spawn` starts 3 + cards, all
    at once): processes 0 and 1 join a gloo group on ``ports[0]`` and
    run the ZeRO-2 overlap CLI under ``--dist`` sharing the card;
    process 2 runs the same argv on a `LocalMesh` of 2 (the JAX
    trainer's global batches: the two samplers' slices,
    `ZeroStitched`), then the LM CLI at the serving width with
    ``--overlap-reduce --emulate_node 2``; processes 3 .. 2 + cards join
    an nccl group on ``ports[1]``, a card each, and run
    ZERO["nccl_steps"] ZeRO-2 overlap steps, checking the bytes they
    hand to each all-to-all against `zero2_transport_bytes`.  Arrays
    come back as numpy."""
    import torch
    import torch.distributed as dist

    import cpd_tpu_torch.data as tdata
    from cpd_tpu_torch.obs.timing import now
    from cpd_tpu_torch.parallel.dist import dist_init, local_rows
    from cpd_tpu_torch.parallel.mesh import ProcessMesh
    from cpd_tpu_torch.parallel.zero import zero2_transport_bytes

    idx = int(os.environ["RANK"])
    w = ZERO["dist_world"]
    local = idx == w
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = dict(rank=idx, seconds={})
    t0 = now()
    if local:
        tdata.DistributedGivenIterationSampler = ZeroStitched
        where = os.path.join(base, "local")
        res, _ = run_cli(zero_cli_argv(root, where), ZERO["dist_world"],
                         device)
        out["cli"] = {k: res[k] for k in ("step", "loss", "accuracy",
                                          "diverged")}
        out["saved"] = zero_saved(os.path.join(where,
                                               str(ZERO["dist_iters"])))
        out["seconds"]["cli"] = now() - t0
        from cpd_tpu_torch.examples.lm import train as lcli

        t0 = now()
        argv = [a for a in lm_emu_cli_argv()
                if a not in ("--dist", "--dist-backend", "nccl")]
        with contextlib.redirect_stdout(io.StringIO()):
            lres = lcli.run(lcli.parse_args(argv + [
                "--overlap-reduce", "--dp", str(LM_EMU["world"])]),
                device=device)
        out["lm"] = {k: lres[k] for k in ("step", "loss", "diverged")}
        out["seconds"]["lm"] = now() - t0
        return out
    if idx < w:
        os.environ.update(WORLD_SIZE=str(w), LOCAL_WORLD_SIZE=str(w))
        dist_init("gloo", rank=idx, world_size=w, local_rank=idx,
                  init_method=f"tcp://localhost:{ports[0]}")
        where = os.path.join(base, "dist")
        res, _ = run_cli(zero_cli_argv(root, where) + [
            "--dist", "--dist-backend", "gloo"], 1, device)
        out["cli"] = {k: res[k] for k in ("step", "loss", "accuracy",
                                          "diverged")}
        out["saved"] = zero_saved(os.path.join(where,
                                               str(ZERO["dist_iters"])))
        dist.destroy_process_group()
        out["seconds"]["gloo"] = now() - t0
        return out
    rank = idx - w - 1
    if rank < cards:
        t0 = now()
        os.environ.update(WORLD_SIZE=str(cards),
                          LOCAL_WORLD_SIZE=str(cards))
        dist_init("nccl", rank=rank, world_size=cards, local_rank=rank,
                  init_method=f"tcp://localhost:{ports[1]}")
        mesh = ProcessMesh(device)
        batches = zero_world_batches(cards, ZERO["nccl_steps"])
        step_ms = {}
        # timed beside the checked arm: the replicated reduce and the
        # ring, each with overlap off and on
        for name in ZERO_NCCL_ARMS:
            model, state, step, z = zero_build(mesh.device, name, mesh,
                                               None)
            losses, handed, secs = [], [], []
            for bx, by in batches:
                mesh.log = []
                torch.cuda.synchronize()
                t1 = now()
                state, m = step(state, local_rows(bx, mesh),
                                local_rows(by, mesh))
                torch.cuda.synchronize()
                secs.append((now() - t1) * 1e3)
                losses.append(float(m["loss"]))
                handed.append([b for op, _, b in mesh.log
                               if op == "all_to_all"])
            step_ms[name] = secs
            if name != "zero2+overlap":
                del model, state, step, z
        lay = z._layout(list(model.parameters()))
        for logged in handed:
            if len(logged) != len(lay.meta):
                raise AssertionError(f"17b nccl rank {rank}: "
                                     f"{len(logged)} all-to-alls a step, "
                                     f"{len(lay.meta)} buckets")
        handed = [sum(b * (cards - 1) // cards for b in lg)
                  for lg in handed]
        want = sum(zero2_transport_bytes(mb, cards, *ZERO["fmt"])
                   for mb in lay.spans)
        if any(h != want for h in handed):
            raise AssertionError(f"17b nccl rank {rank}: all-to-all bytes "
                                 f"{handed}, zero2_transport_bytes {want}")
        out["nccl"] = dict(
            rank=rank, world=cards, losses=losses, wire_bytes=want,
            step_ms=step_ms,
            shard=state.opt_state.momentum[0].cpu().numpy(),
            params=[p.detach().cpu().numpy() for p in model.parameters()])
        dist.destroy_process_group()
        out["seconds"]["nccl"] = now() - t0
    return out


def zero_dist(device, root: str) -> dict:
    """17b (and 17c's LM CLI): one spawn (`zero_dist_rank`); the gloo
    pair's CLI results and checkpoints bitwise the `LocalMesh` W = 2
    process's; each nccl rank's weights and shard bitwise a `LocalMesh`
    of the same W, run here."""
    import numpy as np
    import torch

    from cpd_tpu_torch.obs.timing import now
    from cpd_tpu_torch.parallel.launch import _free_port
    from cpd_tpu_torch.parallel.mesh import data_parallel_mesh

    t0 = now()
    base = save_path("zero_17b")
    os.makedirs(base)
    cards = min(torch.cuda.device_count(), DIST["max_cards"])
    ports = {_free_port()}
    while len(ports) < 2:
        ports.add(_free_port())
    w = ZERO["dist_world"]
    procs = POOL.spawn(zero_dist_rank, w + 1 + cards,
                  args=(device, root, base, tuple(sorted(ports)), cards),
                  timeout=ZERO["deadline"], env={"NCCL_DEBUG": "WARN"})
    spawn_s = now() - t0
    local = procs[w]
    for res in procs[:w]:
        same = len(res["saved"]) == len(local["saved"]) and all(
            a.dtype == b.dtype and np.array_equal(
                a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8))
            for a, b in zip(local["saved"], res["saved"]))
        if res["cli"] != local["cli"] or not same:
            raise AssertionError(f"17b gloo rank {res['rank']}: "
                                 f"{res['cli']} or its checkpoint differs "
                                 f"from the LocalMesh's {local['cli']}")
    if local["cli"]["step"] != ZERO["dist_iters"] or local["cli"][
            "diverged"] or not math.isfinite(local["cli"]["loss"]):
        raise AssertionError(f"17b LocalMesh CLI: {local['cli']}")
    if local["lm"]["step"] != 2 or local["lm"]["diverged"] or \
            not math.isfinite(local["lm"]["loss"]):
        raise AssertionError(f"17c LM CLI --overlap-reduce: {local['lm']}")
    mesh = data_parallel_mesh(cards, device)
    model, state, step, _ = zero_build(device, "zero2+overlap", mesh, None)
    for bx, by in zero_world_batches(cards, ZERO["nccl_steps"]):
        state, _ = step(state, bx, by)
    for res in procs[w + 1:]:
        got = res["nccl"]
        r = got["rank"]
        same_state([torch.from_numpy(a) for a in got["params"]],
                   [p.detach().cpu() for p in model.parameters()],
                   f"17b nccl rank {r} weights vs LocalMesh")
        if not same_bits(torch.from_numpy(got["shard"]),
                         state.opt_state.momentum[r].cpu()):
            raise AssertionError(f"17b nccl rank {r}: its shard differs "
                                 "from the LocalMesh's")
    out = dict(spawn_seconds=spawn_s, seconds=now() - t0,
               process_seconds=[p["seconds"] for p in procs],
               cli=local["cli"], lm=local["lm"],
               nccl=dict(world=cards, losses=procs[w + 1]["nccl"]["losses"],
                         wire_bytes_per_rank=procs[w + 1]["nccl"][
                             "wire_bytes"],
                         step_ms=procs[w + 1]["nccl"]["step_ms"]))
    print(f"zero 17b: 2 gloo processes on the card under --dist --zero2 "
          f"--overlap-reduce --bucket-elems {ZERO['cli_bucket_elems']}: "
          "both ranks' results and checkpoints bitwise the LocalMesh "
          f"W=2's; {cards} nccl process(es), a card each: the ZeRO-2 "
          f"overlap steps bitwise a LocalMesh W={cards}, all-to-all bytes "
          "= zero2_transport_bytes; the LM CLI --overlap-reduce "
          "--emulate_node 2 at the serving width; " + json.dumps(out),
          flush=True)
    return out


def zero_restore(device, kept) -> dict:
    """17c: 17a's ZeRO-2 overlap arm (W = 4, ``bucket_elems``) saved
    padded and portable; ``restore(world=2)`` of each with a W = 2
    template is bitwise an `import_state` at W = 2 of the portable
    save."""
    from cpd_tpu_torch.obs.timing import now
    from cpd_tpu_torch.parallel.mesh import data_parallel_mesh
    from cpd_tpu_torch.train.checkpoint import CheckpointManager

    t0 = now()
    model, state4, z4 = kept
    padded = save_path("zero_17c_padded")
    CheckpointManager(padded).save(ZERO["steps"], state4)
    portable = save_path("zero_17c_portable")
    CheckpointManager(portable).save(ZERO["steps"], z4.export_state(state4))
    save_s = now() - t0
    mesh2 = data_parallel_mesh(2, device)
    _, tmpl, _, z2 = zero_build(device, "zero2", mesh2, None, model=model)
    want = z2.import_state(CheckpointManager(portable).restore(
        z2.portable_template(tmpl)), mesh2)
    for src in (padded, portable):
        got = CheckpointManager(src).restore(tmpl, world=2)
        for a, b in zip(want.opt_state.momentum, got.opt_state.momentum):
            if not same_bits(a, b):
                raise AssertionError(f"17c restore(world=2) of {src} "
                                     "differs from import_state at W = 2")
    out = dict(save_s=save_s, seconds=now() - t0,
               shard_elems_w2=want.opt_state.momentum[0].numel())
    print("zero 17c: 17a's W=4 ZeRO-2 state saved padded and portable; "
          "restore(world=2) of each bitwise import_state at W=2; "
          + json.dumps(out), flush=True)
    return out


def zero_phase(device) -> dict:
    """Phase 17: the offset arm, 17a-17c (module docstring)."""
    import torch

    from cpd_tpu_torch.obs.timing import now

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    marks = [now()]
    out = {"offset_arm": zero_offset_arm(device)}
    out["a"], kept = zero_local(device)
    marks.append(now())
    out["c"] = zero_restore(device, kept)
    del kept
    torch.cuda.empty_cache()
    marks.append(now())
    out["b"] = zero_dist(device, dist_cifar_root())
    marks.append(now())
    out["seconds"] = dict(zip("acb", (b - a for a, b in
                                      zip(marks, marks[1:]))))
    out["seconds"]["all"] = marks[-1] - marks[0]
    print("zero seconds: " + json.dumps(out["seconds"]), flush=True)
    return out

# phase 18: the rest of the quant package at ResNet-18/CIFAR's layer
# widths, batch 8, e5m2 (the APS wire's format): the stem conv 3 -> 64
# and a stage-1 conv 64 -> 64 at 32 x 32, a stage-4 conv 512 -> 512 at
# 4 x 4 (3 x 3, padding 1, no bias, as the model's) and the FC 512 -> 10
QUANT_LAYERS = dict(batch=8, fmt=(5, 2), seed=18, key=(18, 2026))
QUANT_CONVS = {"stem": (3, 64, 32), "stage1": (64, 64, 32),
               "stage4": (512, 512, 4)}
QUANT_FC = (512, 10)
# K8's SR and stats arms against their plain versions at odd shapes (a
# row that saturates the small formats, a row that underflows)
QGEMM_ARM_FORMATS = ((4, 3), (5, 2), (8, 23), (2, 1))
QGEMM_ARM_SHAPES = ((37, 29, 23), (70, 65, 33), (1, 1, 1))
# the SR arm's work per Kahan step, (ALU-pipe, fp32) instructions: five
# threefry2x32 evaluations of 45 ALU-pipe instructions (the flat sr_bits
# arm's SASS count, PERF.md) and five SR casts of ~24 ALU instructions
# (the reference cast's count, qgemm.cu) with their two power-of-two
# products, and the step's five fp32 ops
QGEMM_SR_STEP_WORK = (5 * (45 + 24), 5 + 5 * 2)
# the stats arm's work on top of its arm's, per cast: two masks, three
# compares and the three tally adds
QGEMM_STATS_CAST_ALU = 8
QGEMM_SR_KERNEL = "qgemm_tile_kernelINS_6SrCastEE"
# the launches of phase 18's main path (the layers' forward and backward,
# RTNE and SR, the Quantizer, the stats twins on the layers' forward
# operands): 4 layers x 3 GEMMs an arm; the FC bias gradient's cast (K1,
# or sr_bits and K2); the Quantizer's SR casts forward and backward
QUANT_LAYERS_DESIGN = {"qgemm_faithful": 12, "qgemm_faithful_sr": 12,
                       "qgemm_faithful_stats": 8, "quantize_cast": 1,
                       "quantize_cast_sr": 3, "sr_bits": 3}


def arm_check(a, b, fmt, key, label: str) -> dict:
    """K8's SR arm, its stats arm (RTNE and SR) and the RTNE arm on
    ``a @ b`` against the plain scan, bitwise, counts equal; the stats
    arm's products bitwise the arms without counting.  Returns the plain
    scans' wall seconds by arm."""
    import torch

    from cpd_tpu_torch.ops import qgemm as qg

    got = dict(sr=qg.qgemm_faithful_sr(a, b, *fmt, key),
               rtne=qg.qgemm_faithful(a, b, *fmt),
               stats=qg.qgemm_faithful_stats(a, b, *fmt),
               stats_sr=qg.qgemm_faithful_stats(a, b, *fmt, key=key))
    torch.cuda.synchronize()
    secs, want = {}, {}
    for arm, kw in (("sr", dict(key=key)), ("stats", dict(stats=True)),
                    ("stats_sr", dict(key=key, stats=True))):
        t0 = time.perf_counter()
        want[arm] = graphed_scan(a, b, *fmt, **kw)
        torch.cuda.synchronize()
        secs[arm] = time.perf_counter() - t0
    pairs = [("sr", got["sr"], want["sr"]),
             ("stats", got["stats"][0], want["stats"][0]),
             ("stats_sr", got["stats_sr"][0], want["stats_sr"][0]),
             ("stats == rtne", got["stats"][0], got["rtne"]),
             ("stats_sr == sr", got["stats_sr"][0], got["sr"])]
    for arm, x, y in pairs:
        if not same_bits(x, y):
            raise AssertionError(f"K8 {arm} {label}: differs from its "
                                 "plain version")
    for arm in ("stats", "stats_sr"):
        if not torch.equal(got[arm][1], want[arm][1]):
            raise AssertionError(f"K8 {arm} {label}: counts "
                                 f"{got[arm][1].tolist()} != plain "
                                 f"{want[arm][1].tolist()}")
    return secs


def quant_layer_set(rounding: str, device) -> dict:
    """Phase 18's layers (seeded, the same weights for either rounding)
    and their inputs: a normalised image batch, post-ReLU activations,
    pooled features."""
    import torch

    from cpd_tpu_torch import quant

    L = QUANT_LAYERS
    gen = torch.Generator(device=device).manual_seed(L["seed"])
    kw = dict(exp=L["fmt"][0], man=L["fmt"][1], rounding=rounding,
              device=device, generator=gen)
    out = {}
    for name, (ci, co, hw) in QUANT_CONVS.items():
        layer = quant.QuantConv(ci, co, 3, padding=1, use_bias=False, **kw)
        x = torch.randn((L["batch"], ci, hw, hw), generator=gen,
                        device=device)
        out[name] = (layer, x if name == "stem" else x.relu())
    layer = quant.QuantLinear(*QUANT_FC, **kw)
    out["fc"] = (layer, torch.randn((L["batch"], QUANT_FC[0]),
                                    generator=gen, device=device).relu())
    return out


def layer_operands(layer, x) -> tuple:
    """The forward GEMM's operands of a QuantConv (im2col patches,
    weightᵀ) or QuantLinear (x, weightᵀ)."""
    import torch.nn.functional as F

    if x.dim() == 2:
        return x, layer.weight.detach().t()
    patches = F.unfold(x, layer.kernel_size, padding=layer.padding)
    return (patches.transpose(1, 2).reshape(-1, patches.shape[1]),
            layer.weight.detach().reshape(layer.out_channels, -1).t())


def quant_layers_phase(device, train: dict) -> dict:
    """Phase 18: K8's SR and stats arms bitwise their plain versions at
    odd shapes, the layers' main path with its launches as designed, the
    arms on the stem, stage-1 and FC forward GEMMs' own operands bitwise
    their plain versions, the stage-4 GEMMs run to run, each arm timed
    (`queued_ms`) beside the RTNE arm at the stage-1 and stage-4 shapes,
    and the native fused augment on the CLI's and the slice's batches."""
    import torch

    from cpd_tpu_torch import quant
    from cpd_tpu_torch.ops import qgemm as qg
    from cpd_tpu_torch.quant import numerics, prng

    L = QUANT_LAYERS
    fmt, key = L["fmt"], L["key"]
    gen = torch.Generator(device=device).manual_seed(L["seed"] + 1)
    t0 = time.perf_counter()
    for f in QGEMM_ARM_FORMATS:
        for m, k, n in QGEMM_ARM_SHAPES:
            a = torch.randn((m, k), generator=gen, device=device) * 8
            b = torch.randn((k, n), generator=gen, device=device)
            a[0] *= 1e4
            a[-1] *= 2.0 ** -30
            arm_check(a, b, f, key, f"{f} {m}x{k}x{n}")
    odd_s = time.perf_counter() - t0

    # the main path: the layers forward and backward, RTNE then SR (a key
    # a layer), the Quantizer SR on the stage-1 activations, and the
    # stats twins on each layer's forward operands
    sets = {r: quant_layer_set(r, device) for r in ("nearest",
                                                    "stochastic")}
    keys = {name: prng.fold_in(key, i) for i, name in
            enumerate(sets["nearest"])}
    quantizer = quant.Quantizer(*fmt, *fmt, rounding="stochastic")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    outs, health = {}, {}
    for rounding, layers in sets.items():
        for name, (layer, x) in layers.items():
            xin = x.clone().requires_grad_()
            y = layer(xin, key=keys[name] if rounding == "stochastic"
                      else None)
            y.backward(torch.full_like(y, 2.0 ** -6))
            grads = [xin.grad] + [p.grad for p in layer.parameters()]
            outs[rounding, name] = (y.detach(), grads)
    act = sets["nearest"]["stage1"][1].clone().requires_grad_()
    qa = quantizer(act, key=key)
    qa.backward(act.detach())
    for rounding, layers in sets.items():
        for name, (layer, x) in layers.items():
            # the forward GEMM's key: a conv folds its group (0), then
            # every layer its GEMM site (0)
            sr_key = None
            if rounding == "stochastic":
                sr_key = keys[name] if name == "fc" else prng.fold_in(
                    keys[name], 0)
                sr_key = prng.fold_in(sr_key, 0)
            health[rounding, name] = quant.qgemm_stats(
                *layer_operands(layer, x), *fmt, rounding=rounding,
                key=sr_key)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = read_counts()
    got = {k: launches.get(k, 0) for k in QUANT_LAYERS_DESIGN}
    if got != QUANT_LAYERS_DESIGN:
        raise AssertionError(f"phase 18 launches {got} != the design "
                             f"{QUANT_LAYERS_DESIGN}")
    for (rounding, name), (y, grads) in outs.items():
        if not all(bool(t.isfinite().all()) for t in [y] + grads):
            raise AssertionError(f"phase 18 {rounding} {name}: a value "
                                 "that is not finite")
        # the stats twin's product is the layer's forward GEMM
        prod, _ = health[rounding, name]
        layer = sets[rounding][name][0]
        if name == "fc":
            prod = prod + layer.bias.detach()
        else:
            b_, c_, hw, _ = y.shape
            prod = prod.reshape(b_, hw * hw, c_).transpose(1, 2).reshape(
                y.shape)
        if not same_bits(prod, y):
            raise AssertionError(f"phase 18 {rounding} {name}: the stats "
                                 "twin's product differs from the layer's "
                                 "forward")
    if not same_bits(numerics.cast_body(qa.detach(), *fmt), qa.detach()):
        raise AssertionError("phase 18 Quantizer: an output off the format")
    sr, rt = outs["stochastic", "stage1"][0], outs["nearest", "stage1"][0]
    if same_bits(sr, rt):
        raise AssertionError("phase 18: the SR stage-1 conv equals the "
                             "RTNE one")

    # the arms on the stem, stage-1 and FC forward operands against their
    # plain versions; the stage-4 GEMMs run to run
    t0 = time.perf_counter()
    plain_s = {}
    for name in ("stem", "stage1", "fc"):
        layer, x = sets["nearest"][name]
        plain_s[name] = arm_check(*layer_operands(layer, x), fmt, key,
                                  f"{name} forward")
    main_checks_s = time.perf_counter() - t0
    a4, b4 = layer_operands(*sets["nearest"]["stage4"])
    runs = [(qg.qgemm_faithful_sr(a4, b4, *fmt, key),
             qg.qgemm_faithful_stats(a4, b4, *fmt),
             qg.qgemm_faithful_stats(a4, b4, *fmt, key=key))
            for _ in range(2)]
    first, second = runs
    if not (same_bits(first[0], second[0])
            and all(same_bits(p[0], q[0]) and torch.equal(p[1], q[1])
                    for p, q in zip(first[1:], second[1:]))
            and same_bits(first[2][0], first[0])):
        raise AssertionError("phase 18 stage-4: the SR or stats arm differs "
                             "run to run, or from the SR arm")

    # each arm by queued_ms beside the RTNE arm, at stage 1 and stage 4
    arms = {"rtne": lambda a, b: qg.qgemm_faithful(a, b, *fmt),
            "sr": lambda a, b: qg.qgemm_faithful_sr(a, b, *fmt, key),
            "stats": lambda a, b: qg.qgemm_faithful_stats(a, b, *fmt),
            "stats_sr": lambda a, b: qg.qgemm_faithful_stats(a, b, *fmt,
                                                             key=key)}
    work = {"rtne": QGEMM_STEP_WORK, "sr": QGEMM_SR_STEP_WORK}
    work["stats"] = (work["rtne"][0] + 5 * QGEMM_STATS_CAST_ALU,
                     work["rtne"][1])
    work["stats_sr"] = (work["sr"][0] + 5 * QGEMM_STATS_CAST_ALU,
                        work["sr"][1])
    shapes = {}
    for name in ("stage1", "stage4"):
        a, b = layer_operands(*sets["nearest"][name])
        m, k = a.shape
        n = b.shape[1]
        row = {"shape": [m, k, n]}
        for arm, fn in arms.items():
            alu, fp32 = work[arm]
            t_ops, pipe = pipe_bound_s({"alu": alu, "imad": 0.0,
                                        "alu+imad": alu, "fp32": fp32,
                                        "cvt": 0.0, "issue": alu + fp32},
                                       m * n * k)
            t_bytes = (4 * (m * k + k * n + m * n)
                       + (40 * k if "sr" in arm else 0)) / PEAK_BYTES_PER_S
            row[arm] = dict(ms=queued_ms(lambda: fn(a, b), iters=5,
                                         warmup=1),
                            bound_ms=max(t_ops, t_bytes) * 1e3,
                            bound_by=("operations" if t_ops >= t_bytes
                                      else "bytes"), bound_pipe=pipe)
        shapes[name] = row
    # the plain scans as a caller runs them (eager), at phase 10a's small
    # shape
    a = torch.randn(QGEMM_PLAIN_SHAPE[:2], generator=gen, device=device)
    b = torch.randn(QGEMM_PLAIN_SHAPE[1:], generator=gen, device=device)
    plain_ms = {
        "sr": time_ms(lambda: qg.qgemm_faithful_ref(a, b, *fmt, key=key),
                      iters=1, warmup=1),
        "stats": time_ms(lambda: qg.qgemm_faithful_ref(a, b, *fmt,
                                                       stats=True),
                         iters=1, warmup=1)}
    build = {k: v for k, v in qgemm_build().items()
             if "SrCast" in k or "Counted" in k}
    insns, loops, _ = _sass_loops("qgemm", QGEMM_SR_KERNEL)
    lo, hi = _inner_loop(loops)
    sr_sass = {p: v for p, v in _by_pipe(insns[lo:hi + 1], 4).items()
               if p != "opcodes"}

    fused = {"cli": train["cli"]["augment_fused_calls"],
             "slice": _SLICE_PIPE[0].pipeline.fused_calls}
    if min(fused.values()) <= 0:
        raise AssertionError(f"phase 18: batches through the native fused "
                             f"augment {fused}: the numpy path ran")
    out = dict(odd_s=odd_s, main_s=main_s, main_checks_s=main_checks_s,
               launches=got, graphed_plain_s=plain_s, plain_ms=plain_ms,
               plain_shape=list(QGEMM_PLAIN_SHAPE), shapes=shapes,
               build=build,
               sr_sass_per_step=sr_sass, fused_augment_calls=fused,
               health={f"{r} {n}": {f: float(v) for f, v in h[1].items()}
                       for (r, n), h in health.items()})
    print("quant layers: " + json.dumps(out), flush=True)
    return out


def quant_kernel_entries(ql: dict) -> list:
    """The ``kernels`` line's entries of K8's SR and stats arms, from
    phase 18: launches from its main path, times at the stage-1 shape
    (stage 4 beside), the plain scans' ms at the stage-1 forward."""
    out = []
    for name, arm in (("qgemm_faithful_sr", "sr"),
                      ("qgemm_faithful_stats", "stats")):
        main = ql["shapes"]["stage1"]
        plain_ms = ql["plain_ms"][arm]
        out.append(dict(
            name=name, route="cuda", source="cpd_tpu_torch/csrc/qgemm.cu",
            replaces="cpd_tpu/ops/qgemm.py:64",
            replaces_note="K8's arms: the JAX package runs its SR and stats "
                          "scans as XLA (cpd_tpu/quant/quant_function.py:"
                          "257-285)",
            launches=ql["launches"][name], max_abs_err=0.0,
            ms=main[arm]["ms"], plain_ms=plain_ms,
            bound_ms=main[arm]["bound_ms"], bound_by=main[arm]["bound_by"],
            library_ms=None, library_note=NO_LIBRARY_QGEMM,
            shape=main["shape"], plain_shape=ql["plain_shape"],
            rtne_ms=main["rtne"]["ms"],
            shapes={s: {a: r[a] for a in ("rtne", arm, "stats_sr")}
                    for s, r in ql["shapes"].items()},
            parity="bitwise the plain scan (counts equal) over "
                   f"{list(QGEMM_ARM_FORMATS)} at odd shapes and on the "
                   "stem, stage-1 and FC forward operands; the stage-4 "
                   "GEMMs bitwise run to run"))
    return out

# --overlap-nccl: steps timed an arm (the first WARMUP left out of the
# summary), then one profiled step
# -- phase 19: sequence parallelism ----------------------------------------

# 19a: dp x sp ranks on the LocalMesh, rows a dp rank, the global sequence;
# the gradient gate's relative tolerance against the same model at sp = 1
SP = dict(dp=2, sp=2, rows=4, seq=2048, steps=2, fmt=(5, 2), seed=19,
          lr=0.01, grad_rtol=1e-5, dropout=0.1, deadline=300.0)
# name -> the model's sp options and the step's reduce options
SP_ARMS = {
    "ring": dict(model=dict(attn_impl="xla", sp_mode="ring"),
                 step=dict(mode="ring")),
    "ulysses": dict(model=dict(attn_impl="flash", flash_bwd="pallas",
                               sp_mode="ulysses",
                               dropout_rate=SP["dropout"]),
                    step=dict(mode="ring", grad_rounding="stochastic",
                              grad_seed=0)),
}


def sp_design(name: str, leaves: int, buckets: int) -> dict:
    """The launches of one 19a step of arm ``name``: the dp reduce over
    the sp-index-0 ranks (`reduce_design` at W = dp: the ring mode's APS
    casts, K6 a bucket and K5 (W - 1) a bucket a rank, their SR arms and
    ``sr_bits`` at every cast site under SR); under Ulysses flash one K9
    and one K10 a layer and rank; with dropout two flat ``sr_bits`` draws
    a layer and rank."""
    arm = SP_ARMS[name]
    n, ranks = LM_MODEL["n_layers"], SP["dp"] * SP["sp"]
    sr = arm["step"].get("grad_rounding") == "stochastic"
    want = reduce_design("ring", sr, False, SP["dp"], leaves, buckets)
    if arm["model"]["attn_impl"] == "flash":
        want.update(flash_gqa_fwd=n * ranks, flash_gqa_bwd=n * ranks)
    if arm["model"].get("dropout_rate"):
        want["sr_bits"] += 2 * n * ranks
    return want


def sp_step_kw(name: str, arms=None) -> dict:
    """The step keywords of arm ``name`` of ``arms`` (default
    `SP_ARMS`): the APS e5m2 reduce."""
    return dict(use_aps=True, grad_exp=SP["fmt"][0], grad_man=SP["fmt"][1],
                **(arms or SP_ARMS)[name]["step"])


def sp_reduce_kw(name: str, arms=None) -> dict:
    """`sum_gradients` keywords of arm ``name``'s first step."""
    from cpd_tpu_torch.parallel.dist import grad_sr_key

    kw = sp_step_kw(name, arms)
    sr = kw.pop("grad_rounding", "nearest") == "stochastic"
    seed = kw.pop("grad_seed", 0)
    return dict(kw, rounding="stochastic" if sr else "nearest",
                key=grad_sr_key(seed, 0, 1) if sr else None)


def sp_kernel_check(model, toks, mesh, label: str = "19a") -> dict:
    """One layer's K9 and K10 calls on the card against their plain
    versions: K9's inputs recorded from layer 0's Ulysses middle step (a
    forward of dp group 0, its sp x tp ranks), the backward fed a seeded
    cotangent."""
    import torch

    from cpd_tpu_torch.ops import flash_gqa as fl

    real, seen = fl.flash_gqa_fwd, []

    def record(q, k, v, causal, *a, **kw):
        if not seen:
            seen.append((q.clone(), k.clone(), v.clone(), causal))
        return real(q, k, v, causal, *a, **kw)

    # the wrapper counts in its module's name while it stands there
    record.launches = real.launches
    dp, sp, tp = (mesh.axes[a] for a in ("dp", "sp", "tp"))
    rows, t_local = toks.shape[0] // dp, toks.shape[1] // sp
    group = list(range(sp * tp))
    cols = [mesh.coords(p)["sp"] * t_local for p in group]
    fl.flash_gqa_fwd = record
    try:
        with torch.no_grad():
            model.eval()
            model.forward_sp([toks[:rows, c:c + t_local] for c in cols],
                             mesh.axis("sp", group), None, None,
                             mesh.axis("tp", group))
    finally:
        fl.flash_gqa_fwd = real
        real.launches = record.launches
        model.train()
    q, k, v, causal = seen[0]
    gen = torch.Generator(device=q.device).manual_seed(SP["seed"])
    g = torch.randn(q.shape, generator=gen, device=q.device)
    out, lse = fl.flash_gqa_fwd(q, k, v, causal)
    grads = fl.flash_gqa_bwd(q, k, v, out, lse, g, causal)
    r_out, r_lse = fl.flash_gqa_fwd_ref(q, k, v, causal)
    r_grads = fl.flash_gqa_bwd_ref(q, k, v, r_out, r_lse, g, causal)
    fwd = max(max_abs_diff(out, r_out), max_abs_diff(lse, r_lse))
    bwd = max(max_abs_diff(a, b) for a, b in zip(grads, r_grads))
    if not (fwd <= FLASH_ATOL and bwd <= FLASH_GRAD_ATOL):
        raise AssertionError(f"{label} Ulysses K9/K10 at {tuple(q.shape)}: "
                             f"{fwd} / {bwd} past {FLASH_ATOL} / "
                             f"{FLASH_GRAD_ATOL}")
    return dict(shape=list(q.shape), kv_heads=k.shape[2],
                contiguous=q.is_contiguous(), fwd_err=fwd, bwd_err=bwd)


def sp_mask_check(device, step: int = 0, dp_index: int = 1,
                  layer: int = 0, label: str = "19a") -> dict:
    """One layer's dropout mask at 19a's activation shape (20a's too:
    the mask falls on the tp-summed value), drawn on the card
    (`sr_bits`' flat arm) for rank (``dp_index``, sp index 1) at
    ``step``, bitwise the CPU bits of `quant.prng`."""
    import torch

    from cpd_tpu_torch.models.transformer import dropout_key, dropout_mask
    from cpd_tpu_torch.train.lm import step_dropout_key

    key = dropout_key(step_dropout_key(0, step, 1, 0, dp_index, 1), layer,
                      1)
    shape = (SP["rows"], SP["seq"] // SP["sp"], LM_MODEL["d_model"])
    card = dropout_mask(key, torch.empty(shape, device=device),
                        SP["dropout"])
    cpu = dropout_mask(key, torch.empty(shape), SP["dropout"])
    if not torch.equal(card.cpu(), cpu):
        raise AssertionError(f"{label}: the card's dropout mask differs "
                             "from the CPU bits of quant/prng.py")
    return dict(shape=list(shape), kept=float(cpu.float().mean()))


def sp_arm(device, name: str, keep=None) -> dict:
    """19a, one arm: the gates on the first batch, then ``SP["steps"]``
    counted steps, then the step's split (module docstring).  With a
    ``keep`` dict, its ``"grads"`` gets the first batch's sp-summed
    gradients of each dp index (phase 20's tp = 1 reference)."""
    import torch

    from cpd_tpu_torch.obs.timing import now
    from cpd_tpu_torch.parallel.dist import sum_gradients
    from cpd_tpu_torch.parallel.mesh import make_mesh
    from cpd_tpu_torch.parallel.overlap import (DEFAULT_BUCKET_ELEMS,
                                                bucket_layout)
    from cpd_tpu_torch.train import create_train_state, sgd
    from cpd_tpu_torch.train.lm import (as_tokens, lm_local_gradients,
                                        lm_sp_gradients, make_lm_train_step,
                                        step_dropout_key)
    from cpd_tpu_torch.train.step import fp32_numerics

    dp, sp = SP["dp"], SP["sp"]
    mesh = make_mesh(dp, sp, device)
    dp_view = mesh.axis("dp", [d * sp for d in range(dp)])
    model = lm_model(device, SP["seed"], LM_MODEL, sp_axis="sp",
                     **SP_ARMS[name]["model"])
    params = list(model.parameters())
    batches = lm_batches(LM_MODEL["vocab_size"], SP["steps"],
                         dp * SP["rows"], SP["seq"], SP["seed"])
    toks, tgts = as_tokens(*batches[0], device)
    out = dict(arm=name)
    # the gradient gate, dropout off on both sides
    for blk in model.blocks:
        blk.dropout_rate = 0.0
    with fp32_numerics():
        g_sp, _, _ = lm_sp_gradients(model, toks, tgts, mesh)
        g_one, _, _ = lm_local_gradients(model, toks, tgts,
                                         make_mesh(dp, 1, device))
    for blk in model.blocks:
        blk.dropout_rate = SP_ARMS[name]["model"].get("dropout_rate", 0.0)
    rel = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
              for d in range(dp) for a, b in zip(g_sp[d * sp], g_one[d]))
    del g_one
    if not rel <= SP["grad_rtol"]:
        raise AssertionError(f"19a {name}: the sp-summed gradients are "
                             f"{rel} relative from sp = 1's")
    out["grad_rel_err"] = rel
    grads = [g_sp[d * sp] for d in range(dp)]
    del g_sp
    red = [sum_gradients(grads, dp_view, fused=f, **sp_reduce_kw(name))
           for f in (None, False)]
    if not all(same_bits(a, b) for a, b in zip(red[0][0], red[1][0])):
        raise AssertionError(f"19a {name}: the dp reduce's kernels differ "
                             "from its plain version")
    if keep is not None:
        keep["grads"] = grads
    del red, grads
    if SP_ARMS[name]["model"]["attn_impl"] == "flash":
        out["k9_k10"] = sp_kernel_check(model, toks, mesh)
    opt = sgd(lambda s: SP["lr"], momentum=0.9)
    state = create_train_state(model, opt)
    step = make_lm_train_step(model, opt, mesh, **sp_step_kw(name))
    torch.cuda.synchronize()
    reset_counts()
    secs, losses = [], []
    for tk, tg in batches:
        t0 = now()
        state, m = step(state, tk, tg)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        secs.append(now() - t0)
    launches = read_counts()
    buckets = len(bucket_layout([p.numel() for p in params],
                                DEFAULT_BUCKET_ELEMS))
    want = sp_design(name, len(params), buckets)
    per_step = {k: v // SP["steps"] for k, v in launches.items() if v}
    if per_step != {k: v for k, v in want.items() if v} or any(
            v % SP["steps"] for v in launches.values()):
        raise AssertionError(f"19a {name}: launches {launches} over "
                             f"{SP['steps']} steps, the design {want}")
    if not all(math.isfinite(x) for x in losses) or abs(
            losses[0] - math.log(LM_MODEL["vocab_size"])) > LM_LOSS_BAND:
        raise AssertionError(f"19a {name}: losses {losses}")
    # the split: one more first-batch step's forward/backward (its
    # dropout keys those of a step numbered SP["steps"]) and reduce

    def key_fn(d, j, micro):
        return step_dropout_key(0, SP["steps"], 1, micro, d, j)

    with fp32_numerics():
        torch.cuda.synchronize()
        t0 = now()
        g_sp, _, _ = lm_sp_gradients(model, toks, tgts, mesh, key_fn=key_fn)
        torch.cuda.synchronize()
        t1 = now()
        sum_gradients([g_sp[d * sp] for d in range(dp)], dp_view,
                      **sp_reduce_kw(name))
        torch.cuda.synchronize()
        t2 = now()
    del g_sp
    tokens = dp * SP["rows"] * SP["seq"]
    out.update(losses=losses, step_ms=[x * 1e3 for x in secs],
               fwd_bwd_ms=(t1 - t0) * 1e3, reduce_ms=(t2 - t1) * 1e3,
               tokens_per_s=tokens * (len(secs) - 1) / sum(secs[1:]),
               launches_per_step=per_step,
               leaves=len(params), buckets=buckets)
    del model, state, step, opt
    torch.cuda.empty_cache()
    return out


def sp_cli_argv(mode: str, sp: int = 2) -> list:
    """19b's LM CLI: the serving width at ``LM_EMU_CLI_VOCAB`` tokens,
    ``--sp`` ``sp`` in ``mode``, 19a's arm (ring: xla attention and the
    RTNE ring reduce; Ulysses: the flash kernels, dropout and the SR ring
    reduce), batch 4 of 2048 tokens, 2 iterations."""
    L = LM_MODEL
    argv = ["--vocab-size", str(LM_EMU_CLI_VOCAB), "--d-model",
            str(L["d_model"]), "--n-layers", str(L["n_layers"]),
            "--n-heads", str(L["n_heads"]), "--n-kv-heads",
            str(L["n_kv_heads"]), "--seq-len", str(SP["seq"]),
            "--batch-size", str(SP["rows"]), "--sp", str(sp), "--sp-mode",
            mode, "--use_APS", "--grad_exp", str(SP["fmt"][0]),
            "--grad_man", str(SP["fmt"][1]), "--mode", "ring",
            "--max-iter", "2", "--print-freq", "1"]
    if mode == "ulysses":
        return argv + ["--attn-impl", "flash", "--flash-bwd", "pallas",
                       "--dropout", str(SP["dropout"]), "--grad-rounding",
                       "stochastic"]
    return argv + ["--attn-impl", "xla"]


def sp_cli_run(argv: list, device, log: bool = False,
               axis: str = "sp") -> dict:
    """The LM CLI at ``argv`` on ``device``: its last loss, validation,
    printed loss lines (without the host clock's tokens/s), the digest of
    the trained weights and, with ``log``, the bytes this rank handed to
    each collective of the ``axis`` view in each step
    (``ProcessMesh.log``); for ``axis`` "tp" also `tp_held`'s digests
    and bytes of the weights and momentum."""
    from cpd_tpu_torch.examples.lm import train as cli
    from cpd_tpu_torch.train import lm as tlm

    real, seen = tlm.make_lm_train_step, {"logs": []}

    def recorded(model, opt, mesh, **kw):
        seen["model"] = model
        step = real(model, opt, mesh, **kw)

        def logged(state, toks, tgts):
            if log:
                mesh.log = []
            res = step(state, toks, tgts)
            seen["state"] = res[0]
            if log:
                by_op: dict = {}
                for op, _, nbytes in mesh.log:
                    if op.startswith(axis + "."):
                        by_op[op] = by_op.get(op, 0) + nbytes
                seen["logs"].append(by_op)
                mesh.log = None
            return res

        return logged

    tlm.make_lm_train_step = recorded
    text = io.StringIO()
    try:
        with contextlib.redirect_stdout(text):
            res = cli.run(cli.parse_args(argv), device=device)
    finally:
        tlm.make_lm_train_step = real
    return dict(loss=res["loss"], val=res["val"], seconds=res["seconds"],
                lines=[ln.split(" TokPerSec")[0]
                       for ln in text.getvalue().splitlines()
                       if ln.startswith(("Iter", "Val"))],
                digest=state_digest(seen["model"]), logs=seen["logs"],
                numel=sum(p.numel() for p in seen["model"].parameters()),
                **(tp_held(seen["model"], seen["state"]) if axis == "tp"
                   else {}))


def sp_wire_bytes(mode: str, sp: int, leaves_numel: int) -> dict:
    """The bytes one rank hands to the sp collectives in one 19b step,
    from the shapes: the ring's stacked K/V block a hop (W - 1 hops a
    layer, forward and backward), Ulysses' four all-to-alls of q, k, v
    and the output a layer (forward and backward), and the sp sum's
    all-gather of the flat gradients."""
    L = LM_MODEL
    d = L["d_model"] // L["n_heads"]
    tok = SP["rows"] * SP["seq"] // sp * d * 4          # fp32, one head
    n = L["n_layers"]
    out = {"sp.all_gather": leaves_numel * 4}
    if mode == "ring":
        out["sp.ring_shift"] = n * 2 * (sp - 1) * 2 * L["n_kv_heads"] * tok
    else:
        hkv = L["n_kv_heads"]
        if hkv % sp:
            hkv = next(e * hkv for e in range(1, L["n_heads"] + 1)
                       if (L["n_heads"] // hkv) % e == 0
                       and (hkv * e) % sp == 0)
        out["sp.all_to_all"] = n * 2 * (2 * L["n_heads"] + 2 * hkv) * tok
    return out


def sp_dist_rank(device, ports: tuple, cards: int) -> dict:
    """One process of 19b/19c and 20b/20c (`parallel.launch.spawn`
    starts max(2, cards)): processes 0 and 1 join a gloo group on
    ``ports[0]`` sharing the card and run the CLI under ``--dist --sp 2``
    in each mode, then under ``--dist --tp 2`` (dp 1 x tp 2); then, with
    two cards or more, processes 0..cards-1 join an nccl group on
    ``ports[1]``, one card each, and run it at ``--sp cards`` and, where
    tp divides the cards, at ``--tp 2`` (dp = cards / 2)."""
    import torch
    import torch.distributed as dist

    from cpd_tpu_torch.parallel.dist import dist_init

    rank = int(os.environ["RANK"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = dict(rank=rank, parts={})
    parts = [("b", "gloo", 2, ports[0])]
    if cards > 1:
        parts.append(("c", "nccl", cards, ports[1]))
    for part, backend, w, port in parts:
        if rank >= w:
            continue
        os.environ.update(WORLD_SIZE=str(w), LOCAL_WORLD_SIZE=str(w))
        dist_init(backend, rank=rank, world_size=w, local_rank=rank,
                  init_method=f"tcp://localhost:{port}")
        dev = f"cuda:{rank}" if backend == "nccl" else device
        flags = ["--dist", "--dist-backend", backend]
        out["parts"][part] = {
            mode: sp_cli_run(sp_cli_argv(mode, w) + flags, dev, log=True)
            for mode in SP_ARMS}
        if w % TP["tp"] == 0:
            out["parts"][part]["tp"] = sp_cli_run(tp_cli_argv() + flags, dev,
                                                  log=True, axis="tp")
        dist.destroy_process_group()
    return out


def sp_dist(device) -> dict:
    """19b/19c and 20b/20c: the `LocalMesh` references of the CLI here
    (dp 1 x sp in each mode; dp x tp 2), one spawn of the ranks
    (`sp_dist_rank`), then the checks: every rank's loss lines and
    weights bitwise its sp reference and its sp bytes the shapes'
    (`sp_dist_check`), its tp shard bitwise its tp reference's
    (`tp_dist_check`)."""
    import torch

    from cpd_tpu_torch.obs.timing import now
    from cpd_tpu_torch.parallel.launch import _free_port

    cards = min(torch.cuda.device_count(), DIST["max_cards"])
    worlds = [2] + ([cards] if cards > 1 else [])
    marks = [now()]
    refs = {(mode, w): sp_cli_run(sp_cli_argv(mode, w), device)
            for w in worlds for mode in SP_ARMS}
    refs.update({("tp", w): sp_cli_run(tp_cli_argv(w // TP["tp"]), device,
                                       axis="tp")
                 for w in worlds if w % TP["tp"] == 0})
    marks.append(now())
    ports = {_free_port()}
    while len(ports) < 2:
        ports.add(_free_port())
    ranks = POOL.spawn(sp_dist_rank, max(2, cards),
                  args=(device, tuple(sorted(ports)), cards),
                  timeout=SP["deadline"], env={"NCCL_DEBUG": "WARN"})
    marks.append(now())
    seconds = dict(references=marks[1] - marks[0],
                   spawn=marks[2] - marks[1])
    return dict(sp=sp_dist_check(ranks, refs, worlds), seconds=seconds,
                tp=tp_dist_check(ranks, refs, worlds))


def sp_dist_check(ranks: list, refs: dict, worlds: list) -> dict:
    """19b/19c's gates on the spawn's ranks (`sp_dist`)."""
    out = {}
    for part, w in zip("bc", worlds):
        for mode in SP_ARMS:
            want = refs[(mode, w)]
            wire = sp_wire_bytes(mode, w, want["numel"])
            for rk in ranks[:w]:
                got = rk["parts"][part][mode]
                if (got["loss"], got["val"], got["digest"]) != (
                        want["loss"], want["val"], want["digest"]):
                    raise AssertionError(
                        f"19{part} {mode} rank {rk['rank']}: loss "
                        f"{got['loss']} val {got['val']} weights "
                        f"{got['digest']} differ from the LocalMesh "
                        f"sp={w}'s {want['loss']} {want['val']} "
                        f"{want['digest']}")
                if rk["rank"] == 0 and got["lines"] != want["lines"]:
                    raise AssertionError(f"19{part} {mode}: rank 0's loss "
                                         f"lines {got['lines']} != "
                                         f"{want['lines']}")
                if any(log != wire for log in got["logs"]):
                    raise AssertionError(f"19{part} {mode} rank "
                                         f"{rk['rank']}: sp bytes "
                                         f"{got['logs']} != {wire}")
            out[f"{part}-{mode}"] = dict(
                world=w, backend="gloo" if part == "b" else "nccl",
                loss=want["loss"], val=want["val"],
                sp_bytes_per_step=wire,
                cli_seconds=[rk["parts"][part][mode]["seconds"]
                             for rk in ranks[:w]],
                local_seconds=want["seconds"])
            print(f"sp dist 19{part} {mode}: {w} "
                  f"{'gloo processes sharing the card' if part == 'b' else 'nccl processes, one a card'}"
                  f", the CLI's losses and weights bitwise the LocalMesh "
                  f"sp={w}'s, sp bytes a rank and step as the shapes say; "
                  + json.dumps(out[f"{part}-{mode}"]), flush=True)
    return out


def sp_phase(device, keep=None) -> dict:
    """Phase 19a: its arms, the mask and reduce checks; the ring arm's
    sp-summed gradients into ``keep`` (`sp_arm`).  19b/19c run in phase
    20's spawn (`sp_dist`)."""
    import torch

    from cpd_tpu_torch.obs.timing import now

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    marks = [now()]
    out = dict(mask=sp_mask_check(device), arms={})
    for name in SP_ARMS:
        out["arms"][name] = sp_arm(device, name,
                                   keep if name == "ring" else None)
        print(f"train sp 19a {name}: dp {SP['dp']} x sp {SP['sp']} "
              f"LocalMesh, {SP['rows']} x {SP['seq']} tokens a dp rank; "
              + json.dumps(out["arms"][name]), flush=True)
    marks.append(now())
    out["seconds"] = dict(a=marks[1] - marks[0])
    print("sp mask 19a: " + json.dumps(out["mask"]), flush=True)
    print("sp seconds: " + json.dumps(out["seconds"]), flush=True)
    return out


# -- phase 20: tensor parallelism and scanned layers ------------------------

# 20a: dp x sp x tp ranks on the LocalMesh; phase 19's model, weights,
# batches (SP's rows, sequence, steps, seed), APS format and learning rate
TP = dict(dp=2, sp=2, tp=2, deadline=300.0)
# name -> the model's options and the step's reduce options
TP_ARMS = {
    "tp-ring": dict(model=dict(attn_impl="xla", sp_mode="ring"),
                    step=dict(mode="ring")),
    "tp-ulysses": dict(model=dict(attn_impl="flash", flash_bwd="pallas",
                                  sp_mode="ulysses",
                                  dropout_rate=SP["dropout"], ffn_exp=4,
                                  ffn_man=3, ffn_mode="faithful"),
                       step=dict(mode="ring", grad_rounding="stochastic",
                                 grad_seed=0)),
}


def tp_design(name: str, leaves: int, buckets: int) -> dict:
    """The launches of one 20a step of arm ``name``: one dp reduce a tp
    index over its local tree (`reduce_design` at W = dp, ``leaves``
    local leaves in ``buckets`` buckets); under Ulysses flash one K9 and
    one K10 a layer and rank; with the e4m3 FFN six K8 calls a layer and
    rank (wi and wo_mlp: forward, grad_x, grad_W); with dropout two flat
    ``sr_bits`` draws a layer and rank (every tp rank draws its mask)."""
    arm = TP_ARMS[name]
    n, ranks = LM_MODEL["n_layers"], TP["dp"] * TP["sp"] * TP["tp"]
    sr = arm["step"].get("grad_rounding") == "stochastic"
    one = reduce_design("ring", sr, False, TP["dp"], leaves, buckets)
    want = {k: TP["tp"] * v for k, v in one.items()}
    if arm["model"]["attn_impl"] == "flash":
        want.update(flash_gqa_fwd=n * ranks, flash_gqa_bwd=n * ranks)
    if "ffn_exp" in arm["model"]:
        want["qgemm_faithful"] = 6 * n * ranks
    if arm["model"].get("dropout_rate"):
        want["sr_bits"] += 2 * n * ranks
    return want


@contextlib.contextmanager
def k8_recorded(seen: dict):
    """The first `qgemm_faithful` call of each operand shape in the block,
    its operands copied into ``seen[(a.shape, b.shape)]``."""
    from cpd_tpu_torch.ops import qgemm as qg

    kernel = qg.qgemm_faithful

    def record(a, b, exp_bits, man_bits):
        key = (tuple(a.shape), tuple(b.shape))
        if key not in seen:
            seen[key] = (a.detach().contiguous().clone(),
                         b.detach().contiguous().clone(), exp_bits, man_bits)
        return kernel(a, b, exp_bits, man_bits)

    # the kernel counts its launches on the module's name, the recorder
    record.launches = kernel.launches
    qg.qgemm_faithful = record
    try:
        yield seen
    finally:
        qg.qgemm_faithful = kernel
        kernel.launches = record.launches


def tp_k8_check(seen: dict, rows: int = 256) -> list:
    """Each recorded K8 call (one a tp-local shape) on the card again,
    its first ``rows`` output rows bitwise the plain scan on those rows
    of ``a`` (`graphed_scan`: every output element is its own scan over
    K, so a row slice is the same function on fewer rows)."""
    from cpd_tpu_torch.ops import qgemm as qg

    out = []
    for (ash, bsh), (a, b, e, m) in seen.items():
        got = qg.qgemm_faithful(a, b, e, m)[:rows]
        want = graphed_scan(a[:rows], b, e, m)
        if not same_bits(got, want):
            raise AssertionError(f"20a K8 at {ash} x {bsh}: the kernel "
                                 "differs from its plain version")
        out.append([*ash, bsh[1]])
    return out


def tp_whole(grads: list, pos: list, i: int, dim) -> "torch.Tensor":
    """Leaf ``i`` of the local trees at flat ranks ``pos`` (one a tp
    index) put back whole: the shards' concatenation along ``dim``, or
    the first rank's replicated leaf."""
    import torch

    if dim is None:
        return grads[pos[0]][i]
    return torch.cat([grads[p][i] for p in pos], dim=dim)


def tp_scan_check(device, name: str, init: dict, mesh, batches, losses,
                  model) -> dict:
    """The arm again on scanned layers with remat: a ``scan_layers=True``
    model on ``init`` stacked over the layers, ``SP["steps"]`` steps;
    its losses and its weights restacked bitwise the unrolled ``model``'s
    (``losses``, its weights after the same steps)."""
    import torch

    from cpd_tpu_torch.models import transformer_lm
    from cpd_tpu_torch.obs.timing import now
    from cpd_tpu_torch.train import create_train_state, sgd
    from cpd_tpu_torch.train.lm import make_lm_train_step

    n = LM_MODEL["n_layers"]
    scanned = transformer_lm(**LM_MODEL, sp_axis="sp", tp_axis="tp",
                             scan_layers=True, remat=True, device=device,
                             **TP_ARMS[name]["model"])

    def stacked(src: dict, name_: str):
        if not name_.startswith("blocks."):
            return src[name_]
        rest = name_[len("blocks."):]
        return torch.stack([src[f"blocks.{i}.{rest}"] for i in range(n)])

    with torch.no_grad():
        for k, p in scanned.named_parameters():
            p.copy_(stacked(init, k))
    opt = sgd(lambda s: SP["lr"], momentum=0.9)
    state = create_train_state(scanned, opt)
    step = make_lm_train_step(scanned, opt, mesh,
                              **sp_step_kw(name, TP_ARMS))
    got, secs = [], []
    for tk, tg in batches:
        torch.cuda.synchronize()
        t0 = now()
        state, m = step(state, tk, tg)
        got.append(float(m["loss"]))
        torch.cuda.synchronize()
        secs.append(now() - t0)
    if got != losses:
        raise AssertionError(f"20a {name} scanned: losses {got} != the "
                             f"unrolled arm's {losses}")
    final = dict(model.named_parameters())
    for k, p in scanned.named_parameters():
        if not same_bits(p.detach(), stacked(final, k).detach()):
            raise AssertionError(f"20a {name} scanned: {k} differs from "
                                 "the unrolled arm's weights restacked")
    del scanned, state, step, opt
    return dict(losses=got, step_ms=[x * 1e3 for x in secs],
                parity="losses and weights (restacked) bitwise the "
                       "unrolled arm's")


def tp_arm(device, name: str, ref) -> dict:
    """20a, one arm: the gates on the first batch (the tp-summed
    gradients against ``ref``, phase 19a's tp = 1 gradients, where given;
    each tp index's dp reduce against its plain version; the K8, K9/K10
    calls against theirs), ``SP["steps"]`` counted steps, the step's
    split and, with ``ref``, the scanned-layer check."""
    import torch

    from cpd_tpu_torch.models.transformer import lm_param_specs, shard_param
    from cpd_tpu_torch.obs.timing import now
    from cpd_tpu_torch.parallel.dist import sum_gradients
    from cpd_tpu_torch.parallel.mesh import make_mesh
    from cpd_tpu_torch.parallel.overlap import (DEFAULT_BUCKET_ELEMS,
                                                bucket_layout)
    from cpd_tpu_torch.train import create_train_state, sgd
    from cpd_tpu_torch.train.lm import (as_tokens, lm_sp_gradients,
                                        make_lm_train_step,
                                        step_dropout_key)
    from cpd_tpu_torch.train.step import fp32_numerics

    dp, sp, tp = TP["dp"], TP["sp"], TP["tp"]
    arm = TP_ARMS[name]
    mesh = make_mesh(dp, sp, device, tp=tp)
    # the flat ranks of each tp index's dp reduce
    dp_pos = [[d * sp * tp + k for d in range(dp)] for k in range(tp)]
    dp_views = [mesh.axis("dp", pos) for pos in dp_pos]
    model = lm_model(device, SP["seed"], LM_MODEL, sp_axis="sp",
                     tp_axis="tp", **arm["model"])
    named = list(model.named_parameters())
    specs = lm_param_specs(named)
    dims = [specs[n][1] for n, _ in named]
    batches = lm_batches(LM_MODEL["vocab_size"], SP["steps"],
                         dp * SP["rows"], SP["seq"], SP["seed"])
    toks, tgts = as_tokens(*batches[0], device)
    out = dict(arm=name)
    init = ({n: p.detach().clone() for n, p in named} if ref is not None
            else None)
    # the gradient gate, dropout off
    rate = arm["model"].get("dropout_rate", 0.0)
    for blk in model.blocks:
        blk.dropout_rate = 0.0
    k8 = {}
    with fp32_numerics(), k8_recorded(k8):
        g, _, _ = lm_sp_gradients(model, toks, tgts, mesh)
    for blk in model.blocks:
        blk.dropout_rate = rate
    if ref is not None:
        rel = max(float((tp_whole(g, [d * sp * tp + k for k in range(tp)],
                                  i, dim) - b).abs().max()
                        / b.abs().max().clamp_min(1e-30))
                  for d in range(dp) for i, (dim, b) in
                  enumerate(zip(dims, ref[d])))
        if not rel <= SP["grad_rtol"]:
            raise AssertionError(f"20a {name}: the sp- and tp-summed "
                                 f"gradients are {rel} relative from tp = "
                                 "1's")
        out["grad_rel_err"] = rel
    for k, (pos, view) in enumerate(zip(dp_pos, dp_views)):
        local = [g[p] for p in pos]
        red = [sum_gradients(local, view, fused=f,
                             **sp_reduce_kw(name, TP_ARMS))
               for f in (None, False)]
        if not all(same_bits(a, b) for a, b in zip(red[0][0], red[1][0])):
            raise AssertionError(f"20a {name}: tp index {k}'s dp reduce's "
                                 "kernels differ from its plain version")
    del g, local, red
    if k8:
        out["k8_shapes"] = tp_k8_check(k8)
    del k8
    if arm["model"]["attn_impl"] == "flash":
        out["k9_k10"] = sp_kernel_check(model, toks, mesh, "20a")
    opt = sgd(lambda s: SP["lr"], momentum=0.9)
    state = create_train_state(model, opt)
    step = make_lm_train_step(model, opt, mesh, **sp_step_kw(name, TP_ARMS))
    torch.cuda.synchronize()
    reset_counts()
    secs, losses = [], []
    for tk, tg in batches:
        t0 = now()
        state, m = step(state, tk, tg)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        secs.append(now() - t0)
    launches = read_counts()
    local_numel = [shard_param(p.detach(), specs[n][0], 0, tp).numel()
                   for n, p in named]
    buckets = len(bucket_layout(local_numel, DEFAULT_BUCKET_ELEMS))
    want = tp_design(name, len(named), buckets)
    per_step = {k: v // SP["steps"] for k, v in launches.items() if v}
    if per_step != {k: v for k, v in want.items() if v} or any(
            v % SP["steps"] for v in launches.values()):
        raise AssertionError(f"20a {name}: launches {launches} over "
                             f"{SP['steps']} steps, the design {want}")
    if not all(math.isfinite(x) for x in losses) or abs(
            losses[0] - math.log(LM_MODEL["vocab_size"])) > LM_LOSS_BAND:
        raise AssertionError(f"20a {name}: losses {losses}")
    # the split: one more first-batch step's forward/backward (its dropout
    # keys those of a step numbered SP["steps"]) and its dp reduces

    def key_fn(d, j, micro):
        return step_dropout_key(0, SP["steps"], 1, micro, d, j)

    with fp32_numerics():
        torch.cuda.synchronize()
        t0 = now()
        g, _, _ = lm_sp_gradients(model, toks, tgts, mesh, key_fn=key_fn)
        torch.cuda.synchronize()
        t1 = now()
        for pos, view in zip(dp_pos, dp_views):
            sum_gradients([g[p] for p in pos], view,
                          **sp_reduce_kw(name, TP_ARMS))
        torch.cuda.synchronize()
        t2 = now()
    del g
    tokens = dp * SP["rows"] * SP["seq"]
    out.update(losses=losses, step_ms=[x * 1e3 for x in secs],
               fwd_bwd_ms=(t1 - t0) * 1e3, reduce_ms=(t2 - t1) * 1e3,
               tokens_per_s=tokens * (len(secs) - 1) / sum(secs[1:]),
               launches_per_step=per_step, leaves=len(named),
               local_elements=sum(local_numel), buckets=buckets)
    del state, step, opt
    torch.cuda.empty_cache()
    if init is not None:
        out["scan"] = tp_scan_check(device, name, init, mesh, batches,
                                    losses, model)
    del model, init
    torch.cuda.empty_cache()
    return out


def tp_cli_argv(dp: int = 1) -> list:
    """20b's LM CLI: the serving width at ``LM_EMU_CLI_VOCAB`` tokens,
    ``--tp`` 2 (x ``--dp`` ``dp`` on a `LocalMesh`), 20a's ring arm
    without sp (xla attention, the APS e5m2 RTNE ring reduce), batch 4 of
    2048 tokens, 2 iterations."""
    L = LM_MODEL
    argv = ["--vocab-size", str(LM_EMU_CLI_VOCAB), "--d-model",
            str(L["d_model"]), "--n-layers", str(L["n_layers"]),
            "--n-heads", str(L["n_heads"]), "--n-kv-heads",
            str(L["n_kv_heads"]), "--seq-len", str(SP["seq"]),
            "--batch-size", str(SP["rows"]), "--tp", str(TP["tp"]),
            "--use_APS", "--grad_exp", str(SP["fmt"][0]), "--grad_man",
            str(SP["fmt"][1]), "--mode", "ring", "--attn-impl", "xla",
            "--max-iter", "2", "--print-freq", "1"]
    return argv + (["--dp", str(dp)] if dp > 1 else [])


def tp_held(model, state) -> dict:
    """The digest of each tp index's weights and momentum (a `LocalMesh`
    model at ``tp_size`` 1 cut into the mesh's tp shards, a process's
    shard model as it is) and the bytes one tp rank holds of them."""
    import hashlib

    import torch

    from cpd_tpu_torch.models.transformer import lm_param_specs, shard_param

    named = list(model.named_parameters())
    specs = lm_param_specs(named)
    pairs = ([(specs[n][0], p.detach()) for n, p in named]
             + [(specs[n][0], m) for (n, _), m in
                zip(named, state.opt_state.momentum_buf)])
    tp = TP["tp"] if model.tp_size == 1 else 1
    digests, held = [], 0
    for k in range(tp):
        h, held = hashlib.sha256(), 0
        for kind, t in pairs:
            t = shard_param(t, kind, k, tp).contiguous()
            held += t.numel() * t.element_size()
            h.update(t.view(-1).view(torch.uint8).cpu().numpy().tobytes())
        digests.append(h.hexdigest())
    return dict(shard_digests=digests, held_bytes=held)


def tp_shapes(vocab: int) -> dict:
    """From the shapes alone: the fp32 bytes of weights and momentum one
    tp rank holds (the wq/wkv/wi columns and the wo/wo_mlp rows cut into
    tp shards, the embedding and the LayerNorms whole) and the bytes it
    hands to the tp all-gathers in one 20b step: two tp sums a layer of
    the (rows, T, d_model) fp32 activations forward and two backward,
    then the replicated leaves' gradients once."""
    L, tp = LM_MODEL, TP["tp"]
    d, n = L["d_model"], L["n_layers"]
    hd = d // L["n_heads"]
    sharded = (d * d + d * 2 * L["n_kv_heads"] * hd + d * d
               + 2 * d * L["d_ff"]) // tp
    replicated = vocab * d + n * 4 * d + 2 * d
    act = SP["rows"] * SP["seq"] * d * 4
    return dict(held_bytes=(n * sharded + replicated) * 4 * 2,
                tp_bytes={"tp.all_gather": n * 4 * act + replicated * 4})


def tp_dist_check(ranks: list, refs: dict, worlds: list) -> dict:
    """20b/20c's gates on `sp_dist`'s ranks: every rank's loss,
    validation and weights and momentum bitwise its tp index's shard of
    its `LocalMesh` reference, rank 0's loss lines its reference's, and
    its held bytes and tp bytes a step the shapes' (`tp_shapes`)."""
    shapes = tp_shapes(LM_EMU_CLI_VOCAB)
    out = {}
    for part, w in zip("bc", worlds):
        if w % TP["tp"]:
            continue
        want = refs[("tp", w)]
        for rk in ranks[:w]:
            got = rk["parts"][part]["tp"]
            k = rk["rank"] % TP["tp"]
            if (got["loss"], got["val"], got["shard_digests"][0]) != (
                    want["loss"], want["val"], want["shard_digests"][k]):
                raise AssertionError(
                    f"20{part} rank {rk['rank']}: loss {got['loss']} val "
                    f"{got['val']} shard {got['shard_digests'][0]} differ "
                    f"from the LocalMesh's {want['loss']} {want['val']} "
                    f"tp shard {k} {want['shard_digests'][k]}")
            if rk["rank"] == 0 and got["lines"] != want["lines"]:
                raise AssertionError(f"20{part}: rank 0's loss lines "
                                     f"{got['lines']} != {want['lines']}")
            if got["held_bytes"] != shapes["held_bytes"]:
                raise AssertionError(f"20{part} rank {rk['rank']}: holds "
                                     f"{got['held_bytes']} bytes of "
                                     "weights and momentum, the shapes "
                                     f"say {shapes['held_bytes']}")
            if any(log != shapes["tp_bytes"] for log in got["logs"]):
                raise AssertionError(f"20{part} rank {rk['rank']}: tp "
                                     f"bytes {got['logs']} != "
                                     f"{shapes['tp_bytes']}")
        out[part] = dict(
            world=w, backend="gloo" if part == "b" else "nccl",
            dp=w // TP["tp"], tp=TP["tp"], loss=want["loss"],
            val=want["val"], held_bytes=shapes["held_bytes"],
            tp_bytes_per_step=shapes["tp_bytes"],
            cli_seconds=[rk["parts"][part]["tp"]["seconds"]
                         for rk in ranks[:w]],
            local_seconds=want["seconds"])
        where = ("gloo processes sharing the card" if part == "b"
                 else "nccl processes, one a card")
        print(f"tp dist 20{part}: {w} {where} at dp {w // TP['tp']} x tp "
              f"{TP['tp']}, the CLI's losses, "
              "weights and momentum bitwise the LocalMesh's tp shards, "
              "bytes held and tp bytes a rank and step as the shapes say; "
              + json.dumps(out[part]), flush=True)
    return out


def tp_phase(device, ref: dict, card: str) -> dict:
    """Phase 20: 20a's arms (the ring arm's gradients against phase 19a's
    ``ref["grads"]``, its scanned twin), the mask check, then one spawn
    for 19b/19c and 20b/20c (`sp_dist`)."""
    import torch

    from cpd_tpu_torch.obs.timing import now

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    marks = [now()]
    out = dict(mask=sp_mask_check(device, step=1, dp_index=0, layer=3,
                                  label="20a"), arms={})
    for name in TP_ARMS:
        r = out["arms"][name] = tp_arm(
            device, name, ref.pop("grads") if name == "tp-ring" else None)
        dims = f"dp {TP['dp']} x sp {TP['sp']} x tp {TP['tp']} LocalMesh"
        for key, label in (("step_ms", "step ms"), ("fwd_bwd_ms",
                                                     "fwd_bwd_ms"),
                           ("reduce_ms", "reduce_ms"),
                           ("tokens_per_s", "tokens/s")):
            print(f"train tp 20a {name} {label}: {json.dumps(r[key])} "
                  f"({dims}; {card})", flush=True)
        print(f"train tp 20a {name}: " + json.dumps(r), flush=True)
    marks.append(now())
    out["dist"] = sp_dist(device)
    marks.append(now())
    out["seconds"] = dict(a=marks[1] - marks[0], bc=marks[2] - marks[1],
                          **out["dist"]["seconds"])
    print("tp mask 20a: " + json.dumps(out["mask"]), flush=True)
    print("tp seconds: " + json.dumps(out["seconds"]), flush=True)
    return out


OVERLAP_NCCL = dict(steps=12, warmup=2, deadline=600.0)
# host calls that wait for the device (or a copy to finish)
HOST_SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "aten::_local_scalar_dense")


def _union_us(spans: list) -> float:
    """Microseconds covered by the union of ``(start, end)`` spans."""
    total, end = 0.0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def overlap_trace(prof) -> dict:
    """What one profiled step did: its device kernels' span, busy union
    and idle share; the nccl kernels' count and busy union; how many
    backward convolution or GEMM kernels (`COMPUTE_MARKS`) started after
    the first nccl kernel and how many ran while one ran; the host's
    calls that wait for the device (`HOST_SYNCS`), by name; and the
    host's CUDA runtime calls with the most time (count, ms)."""
    from torch.autograd import DeviceType

    kern, syncs, runtime = [], {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kern.append((e.time_range.start, e.time_range.end, e.name))
            continue
        if e.name in HOST_SYNCS:
            syncs[e.name] = syncs.get(e.name, 0) + 1
        if e.name.startswith("cu"):
            n, t = runtime.get(e.name, (0, 0.0))
            runtime[e.name] = (n + 1, t + (e.time_range.end
                                           - e.time_range.start) / 1e3)
    kern.sort()
    nccl = [(s, e) for s, e, n in kern if "nccl" in n.lower()]
    compute = [(s, e) for s, e, n in kern
               if any(m in n.lower() for m in COMPUTE_MARKS)]
    first = min((s for s, _ in nccl), default=None)
    span = (kern[-1][1] - kern[0][0]) if kern else 0.0
    busy = _union_us([(s, e) for s, e, _ in kern])
    return dict(
        kernels=len(kern), span_ms=span / 1e3, busy_ms=busy / 1e3,
        idle_share=(1.0 - busy / span) if span else None,
        nccl_kernels=len(nccl), nccl_ms=_union_us(nccl) / 1e3,
        compute_kernels=len(compute),
        compute_after_first_nccl=(0 if first is None else
                                  sum(1 for s, _ in compute if s > first)),
        compute_beside_nccl=sum(1 for s, e in compute
                                if any(s < ne and ns < e
                                       for ns, ne in nccl)),
        host_syncs=syncs,
        host_runtime=dict(sorted(runtime.items(),
                                 key=lambda kv: -kv[1][1])[:8]))


def overlap_nccl_rank(device, port: int, cards: int,
                      backend: str = "nccl") -> dict:
    """One process of ``--overlap-nccl``: a card each (``backend``
    gloo and a CPU ``device`` run it on the CPU), every arm of
    `ZERO_NCCL_ARMS` for OVERLAP_NCCL["steps"] timed steps, then one
    profiled step (`overlap_trace`)."""
    import torch
    import torch.distributed as dist

    from cpd_tpu_torch.obs.timing import now
    from cpd_tpu_torch.parallel.dist import dist_init, local_rows
    from cpd_tpu_torch.parallel.mesh import ProcessMesh

    rank = int(os.environ["RANK"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist_init(backend, rank=rank, world_size=cards, local_rank=rank,
              init_method=f"tcp://localhost:{port}")
    mesh = ProcessMesh(device)
    cuda = mesh.device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    n = OVERLAP_NCCL["steps"]
    batches = zero_world_batches(cards, n + 1)
    acts = [torch.profiler.ProfilerActivity.CPU] + (
        [torch.profiler.ProfilerActivity.CUDA] if cuda else [])
    out = {}
    for name in ZERO_NCCL_ARMS:
        model, state, step, _ = zero_build(mesh.device, name, mesh, None)
        secs, losses = [], []
        for bx, by in batches:
            sync()
            t1 = now()
            if len(secs) == n:
                with torch.profiler.profile(activities=acts) as prof:
                    state, m = step(state, local_rows(bx, mesh),
                                    local_rows(by, mesh))
                    sync()
            else:
                state, m = step(state, local_rows(bx, mesh),
                                local_rows(by, mesh))
                sync()
            secs.append((now() - t1) * 1e3)
            losses.append(float(m["loss"]))
        out[name] = dict(step_ms=secs[:n], profiled_ms=secs[n],
                         losses=losses, trace=overlap_trace(prof))
        del model, state, step
        if cuda:
            torch.cuda.empty_cache()
    dist.destroy_process_group()
    return out


def overlap_summary(ranks: list) -> dict:
    """Each arm's timed steps past the warmup (every rank's median, the
    slowest rank's min and max) and every rank's trace; raises unless each
    ``<x>+overlap`` arm's losses are bitwise ``<x>``'s on every rank."""
    import statistics

    k = OVERLAP_NCCL["warmup"]
    out = {}
    for name in ZERO_NCCL_ARMS:
        base, _, extra = name.partition("+")
        for r, res in enumerate(ranks):
            if extra and res[name]["losses"] != res[base]["losses"]:
                raise AssertionError(
                    f"--overlap-nccl rank {r}: {name} losses "
                    f"{res[name]['losses']} != {base}'s "
                    f"{res[base]['losses']}")
        timed = [res[name]["step_ms"][k:] for res in ranks]
        out[name] = dict(
            median_ms=[statistics.median(t) for t in timed],
            min_ms=max(min(t) for t in timed),
            max_ms=max(max(t) for t in timed),
            steps=len(timed[0]), profiled_ms=ranks[0][name]["profiled_ms"],
            traces=[res[name]["trace"] for res in ranks])
    return out


def overlap_nccl_main() -> int:
    """``--overlap-nccl`` (module docstring)."""
    try:
        import torch
    except ImportError as e:
        return fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False: this run needs "
                    "NVIDIA cards")
    cards = torch.cuda.device_count()
    if cards < 2:
        return fail(f"--overlap-nccl needs 2 cards or more, found {cards}")
    try:
        from cpd_tpu_torch.ops.build import build_all
    except ImportError as e:
        return fail(f"cpd_tpu_torch is not importable (run from the root "
                    f"of a checkout): {e}")
    from cpd_tpu_torch.obs.timing import now
    from cpd_tpu_torch.parallel.launch import _free_port, spawn

    card = card_line()
    print(f"card: {card}", flush=True)
    t0 = now()
    build_all()
    print(f"build: all kernels in {now() - t0:.1f} s", flush=True)
    t0 = now()
    ranks = spawn(overlap_nccl_rank, cards,
                  args=(DEVICE, _free_port(), cards),
                  timeout=OVERLAP_NCCL["deadline"],
                  env={"NCCL_DEBUG": "WARN"})
    out = dict(cards=cards, seconds=now() - t0, steps=OVERLAP_NCCL["steps"],
               warmup=OVERLAP_NCCL["warmup"],
               per_rank_batch=ZERO["per_rank_batch"],
               bucket_elems=ZERO["bucket_elems"],
               arms=overlap_summary(ranks))
    print("overlap nccl: each +overlap arm's losses bitwise its pair's on "
          "every rank", flush=True)
    print(card, flush=True)
    print(json.dumps(out), flush=True)
    return 0


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

    # the rank processes of phases 14-17 and 20 (17b's are the most)
    # import while the kernels build
    POOL.start(ZERO["dist_world"] + 1
               + min(torch.cuda.device_count(), DIST["max_cards"]))
    t0 = now()
    build_all()
    print(f"build: all kernels in {now() - t0:.1f} s", flush=True)
    for name in ("serve_attn", "quantize", "qgemm", "flash_gqa",
                 "flash_mha_tc", "flash_f32_tc"):
        for line in build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}", flush=True)

    phase_seconds = {}
    shared, text_done = shared_setup()

    def timed(name, fn, *args, **kwargs):
        # each phase's wall seconds, printed on one line after the last
        t = now()
        out = fn(*args, **kwargs)
        phase_seconds[name] = now() - t
        return out

    kern = timed("2", kernel_phase, device)
    quant = timed("3", quantize_phase, device)
    quant.update(timed("7", sr_quantize_phase, device))
    serve = timed("4", serve_phase, device)
    timed("5", profile_phase, device)
    train = timed("6", train_phase, device)
    sr_train = timed("8", sr_train_phase, device, train)
    blocked = timed("9a", blocked_quantize_phase, device)
    blocked_train = timed("9b", blocked_train_phase, device)
    qgemm = timed("10a", qgemm_phase, device)
    phase_seconds.update({f"10a {k}": v for k, v in qgemm["split_s"].items()})
    flash = timed("10b", flash_phase, device)
    lm = timed("10c-f", lm_phase, device)
    mha = timed("11a", mha_phase, device)
    split = timed("11a split", split_head_dim_phase, device)
    bench_lm = timed("11b-c", bench_lm_phase, device)
    # 11d: bench.py's GQA flash arm through K9/K10 bf16
    gqa_lm = timed("11d", bench_slice, device, "bench gqa lm",
                   GQA_BF16_KERNELS, **GQA_PATH)
    print("train bench gqa lm seconds: " + json.dumps(gqa_lm["seconds"]),
          flush=True)
    text_done()       # the last LM CLI at 32000 tokens has run
    headline = timed("12", headline_phase, device)
    print("train headline seconds: " + json.dumps(headline["seconds"]),
          flush=True)
    emulate = timed("13", emulate_phase, device)
    dist = timed("14", dist_phase, device)
    print("dist seconds: " + json.dumps({k: v["seconds"]
                                         for k, v in dist.items()}),
          flush=True)
    ladder = timed("15", ladder_phase, device)
    switches = timed("16", switches_phase, device)
    zero = timed("17", zero_phase, device)
    quant_layers = timed("18", quant_layers_phase, device, train)
    tp_ref = {}        # phase 19a's sp-summed gradients: 20a's tp = 1
    seq_par = timed("19", sp_phase, device, tp_ref)
    tensor_par = timed("20", tp_phase, device, tp_ref, card)
    print("phase seconds: " + json.dumps(phase_seconds), flush=True)
    print("shared setup: " + json.dumps(shared), flush=True)
    if dist["b"]["world"] == 1:
        # at W = 1, 14b's headline is phase 12's: the same seed, batches
        # and steps on one rank, through the ProcessMesh in place of the
        # LocalMesh
        for mode, r in headline["modes"].items():
            got = dist["b"]["ranks"][0]["headline"]["modes"][mode]["losses"]
            if got != r["losses"]:
                return fail(f"14b headline {mode} losses at W=1 {got} != "
                            f"phase 12's LocalMesh {r['losses']}")
        print("dist 14b headline: the W=1 losses of both modes bitwise "
              "phase 12's LocalMesh", flush=True)

    main_case = kern["cases"]["e4m3"]
    kernels = [dict(
        name="serve_attn", route="cuda",
        source="cpd_tpu_torch/csrc/serve_attn.cu",
        replaces="cpd_tpu/ops/serve_attn.py:47",
        launches=serve["kernel_launches"],
        max_abs_err=max(c["max_abs_err"] for c in kern["cases"].values()),
        ms=main_case["ms"], plain_ms=main_case["plain_ms"],
        bound_ms=main_case["bound_ms"], bound_by=main_case["bound_by"],
        bound_basis="distinct gathered pages read once; int64 digests",
        library_ms=main_case["library_ms"],
        library_note="scaled_dot_product_attention on K/V unpacked and "
                     "expanded ahead: attention only, not the same "
                     "function",
        kept_ms=main_case["kept_ms"], speedup=main_case["speedup"],
        call_ms=main_case["call_ms"],
        parity="digests bitwise; attn within atol "
               f"{ATTN_ATOL} rtol {ATTN_RTOL} in every case; two launches "
               "bitwise",
        cases={k: {"max_abs_err": c["max_abs_err"], "ms": c["ms"],
                   "kept_ms": c["kept_ms"], "bound_ms": c["bound_ms"]}
               for k, c in kern["cases"].items()})]
    # each kernel's launches from the main path that runs it, counted from
    # 0 around that run: the RTNE ring training (K1, K6, K5), the faithful
    # CLI (K3), the SR ring training (sr_bits, K2, K6-SR, K5-SR) and the
    # SR Kahan faithful CLI (K4)
    # the headline step's launches of K1 (both modes) and K3 (faithful)
    headline_runs = {k: headline["launches"].get(k, 0)
                     for k in ("quantize_cast", "quantize_add")}
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
            **({"launches_headline": headline_runs[name]}
               if name in headline_runs else {}),
            **{k: q[k] for k in ("ms_with_digest", "bound_pipe",
                                 "sass_per_element") + WIRE_FIELDS
               if k in q}))
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
            parity=("bitwise its plain version and the kept two-launch "
                    "kernel in every row count, size and alignment case, "
                    "back to back and on two streams; and the blocked "
                    "verified training kernels == plain"
                    if name == "digest_rows" else
                    "bitwise (fp32 partials, wire bytes with the sidecar, "
                    "digests) in every format, block and size case; and "
                    "the blocked verified training kernels == plain"),
            shape=q["shape"],
            **{k: q[k] for k in ("ms_with_digest",) + WIRE_FIELDS
               if k in q}))
    # phase 13's launches per step of each arm (the emulate-node reduce,
    # the APS reduce and quant_sgd's casts), and the flat bits arm
    for entry in kernels:
        per_arm = {a: r["launches_per_step"].get(entry["name"], 0)
                   for a, r in emulate["arms"].items()}
        if any(per_arm.values()):
            entry["launches_per_step_emulate"] = per_arm
        if entry["name"] == "sr_bits":
            entry["flat_arm"] = emulate["flat_bits"]
        # phase 14a's launches per rank per arm on the process mesh
        per_arm = {a: e["launches"].get(entry["name"], 0) for a, e in
                   dist["a"]["ranks"][0]["matrix"]["arms"].items()}
        if any(per_arm.values()):
            entry["launches_per_rank_process_mesh"] = per_arm
    # phase 15a/15b's launches per step of each rung of the ladder
    for entry in kernels:
        if entry["name"] in LADDER_KERNELS:
            entry["launches_per_step_ladder"] = {
                rung: counts.get(entry["name"], 0)
                for rung, counts in ladder["launches_per_step"].items()}
    kernels += lm_kernel_entries(qgemm, flash, lm)
    kernels += mha_kernel_entries(mha, bench_lm)
    kernels += gqa_bf16_kernel_entries(flash, mha, gqa_lm)
    kernels += split_kernel_entries(split)
    # phase 16a's launches per step of the LM at emulate_node 2 (RTNE, and
    # its SR step), 16b's per rank and step on the gloo process mesh
    lm_emu = switches["a"]
    for entry in kernels:
        per = {arm: counts.get(entry["name"], 0) for arm, counts in (
            ("rtne", lm_emu["launches_per_step"]),
            ("sr", lm_emu["sr_launches_per_step"]))}
        if any(per.values()):
            entry["launches_per_step_lm_emulate"] = per
        per = {arm: counts.get(entry["name"], 0) for arm, counts in
               switches["b"]["a"]["launches_per_rank"].items()}
        if any(per.values()):
            entry["launches_per_rank_lm_process_mesh"] = per
    # phase 17a's launches per step of each arm (overlap and ZeRO), and
    # the offset-array arm of sr_bits
    for entry in kernels:
        per = {arm: r["launches_per_step"].get(entry["name"], 0)
               for arm, r in zero["a"]["arms"].items()}
        if any(per.values()):
            entry["launches_per_step_zero"] = per
        if entry["name"] == "sr_bits":
            entry["offset_arm"] = dict(
                zero["offset_arm"], launches_per_step_zero={
                    arm: r["launches_per_step"].get("sr_bits_offsets", 0)
                    for arm, r in zero["a"]["arms"].items()})
    kernels += quant_kernel_entries(quant_layers)
    # phase 19a's launches per step of each arm on the dp x sp LocalMesh
    for entry in kernels:
        per = {arm: r["launches_per_step"].get(entry["name"], 0)
               for arm, r in seq_par["arms"].items()}
        if any(per.values()):
            entry["launches_per_step_sp"] = per
    # phase 20a's launches per step of each arm on the dp x sp x tp
    # LocalMesh
    for entry in kernels:
        per = {arm: r["launches_per_step"].get(entry["name"], 0)
               for arm, r in tensor_par["arms"].items()}
        if any(per.values()):
            entry["launches_per_step_tp"] = per
    print(card, flush=True)      # exactly as nvidia-smi gives it
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = (overlap_nccl_main() if sys.argv[1:] == ["--overlap-nccl"]
              else main())
    finally:
        POOL.close()
        for _root in _SAVE_ROOT:
            shutil.rmtree(_root, ignore_errors=True)
    sys.exit(rc)
