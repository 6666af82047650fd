"""bench.py's headline step on the port: ResNet-50 training throughput on
one NVIDIA card.

    python -m cpd_tpu_torch.bench

The workload of the repo's ``bench.py`` (its headline arms,
``bench.py:283-340``): `models.resnet.resnet50` at ``dtype=bfloat16``
(bf16 compute over fp32 master weights), SGD with momentum 0.9 and
weight decay 1e-4 under ``warmup_step_decay(3.2, 500, [3000, 6000])``,
the APS e5m2 gradient reduce (``use_aps=True``, ``grad_exp=5``,
``grad_man=2``) in ``mode="faithful"`` and then ``mode="fast"``, each
from a fresh state (weights from seed 0), on one rank on the card
(bench.py's one-card mesh), batch 32 at 224 x 224, images and labels
drawn from ``np.random.RandomState(0)`` as bench.py draws them (16
batches, the images rounded to bf16).  Each mode runs 3 warm steps, then
10 timed steps (host clock between synchronisations), then one step
split into its forward and backward, its reduce and its update.

Prints ONE JSON line: ``metric`` ("resnet50_train_img_per_sec_per_chip"),
``value`` (the faithful images/s per card), ``fast`` (the fast-mode
images/s), the step's split in each mode (``fwd_bwd_ms``, ``reduce_ms``,
``update_ms``), peak device memory, the quantize kernels' launches per
step, the losses, the card's name and power limit as nvidia-smi gives
them, and ``tflops_per_sec``/``mfu_pct``: ``FLOPS_PER_IMG`` (bench.py's
FLOP count of a ResNet-50 forward and backward at 224 x 224) at the
faithful rate over the H100's dense bf16 peak, named beside them.  It
carries no number taken on or for a TPU.  Without a CUDA device it
prints ``value: null`` with an ``error`` and exits 1; it never prints
an estimate.
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np

__all__ = ["run", "main", "headline_batches", "headline_step",
           "step_split", "FLOPS_PER_IMG", "PEAK_BF16_TFLOPS"]

METRIC = "resnet50_train_img_per_sec_per_chip"
# bench.py:72: ResNet-50 forward + backward at 224 x 224, two flops a MAC
FLOPS_PER_IMG = 24.6e9
# NVIDIA's data sheet for the H100 SXM: dense bf16 tensor-core peak
PEAK_BF16_TFLOPS = 989.0
PEAK_NAME = "NVIDIA H100 SXM dense bf16 (data sheet), 989 TFLOP/s"
FMT = (5, 2)
WORLD, BATCH, IMAGE_SIZE = 1, 32, 224
WARMUP, STEPS = 3, 10
# bench.py draws BENCH_FUSE_STEPS (16) batches at once; the steps cycle
# over them
FUSE = 16
SEED = 0
# the quantize wrappers whose launches a step reports
_COUNTED = ("quantize_cast", "quantize_cast_sr", "quantize_add",
            "quantize_add_sr", "quantize_pack", "hop_pack", "digest_rows",
            "sr_bits")


def card_line() -> str:
    """``name, power limit`` as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def headline_batches(world: int, batch: int, size: int, device,
                     fuse: int = FUSE) -> tuple:
    """bench.py's inputs: ``fuse`` global batches of ``world * batch``
    NHWC images, ``RandomState(0).randn`` rounded to bf16, and labels in
    [0, 1000), on ``device``."""
    import torch

    rng = np.random.RandomState(SEED)
    x = rng.randn(fuse, batch * world, size, size, 3).astype(np.float32)
    y = rng.randint(0, 1000, (fuse, batch * world)).astype(np.int32)
    return (torch.from_numpy(x).to(device).to(torch.bfloat16),
            torch.from_numpy(y).to(device))


def headline_step(mode: str, mesh):
    """A fresh ``(model, opt, state, step)`` of bench.py's headline arm in
    ``mode`` on ``mesh``: the bf16 ResNet-50 from seed 0, SGD, APS
    e5m2."""
    import torch

    from .models.resnet import resnet50
    from .train import (create_train_state, make_train_step, sgd,
                        warmup_step_decay)

    gen = torch.Generator(device=mesh.device).manual_seed(SEED)
    model = resnet50(dtype=torch.bfloat16,
                     device=mesh.device).init_weights(gen)
    opt = sgd(warmup_step_decay(3.2, 500, [3000, 6000]), momentum=0.9,
              weight_decay=1e-4)
    state = create_train_state(model, opt)
    step = make_train_step(model, opt, mesh, mode=mode, use_aps=True,
                           grad_exp=FMT[0], grad_man=FMT[1])
    return model, opt, state, step


def _launches() -> dict:
    from .ops import quantize as tq

    return {k: getattr(tq, k).launches for k in _COUNTED}


def step_split(model, opt, state, mesh, images, labels, mode: str) -> dict:
    """One train step of the headline arm taken apart: the forward and
    backward of every rank, the reduce and the update (SGD and the BN
    stats' rank mean), each on the host clock between synchronisations.
    It updates ``state`` as the step does."""
    import torch

    from .obs.timing import now
    from .parallel.dist import sum_gradients
    from .train import as_batch, fp32_numerics, local_gradients

    x, y = as_batch(images, labels, mesh.device)
    with fp32_numerics():
        torch.cuda.synchronize()
        t0 = now()
        grads, new_stats, _, _ = local_gradients(model, x, y, mesh)
        torch.cuda.synchronize()
        t1 = now()
        reduced = sum_gradients(grads, mesh, use_aps=True, grad_exp=FMT[0],
                                grad_man=FMT[1], mode=mode)
        torch.cuda.synchronize()
        t2 = now()
        state.opt_state = opt.apply(reduced[0], state.opt_state,
                                    state.params)
        with torch.no_grad():
            for j, s in enumerate(state.batch_stats):
                s.copy_(mesh.mean([ns[j] for ns in new_stats])[0])
        torch.cuda.synchronize()
        t3 = now()
    state.step += 1
    return dict(fwd_bwd_ms=(t1 - t0) * 1e3, reduce_ms=(t2 - t1) * 1e3,
                update_ms=(t3 - t2) * 1e3)


def _measure(mode: str, mesh, batches) -> dict:
    """WARMUP then STEPS timed steps of a fresh headline arm in ``mode``,
    then one split step."""
    import torch

    from .obs.timing import now

    x, y = batches
    model, opt, state, step = headline_step(mode, mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for i in range(WARMUP):
        state, m = step(state, x[i % len(x)], y[i % len(y)])
        losses.append(m["loss"])
    torch.cuda.synchronize()
    before = _launches()
    t0 = now()
    for i in range(WARMUP, WARMUP + STEPS):
        state, m = step(state, x[i % len(x)], y[i % len(y)])
        losses.append(m["loss"])
    torch.cuda.synchronize()
    seconds = now() - t0
    after = _launches()
    i = WARMUP + STEPS
    split = step_split(model, opt, state, mesh, x[i % len(x)],
                       y[i % len(y)], mode)
    # every rank runs on the one card: its images/s are the card's
    return dict(
        img_per_s=mesh.world * BATCH * STEPS / seconds,
        step_ms=seconds / STEPS * 1e3, losses=[float(v) for v in losses],
        launches_per_step={k: (after[k] - before[k]) // STEPS
                           for k in _COUNTED if after[k] != before[k]},
        peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        n_params=sum(p.numel() for p in model.parameters()),
        n_leaves=len(list(model.parameters())), **split)


def run(device="cuda") -> dict:
    """The headline arms on ``device`` (a CUDA device); the result that
    `main` prints.  Raises where there is no card."""
    import torch

    from .device import resolve_device
    from .parallel.mesh import data_parallel_mesh

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the bench measures a CUDA device; got "
                           f"{dev}")
    mesh = data_parallel_mesh(WORLD, dev)
    batches = headline_batches(WORLD, BATCH, IMAGE_SIZE, dev)
    modes = {m: _measure(m, mesh, batches) for m in ("faithful", "fast")}
    ips = modes["faithful"]["img_per_s"]
    tflops = ips * FLOPS_PER_IMG / 1e12
    return dict(metric=METRIC, value=ips, unit="img/s",
                fast=modes["fast"]["img_per_s"], modes=modes,
                config=dict(arch="resnet50", dtype="bfloat16", world=WORLD,
                            batch_per_rank=BATCH, image_size=IMAGE_SIZE,
                            grad_format=list(FMT), use_aps=True,
                            warmup_steps=WARMUP, timed_steps=STEPS),
                device=dict(kind=torch.cuda.get_device_name(dev),
                            count=torch.cuda.device_count(),
                            card=card_line()),
                tflops_per_sec=tflops,
                mfu_pct=100.0 * tflops / PEAK_BF16_TFLOPS, peak=PEAK_NAME)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print(json.dumps({
            "metric": METRIC, "value": None, "unit": "img/s",
            "error": "torch.cuda.is_available() is False: the bench "
                     "measures an NVIDIA card and prints no estimate"}),
            flush=True)
        return 1
    print(json.dumps(run()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
