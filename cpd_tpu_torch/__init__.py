"""cpd_tpu_torch — the PyTorch/CUDA port of `cpd_tpu`.

A second package beside the JAX one, which stays the reference: every
module here mirrors a `cpd_tpu` module of the same name (the numerics in
`quant/numerics.py`, the page digests in `parallel/integrity.py`, the
paged KV cache in `serve/kvcache.py`, ...) and is held against it by the
tests in `tests/test_torch_*.py`.  The port imports torch and numpy only —
never jax, flax or any module of `cpd_tpu`.

Ported so far: continuous-batching serving of the transformer LM at
tp=1, whose decode attention runs through a hand-written CUDA kernel
(`ops/serve_attn.py`, `csrc/serve_attn.cu`); data-parallel training
of ResNet-18/CIFAR with the APS low-precision gradient reduce, whose
casts, ring hops and ordered-scan steps run through hand-written CUDA
kernels (`ops/quantize.py`, `csrc/quantize.cu`); and data-parallel
training of the GQA transformer LM, whose attention runs through
hand-written flash kernels (`ops/flash_gqa.py`, `csrc/flash_gqa.cu`) and
whose MLP GEMMs accumulate in eXmY through a hand-written
quantized-Kahan GEMM kernel (`quant/quant_module.py`, `ops/qgemm.py`,
`csrc/qgemm.cu`); and bench.py's MHA LM in bf16 compute over fp32
weights, whose attention runs through the MHA flash kernel
(`ops/flash_mha.py`, the same `csrc/flash_gqa.cu` kernels at rep = 1).
Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; asking for ``cuda`` on a host without it raises
(`device.resolve_device`).
"""

from .device import resolve_device

__all__ = ["resolve_device"]
