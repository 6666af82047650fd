"""ImageNet ResNets (port of `cpd_tpu/models/resnet.py`).

ResNet-v1 for 224x224 inputs: a 7x7/2 stem conv, BN, ReLU and a 3x3/2
max-pool, four stages of `Bottleneck` (ResNet-50/101: 1x1 reduce, 3x3
with the stride, 1x1 expand x4) or `BasicBlockV1` (ResNet-18/34: two
3x3) blocks at widths 64/128/256/512, a global average pool and a
``num_classes`` head: 25.6 M parameters for ResNet-50.  NCHW.  Module
names are the flax ones (``stem_conv``, ``stem_bn``,
``layer{s}_block{b}.conv1`` ... ``downsample_bn``, ``fc``), so a flax
variables tree maps onto it one to one (`interop.load_jax_resnet`).

``dtype`` is the compute dtype over fp32 parameters and BN running
stats, as flax's ``dtype`` over ``param_dtype``.  At bf16 it reproduces
flax's casts: each conv takes its input and kernel in bf16 (cuDNN
accumulates in fp32 and rounds its output to bf16); BatchNorm reduces
its statistics of the bf16 activations in fp32 and normalises in fp32,
rounding once to bf16 (flax 0.12's `_compute_stats` and `_normalize`
with ``force_float32_reductions``; `resnet_cifar.BatchNorm`); ReLU,
the max-pool and the residual adds run on bf16; the global mean sums in
fp32 and rounds to bf16; the head is an fp32 Dense, and the logits come
back in fp32.  BatchNorm keeps flax's semantics (momentum 0.9, eps
1e-5, the biased batch variance in the running stats) and the init
flax's (convs kaiming-normal truncated fan-in, the head lecun-normal
truncated with a zero bias), drawn by `init_weights` from a caller's
`torch.Generator`.

FCN's options (``output_stride``, ``features_only``, ``feature_stages``)
and sync-BN (``bn_axis``) are not ported yet and raise.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .resnet_cifar import _TRUNC_STD, BatchNorm

__all__ = ["ResNet", "Bottleneck", "BasicBlockV1", "resnet18", "resnet34",
           "resnet50", "resnet101"]


def _conv(conv: nn.Conv2d, x: torch.Tensor, dtype) -> torch.Tensor:
    """``conv`` with its input and kernel in ``dtype`` (flax's
    ``promote_dtype``); no bias."""
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), None, conv.stride,
                    conv.padding)


class Bottleneck(nn.Module):
    """1x1 reduce -> 3x3 (the stride) -> 1x1 expand x4, and a 1x1
    projection shortcut where the stride or the width changes."""
    expansion = 4

    def __init__(self, cin: int, channels: int, stride: int, device=None):
        super().__init__()
        out = channels * self.expansion
        kw = dict(bias=False, device=device)
        self.conv1 = nn.Conv2d(cin, channels, 1, 1, 0, **kw)
        self.bn1 = BatchNorm(channels, device=device)
        self.conv2 = nn.Conv2d(channels, channels, 3, stride, 1, **kw)
        self.bn2 = BatchNorm(channels, device=device)
        self.conv3 = nn.Conv2d(channels, out, 1, 1, 0, **kw)
        self.bn3 = BatchNorm(out, device=device)
        self.projects = stride != 1 or cin != out
        if self.projects:
            self.downsample_conv = nn.Conv2d(cin, out, 1, stride, 0, **kw)
            self.downsample_bn = BatchNorm(out, device=device)

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        y = F.relu(self.bn1(_conv(self.conv1, x, dtype)))
        y = F.relu(self.bn2(_conv(self.conv2, y, dtype)))
        y = self.bn3(_conv(self.conv3, y, dtype))
        if self.projects:
            x = self.downsample_bn(_conv(self.downsample_conv, x, dtype))
        return F.relu(y + x)


class BasicBlockV1(nn.Module):
    """Two 3x3 convs (the first with the stride), and a 1x1 projection
    shortcut where the stride or the width changes."""
    expansion = 1

    def __init__(self, cin: int, channels: int, stride: int, device=None):
        super().__init__()
        kw = dict(bias=False, device=device)
        self.conv1 = nn.Conv2d(cin, channels, 3, stride, 1, **kw)
        self.bn1 = BatchNorm(channels, device=device)
        self.conv2 = nn.Conv2d(channels, channels, 3, 1, 1, **kw)
        self.bn2 = BatchNorm(channels, device=device)
        self.projects = stride != 1 or cin != channels
        if self.projects:
            self.downsample_conv = nn.Conv2d(cin, channels, 1, stride, 0,
                                             **kw)
            self.downsample_bn = BatchNorm(channels, device=device)

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        y = F.relu(self.bn1(_conv(self.conv1, x, dtype)))
        y = self.bn2(_conv(self.conv2, y, dtype))
        if self.projects:
            x = self.downsample_bn(_conv(self.downsample_conv, x, dtype))
        return F.relu(y + x)


class ResNet(nn.Module):
    """ResNet-v1 for NCHW images (224 x 224 for ImageNet); the input may
    be any float dtype, the convs cast it to ``dtype``.  Returns fp32
    logits."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 block=Bottleneck,
                 widths: Sequence[int] = (64, 128, 256, 512),
                 num_classes: int = 1000, dtype=torch.float32,
                 output_stride: int = 32, features_only: bool = False,
                 feature_stages: Sequence[int] = (), bn_axis=None,
                 device="cuda"):
        super().__init__()
        for name, value, default in (
                ("output_stride", output_stride, 32),
                ("features_only", features_only, False),
                ("feature_stages", tuple(feature_stages), ()),
                ("bn_axis", bn_axis, None)):
            if value != default:
                raise NotImplementedError(
                    f"{name}={value!r}: not yet ported to cpd_tpu_torch "
                    "(FCN's dilated and multi-stage modes and sync-BN; "
                    "ROADMAP Queue A, A7)")
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be float32 or bfloat16, got "
                             f"{dtype}")
        dev = resolve_device(device)
        self.dtype = dtype
        self.stem_conv = nn.Conv2d(3, 64, 7, 2, 3, bias=False, device=dev)
        self.stem_bn = BatchNorm(64, device=dev)
        self.blocks = []
        cin = 64
        for stage, (n_blocks, width) in enumerate(zip(stage_sizes, widths)):
            for b in range(n_blocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                blk = block(cin, width, stride, device=dev)
                self.add_module(f"layer{stage + 1}_block{b}", blk)
                self.blocks.append(blk)
                cin = width * block.expansion
        self.fc = nn.Linear(cin, num_classes, device=dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.stem_bn(_conv(self.stem_conv, x, self.dtype)))
        x = F.max_pool2d(x, 3, 2, 1)
        for blk in self.blocks:
            x = blk(x, self.dtype)
        x = x.to(torch.float32).mean(dim=(2, 3)).to(self.dtype)
        return self.fc(x.to(torch.float32))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "ResNet":
        """Draw every weight from ``generator`` (flax's initializers)."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                gain = 2.0 if isinstance(m, nn.Conv2d) else 1.0
                std = math.sqrt(gain / fan_in) / _TRUNC_STD
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, BatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        return self


def resnet50(num_classes: int = 1000, dtype=torch.float32, device="cuda",
             **kw) -> ResNet:
    """torchvision.models.resnet50's architecture (the JAX package's
    ``resnet50``)."""
    return ResNet((3, 4, 6, 3), Bottleneck, num_classes=num_classes,
                  dtype=dtype, device=device, **kw)


def resnet101(num_classes: int = 1000, dtype=torch.float32, device="cuda",
              **kw) -> ResNet:
    return ResNet((3, 4, 23, 3), Bottleneck, num_classes=num_classes,
                  dtype=dtype, device=device, **kw)


def resnet18(num_classes: int = 1000, dtype=torch.float32, device="cuda",
             **kw) -> ResNet:
    return ResNet((2, 2, 2, 2), BasicBlockV1, num_classes=num_classes,
                  dtype=dtype, device=device, **kw)


def resnet34(num_classes: int = 1000, dtype=torch.float32, device="cuda",
             **kw) -> ResNet:
    """torchvision.models.resnet34's architecture (BasicBlock, 3-4-6-3)."""
    return ResNet((3, 4, 6, 3), BasicBlockV1, num_classes=num_classes,
                  dtype=dtype, device=device, **kw)
