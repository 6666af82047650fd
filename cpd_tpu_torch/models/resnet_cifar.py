"""ResNet-18 for 32x32 CIFAR (port of `cpd_tpu/models/resnet_cifar.py`).

3x3 stem without max-pool, 4 stages of 2 BasicBlocks at 64/128/256/512
channels, strides 1/2/2/2, global average pool, a 512 -> classes head:
11.2 M parameters.  NCHW, fp32.  Module names are the flax ones
(``stem_conv``, ``stem_bn``, ``layer{s}_block{b}.conv1`` ...
``shortcut_bn``, ``fc``), so a flax variables tree maps onto it one to
one (`interop.load_jax_resnet_cifar`).

BatchNorm keeps flax's semantics: momentum 0.9 on the running stats
(torch's ``momentum=0.1``), eps 1e-5, and the running variance updated
with the BIASED batch variance (torch's own BatchNorm would fold in the
unbiased one).  Init follows flax too: convs kaiming-normal (truncated,
fan-in), the head lecun-normal (truncated) with a zero bias, BN scale 1
and bias 0, drawn from a caller's `torch.Generator`.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device

__all__ = ["ResNetCIFAR", "resnet18_cifar", "BatchNorm"]

# stddev of a standard normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


class BatchNorm(nn.Module):
    """Training-mode batch statistics, flax's running-stat update."""

    def __init__(self, channels: int, momentum: float = 0.9,
                 eps: float = 1e-5, device=None):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(channels, device=device))
        self.register_buffer("running_var",
                             torch.ones(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)


class BasicBlock(nn.Module):
    """Two 3x3 convs and an identity or 1x1 projection shortcut."""

    def __init__(self, cin: int, cout: int, stride: int, device=None):
        super().__init__()
        kw = dict(bias=False, device=device)
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, **kw)
        self.bn1 = BatchNorm(cout, device=device)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, **kw)
        self.bn2 = BatchNorm(cout, device=device)
        self.projects = stride != 1 or cin != cout
        if self.projects:
            self.shortcut_conv = nn.Conv2d(cin, cout, 1, stride, 0, **kw)
            self.shortcut_bn = BatchNorm(cout, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.projects:
            x = self.shortcut_bn(self.shortcut_conv(x))
        return F.relu(y + x)


class ResNetCIFAR(nn.Module):
    """CIFAR-sized ResNet.  Input NCHW (B, 3, 32, 32) fp32."""

    def __init__(self, num_classes: int = 10,
                 stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 stage_channels: Sequence[int] = (64, 128, 256, 512),
                 device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.stem_conv = nn.Conv2d(3, 64, 3, 1, 1, bias=False, device=dev)
        self.stem_bn = BatchNorm(64, device=dev)
        self.blocks = []
        cin = 64
        for stage, (n_blocks, cout) in enumerate(zip(stage_sizes,
                                                     stage_channels)):
            for b in range(n_blocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                block = BasicBlock(cin, cout, stride, device=dev)
                self.add_module(f"layer{stage + 1}_block{b}", block)
                self.blocks.append(block)
                cin = cout
        self.fc = nn.Linear(cin, num_classes, device=dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        for block in self.blocks:
            x = block(x)
        return self.fc(x.mean(dim=(2, 3)))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "ResNetCIFAR":
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


def resnet18_cifar(num_classes: int = 10, device="cuda") -> ResNetCIFAR:
    """The reference's ``res_cifar`` model."""
    return ResNetCIFAR(num_classes=num_classes, device=device)
