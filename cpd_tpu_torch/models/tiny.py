"""The tiny CNN (port of `cpd_tpu/models/tiny.py`): conv-BN-relu twice
at stride 2, a spatial mean, a dense head.  The trainers' smoke-test
model and the golden APS experiment's (`examples/aps_golden.py`).

NCHW, fp32; module names are flax's (``conv0``, ``bn0``, ``conv1``,
``bn1``, ``fc``), so a flax variables tree loads one to one
(`interop.load_jax_tiny`).  flax's ``padding="SAME"`` pads a strided
conv by ``max((ceil(n / s) - 1) * s + k - n, 0)`` split low-then-high,
the odd element at the END: at stride 2 on an even size that is (0, 1),
which ``nn.Conv2d(padding=1)`` would not reproduce, so the pad is
explicit.  BN is flax's (`resnet_cifar.BatchNorm`); init follows flax's
defaults: lecun-normal (truncated, fan-in) convs and head, a zero head
bias, BN scale 1 and bias 0.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .resnet_cifar import _TRUNC_STD, BatchNorm

__all__ = ["TinyCNN", "tiny_cnn", "same_pads"]


def same_pads(n: int, k: int, s: int) -> tuple:
    """flax/XLA ``SAME`` padding of one spatial dim: (low, high)."""
    total = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class TinyCNN(nn.Module):
    """conv-BN-relu -> conv-BN-relu -> mean -> dense.  Input NCHW fp32."""

    def __init__(self, num_classes: int = 10, width: int = 16,
                 device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        cin = 3
        for i in range(2):
            cout = width * (i + 1)
            self.add_module(f"conv{i}", nn.Conv2d(cin, cout, 3, 2, 0,
                                                  bias=False, device=dev))
            self.add_module(f"bn{i}", BatchNorm(cout, device=dev))
            cin = cout
        self.fc = nn.Linear(cin, num_classes, device=dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(2):
            (hl, hh), (wl, wh) = (same_pads(x.shape[2], 3, 2),
                                  same_pads(x.shape[3], 3, 2))
            x = F.pad(x, (wl, wh, hl, hh))
            x = getattr(self, f"conv{i}")(x)
            x = F.relu(getattr(self, f"bn{i}")(x))
        return self.fc(x.mean(dim=(2, 3)))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "TinyCNN":
        """Draw every weight from ``generator`` (flax's initializers)."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                std = math.sqrt(1.0 / m.weight[0].numel()) / _TRUNC_STD
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, BatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        return self


def tiny_cnn(num_classes: int = 10, device="cuda", **kw) -> TinyCNN:
    """The JAX registry's ``tiny`` model."""
    return TinyCNN(num_classes=num_classes, device=device, **kw)
