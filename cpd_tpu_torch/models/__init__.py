"""Models (port of `cpd_tpu.models`)."""

from .resnet_cifar import ResNetCIFAR, resnet18_cifar
from .transformer import TransformerLM, transformer_lm

__all__ = ["ResNetCIFAR", "resnet18_cifar", "TransformerLM",
           "transformer_lm"]
