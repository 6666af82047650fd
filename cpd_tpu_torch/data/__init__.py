"""Data pipeline (port of `cpd_tpu.data`: CIFAR-10, samplers,
augmentation and the synthetic LM corpus).  Host-side numpy, copied bitwise from the JAX package."""

from .augment import (CIFAR10_MEAN, CIFAR10_STD, Crop, Cutout, FlipLR,
                      TransformPipeline, normalise, pad_reflect)
from .cifar import CIFAR10Pipeline, load_cifar10, synthetic_cifar10
from .lm_data import SyntheticText
from .samplers import DistributedGivenIterationSampler, GivenIterationSampler

__all__ = ["CIFAR10_MEAN", "CIFAR10_STD", "Crop", "Cutout", "FlipLR",
           "TransformPipeline", "normalise", "pad_reflect",
           "CIFAR10Pipeline", "load_cifar10", "synthetic_cifar10",
           "GivenIterationSampler", "DistributedGivenIterationSampler",
           "SyntheticText"]
