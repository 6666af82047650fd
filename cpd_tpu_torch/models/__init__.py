"""Models (port of `cpd_tpu.models`) and a registry of the image models
by the JAX package's names (`get_model`)."""

from .resnet import ResNet, resnet18, resnet34, resnet50, resnet101
from .resnet_cifar import ResNetCIFAR, resnet18_cifar
from .tiny import TinyCNN, tiny_cnn
from .transformer import TransformerLM, transformer_lm

_REGISTRY = {
    "res_cifar": resnet18_cifar,
    "resnet18_cifar": resnet18_cifar,
    "resnet18": resnet18,
    "resnet34": resnet34,
    "resnet50": resnet50,
    "resnet101": resnet101,
    "tiny": tiny_cnn,
}
ARCHS = tuple(_REGISTRY)


def get_model(name: str, **kwargs):
    """Instantiate a model by the JAX registry's name
    (`cpd_tpu.models.get_model`)."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown or not yet ported model {name!r}; have "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


__all__ = ["ResNetCIFAR", "resnet18_cifar", "ResNet", "resnet18",
           "resnet34", "resnet50", "resnet101", "TransformerLM",
           "transformer_lm", "TinyCNN", "tiny_cnn", "get_model", "ARCHS"]
