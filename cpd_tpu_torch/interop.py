"""Load flax variables trees into the port's modules.

`load_jax_params` — a flax `TransformerLM` param tree.  The port keeps
flax's layout and names (`models/transformer.py`), so the
mapping is one to one: ``params["block{i}"]["wq"]["kernel"]`` lands in
``model.blocks[i].wq.kernel``, ``params["embed"]["embedding"]`` in
``model.embed.embedding``, LayerNorm ``scale``/``bias`` as they are.
Both projection layouts load: MHA (``wqkv``) and GQA (``wq``/``wkv``).

`load_jax_resnet_cifar` — a flax `ResNetCIFAR`'s ``params`` and
``batch_stats``: conv kernels HWIO -> OIHW, the Dense kernel (I, O) ->
(O, I), BN ``scale``/``bias``/``mean``/``var`` -> ``weight``/``bias``/
``running_mean``/``running_var``.  (The port's own copy of the mapping
in `cpd_tpu/interop/torch_export.py`.)  `load_jax_resnet` — the same
mapping for a flax ImageNet `ResNet` (`models.resnet`), `load_jax_tiny`
for a flax `TinyCNN` (`models.tiny`).

The trees hold numpy arrays (``jax.device_get`` of the flax variables);
this module never imports jax.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

__all__ = ["load_jax_params", "load_jax_resnet_cifar", "load_jax_resnet",
           "load_jax_tiny"]


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        key = prefix + str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = v
    return out


def _state_key(flax_key: str) -> str:
    """``block3.wq.kernel`` -> ``blocks.3.wq.kernel``."""
    head, _, rest = flax_key.partition(".")
    if head.startswith("block") and head[5:].isdigit():
        return f"blocks.{head[5:]}.{rest}"
    return flax_key


def load_jax_params(model: torch.nn.Module,
                    params: Mapping[str, Any]) -> torch.nn.Module:
    """Copy a flax param tree (``{"params": ...}`` or the inner dict,
    numpy leaves) into ``model`` in place, on the model's own device.
    Every parameter must be covered and every leaf used, with equal
    shapes — a partial load raises."""
    params = params.get("params", params)
    flat = {_state_key(k): v for k, v in _flatten(params).items()}
    own = dict(model.named_parameters())
    missing = sorted(set(own) - set(flat))
    extra = sorted(set(flat) - set(own))
    if missing or extra:
        raise KeyError(f"param trees differ: missing {missing}, "
                       f"unexpected {extra}")
    with torch.no_grad():
        for name, p in own.items():
            arr = np.asarray(flat[name], dtype=np.float32)
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {arr.shape} != "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.from_numpy(arr.copy()))
    return model


def _resnet_leaf(flax_key: str, arr: np.ndarray) -> tuple:
    """A flax ResNetCIFAR leaf -> (torch state_dict key, array)."""
    path, _, leaf = flax_key.rpartition(".")
    if leaf == "kernel" and arr.ndim == 4:
        return f"{path}.weight", np.transpose(arr, (3, 2, 0, 1))
    if leaf == "kernel":
        return f"{path}.weight", arr.T
    names = {"scale": "weight", "bias": "bias", "mean": "running_mean",
             "var": "running_var"}
    return f"{path}.{names[leaf]}", arr


def load_jax_resnet_cifar(model: torch.nn.Module,
                          variables: Mapping[str, Any]) -> torch.nn.Module:
    """Copy a flax ResNetCIFAR's ``{"params": ..., "batch_stats": ...}``
    (numpy leaves) into the port's `ResNetCIFAR` in place.  Every
    parameter and running stat must be covered and every leaf used."""
    return _load_resnet(model, variables)


def load_jax_resnet(model: torch.nn.Module,
                    variables: Mapping[str, Any]) -> torch.nn.Module:
    """Copy a flax ImageNet ResNet's ``{"params": ..., "batch_stats":
    ...}`` (numpy leaves: ``stem_conv``, ``stem_bn``,
    ``layer{s}_block{b}.{conv1..3, bn1..3, downsample_conv,
    downsample_bn}``, ``fc``) into the port's `models.resnet.ResNet` in
    place.  Every parameter and running stat must be covered and every
    leaf used."""
    return _load_resnet(model, variables)


def load_jax_tiny(model: torch.nn.Module,
                  variables: Mapping[str, Any]) -> torch.nn.Module:
    """Copy a flax TinyCNN's ``{"params": ..., "batch_stats": ...}``
    (numpy leaves: ``conv0``, ``bn0``, ``conv1``, ``bn1``, ``fc``) into
    the port's `models.tiny.TinyCNN` in place.  Every parameter and
    running stat must be covered and every leaf used."""
    return _load_resnet(model, variables)


def _load_resnet(model: torch.nn.Module,
                 variables: Mapping[str, Any]) -> torch.nn.Module:
    flat = {}
    for coll in ("params", "batch_stats"):
        for k, v in _flatten(variables[coll]).items():
            key, arr = _resnet_leaf(k, np.asarray(v, dtype=np.float32))
            flat[key] = arr
    own = model.state_dict()
    missing = sorted(set(own) - set(flat))
    extra = sorted(set(flat) - set(own))
    if missing or extra:
        raise KeyError(f"variables differ: missing {missing}, "
                       f"unexpected {extra}")
    with torch.no_grad():
        for name, t in own.items():
            arr = flat[name]
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"{name}: shape {arr.shape} != "
                                 f"{tuple(t.shape)}")
            t.copy_(torch.from_numpy(np.array(arr)))
    return model
