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

The reference CPDtorch ResNet-18 ``.pth`` (the layout of
`cpd_tpu/interop/torch_import.py` and `torch_export.py`):
`load_reference_checkpoint` reads one (a ``state_dict`` or ``model``
wrapper or a bare dict, DDP's ``module.`` prefix dropped),
`import_reference_resnet18_cifar` copies it into the port's
`ResNetCIFAR`, `export_reference_resnet18_cifar` gives the reference's
dict back and `save_torch_checkpoint` writes it.  The reference builds
its model from ``nn.Sequential`` children, the port names its modules as
flax does; both keep torch's layouts (OIHW convs, (out, in) linears), so
the mapping is a key map (`reference_key`) with no transposes:

    conv1.0 / conv1.1               <-> stem_conv / stem_bn
    layer{s}.{b}.left.0/.1/.3/.4    <-> layer{s}_block{b}.conv1/bn1/conv2/bn2
    layer{s}.{b}.shortcut.0/.1      <-> layer{s}_block{b}.shortcut_conv/_bn
    fc                              <-> fc

The reference's BatchNorm ``num_batches_tracked`` has no counterpart in
the port: import drops it, export writes 0, as the reference's export
does.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

__all__ = ["load_jax_params", "load_jax_resnet_cifar", "load_jax_resnet",
           "load_jax_tiny", "reference_key", "load_reference_checkpoint",
           "import_reference_resnet18_cifar",
           "export_reference_resnet18_cifar", "save_torch_checkpoint"]


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


_REF_BLOCK = {"conv1": "left.0", "bn1": "left.1", "conv2": "left.3",
              "bn2": "left.4", "shortcut_conv": "shortcut.0",
              "shortcut_bn": "shortcut.1"}


def reference_key(port_key: str) -> str:
    """The reference ResNet-18's state_dict key of one of the port's
    `ResNetCIFAR` keys (module docstring)."""
    module, _, leaf = port_key.rpartition(".")
    head, _, sub = module.partition(".")
    if head == "stem_conv":
        return f"conv1.0.{leaf}"
    if head == "stem_bn":
        return f"conv1.1.{leaf}"
    if head == "fc":
        return port_key
    stage, sep, block = head.partition("_block")
    if sep and stage.startswith("layer") and sub in _REF_BLOCK:
        return f"{stage}.{block}.{_REF_BLOCK[sub]}.{leaf}"
    raise KeyError(f"{port_key}: no reference ResNet-18 key")


def load_reference_checkpoint(path: str) -> dict:
    """A reference ``.pth`` as its bare state_dict of tensors, loaded
    with ``weights_only=True`` on the CPU: the ``state_dict`` or
    ``model`` wrapper unwrapped, DDP's ``module.`` prefix dropped."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt
    if isinstance(ckpt, dict):
        for key in ("state_dict", "model"):
            if key in ckpt and isinstance(ckpt[key], dict):
                sd = ckpt[key]
                break
    if any(k.startswith("module.") for k in sd):
        sd = {k[len("module."):] if k.startswith("module.") else k: v
              for k, v in sd.items()}
    return dict(sd)


def import_reference_resnet18_cifar(model: torch.nn.Module,
                                    sd: Mapping[str, Any]
                                    ) -> torch.nn.Module:
    """Copy a reference ResNet-18 state_dict (tensors or arrays) into
    the port's `ResNetCIFAR` in place, on the model's device.  Every
    parameter and running stat must be covered and every key used (the
    ``num_batches_tracked`` counters aside); a shape mismatch raises."""
    sd = {k: v for k, v in sd.items()
          if not k.endswith("num_batches_tracked")}
    own = model.state_dict()
    want = {reference_key(k): k for k in own}
    missing = sorted(set(want) - set(sd))
    extra = sorted(set(sd) - set(want))
    if missing or extra:
        raise KeyError(f"reference checkpoint does not match the model "
                       f"(wrong --arch?): missing {missing[:5]}, "
                       f"unexpected {extra[:5]}")
    with torch.no_grad():
        for ref, name in want.items():
            src = torch.as_tensor(sd[ref])
            t = own[name]
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"{ref}: shape {tuple(src.shape)} != "
                                 f"{tuple(t.shape)} of {name}")
            t.copy_(src.to(t.dtype))
    return model


def export_reference_resnet18_cifar(model: torch.nn.Module) -> dict:
    """The port's `ResNetCIFAR` as the reference trainer's state_dict:
    fp32 CPU tensors under the reference's keys, each BatchNorm with
    ``num_batches_tracked`` 0."""
    out = {}
    for name, t in model.state_dict().items():
        key = reference_key(name)
        out[key] = t.detach().to("cpu", torch.float32).clone()
        if key.endswith(".running_var"):
            out[key[:-len("running_var")] + "num_batches_tracked"] = \
                torch.tensor(0, dtype=torch.int64)
    return out


def save_torch_checkpoint(sd: Mapping[str, Any], path: str,
                          wrapper: str = "state_dict") -> None:
    """``torch.save`` of ``sd`` wrapped as the reference's loaders
    expect: ``state_dict`` (its ResNet-18 trainer), ``model`` (its
    ResNet-50 trainer) or ``""`` for a bare dict."""
    tensors = {k: torch.as_tensor(v) for k, v in sd.items()}
    torch.save({wrapper: tensors} if wrapper else tensors, path)
