"""Checkpoints of models and training state
(vi_diffusion_processes_tpu/utils/checkpoint.py).

The reference saves only final artifacts with ``np.savez``
(docs/diffusion_processes/cvi_dp.py:140-155).  The JAX package checkpoints
whole pytrees with orbax; here a model is a tree of frozen dataclasses,
named tuples, containers, ``nn.Module``\\ s and tensors, saved with
``torch.save`` as one flat ``{field path: value}`` dict: tensors (moved to
the CPU), and the numbers, strings and ``None`` among the fields.  A
module contributes its ``state_dict`` under its path.  The file loads with
``weights_only=True`` (no pickled code), and :func:`restore_checkpoint`
rebuilds a template's structure from it.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

__all__ = ["save_checkpoint", "restore_checkpoint", "save_npz_artifacts", "flatten_tree"]

_SCALARS = (bool, int, float, str, type(None))


def _join(prefix: str, key) -> str:
    return f"{prefix}.{key}" if prefix else str(key)


def _children(obj):
    """``(key, child)`` pairs of a container node, or None for a leaf."""
    if isinstance(obj, nn.Module):
        return None
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return [(f.name, getattr(obj, f.name)) for f in dataclasses.fields(obj)]
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return list(zip(obj._fields, obj))
    if isinstance(obj, (list, tuple)):
        return list(enumerate(obj))
    if isinstance(obj, dict):
        return list(obj.items())
    return None


def flatten_tree(obj, prefix: str = "") -> Dict[str, Any]:
    """The tree as one flat ``{field path: value}`` dict: tensors (detached,
    on the CPU) and numbers, strings and ``None``.  Module states enter
    under the module's path; other values (functions, dtypes) are left to
    the template."""
    flat: Dict[str, Any] = {}
    if isinstance(obj, nn.Module):
        for name, value in obj.state_dict().items():
            flat[_join(prefix, name)] = value.detach().cpu()
        return flat
    children = _children(obj)
    if children is not None:
        for key, child in children:
            flat.update(flatten_tree(child, _join(prefix, key)))
    elif isinstance(obj, torch.Tensor):
        flat[prefix] = obj.detach().cpu()
    elif isinstance(obj, np.ndarray):
        flat[prefix] = torch.from_numpy(obj)
    elif isinstance(obj, _SCALARS):
        flat[prefix] = obj
    return flat


def _rebuild(template, flat: Dict[str, Any], prefix: str):
    if isinstance(template, nn.Module):
        module = copy.deepcopy(template)
        state = {name: flat[_join(prefix, name)] for name in module.state_dict()}
        module.load_state_dict(state)
        return module
    children = _children(template)
    if children is not None:
        values = {key: _rebuild(child, flat, _join(prefix, key)) for key, child in children}
        if dataclasses.is_dataclass(template):
            return dataclasses.replace(template, **values)
        if isinstance(template, tuple) and hasattr(template, "_fields"):
            return type(template)(**values)
        if isinstance(template, dict):
            return type(template)(values)
        return type(template)(values[i] for i in range(len(template)))
    if isinstance(template, torch.Tensor):
        return flat[prefix].to(device=template.device, dtype=template.dtype)
    if isinstance(template, np.ndarray):
        return flat[prefix].numpy().astype(template.dtype)
    if isinstance(template, _SCALARS):
        return flat[prefix]
    return template


def save_checkpoint(path, tree) -> None:
    """Save a model or training state (any tree of the kinds above)."""
    torch.save(flatten_tree(tree), path)


def restore_checkpoint(path, template):
    """Load a checkpoint into the structure of ``template``: a tree of the
    same kinds and shapes (a freshly built model will do).  Tensors land on
    the device and in the dtype of the template's; modules are copies of the
    template's with the saved state.  Raises ``KeyError`` when the file
    lacks a field of the template."""
    flat = torch.load(path, map_location="cpu", weights_only=True)
    return _rebuild(template, flat, "")


def save_npz_artifacts(path, **arrays) -> None:
    """Reference-compatible final artifacts (cvi_dp.py:140-155): each
    keyword is saved under its name when it is one tensor or array, else
    its leaves (tensors and numbers, in field order) as ``name_0``,
    ``name_1``, …"""
    flat = {}
    for name, value in arrays.items():
        leaves = [x for x in flatten_tree(value).values()
                  if isinstance(x, (torch.Tensor, bool, int, float))]
        if len(leaves) == 1 and name not in flat:
            flat[name] = np.asarray(leaves[0])
        else:
            for i, leaf in enumerate(leaves):
                flat[f"{name}_{i}"] = np.asarray(leaf)
    np.savez(path, **flat)
