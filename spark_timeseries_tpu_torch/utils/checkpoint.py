"""Checkpoint/restore of nested NamedTuples, dicts and tensors
(counterpart of ``spark_timeseries_tpu/utils/checkpoint.py``, same
layout): the array leaves go to one ``<path>.npz`` and a
``<path>.tree.json`` sidecar describes the tree, so restore needs no
caller-side knowledge of leaf order.

Tensors are saved as numpy arrays (copied to the host) and load back as
numpy arrays: the caller puts them on a device.  NamedTuples are recorded
by import path (the port's own classes, ``spark_timeseries_tpu_torch.
...``) and re-imported on load.  Every array leaf is checked against the
shape and dtype the sidecar recorded, and a disagreement raises
:class:`CheckpointMismatchError`.
"""

from __future__ import annotations

import importlib
import json
import os
from typing import Any

import numpy as np
import torch

__all__ = ["CheckpointMismatchError", "save_pytree", "save_pytree_atomic",
           "load_pytree"]


class CheckpointMismatchError(ValueError):
    """A checkpoint's stored arrays disagree with its structure sidecar
    (shape, dtype or leaf count): corruption or a stale re-save."""


def _is_namedtuple(node: Any) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _arr_spec(arrays: list, a: np.ndarray) -> dict:
    arrays.append(a)
    return {"k": "arr", "i": len(arrays) - 1,
            "shape": list(a.shape), "dtype": str(a.dtype)}


def _encode(node: Any, arrays: list) -> Any:
    """A JSON-able structure spec of ``node``; array leaves are appended
    to ``arrays`` and referenced by position, with shape and dtype."""
    if isinstance(node, torch.Tensor):
        return _arr_spec(arrays, node.detach().cpu().numpy())
    if isinstance(node, (np.ndarray, np.generic)):
        return _arr_spec(arrays, np.asarray(node))
    if node is None or isinstance(node, (bool, int, float, str)):
        return {"k": "py", "v": node}
    if _is_namedtuple(node):
        cls = type(node)
        return {"k": "nt", "cls": f"{cls.__module__}:{cls.__qualname__}",
                "items": [_encode(v, arrays) for v in node]}
    if isinstance(node, tuple):
        return {"k": "tuple", "items": [_encode(v, arrays) for v in node]}
    if isinstance(node, list):
        return {"k": "list", "items": [_encode(v, arrays) for v in node]}
    if isinstance(node, dict):
        if not all(isinstance(key, str) for key in node):
            raise TypeError("checkpoint dicts must have string keys")
        return {"k": "dict",
                "items": {key: _encode(v, arrays) for key, v in node.items()}}
    raise TypeError(f"cannot checkpoint node of type {type(node).__name__}")


def _decode(spec: Any, arrays: dict) -> Any:
    kind = spec["k"]
    if kind == "arr":
        name = f"leaf_{spec['i']}"
        if name not in arrays:
            raise CheckpointMismatchError(
                f"checkpoint structure references {name} but the .npz holds "
                f"only {len(arrays)} leaves — the sidecar and array file "
                f"are out of sync (re-save the checkpoint)")
        arr = arrays[name]
        want_shape = spec.get("shape")
        if want_shape is not None and list(arr.shape) != list(want_shape):
            raise CheckpointMismatchError(
                f"checkpoint leaf {name} has shape {tuple(arr.shape)} but "
                f"the structure sidecar recorded {tuple(want_shape)} — the "
                f".npz does not belong to this .tree.json")
        want_dtype = spec.get("dtype")
        if want_dtype is not None and str(arr.dtype) != want_dtype:
            raise CheckpointMismatchError(
                f"checkpoint leaf {name} has dtype {arr.dtype} but the "
                f"structure sidecar recorded {want_dtype} — the .npz does "
                f"not belong to this .tree.json")
        return arr
    if kind == "py":
        return spec["v"]
    if kind == "nt":
        mod_name, _, qualname = spec["cls"].partition(":")
        obj = importlib.import_module(mod_name)
        for part in qualname.split("."):
            obj = getattr(obj, part)
        # only ever call an actual NamedTuple class, never an arbitrary
        # callable the sidecar names
        if not (isinstance(obj, type) and issubclass(obj, tuple)
                and hasattr(obj, "_fields")):
            raise ValueError(
                f"checkpoint names {spec['cls']!r}, which is not a "
                "NamedTuple class — refusing to call it")
        return obj(*(_decode(s, arrays) for s in spec["items"]))
    if kind == "tuple":
        return tuple(_decode(s, arrays) for s in spec["items"])
    if kind == "list":
        return [_decode(s, arrays) for s in spec["items"]]
    if kind == "dict":
        return {key: _decode(s, arrays) for key, s in spec["items"].items()}
    raise ValueError(f"unknown checkpoint node kind {kind!r}")


def save_pytree(path: str, tree: Any) -> None:
    """Save ``tree`` as ``<path>.npz`` (array leaves) plus a
    ``<path>.tree.json`` structure sidecar that fully describes it."""
    arrays: list = []
    spec = _encode(tree, arrays)
    np.savez(path + ".npz", **{f"leaf_{i}": a for i, a in enumerate(arrays)})
    with open(path + ".tree.json", "w") as f:
        json.dump({"format": 2, "spec": spec, "n_leaves": len(arrays)}, f)


def _fsync_replace(tmp: str, dst: str) -> None:
    with open(tmp, "rb+") as f:
        os.fsync(f.fileno())
    os.replace(tmp, dst)


def save_pytree_atomic(path: str, tree: Any) -> None:
    """:func:`save_pytree` through tmp-file + fsync + rename: a crash at
    any instant leaves either the previous files or the new ones at
    ``path``, never a torn ``.npz`` or ``.tree.json`` (each rename is
    atomic, the pair is not)."""
    tmp = f"{path}.tmp-{os.getpid()}"
    save_pytree(tmp, tree)
    _fsync_replace(tmp + ".npz", path + ".npz")
    _fsync_replace(tmp + ".tree.json", path + ".tree.json")


def load_pytree(path: str) -> Any:
    """Rebuild the tree saved by :func:`save_pytree`: structure, Python
    fields and array leaves (as numpy)."""
    with open(path + ".tree.json") as f:
        meta = json.load(f)
    if "spec" not in meta:
        raise ValueError(
            f"{path}.tree.json is a format-1 checkpoint (opaque treedef); "
            "re-save it")
    with np.load(path + ".npz") as data:
        arrays = {name: data[name] for name in data.files}
    n_expected = meta.get("n_leaves")
    if n_expected is not None and len(arrays) != n_expected:
        raise CheckpointMismatchError(
            f"checkpoint {path!r} holds {len(arrays)} array leaves but its "
            f"structure sidecar recorded {n_expected} — the .npz and "
            f".tree.json are out of sync")
    return _decode(meta["spec"], arrays)
