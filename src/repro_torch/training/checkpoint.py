"""Checkpointing: a parameter tree <-> one ``.npz`` (port of
``repro.training.checkpoint``, the same format).

Keys are the ``/``-joined key paths of nested dicts and lists (a list
entry by its index), written in ``jax.tree_util``'s order (sorted keys);
bf16 leaves are stored as a ``uint16`` view; ``__meta__`` holds a JSON ``{"dtypes": {key: numpy dtype
name}, "extra": {...}}``. A file written by either package loads in the
other. The write is atomic: a temporary file in the same directory,
renamed over the path.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict

import numpy as np
import torch

_TORCH = {"bfloat16": torch.bfloat16}


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    if isinstance(tree, (dict, list, tuple)):
        items = (sorted(tree.items()) if isinstance(tree, dict)
                 else enumerate(tree))
        flat = {}
        for k, v in items:
            flat.update(_flatten(v, f"{prefix}{k}/"))
        return flat
    return {prefix[:-1]: tree}


def _to_numpy(t) -> tuple:
    """(array as stored, dtype name) of a tensor or array leaf."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(t)
    return a, str(a.dtype)


def save(path: str, tree, extra: Dict[str, Any] | None = None) -> None:
    arrays, dtypes = {}, {}
    for k, v in _flatten(tree).items():
        arrays[k], dtypes[k] = _to_numpy(v)
    arrays["__meta__"] = np.frombuffer(
        json.dumps({"dtypes": dtypes, "extra": extra or {}}).encode(), np.uint8)
    folder = os.path.dirname(os.path.abspath(path))
    os.makedirs(folder, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=folder, suffix=".npz")
    os.close(fd)
    try:
        np.savez(tmp, **arrays)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def _tensor(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype in _TORCH:    # stored as a uint16 view
        return torch.from_numpy(np.array(a).view(np.int16)).view(_TORCH[dtype])
    return torch.from_numpy(np.array(a))


def load(path: str, like=None):
    """Load a checkpoint: (flat {key: tensor}, extra), or with ``like`` (a
    tree of the same keys) (tree, extra), each leaf on its ``like`` leaf's
    device."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        flat = {k: _tensor(z[k], meta["dtypes"][k]) for k in z.files if k != "__meta__"}
    if like is None:
        return flat, meta["extra"]
    want = _flatten(like)
    if set(want) != set(flat):
        raise KeyError(f"checkpoint keys mismatch: {sorted(set(want) ^ set(flat))}")

    def rebuild(node, prefix):
        if isinstance(node, dict):
            return {k: rebuild(v, f"{prefix}{k}/") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(rebuild(v, f"{prefix}{i}/") for i, v in enumerate(node))
        return flat[prefix[:-1]].to(node.device)

    return rebuild(like, ""), meta["extra"]
