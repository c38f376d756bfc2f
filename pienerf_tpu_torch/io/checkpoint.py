"""Native checkpoint format: a flat npz with slash-joined keys plus a JSON
sidecar of metadata, the format ``pienerf_tpu.io.checkpoint`` writes.

Leaves load as numpy arrays; ``weights.field_from_numpy`` puts a params
tree on a device. The reference's ``.pth`` import is not ported yet
(ROADMAP.md queue 1 item 10).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _leaf(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_native(path: str, params: Dict[str, Any],
                extra: Optional[Dict[str, Any]] = None) -> None:
    """Write ``params`` (nested dicts/lists of arrays or tensors)."""
    flat: Dict[str, np.ndarray] = {}

    def rec(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(f"{prefix}/{k}" if prefix else k, v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(f"{prefix}.{i}", v)
        else:
            flat[prefix] = _leaf(node)

    rec("", params)
    arrays = (np.ndarray, torch.Tensor)
    for k, v in (extra or {}).items():
        if isinstance(v, arrays):
            flat[f"__extra__/{k}"] = _leaf(v)
    np.savez(path, **flat)
    meta = {k: v for k, v in (extra or {}).items()
            if not isinstance(v, arrays)}
    with open(path + ".json", "w") as f:
        json.dump(meta, f)


def load_native(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Returns (params tree with numpy leaves, extra)."""
    params: Dict[str, Any] = {}
    extra: Dict[str, Any] = {}
    with np.load(path) as data:
        for key in data.files:
            if key.startswith("__extra__/"):
                extra[key.split("/", 1)[1]] = data[key]
                continue
            node = params
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            leaf = parts[-1]
            if "." in leaf:
                name, idx = leaf.rsplit(".", 1)
                lst = node.setdefault(name, [])
                idx = int(idx)
                while len(lst) <= idx:
                    lst.append(None)
                lst[idx] = data[key]
            else:
                node[leaf] = data[key]
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            extra.update(json.load(f))
    return params, extra
