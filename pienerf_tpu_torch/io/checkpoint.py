"""Checkpoints: the native format (a flat npz with slash-joined keys plus
a JSON sidecar of metadata, as ``pienerf_tpu.io.checkpoint`` writes it)
and the reference's torch-ngp ``.pth`` layout.

Leaves load as numpy arrays; ``weights.field_from_numpy`` puts a params
tree on a device. A ``.pth`` state dict holds ``encoder.embeddings``,
``sigma_net.{i}.weight``, ``color_net.{i}.weight``, optionally
``encoder_bg.embeddings`` / ``bg_net.{i}.weight`` and the density grid
(reference nerf/trainer.py:794-916); torch Linear weights are [out, in],
the params tree's [in, out], so they transpose on the way.
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


def _collect_layers(sd: Dict[str, np.ndarray], prefix: str):
    layers, i = [], 0
    while f"{prefix}.{i}.weight" in sd:
        layers.append(np.ascontiguousarray(sd[f"{prefix}.{i}.weight"].T))
        i += 1
    return layers


def load_torch_ngp(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Import a reference ``ngp_ep*.pth``: (params tree of numpy arrays,
    extra) where extra carries density_grid [CAS, H^3] (Morton order),
    mean_density, epoch and global_step where present."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = {k: _leaf(v) for k, v in ckpt.get("model", ckpt).items()}
    params: Dict[str, Any] = {
        "encoder": sd["encoder.embeddings"].astype(np.float32),
        "sigma_net": _collect_layers(sd, "sigma_net"),
        "color_net": _collect_layers(sd, "color_net"),
    }
    if "encoder_bg.embeddings" in sd:
        params["encoder_bg"] = sd["encoder_bg.embeddings"].astype(np.float32)
        params["bg_net"] = _collect_layers(sd, "bg_net")
    extra: Dict[str, Any] = {}
    if "density_grid" in sd:
        extra["density_grid"] = sd["density_grid"].astype(np.float32)
    for k in ("mean_density", "mean_count", "epoch", "global_step"):
        if k in ckpt:
            extra[k] = ckpt[k]
    return params, extra


def save_torch_ngp(path: str, params: Dict[str, Any],
                   extra: Optional[Dict[str, Any]] = None) -> None:
    """Export a params tree in the reference's ``.pth`` layout."""
    sd: Dict[str, Any] = {"encoder.embeddings": torch.from_numpy(
        np.array(_leaf(params["encoder"]), np.float32))}
    for name in ("sigma_net", "color_net", "bg_net"):
        for i, w in enumerate(params.get(name, [])):
            sd[f"{name}.{i}.weight"] = torch.from_numpy(
                np.asarray(_leaf(w), np.float32).T.copy())
    if "encoder_bg" in params:
        sd["encoder_bg.embeddings"] = torch.from_numpy(
            np.array(_leaf(params["encoder_bg"]), np.float32))
    ckpt: Dict[str, Any] = {"model": sd}
    for k, v in (extra or {}).items():
        if k == "density_grid":
            if v is not None:
                sd[k] = torch.from_numpy(np.array(_leaf(v), np.float32))
        else:
            ckpt[k] = v
    torch.save(ckpt, path)
