"""Carry state across from the JAX package: numpy trees -> port objects.

The inputs are what ``load_native`` or ``jax.device_get`` give: nested
dicts / lists / named tuples with numpy leaves. Nothing here imports JAX.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from pienerf_tpu_torch.models.network import FieldMLP, NetworkSpec, layer_dims
from pienerf_tpu_torch.sim.solver import (SimConstants, SimState,
                                          node_gather_list)


def field_from_numpy(tree: Mapping[str, Any], spec: NetworkSpec,
                     device) -> FieldMLP:
    """A params tree {"sigma_net": [...], "color_net": [...]} of [in, out]
    arrays -> FieldMLP on ``device`` (shapes checked against ``spec``)."""
    field = FieldMLP(spec, device=device)
    sd, cd = layer_dims(spec)
    for name, dims, plist in (("sigma_net", sd, field.sigma_net),
                              ("color_net", cd, field.color_net)):
        arrs = list(tree[name])
        if len(arrs) != len(plist):
            raise ValueError(f"{name}: {len(arrs)} layers, spec has "
                             f"{len(plist)}")
        for i, (a, p) in enumerate(zip(arrs, plist)):
            a = np.array(a, np.float32)          # writable copy
            if a.shape != (dims[i], dims[i + 1]):
                raise ValueError(f"{name}[{i}] has shape {a.shape}, spec "
                                 f"wants {(dims[i], dims[i + 1])}")
            p.data.copy_(torch.from_numpy(a))
    return field


def _fields(obj) -> dict:
    return dict(obj._asdict()) if hasattr(obj, "_asdict") else dict(obj)


def sim_consts_from_numpy(consts, device) -> SimConstants:
    """SimConstants fields (named tuple or mapping, numpy leaves; fields
    the port does not use are ignored) -> port SimConstants on device. The
    port's own ``node_gather`` is built from ``chunk_nodes``; a missing
    dense ``B`` stays None."""
    src = _fields(consts)
    out = {}
    for name in SimConstants._fields:
        if name == "node_gather":
            v = node_gather_list(np.asarray(src["chunk_nodes"]),
                                 np.asarray(src["dof_rest"]).shape[0])
        else:
            v = src.get(name)
        if v is None:
            out[name] = None
        elif name in ("dt", "dx"):
            out[name] = float(v)
        elif name == "iters":
            out[name] = int(v)
        else:
            a = np.asarray(v)
            dtype = (torch.int64 if np.issubdtype(a.dtype, np.integer)
                     else torch.float32)
            out[name] = torch.tensor(a, dtype=dtype, device=device)
    return SimConstants(**out)


def sim_state_from_numpy(state, device) -> SimState:
    src = _fields(state)
    return SimState(**{k: torch.tensor(np.asarray(src[k]),
                                          dtype=torch.float32, device=device)
                       for k in SimState._fields})
