"""Carry state across from the JAX package and back: numpy trees <-> port
objects (fields, sim state, occupancy grids, the trainer's state with its
optimizer moments and counts).

The inputs are what ``load_native`` or ``jax.device_get`` give: nested
dicts / lists / named tuples with numpy leaves; the outputs going back are
nested dicts with the JAX names. Nothing here imports JAX.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from pienerf_tpu_torch.models.network import (FieldMLP, NetworkSpec,
                                              bg_dims, layer_dims)
from pienerf_tpu_torch.sim.solver import (SimConstants, SimState,
                                          node_gather_list)


def _np(a) -> np.ndarray:
    """A writable f32 numpy copy of an array or a tensor."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.array(a, np.float32)


def field_from_numpy(tree: Mapping[str, Any], spec: NetworkSpec,
                     device, trainable: bool = False) -> FieldMLP:
    """A params tree {"sigma_net": [...], "color_net": [...]} of [in, out]
    arrays (or tensors), with "encoder" (hashgrid) and "encoder_bg" /
    "bg_net" (bg_radius > 0) where the spec has them -> FieldMLP on
    ``device`` (shapes checked against ``spec``)."""
    field = FieldMLP(spec, device=device, trainable=trainable)
    sd, cd = layer_dims(spec)
    nets = [("sigma_net", sd, field.sigma_net),
            ("color_net", cd, field.color_net)]
    embs = []
    if spec.backbone == "hashgrid":
        embs.append(("encoder", field.encoder))
    if spec.bg_radius > 0:
        nets.append(("bg_net", bg_dims(spec), field.bg_net))
        embs.append(("encoder_bg", field.encoder_bg))
    for name, p in embs:
        a = _np(tree[name])
        if a.shape != tuple(p.shape):
            raise ValueError(f"{name} has shape {a.shape}, spec wants "
                             f"{tuple(p.shape)}")
        p.data.copy_(torch.from_numpy(a))
    for name, dims, plist in nets:
        arrs = list(tree[name])
        if len(arrs) != len(plist):
            raise ValueError(f"{name}: {len(arrs)} layers, spec has "
                             f"{len(plist)}")
        for i, (a, p) in enumerate(zip(arrs, plist)):
            a = _np(a)
            if a.shape != (dims[i], dims[i + 1]):
                raise ValueError(f"{name}[{i}] has shape {a.shape}, spec "
                                 f"wants {(dims[i], dims[i + 1])}")
            p.data.copy_(torch.from_numpy(a))
    return field


def field_to_numpy(field: FieldMLP) -> dict:
    """The inverse: the field's params tree with numpy leaves."""
    return {k: ([_np(p) for p in v] if isinstance(v, list) else _np(v))
            for k, v in field.tree().items()}


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


def _get(obj, name):
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def _tree_leaves(tree) -> list:
    """Leaves of a params tree in ``jax.tree_util.tree_leaves`` order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += list(v) if isinstance(v, (list, tuple)) else [v]
    return out


def _tree_like(field: FieldMLP, leaves) -> dict:
    """The params tree of ``field``'s layout holding ``leaves``."""
    it = iter(leaves)
    tree = field.tree()
    out = {}
    for k in sorted(tree):
        v = tree[k]
        out[k] = ([next(it) for _ in v] if isinstance(v, list)
                  else next(it))
    return out


def grid_from_numpy(grid, device):
    """An occupancy grid (named tuple or mapping of density, bitfield
    uint32, mean_density, iter_density) -> the port's OccupancyGrid,
    whose int32 bitfield holds the same bits."""
    from pienerf_tpu_torch.ops.grid import OccupancyGrid

    bf = np.ascontiguousarray(np.asarray(_get(grid, "bitfield")))
    return OccupancyGrid(
        density=torch.tensor(np.asarray(_get(grid, "density"), np.float32),
                             device=device),
        bitfield=torch.tensor(bf.view(np.int32), device=device),
        mean_density=torch.tensor(float(_get(grid, "mean_density")),
                                  device=device),
        iter_density=torch.tensor(int(_get(grid, "iter_density")),
                                  device=device))


def grid_to_numpy(grid) -> dict:
    """The inverse: numpy density, uint32 bitfield, mean and count."""
    return {"density": grid.density.cpu().numpy(),
            "bitfield": grid.bitfield.cpu().numpy().view(np.uint32),
            "mean_density": np.float32(grid.mean_density.cpu()),
            "iter_density": np.int32(grid.iter_density.cpu())}


def train_state_from_numpy(state, spec: NetworkSpec, device):
    """The JAX trainer's TrainState (``jax.device_get`` of it, or a
    mapping of the same names) -> the port's ``trainer.TrainState``:
    params and ema_params as fields, the optimizer's
    ApplyIfFiniteState(inner_state=(ScaleByAdamState,
    ScaleByScheduleState)) as an ``optim.AdamState``, and the step."""
    from pienerf_tpu_torch.train.optim import AdamState
    from pienerf_tpu_torch.train.trainer import TrainState

    params = field_from_numpy(_get(state, "params"), spec, device,
                              trainable=True)
    ema = field_from_numpy(_get(state, "ema_params"), spec, device)
    opt = _get(state, "opt_state")
    adam, sched = _get(opt, "inner_state")

    def t(a, dtype=None):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    def moments(tree):
        return [t(a, torch.float32) for a in _tree_leaves(tree)]

    i32 = torch.int32
    opt_state = AdamState(
        count=t(_get(adam, "count"), i32), mu=moments(_get(adam, "mu")),
        nu=moments(_get(adam, "nu")),
        schedule_count=t(_get(sched, "count"), i32),
        notfinite_count=t(_get(opt, "notfinite_count"), i32),
        last_finite=t(_get(opt, "last_finite"), torch.bool),
        total_notfinite=t(_get(opt, "total_notfinite"), i32))
    return TrainState(params, opt_state, ema,
                      t(_get(state, "step"), i32))


def train_state_to_numpy(state) -> dict:
    """The inverse, as nested dicts with the JAX names: {"params",
    "ema_params", "step", "opt_state": {"notfinite_count", "last_finite",
    "total_notfinite", "inner_state": ({"count", "mu", "nu"},
    {"count"})}}; mu / nu are params trees."""
    def a(x):
        return x.detach().cpu().numpy()

    o = state.opt_state
    field = state.params
    return {
        "params": field_to_numpy(field),
        "ema_params": field_to_numpy(state.ema_params),
        "step": a(state.step),
        "opt_state": {
            "notfinite_count": a(o.notfinite_count),
            "last_finite": a(o.last_finite),
            "total_notfinite": a(o.total_notfinite),
            "inner_state": (
                {"count": a(o.count),
                 "mu": _tree_like(field, [a(m) for m in o.mu]),
                 "nu": _tree_like(field, [a(v) for v in o.nu])},
                {"count": a(o.schedule_count)})}}


def lpips_to_torch(w: Mapping[str, Any], device) -> dict:
    """LPIPS-alex weights (``train.lpips.load_weights``: numpy conv{i}_w,
    conv{i}_b, lin{i}_w) -> f32 tensors on ``device``, the same keys."""
    return {k: torch.tensor(_np(v), device=device) for k, v in w.items()}


def clip_to_torch(params: Mapping[str, Any], device) -> dict:
    """CLIP params (``train.clip_guidance.import_hf_state_dict``: towers
    of numpy arrays, a list of layer dicts and the int head count) -> the
    same tree with f32 tensors on ``device``."""
    def conv(v):
        if isinstance(v, Mapping):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [conv(x) for x in v]
        if isinstance(v, (int, np.integer)):
            return int(v)
        return torch.tensor(_np(v), device=device)

    return conv(params)
