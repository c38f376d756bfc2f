"""Multi-GPU scaling over ``torch.distributed`` (port of
``pienerf_tpu.parallel.sharding``, which places arrays on a JAX mesh and
lets GSPMD insert the collectives; here each rank is a process and the
collectives are explicit).

- Data parallelism: each rank trains on its share of the rays; the
  gradients are averaged over the ranks before the optimizer, so the
  params, Adam's moments and skips and the EMA stay the same on every
  rank.
- The simulator shards by integration points: each rank holds a share of
  the chunked operator's chunks, and the [K, 10, 3] elastic term is
  all-reduced before ``global_inv`` (one collective a local-global
  iteration); the state stays replicated.
- Rendering shards a frame into horizontal bands, one a rank; the scene
  state is replicated, so the only traffic is the gather of the bands.

A ``Mesh`` is the calling process's handle: its rank, the world size, its
device and the process group. The backend is the caller's choice: NCCL
where each rank owns a card, gloo otherwise (gloo all-reduces and
broadcasts CUDA tensors but gathers only host tensors).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist


class Mesh(NamedTuple):
    rank: int
    world: int
    device: torch.device
    group: Any                    # the process group (None: the default)
    backend: str


def make_mesh(init_method: str, world: int, rank: int,
              backend: str = "gloo", device=None) -> Mesh:
    """Join the process group at ``init_method`` (``file://`` or
    ``tcp://host:port``) as ``rank`` of ``world``; ``device`` defaults to
    the card."""
    from pienerf_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)
    return Mesh(rank, world, dev, None, backend)


def close(mesh: Mesh) -> None:
    dist.destroy_process_group(mesh.group)


def all_reduce_mean(mesh: Mesh):
    """A ``reduce`` for ``trainer.make_train_step``: averages each tensor
    of a list over the ranks, in place."""
    def reduce(tensors):
        for t in tensors:
            dist.all_reduce(t, group=mesh.group)
            t /= mesh.world
    return reduce


def all_reduce_sum(mesh: Mesh):
    """A ``reduce`` for ``sim.sim_step``: the tensor summed over the
    ranks."""
    def reduce(t):
        dist.all_reduce(t, group=mesh.group)
        return t
    return reduce


def shard_batch(mesh: Mesh, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    """This rank's rows of each batch array: an equal share of the
    leading dimension, on the rank's device."""
    out = {}
    for k, v in batch.items():
        n = v.shape[0]
        if n % mesh.world:
            raise ValueError(f"{k}: {n} rows do not split into "
                             f"{mesh.world} equal shares")
        m = n // mesh.world
        out[k] = v[mesh.rank * m:(mesh.rank + 1) * m].to(mesh.device)
    return out


def _tensors(tree) -> list:
    """The tensors of a tree of named tuples, dicts, lists and fields."""
    from pienerf_tpu_torch.models.network import FieldMLP

    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, FieldMLP):
        return list(tree.leaves())
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def replicate(mesh: Mesh, tree: Any) -> Any:
    """Broadcast every tensor of ``tree`` (a train state, a field, a dict
    or list of tensors) from rank 0, in place; returns ``tree``."""
    with torch.no_grad():
        for t in _tensors(tree):
            if mesh.backend == "gloo" and t.device.type == "cuda":
                h = t.detach().cpu()
                dist.broadcast(h, 0, group=mesh.group)
                t.copy_(h)
            else:
                dist.broadcast(t.data, 0, group=mesh.group)
    return tree


def render_frame_sharded(mesh: Mesh, settings, packed_w: torch.Tensor,
                         ip_pack: torch.Tensor, p_def: torch.Tensor,
                         pose: torch.Tensor, intrinsics, H: int, W: int,
                         bg_color, cut_bounds=None):
    """The interactive frame split into horizontal bands, band b on rank
    b; called by every rank with the same replicated scene. Returns the
    assembled [H, W, 3] image (numpy) and the drop counters summed over
    the bands, on every rank.

    Bands run uncapped (``active_frac`` 1): a band that crosses the
    object holds far more hit tiles than the frame's average, and a
    per-band cap of active_frac x band tiles drops tiles (the JAX
    package's 896x800 dryrun read a 0.35 max error so). A band has
    n_tiles / world tiles, so its prep cost stays bounded. With 16-wide
    pack rows, 16-pixel tiles and one Newton step a band runs the fused
    tile kernel, else ``render_frame`` (the field kernel)."""
    from pienerf_tpu_torch.render import interactive

    n = mesh.world
    if H % (n * settings.tile):
        raise ValueError(f"H={H} must split into {n} tile-aligned bands")
    band_h = H // n
    fx, fy, cx, cy = intrinsics
    settings = settings._replace(active_frac=1.0)
    fused = (ip_pack.shape[1] == 16 and settings.tile == 16
             and settings.bend.max_iter_num == 1)
    render = (interactive.render_frame_fused if fused
              else interactive.render_frame)
    # band b covers rows [b band_h, (b + 1) band_h): cy shifts, in f32
    cy_band = float(np.float32(cy) - np.float32(mesh.rank) * band_h)
    with torch.no_grad():
        out = render(settings, packed_w, ip_pack, p_def, pose,
                     (fx, fy, cx, cy_band), band_h, W, bg_color,
                     cut_bounds)
    ts = settings.tile
    band = (out["tiles_image"].reshape(band_h // ts, W // ts, ts, ts, 3)
            .transpose(1, 2).reshape(band_h, W, 3).contiguous())
    drops = torch.stack([torch.as_tensor(out[k]).to(torch.int64).reshape(())
                         for k in ("n_tile_overflow", "dropped_beam",
                                   "dropped_window")]).cpu()
    if n == 1:
        img = band
    else:
        # the bands meet on the host, as JAX's np.asarray(bands) does
        # (gloo gathers host tensors only)
        src = band.cpu() if mesh.backend == "gloo" else band
        bands = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(bands, src, group=mesh.group)
        img = torch.cat(bands, dim=0)
        dist.all_reduce(drops, group=mesh.group)
    d = drops.tolist()
    counters = {"n_tile_overflow": d[0], "dropped_beam": d[1],
                "dropped_window": d[2]}
    return img.cpu().numpy(), counters


def make_sharded_sim_step(mesh: Mesh, consts):
    """The simulator sharded by integration points.

    The per-step cost is the chunked F-assembly operator ``Dc`` [C, S, 3,
    80] (per-IP blocks batched over chunks). Each rank keeps C / world
    chunks (the chunk axis padded to a multiple of the world size: padded
    chunks have Dc = 0 and mu = lam = 0, so they add exactly zero, to node
    0) and its own ``node_gather`` over them; the forward block product is
    chunk-local, and the per-node sums are all-reduced before
    ``global_inv``. The kernel-node arrays are small and stay replicated.
    The only departure from the single-process trajectory is the f32 order
    of the cross-rank sum.

    Returns (consts_local, step) with step(consts_local, state) -> state,
    the state replicated. consts_local drops the dense ``B``: use it only
    with ``step``; keep ``consts`` for get_ip_info, update_force and the
    render."""
    from pienerf_tpu_torch.sim import solver as sim

    n = mesh.world
    C = consts.Dc.shape[0]
    pad = -(-C // n) * n - C

    def padded(t):
        return torch.cat([t, t.new_zeros((pad,) + t.shape[1:])], 0)

    per = (C + pad) // n
    sl = slice(mesh.rank * per, (mesh.rank + 1) * per)
    nodes = padded(consts.chunk_nodes)[sl]
    n_k = consts.dof_rest.shape[0]
    gather = sim.node_gather_list(nodes.cpu().numpy(), n_k)
    local = consts._replace(
        B=None, Dc=padded(consts.Dc)[sl].contiguous(),
        chunk_nodes=nodes.contiguous(),
        chunk_mu=padded(consts.chunk_mu)[sl].contiguous(),
        chunk_lam=padded(consts.chunk_lam)[sl].contiguous(),
        node_gather=torch.as_tensor(gather, device=consts.Dc.device))
    reduce = all_reduce_sum(mesh)

    def step(consts_local, state):
        return sim.sim_step(consts_local, state, reduce=reduce)

    return local, step


def make_sharded_train_step(mesh: Mesh, spec, settings, optimizer,
                            **step_kw):
    """The data-parallel train step: ``trainer.make_train_step`` (its
    keyword options in ``step_kw``) whose gradients and loss are averaged
    over the ranks. ``step(state, bitfield, batch, generator=None,
    draws=None)`` takes the global batch and the global draws (drawn from
    ``generator`` when absent, in the single step's order, so every rank
    seeded alike draws alike) and runs this rank's rows of both.
    ``per_ray_loss`` is this rank's rows."""
    from pienerf_tpu_torch.render import fast as fastlib
    from pienerf_tpu_torch.train import trainer as trainer_lib

    step = trainer_lib.make_train_step(
        spec, settings, optimizer, reduce=all_reduce_mean(mesh), **step_kw)
    fast = step_kw.get("use_fast_path", False)

    def global_draws(batch, generator, dev):
        n = batch["pixels"].shape[0]
        gdev = generator.device if generator is not None else dev
        d = {}
        if batch["pixels"].shape[-1] == 4:
            d["bg"] = torch.rand((n, 3), generator=generator, device=gdev)
        if fast:
            d["u_coarse"], d["u_fine"] = fastlib.draw(
                n, trainer_lib.fast_settings(settings), generator, gdev)
        else:
            d["noise"] = torch.rand((n,), generator=generator, device=gdev)
        return d

    def sharded_step(state, bitfield, batch,
                     generator: Optional[torch.Generator] = None,
                     draws: Optional[Dict[str, torch.Tensor]] = None):
        if draws is None:
            draws = global_draws(batch, generator, mesh.device)
        return step(state, bitfield, shard_batch(mesh, batch),
                    draws=shard_batch(mesh, draws))

    return sharded_step
