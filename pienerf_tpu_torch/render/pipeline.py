"""Coupled sim + deformed-render frames: the interactive loop's one step.

Port of ``pienerf_tpu.render.pipeline``: ``frame_step`` (the sim step,
then the spatial-hash deformed render of ``render/deformed.py``, any
backbone) and ``interactive_frame_step`` (the sim step, then the fused
tile kernel, mlp backbone). The JAX package runs a frame as one jit; here
it runs eagerly (one CUDA graph a frame is ROADMAP.md queue 1 item 2).
Under ``torch.profiler`` the stages are spans (``utils/trace.py``): this
module opens ``frame.sim`` and ``frame_step``'s ``frame.render``; the
functions it calls open their own (``frame.ip_info``, ``frame.ip_pack``,
``render_frame_fused``'s ``frame.render`` and the spans inside it).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from pienerf_tpu_torch.models import network
from pienerf_tpu_torch.ops import beam_bend
from pienerf_tpu_torch.render import deformed, interactive
from pienerf_tpu_torch.sim import solver as sim
from pienerf_tpu_torch.utils.trace import FRAME_RENDER, FRAME_SIM, span


class FrameSettings(NamedTuple):
    spec: network.NetworkSpec
    deformed: deformed.DeformedSettings


def frame_step(
    settings: FrameSettings,
    consts: sim.SimConstants,
    state: sim.SimState,
    field,
    bitfield: torch.Tensor,
    rays_o: torch.Tensor,         # [N, 3]
    rays_d: torch.Tensor,         # [N, 3]
    bg_color,
    force_vid: torch.Tensor,      # [] int; < 0 disables the force
    force: torch.Tensor,          # [3]
    cut_bounds: Optional[torch.Tensor] = None,
    substeps: int = 1,
) -> Tuple[sim.SimState, Dict[str, torch.Tensor]]:
    """Advance the simulation one frame and render the deformed field
    (reference gui.py:556-645 -> trainer.py:284-329). ``substeps`` needs
    consts built at dt = frame_dt / substeps. The rays render in chunks of
    ``deformed.CHUNK`` over one prepared frame (rays are independent).
    Returns (state, {image, depth_raw, weights_sum} over the N rays)."""
    with span(FRAME_SIM):
        # the picked IP's force, or none where force_vid < 0: a tensor
        # condition, no host branch on the pick
        vid = torch.as_tensor(force_vid, device=state.ddof.device)
        state_f = sim.update_force(consts, state, torch.clamp(vid, min=0),
                                   force)
        state = state._replace(dof_f=torch.where(
            vid >= 0, state_f.dof_f, torch.zeros_like(state.dof_f)))
        for _ in range(substeps):
            state = sim.sim_step(consts, state)
    p_def, F, dF = sim.get_ip_info(consts, state)
    with span(FRAME_RENDER):
        out = deformed.render_deformed_chunked(
            field, settings.deformed, bitfield, p_def, consts.ip_pos.float(),
            F, dF, rays_o, rays_d, bg_color, cut_bounds)
    return state, out


def make_frame_settings(spec: network.NetworkSpec, cfg, sim_dx: float
                        ) -> FrameSettings:
    """Static frame settings from the shared config."""
    from pienerf_tpu_torch.ops import bending as bend_ops
    from pienerf_tpu_torch.ops import spatial_hash as sh
    from pienerf_tpu_torch.render.renderer import RenderSettings

    base = RenderSettings(
        bound=cfg.bound, cascade=cfg.cascade, min_near=cfg.min_near,
        dt_gamma=cfg.dt_gamma, max_steps=cfg.max_steps,
        T_thresh=cfg.T_thresh, max_samples=cfg.train_max_samples * 2,
        bg_radius=cfg.bg_radius)
    layout = sh.make_layout(bound=cfg.bound, hgs=cfg.hash_grid_size,
                            max_per_cell=cfg.bend_max_per_cell)
    bend = bend_ops.BendSettings(
        num_seek_ip=cfg.num_seek_IP, max_iter_num=cfg.max_iter_num,
        ip_dx=1.05 * sim_dx, cut=cfg.cut)
    dst = deformed.DeformedSettings(base=base, bend=bend, layout=layout,
                                    max_bend_samples=4 * base.max_samples)
    return FrameSettings(spec=spec, deformed=dst)


def interactive_frame_step(
    settings: interactive.InteractiveSettings,
    consts: sim.SimConstants,
    state: sim.SimState,
    packed_w: torch.Tensor,       # kernels.field.pack_weights output
    pose: torch.Tensor,           # [4, 4]
    intrinsics: Tuple[float, float, float, float],
    H: int,
    W: int,
    bg_color,
    force_vid: int,               # < 0 disables the force
    force: torch.Tensor,          # [3]
    cut_bounds=None,              # [6] when settings.cut
    substeps: int = 1,
    static_cache: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[sim.SimState, Dict[str, torch.Tensor]]:
    """One coupled frame: force application, ``substeps`` sim steps, the
    per-IP pack, then bend + field + composite through the tile kernel.
    ``substeps`` > 1 needs consts built at dt = frame_dt / substeps. In cut
    mode ``static_cache`` (``interactive.render_static_cache``) stands in
    for the static tile class under a fixed camera."""
    with span(FRAME_SIM):
        if force_vid >= 0:
            state = sim.update_force(consts, state, force_vid, force)
        else:
            state = sim.clear_force(state)
        for _ in range(substeps):
            state = sim.sim_step(consts, state)
    p_def, F, dF = sim.get_ip_info(consts, state)
    pack = beam_bend.pack_ip_data_fast(p_def, consts.ip_pos.float(), F, dF)
    out = interactive.render_frame_fused(
        settings, packed_w, pack, p_def, pose, intrinsics, H, W, bg_color,
        cut_bounds, static_cache=static_cache)
    return state, out
