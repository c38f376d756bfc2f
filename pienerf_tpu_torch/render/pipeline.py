"""Coupled sim + deformed-render frame: the interactive loop's one step.

Port of ``pienerf_tpu.render.pipeline.interactive_frame_step``. The JAX
package runs the frame as one jit; here it runs eagerly (one CUDA graph
per frame is ROADMAP.md queue 1 item 7).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.profiler import record_function

from pienerf_tpu_torch.ops import beam_bend
from pienerf_tpu_torch.render import interactive
from pienerf_tpu_torch.sim import solver as sim


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
    for the static tile class under a fixed camera.
    The stages are named ranges (``frame.sim``, ``frame.ip_pack``,
    ``frame.render``) for ``torch.profiler``."""
    with record_function("frame.sim"):
        if force_vid >= 0:
            state = sim.update_force(consts, state, force_vid, force)
        else:
            state = sim.clear_force(state)
        for _ in range(substeps):
            state = sim.sim_step(consts, state)
    with record_function("frame.ip_pack"):
        p_def, F, dF = sim.get_ip_info(consts, state)
        pack = beam_bend.pack_ip_data_fast(p_def, consts.ip_pos.float(), F,
                                           dF)
    with record_function("frame.render"):
        out = interactive.render_frame_fused(
            settings, packed_w, pack, p_def, pose, intrinsics, H, W,
            bg_color, cut_bounds, static_cache=static_cache)
    return state, out
