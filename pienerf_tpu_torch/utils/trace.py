"""Named spans of the live frame, recorded only under ``torch.profiler``.

``span(name)`` opens a profiler range while a torch profiler is recording
and returns one shared no-op context otherwise, so a frame with no
profiler pays one profiler-state check a span and records nothing.

The range is a function-scope record, as an op's is
(``torch._C._profiler._RecordFunctionFast``), not the user-scope one of
``torch.profiler.record_function``: it sits on the trace's host timeline,
on the clock of the CUDA runtime calls and the device's kernels, but the
profiler puts no device-side copy of it on the device timeline, where it
would count as busy time. Kernels stay linked to the ops that launched
them; a kernel launched through ctypes inside a span (the tile kernel in
``FRAME_TILE_LAUNCH``) links to the span.

Every name the program records is a constant here:

============================ =========================================
``FRAME_SIM``                the force and the sim steps
                             (``render/pipeline.py``)
``FRAME_IP_INFO``            ``sim/solver.py:get_ip_info``
``FRAME_IP_PACK``            ``ops/beam_bend.py:pack_ip_data_fast``
``FRAME_RENDER``             ``render/interactive.py:render_frame_fused``
                             (and ``pipeline.frame_step``'s deformed
                             render)
``FRAME_RENDER_ACTIVITY``    ``active_tiles``, ``cut_classes``
``FRAME_RENDER_PREP``        ``tile_kernel_inputs``, once a tile pass
``FRAME_TILE_LAUNCH``        ``kernels/tile.py:render_tiles`` on CUDA
``FRAME_RENDER_SCATTER``     ``_scatter_frame``
``FRAME_FETCH``              ``web_viewer.py:_fetch_frame``
============================ =========================================
"""

from __future__ import annotations

from contextlib import nullcontext

import torch

FRAME_SIM = "frame.sim"
FRAME_IP_INFO = "frame.ip_info"
FRAME_IP_PACK = "frame.ip_pack"
FRAME_RENDER = "frame.render"
FRAME_RENDER_ACTIVITY = "frame.render.activity"
FRAME_RENDER_PREP = "frame.render.prep"
FRAME_TILE_LAUNCH = "frame.tile_launch"
FRAME_RENDER_SCATTER = "frame.render.scatter"
FRAME_FETCH = "frame.fetch"
NAMES = (FRAME_SIM, FRAME_IP_INFO, FRAME_IP_PACK, FRAME_RENDER,
         FRAME_RENDER_ACTIVITY, FRAME_RENDER_PREP, FRAME_TILE_LAUNCH,
         FRAME_RENDER_SCATTER, FRAME_FETCH)

_OFF = nullcontext()


def span(name: str):
    """A profiler range named ``name`` while a torch profiler records, else
    the shared no-op context."""
    if torch.autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return _OFF
