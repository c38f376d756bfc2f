"""What the tile kernel pays per tile before any sample runs: the arms of
``tools/micro_floor.py`` of the JAX package on ``kernels.probes.floor_shell``,
a kernel with the tile kernel's block shapes that loads its inputs, zeroes
its output block and does nothing else. All slots inactive, A = 1248 tiles,
4 tiles per thread block, bin_start 134 wide, P = 256 candidates:

  full        tile_sc, bin_start, dirs and cand loaded (as production)
  no-bs       bin_start left out
  no-cand     cand [P, 16] left out (16 KB a tile)
  no-dirs     dirs [8, 256] left out (8 KB a tile)
  smem-only   tile_sc and bin_start only
  bs-int16    bin_start as 16-bit counts

    python -m pienerf_tpu_torch.tools.micro_floor

Runs on the card; ``--device cpu`` runs the plain version, to check the
tool, and its times are no device metric.
"""

from __future__ import annotations

import argparse
import json

import torch

from pienerf_tpu_torch.device import resolve_device
from pienerf_tpu_torch.kernels import probes
from pienerf_tpu_torch.tools.timing import (device_label, eager_ms_per_call,
                                            ms_per_call)

ARMS = ("full", "no-bs", "no-cand", "no-dirs", "smem-only", "bs-int16")


def arm_inputs(arm: str, tile_sc: torch.Tensor, BS: int, P: int):
    """(tile_sc, bin_start, dirs, cand) of an arm: zeros and ones as the
    JAX tool's, None for an input the arm leaves out."""
    if arm not in ARMS:
        raise ValueError(f"unknown arm {arm!r}; one of {ARMS}")
    A, dev = tile_sc.shape[0], tile_sc.device
    bs = dirs = cand = None
    if arm != "no-bs":
        bs = torch.zeros((A, BS), device=dev, dtype=(
            torch.int16 if arm == "bs-int16" else torch.int32))
    if arm not in ("no-dirs", "smem-only"):
        dirs = torch.ones((A, 8, probes.T2), dtype=torch.float32, device=dev)
    if arm not in ("no-cand", "smem-only"):
        cand = torch.zeros((A, P, 16), dtype=torch.float32, device=dev)
    return tile_sc, bs, dirs, cand


def run(device: torch.device, tiles: int, block_tiles: int, BS: int, P: int,
        reps: int) -> dict:
    """Device ms per call of every arm (and, under ``<arm>_eager``, the ms
    with the host's launch); raises if an arm's output differs from the
    plain version."""
    tile_sc = torch.zeros((tiles, 8), dtype=torch.float32, device=device)
    ref = probes.floor_shell_plain(tile_sc)
    res = {}
    for arm in ARMS:
        args = arm_inputs(arm, tile_sc, BS, P)
        out = probes.floor_shell(*args, block_tiles=block_tiles)
        if not torch.equal(out, ref):
            raise RuntimeError(f"{arm}: output differs from the plain shell")
        def call():
            return probes.floor_shell(*args, block_tiles=block_tiles)
        res[arm] = ms_per_call(call, device, reps)
        res[f"{arm}_eager"] = eager_ms_per_call(call, device, reps)
        print(f"{arm:12s} {res[arm]:9.4f} ms  (launched from the host: "
              f"{res[arm + '_eager']:.4f} ms)", flush=True)
    return res


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--tiles", type=int, default=1248)
    parser.add_argument("--block_tiles", type=int, default=4)
    parser.add_argument("--bin_width", type=int, default=134)
    parser.add_argument("--candidates", type=int, default=256)
    parser.add_argument("--reps", type=int, default=50)
    ns = parser.parse_args(argv)
    device = resolve_device(ns.device)
    print("device:", device_label(device))
    res = run(device, ns.tiles, ns.block_tiles, ns.bin_width, ns.candidates,
              ns.reps)
    print(json.dumps({"device": device_label(device), "ms": res}))
    return res


if __name__ == "__main__":
    main()
