"""Can a data-dependent row fetch feed an interactive hashgrid on this card?

A hashgrid frame needs about 134 M row fetches (8.4 M samples x 16 levels),
so the go/no-go is whether any mechanism reaches O(10) G rows/s. The arms,
named as in ``tools/pallas_gather_probe.py`` of the JAX package, each
fetch B rows of 128 f32 (512 bytes) from a table of T rows by random
indices, and each is checked to equal ``table[idx]`` exactly:

  A_onehot     the dense one-hot product on the tensor cores, the table
               split into three bf16 parts so that it stays exact
               (``kernels.probes.onehot_fetch``); the cost per fetch grows
               with T, so only the small tables run it
  B_dynslice   one thread copies its rows serially: the per-access floor
  C_index_select  ``torch.index_select(table, 0, idx)``, the library baseline
  D_dma        per-row asynchronous copies, 8 in flight per block
  E_take       one warp per row, coalesced loads: the card's native gather

No table is resident in shared memory (227 KB a block): the 2^11- and
2^13-row tables (1 MB, 4 MB) sit in the L2 cache, the 2^19-row table
(256 MB) in device memory.

    python -m pienerf_tpu_torch.tools.gather_probe

Runs on the card; ``--device cpu`` runs the plain versions at whatever size
is asked, to check the tool, and its times are no device metric.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from pienerf_tpu_torch.device import resolve_device
from pienerf_tpu_torch.kernels import probes
from pienerf_tpu_torch.tools.timing import (device_label, eager_ms_per_call,
                                            ms_per_call)

ONEHOT_MAX_ROWS = 1 << 13   # the one-hot arm's cost per fetch is T x 128 MACs


def arms_for(T: int):
    """(name, fetch) for a table of T rows, in the order they run."""
    arms = []
    if T <= ONEHOT_MAX_ROWS:
        arms.append((f"A_onehot_T{T}", probes.onehot_fetch))
    arms += [
        (f"B_dynslice_T{T}", probes.dynslice_fetch),
        (f"E_take_T{T}", probes.take_fetch),
        (f"C_index_select_T{T}",
         lambda t, i: torch.index_select(t, 0, i)),
        (f"D_dma_T{T}", probes.dma_fetch),
    ]
    return arms


def run(device: torch.device, rows: int, tables, seed: int, reps: int
        ) -> dict:
    """Every arm at every table size -> {name: {rows_per_s (G rows/s, from
    ms_per_call), ms_per_call (device time), eager_ms_per_call (with the
    host's launch)}}, and under "unique_rows" the distinct rows each table's
    indices name (what a fetch must read). Raises if an arm's rows differ
    from ``table[idx]``."""
    rng = np.random.RandomState(seed)
    res = {"unique_rows": {}}
    for T in tables:
        table = torch.as_tensor(
            rng.standard_normal((T, probes.ROW)).astype(np.float32),
            device=device)
        idx = torch.as_tensor(rng.randint(0, T, rows).astype(np.int32),
                              device=device)
        ref = probes.fetch_plain(table, idx)
        res["unique_rows"][T] = int(torch.unique(idx).numel())
        for name, fetch in arms_for(T):
            out = fetch(table, idx)
            if not torch.equal(out, ref):
                raise RuntimeError(f"{name}: rows differ from table[idx]")
            ms = ms_per_call(lambda: fetch(table, idx), device, reps)
            res[name] = {"rows_per_s": rows / (ms * 1e-3) / 1e9,
                         "ms_per_call": ms,
                         "eager_ms_per_call": eager_ms_per_call(
                             lambda: fetch(table, idx), device, reps)}
            print(name, res[name], flush=True)
    return res


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--rows", type=int, default=1 << 16,
                        help="fetches per call (a multiple of 512)")
    parser.add_argument("--tables", type=int, nargs="+",
                        default=[1 << 11, 1 << 13, 1 << 19],
                        help="table sizes T, in rows")
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--seed", type=int, default=0)
    ns = parser.parse_args(argv)
    device = resolve_device(ns.device)
    res = run(device, ns.rows, ns.tables, ns.seed, ns.reps)
    res["device"] = device_label(device)
    print(json.dumps(res, indent=1))
    return res


if __name__ == "__main__":
    main()
