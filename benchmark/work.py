"""The yardstick's arithmetic: the card's published peaks and the least
time a tile pass could take on them.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates), which
assume its 700 W power limit: 67 TFLOP/s in float32 on the CUDA cores,
989 TFLOP/s in bf16 on the tensor cores, 3.35 TB/s of HBM3.

A pass's operations are the field MLP's multiply-adds at every sample the
reference evaluates (2 flops each, at the field dtype's peak) and, where
it bends, 8 flops a (sample, live window row) pair for the squared
distance and one compare a pair for each of the ``num_seek`` nearest-row
passes, at the f32 peak; with a hash-grid field also the encoding's
trilinear weights and interpolation (``grid_flops``, f32). Its bytes are
its inputs read once and its outputs written once, and with a hash grid
the distinct table rows its samples' corners read (``grid_bytes``;
``reference.render.Pass``). Both are 0 for a Fourier-MLP field.
"""

from __future__ import annotations

from typing import Iterable

PEAK_F32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12


def mlp_peak(dtype: str) -> float:
    return PEAK_BF16 if dtype == "bfloat16" else PEAK_F32


def mlp_flops(passes: Iterable, macs: int) -> float:
    return sum(2.0 * macs * p.samples for p in passes)


def least_seconds(passes: Iterable, macs: int, num_seek: int,
                  dtype: str) -> float:
    """Sum over the passes of the larger of operations over peak and bytes
    over bandwidth: the passes run one after another."""
    total = 0.0
    for p in passes:
        op_s = (2.0 * macs * p.samples / mlp_peak(dtype)
                + ((8.0 + num_seek) * p.bend_rows + p.grid_flops) / PEAK_F32)
        total += max(op_s, (p.bytes + p.grid_bytes) / PEAK_BYTES)
    return total
