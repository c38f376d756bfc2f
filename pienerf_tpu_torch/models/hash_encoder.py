"""Multiresolution hash-grid encoder (Instant-NGP), forward only.

Port of ``pienerf_tpu.models.hash_encoder`` (``make_spec``, the level
constants, the per-axis tables and ``encode``), with the reference CUDA
encoder's index semantics (gridencoder/src/gridencoder.cu:51-135):

- per-level scale = exp2(level * log2(per_level_scale)) * base_res - 1
- resolution = ceil(scale) + 1; sample position = x * scale + 0.5
- dense index (stride res + 1) when (res + 1)^D fits the level's table,
  else the xor-hash with primes {1, 2654435761, 805459861}, masked to the
  power-of-two table size; inputs outside [0, 1] encode to zeros.

The per-axis index contributions come from host tables (numpy) as in the
JAX package; the index arithmetic runs in int64 with 32-bit masks, so the
indices are JAX's. The training half (``_grid_index_of``, the TV
gradient) waits for the trainer.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

_PRIMES = (1, 2654435761, 805459861)
_M32 = 0xFFFFFFFF

Coords = Union[torch.Tensor, Sequence[torch.Tensor]]


class HashGridSpec(NamedTuple):
    """Static layout of a hash grid (host-side; hashable)."""
    num_levels: int
    level_dim: int
    base_resolution: int
    log2_hashmap_size: int
    input_dim: int
    per_level_scale: float
    offsets: Tuple[int, ...]          # [L+1] cumulative parameter offsets
    resolutions: Tuple[int, ...]      # [L] per-level grid resolution
    interpolation: str = "linear"

    @property
    def total_params(self) -> int:
        return self.offsets[-1]

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.level_dim


def make_spec(input_dim: int = 3, num_levels: int = 16, level_dim: int = 2,
              base_resolution: int = 16, log2_hashmap_size: int = 19,
              desired_resolution: Optional[float] = 2048,
              per_level_scale: float = 2.0,
              interpolation: str = "linear") -> HashGridSpec:
    """Parameter layout (gridencoder/grid.py:97-134)."""
    if desired_resolution is not None:
        per_level_scale = float(np.exp2(
            np.log2(desired_resolution / base_resolution) / (num_levels - 1)))
    max_params = 2 ** log2_hashmap_size
    offsets, resolutions, offset = [0], [], 0
    for lvl in range(num_levels):
        resolution = int(np.ceil(base_resolution * per_level_scale ** lvl))
        params_in_level = min(max_params, (resolution + 1) ** input_dim)
        offset += int(np.ceil(params_in_level / 8) * 8)
        offsets.append(offset)
        resolutions.append(resolution)
    return HashGridSpec(num_levels=num_levels, level_dim=level_dim,
                        base_resolution=base_resolution,
                        log2_hashmap_size=log2_hashmap_size,
                        input_dim=input_dim, per_level_scale=per_level_scale,
                        offsets=tuple(offsets),
                        resolutions=tuple(resolutions),
                        interpolation=interpolation)


def init_embeddings(spec: HashGridSpec,
                    generator: Optional[torch.Generator] = None,
                    device=None) -> torch.Tensor:
    """Embedding table [total_params, level_dim], U(-1e-4, 1e-4)
    (gridencoder/grid.py:141-143)."""
    u = torch.rand((spec.total_params, spec.level_dim), generator=generator)
    return (u * 2e-4 - 1e-4).to(device)


def _level_constants(spec: HashGridSpec):
    """Per-level (scales f32, res, table sizes, offsets, dense) as numpy."""
    S = math.log2(spec.per_level_scale)
    scales = np.exp2(np.arange(spec.num_levels) * S) * spec.base_resolution \
        - 1.0
    res = np.ceil(scales).astype(np.int64) + 1
    hashmap_sizes = np.diff(np.asarray(spec.offsets))
    dense = np.array([(int(r) + 1) ** spec.input_dim <= int(h)
                      for r, h in zip(res, hashmap_sizes)])
    return (scales.astype(np.float32), res, hashmap_sizes,
            np.asarray(spec.offsets[:-1], np.int64), dense)


def _axis_tables(spec: HashGridSpec):
    """Per-(axis, level) index contributions T[axis][level, coord] (u32
    values in int64) for axes 1.., the per-level hash mask, and the table
    width. Axis 0's contribution is the coordinate itself (prime 1, dense
    stride 1). Hashed levels mask with the power-of-two table size; dense
    levels are already in range."""
    _, res, hashmap_sizes, _, dense = _level_constants(spec)
    L = spec.num_levels
    width = int(res.max()) + 2
    coords = np.arange(width, dtype=np.uint64)
    tables = []
    for axis in range(1, spec.input_dim):
        t = np.zeros((L, width), np.uint32)
        for lvl in range(L):
            mult = ((int(res[lvl]) + 1) ** axis if dense[lvl]
                    else _PRIMES[axis])
            t[lvl] = (coords * np.uint64(mult)).astype(np.uint32)
        tables.append(t.reshape(-1).astype(np.int64))
    mask = np.full(L, _M32, np.int64)
    for lvl in range(L):
        if not dense[lvl]:
            assert hashmap_sizes[lvl] & (hashmap_sizes[lvl] - 1) == 0, (
                "hashed level size must be a power of two")
            mask[lvl] = hashmap_sizes[lvl] - 1
    return tables, mask, width


def _components(inputs: Coords, d: int):
    if isinstance(inputs, (tuple, list)):
        assert len(inputs) == d
        return [c.float().reshape(-1) for c in inputs]
    return [inputs[..., i].float().reshape(-1) for i in range(d)]


def encode(embeddings: torch.Tensor, spec: HashGridSpec, inputs: Coords,
           bound: float = 1.0, feature_major: bool = False) -> torch.Tensor:
    """Encode positions [N, D] in [-bound, bound] (or D component
    tensors): [N, L * C], or [L * C, N] when ``feature_major``. Inputs
    outside the box encode to zeros (gridencoder.cu:113-135)."""
    D, L, C = spec.input_dim, spec.num_levels, spec.level_dim
    comps = [(c + bound) / (2.0 * bound) for c in _components(inputs, D)]
    dev = comps[0].device
    n = comps[0].shape[0]
    scales, _, _, offs, dense = _level_constants(spec)
    tables, mask, width = _axis_tables(spec)
    scales_t = torch.as_tensor(scales, device=dev)[:, None]
    dense_t = torch.as_tensor(dense, device=dev)[:, None]
    mask_t = torch.as_tensor(mask, device=dev)[:, None]
    offs_t = torch.as_tensor(offs, device=dev)[:, None]

    oob = torch.zeros(n, dtype=torch.bool, device=dev)
    for c in comps:
        oob = oob | (c < 0.0) | (c > 1.0)

    pos_grid, frac = [], []                                    # [L, N]
    for c in comps:
        p = c[None, :] * scales_t + 0.5
        pg = torch.floor(p)
        f = p - pg
        if spec.interpolation == "smoothstep":
            f = f * f * (3.0 - 2.0 * f)
        pos_grid.append(pg.to(torch.int64) & _M32)
        frac.append(f)

    # an input outside the box reads clamped rows, as JAX's gathers clamp;
    # its output is zeroed below
    lvl_base = (torch.arange(L, device=dev) * width)[:, None]
    contrib = [[pos_grid[0], (pos_grid[0] + 1) & _M32]]        # axis 0
    for dd in range(1, D):
        tab = torch.as_tensor(tables[dd - 1], device=dev)
        flat = lvl_base + torch.clamp(pos_grid[dd], max=width - 2)
        contrib.append([tab[flat], tab[flat + 1]])

    bits = [[(corner >> dd) & 1 for dd in range(D)]
            for corner in range(2 ** D)]
    idx, w = [], []
    for corner in range(2 ** D):
        acc_dense = acc_hash = contrib[0][bits[corner][0]]
        for dd in range(1, D):
            cdd = contrib[dd][bits[corner][dd]]
            acc_dense = (acc_dense + cdd) & _M32
            acc_hash = acc_hash ^ cdd
        ci = torch.where(dense_t, acc_dense, acc_hash & mask_t)
        idx.append(torch.clamp((ci + offs_t) & _M32,
                               max=embeddings.shape[0] - 1))
        wc = torch.ones((L, n), dtype=embeddings.dtype, device=dev)
        for dd in range(D):
            f = frac[dd].to(embeddings.dtype)
            wc = wc * (f if bits[corner][dd] else (1.0 - f))
        w.append(wc)
    idx = torch.stack(idx)                                     # [8, L, N]
    w = torch.stack(w)

    outs = [(w * embeddings[:, ch][idx]).sum(dim=0) for ch in range(C)]
    out = torch.stack(outs, dim=1)                             # [L, C, N]
    out = torch.where(oob[None, None, :], torch.zeros_like(out), out)
    out = out.reshape(L * C, n)
    return out if feature_major else out.T
