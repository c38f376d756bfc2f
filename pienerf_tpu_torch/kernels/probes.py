"""Probe kernels: four row-fetch mechanisms and the tile kernel's empty
shell (``csrc/probe_kernels.cu``), with their plain PyTorch versions.

Port of the four Pallas probes of ``tools/pallas_gather_probe.py``
(``onehot_fetch``, ``dma_fetch``, ``vmem_take_fetch``, ``dynslice_fetch``)
and of ``tools/micro_floor.py:build_arm``. They price mechanisms for the
tools of ``pienerf_tpu_torch.tools``; no frame path runs them. Each wrapper
launches its kernel for CUDA tensors and takes the plain version only for
CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from pienerf_tpu_torch.kernels import _build
from pienerf_tpu_torch.kernels.field import check_arg

ROW = 128            # floats per table row
FETCH_BLOCK = 512    # indices per thread block (all fetches but take)
T2 = 256             # rays per tile
FETCHES = ("onehot", "dma", "take", "dynslice")


def fetch_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[b] = table[idx[b]]."""
    return table[idx.long()]


def _fetch(which: str, table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    T, B = table.shape[0], idx.shape[0]
    if table.ndim != 2 or table.shape[1] != ROW:
        raise ValueError(f"table must be [T, {ROW}], got {tuple(table.shape)}")
    if which != "take" and B % FETCH_BLOCK:
        raise ValueError(f"{which}_fetch takes a multiple of {FETCH_BLOCK} "
                         f"indices, got {B}")
    if table.device.type == "cpu":
        return fetch_plain(table, idx)
    dev = table.device
    check_arg(table, "table", torch.float32, (T, ROW), dev)
    check_arg(idx, "idx", torch.int32, (B,), dev)
    out = torch.empty((B, ROW), dtype=torch.float32, device=dev)
    lib = _build.library("probes")
    scratch = None
    if which == "onehot":          # the table's three bf16 parts
        nbytes = lib.pienerf_onehot_scratch_bytes
        nbytes.restype = ctypes.c_longlong
        nbytes.argtypes = [ctypes.c_int]
        scratch = torch.empty(nbytes(T), dtype=torch.uint8, device=dev)
    fn = lib.pienerf_fetch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 3 + [ctypes.c_void_p]
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
    rc = fn(FETCHES.index(which), table.data_ptr(), idx.data_ptr(),
            out.data_ptr(), None if scratch is None else scratch.data_ptr(),
            T, B, n_sm, stream)
    _build.check(lib, rc, f"{which}_fetch")
    FETCH_FNS[which].launches += 1
    return out


def onehot_fetch(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows by the dense one-hot product on the tensor cores: the table
    split into three bf16 parts (a prologue kernel, every call), each
    multiplied by the one-hot [B, T] into its own f32 accumulators, summed
    last; exact for every finite table value on bf16's grid (every |x| >=
    2^-110), bit for bit except that -0.0 reads +0.0. table [T, 128] f32,
    idx [B] int32 in [0, T) (an index outside gives a zero row on the
    card)."""
    return _fetch("onehot", table, idx)


def dma_fetch(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows by per-row asynchronous copies (``cp.async``) into a ring of 8
    shared-memory slots per block, then out."""
    return _fetch("dma", table, idx)


def take_fetch(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows by the card's data-parallel gather: one warp per row, one
    coalesced 16-byte load and store per lane. Any B."""
    return _fetch("take", table, idx)


def dynslice_fetch(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows copied one after the other by one thread per 512 indices: the
    per-access latency floor."""
    return _fetch("dynslice", table, idx)


FETCH_FNS = dict(zip(FETCHES, (onehot_fetch, dma_fetch, take_fetch,
                              dynslice_fetch)))
for _fn in FETCH_FNS.values():
    _fn.launches = 0


def floor_shell_plain(tile_sc: torch.Tensor) -> torch.Tensor:
    """Zeros [A, 8, 256] with row 0 = 1 on active tiles (tile_sc[:, 2] >
    0); the other inputs of the shell do not reach its output."""
    out = torch.zeros((tile_sc.shape[0], 8, T2), dtype=torch.float32,
                      device=tile_sc.device)
    out[:, 0, :] = (tile_sc[:, 2] > 0.0).float()[:, None]
    return out


def floor_shell(tile_sc: torch.Tensor,
                bin_start: Optional[torch.Tensor] = None,
                dirs: Optional[torch.Tensor] = None,
                cand: Optional[torch.Tensor] = None,
                block_tiles: int = 4) -> torch.Tensor:
    """The tile kernel's shell: per tile, load tile_sc [A, 8], bin_start
    [A, BS] (int32 or int16), dirs [A, 8, 256] and cand [A, P, 16] into
    shared memory, zero out[a] and add 1 to row 0 of an active tile;
    ``block_tiles`` tiles per thread block. An input given as None is left
    out of the kernel (the arms of ``tools.micro_floor``). Returns out
    [A, 8, 256]."""
    A = tile_sc.shape[0]
    if block_tiles < 1:
        raise ValueError(f"block_tiles {block_tiles} must be >= 1")
    if tile_sc.device.type == "cpu":
        return floor_shell_plain(tile_sc)
    dev = tile_sc.device
    check_arg(tile_sc, "tile_sc", torch.float32, (A, 8), dev)
    BS, P = 1, 1
    if bin_start is not None:
        BS = bin_start.shape[1]
        if bin_start.dtype not in (torch.int32, torch.int16):
            raise TypeError(f"bin_start has dtype {bin_start.dtype}, "
                            f"expected int32 or int16")
        check_arg(bin_start, "bin_start", bin_start.dtype, (A, BS), dev)
    if dirs is not None:
        check_arg(dirs, "dirs", torch.float32, (A, 8, T2), dev)
    if cand is not None:
        P = cand.shape[1]
        check_arg(cand, "cand", torch.float32, (A, P, 16), dev)
    out = torch.empty((A, 8, T2), dtype=torch.float32, device=dev)
    lib = _build.library("probes")
    fn = lib.pienerf_floor_shell
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream

    def ptr(t):
        return None if t is None else t.data_ptr()
    rc = fn(tile_sc.data_ptr(), ptr(bin_start), ptr(dirs), ptr(cand),
            out.data_ptr(), A, block_tiles, BS, P,
            int(bin_start is not None and bin_start.dtype == torch.int16),
            float("nan"), stream)
    _build.check(lib, rc, "floor_shell")
    floor_shell.launches += 1
    return out


floor_shell.launches = 0
