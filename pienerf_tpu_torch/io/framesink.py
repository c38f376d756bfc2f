"""Async frame sink: PNG frames encoded and written off the caller's thread.

The JAX package's sink wraps a native encoder with an imageio fallback;
this one needs neither: an 8-bit PNG is a zlib stream with CRC'd
chunks, written by ``write_png`` and decoded by ``read_png`` (the datasets'
images: the machine with the card has neither cv2 nor PIL).
"""

from __future__ import annotations

import queue
import struct
import threading
import zlib

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


_COLOR_TYPES = {1: 0, 2: 4, 3: 2, 4: 6}     # channels -> PNG color type
_CHANNELS = {v: k for k, v in _COLOR_TYPES.items()}


def encode_png(frame: np.ndarray, level: int = 6) -> bytes:
    """frame: [H, W] gray, [H, W, 3] RGB or [H, W, 4] RGBA, uint8 (or
    float in [0, 1]) -> the bytes of an 8-bit PNG, every row filter 0,
    the image data at zlib ``level``."""
    if frame.dtype != np.uint8:
        frame = (np.clip(frame, 0.0, 1.0) * 255).astype(np.uint8)
    h, w = frame.shape[:2]
    cn = 1 if frame.ndim == 2 else frame.shape[2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          np.ascontiguousarray(frame).reshape(h, w * cn)], 1)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                          _COLOR_TYPES[cn], 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))


def write_png(path: str, frame: np.ndarray) -> None:
    """``encode_png(frame)`` written to ``path``."""
    with open(path, "wb") as f:
        f.write(encode_png(frame))


def _paeth_row(cur: list, prev: list, bpp: int) -> None:
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF


def _average_row(cur: list, prev: list, bpp: int) -> None:
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        cur[i] = (cur[i] + ((a + prev[i]) >> 1)) & 0xFF


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int
              ) -> np.ndarray:
    """Undo the five row filters (PNG spec 9.2): raw [h, 1 + stride]."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        f, row = int(raw[y, 0]), raw[y, 1:]
        if f == 0:
            cur = row.copy()
        elif f == 1:                                           # Sub
            cur = (np.cumsum(row.reshape(-1, bpp).astype(np.int64), 0)
                   & 0xFF).astype(np.uint8).reshape(-1)
        elif f == 2:                                           # Up
            cur = row + prev
        elif f in (3, 4):                                      # Average, Paeth
            cl = row.tolist()
            (_average_row if f == 3 else _paeth_row)(cl, prev.tolist(), bpp)
            cur = np.asarray(cl, np.uint8)
        else:
            raise ValueError(f"row {y}: unknown PNG filter {f}")
        out[y] = cur
        prev = cur
    return out


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit non-interlaced PNG file: gray [H, W], gray + alpha
    [H, W, 2], RGB [H, W, 3] or RGBA [H, W, 4] uint8, every row filter
    (None, Sub, Up, Average, Paeth). What ``cv2.imread(path,
    IMREAD_UNCHANGED)`` reads, in RGB(A) channel order; palette, 16-bit
    and interlaced files raise."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """``read_png`` of the bytes of a PNG (``name`` labels its errors)."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{name}: not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body[:13])
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(f"{name}: bit depth {depth}, color type {ctype}, "
                         f"interlace {interlace}: only 8-bit non-interlaced "
                         "gray, gray+alpha, RGB and RGBA are read")
    cn = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    img = _unfilter(raw.reshape(h, 1 + w * cn), h, w * cn, cn)
    return img.reshape(h, w) if cn == 1 else img.reshape(h, w, cn)


class FrameSink:
    """Push RGB frames; worker threads encode them and write them to disk.
    Use as a context manager: leaving it waits for every frame."""

    N_THREADS = 2

    def __init__(self):
        self._q: "queue.Queue" = queue.Queue()
        self._errors = []
        self._threads = [threading.Thread(target=self._worker, daemon=True)
                         for _ in range(self.N_THREADS)]
        for t in self._threads:
            t.start()

    def _worker(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                write_png(*item)
            except OSError as e:          # reported by close()
                self._errors.append(e)
            finally:
                self._q.task_done()

    def push(self, path: str, frame: np.ndarray) -> None:
        self._q.put((path, np.asarray(frame)))

    def close(self) -> None:
        for _ in self._threads:
            self._q.put(None)
        self._q.join()
        for t in self._threads:
            t.join(timeout=60)
        if self._errors:
            raise self._errors[0]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
