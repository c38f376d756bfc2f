"""Async frame sink: PNG frames encoded and written off the caller's thread.

The JAX package's sink wraps a native encoder with an imageio fallback;
this one needs neither: an 8-bit RGB PNG is a zlib stream with CRC'd
chunks, written by ``write_png``.
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


def write_png(path: str, frame: np.ndarray) -> None:
    """frame: [H, W, 3] uint8 (or float in [0, 1])."""
    if frame.dtype != np.uint8:
        frame = (np.clip(frame, 0.0, 1.0) * 255).astype(np.uint8)
    h, w = frame.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          np.ascontiguousarray(frame).reshape(h, w * 3)], 1)
    png = (b"\x89PNG\r\n\x1a\n"
           + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
           + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def read_png(path: str) -> np.ndarray:
    """[H, W, 3] uint8 of a PNG that ``write_png`` wrote (8-bit RGB,
    filter 0 on every row); no other PNG is read."""
    with open(path, "rb") as f:
        data = f.read()
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if (raw[:, 0] != 0).any():
        raise ValueError(f"{path}: a row filter other than 0")
    return raw[:, 1:].reshape(h, w, 3)


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
