"""PLY point-cloud I/O.

Self-contained reader/writer for the physics point-cloud schema used by the
pipeline: per-vertex ``x, y, z`` plus optional ``vp`` (sample volume, written
by the sampler — reference: main_sample.py:14-23) and user-annotated material
attributes ``pin, lam, mu, mass`` (reference: simulator/solver.py:115-137,
README.md:98-108). Supports ascii and binary_little_endian, arbitrary scalar
vertex properties, and ignores non-vertex elements.
"""

from __future__ import annotations

import io as _io
from typing import Dict, List, Optional, Tuple

import numpy as np

_PLY_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}
_INV_TYPES = {"f8": "double", "f4": "float", "i4": "int", "u1": "uchar",
              "i1": "char", "i2": "short", "u2": "ushort", "u4": "uint"}


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Read a PLY file; returns a dict of per-vertex property arrays."""
    with open(path, "rb") as f:
        data = f.read()

    # --- parse header ---
    end = data.find(b"end_header")
    if end < 0:
        raise ValueError(f"{path}: not a PLY file (no end_header)")
    nl = data.find(b"\n", end)
    header = data[:nl].decode("ascii", errors="replace")
    body = data[nl + 1:]

    fmt = None
    elements: List[Tuple[str, int, List[Tuple[str, str]]]] = []
    cur: Optional[Tuple[str, int, List[Tuple[str, str]]]] = None
    for line in header.splitlines():
        tok = line.strip().split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            cur = (tok[1], int(tok[2]), [])
            elements.append(cur)
        elif tok[0] == "property" and cur is not None:
            if tok[1] == "list":
                cur[2].append((tok[-1], f"list:{tok[2]}:{tok[3]}"))
            else:
                cur[2].append((tok[-1], _PLY_TYPES[tok[1]]))

    if fmt is None:
        raise ValueError(f"{path}: missing PLY format line")
    if fmt == "binary_big_endian":
        raise NotImplementedError("big-endian PLY not supported")

    out: Dict[str, np.ndarray] = {}
    if fmt == "ascii":
        txt = body.decode("ascii")
        rows = [r.split() for r in txt.splitlines() if r.strip()]
        ofs = 0
        for name, count, props in elements:
            block = rows[ofs:ofs + count]
            ofs += count
            if name != "vertex":
                continue
            arr = np.array(block, dtype=np.float64)
            for i, (pname, _) in enumerate(props):
                out[pname] = arr[:, i]
    else:  # binary_little_endian
        offset = 0
        for name, count, props in elements:
            if any(t.startswith("list:") for _, t in props):
                if name == "vertex":
                    raise NotImplementedError("list properties on vertex element")
                break  # list-typed trailing elements (e.g. faces) are skipped
            dtype = np.dtype([(pname, "<" + t) for pname, t in props])
            if name == "vertex":
                arr = np.frombuffer(body, dtype=dtype, count=count, offset=offset)
                for pname, _ in props:
                    out[pname] = np.ascontiguousarray(arr[pname])
            offset += dtype.itemsize * count
    return out


def write_ply(path: str, points: np.ndarray,
              binary: bool = True, **attrs: np.ndarray) -> None:
    """Write points [N,3] (float64, matching the reference schema) plus any
    scalar per-vertex attributes (e.g. vp=..., pin=..., mass=...)."""
    points = np.asarray(points, dtype=np.float64)
    n = points.shape[0]
    cols: List[Tuple[str, np.ndarray]] = [
        ("x", points[:, 0]), ("y", points[:, 1]), ("z", points[:, 2])
    ]
    for k, v in attrs.items():
        v = np.asarray(v)
        if v.dtype not in (np.float32,):
            v = v.astype(np.float64)
        assert v.shape == (n,), f"attribute {k} must be [N]"
        cols.append((k, v))

    hdr = _io.StringIO()
    hdr.write("ply\n")
    hdr.write(f"format {'binary_little_endian' if binary else 'ascii'} 1.0\n")
    hdr.write(f"element vertex {n}\n")
    for k, v in cols:
        hdr.write(f"property {_INV_TYPES[v.dtype.str[1:]]} {k}\n")
    hdr.write("end_header\n")

    with open(path, "wb") as f:
        f.write(hdr.getvalue().encode("ascii"))
        if binary:
            rec = np.empty(n, dtype=np.dtype([(k, "<" + v.dtype.str[1:]) for k, v in cols]))
            for k, v in cols:
                rec[k] = v
            f.write(rec.tobytes())
        else:
            mat = np.stack([v for _, v in cols], axis=1)
            np.savetxt(f, mat, fmt="%.17g")


def read_physics_ply(path: str) -> Dict[str, np.ndarray]:
    """Read a material-annotated physics PLY (solver input).

    Returns pos [N,3] float64 and mass/mu/lam [N] float64, pin [N] bool.
    Missing material attributes get reference-demo defaults so raw sampler
    output is still loadable.
    """
    props = read_ply(path)
    n = props["x"].shape[0]
    pos = np.stack([props["x"], props["y"], props["z"]], axis=1).astype(np.float64)

    def get(name: str, default: float) -> np.ndarray:
        if name in props:
            return props[name].astype(np.float64)
        return np.full((n,), default, dtype=np.float64)

    return {
        "pos": pos,
        "vp": get("vp", 1.0),
        "mass": get("mass", 1.0),
        "mu": get("mu", 1e5),
        "lam": get("lam", 1e5),
        "pin": get("pin", 0.0).astype(bool),
    }
