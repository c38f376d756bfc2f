"""The port's entry point and its isolation from JAX."""

import os
import re
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "pienerf_tpu_torch")
GUI_FLAGS = ["--exp_name", "cube", "--backbone", "mlp", "--sim_dx", "0.2",
             "--bound", "0.5", "--radius", "2.5", "--kres", "4",
             "--max_iter_num", "1", "--num_seek_IP", "3"]


def _read_png(path):
    """Decode an 8-bit RGB PNG written without filters."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    return raw[:, 1:].reshape(h, w, 3)


def test_main_gui_cpu_writes_frames(tmp_path):
    out = tmp_path / "frames"
    cmd = [sys.executable, "-m", "pienerf_tpu_torch.main_gui", "--device",
           "cpu", "--workspace", str(tmp_path / "ws"), "--H", "64", "--W",
           "64", "--frames", "2", "--out_dir", str(out)] + GUI_FLAGS
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "wrote 2 frames" in r.stdout
    pngs = sorted(os.listdir(out))
    assert pngs == ["frame_0000.png", "frame_0001.png"]
    for p in pngs:
        img = _read_png(out / p)
        assert img.shape == (64, 64, 3)
        assert img.min() < 255          # the object covers some pixels


def test_main_gui_cpu_cut_writes_frames(tmp_path):
    """--cut bends inside the box only; the rest of the --bound box renders
    as the static background through the cut-split passes."""
    out = tmp_path / "frames"
    cmd = [sys.executable, "-m", "pienerf_tpu_torch.main_gui", "--device",
           "cpu", "--workspace", str(tmp_path / "ws"), "--H", "64", "--W",
           "64", "--frames", "2", "--out_dir", str(out), "--cut",
           "--cut_bounds", "0.0", "0.5", "-0.5", "0.5", "-0.5",
           "0.5"] + GUI_FLAGS
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "wrote 2 frames" in r.stdout
    pngs = sorted(os.listdir(out))
    assert pngs == ["frame_0000.png", "frame_0001.png"]
    for p in pngs:
        img = _read_png(out / p)
        assert img.shape == (64, 64, 3)
        assert img.min() < 255


def test_main_gui_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this checks the no-CUDA refusal; a card is present")
    from pienerf_tpu_torch import main_gui
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main_gui.main(["--workspace", str(tmp_path / "ws"), "--frames", "1",
                       "--out_dir", str(tmp_path / "o")] + GUI_FLAGS)
    from pienerf_tpu_torch.device import resolve_device
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(RuntimeError):
        resolve_device(None)


def test_unported_paths_raise(tmp_path):
    from pienerf_tpu_torch import main_gui
    base = ["--device", "cpu", "--workspace", str(tmp_path / "ws"),
            "--frames", "1", "--out_dir", str(tmp_path / "o")] + GUI_FLAGS
    with pytest.raises(NotImplementedError):
        main_gui.main(base + ["--backbone", "hashgrid"])
    # bf16 storage of the sim operator runs, and the sim cache is written
    # under the workspace
    main_gui.main(base + ["--sim_bf16_b", "--H", "32", "--W", "32"])
    assert len(os.listdir(tmp_path / "ws" / "sim_cache")) == 1
    assert os.listdir(tmp_path / "o") == ["frame_0000.png"]


def test_port_imports_leave_jax_out():
    code = ("import sys; import pienerf_tpu_torch, "
            "pienerf_tpu_torch.render.pipeline, pienerf_tpu_torch.main_gui, "
            "pienerf_tpu_torch.main_sim, pienerf_tpu_torch.kernels.probes, "
            "pienerf_tpu_torch.tools.gather_probe, "
            "pienerf_tpu_torch.tools.micro_floor; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'pienerf_tpu' or "
            "m.startswith('pienerf_tpu.')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_no_jax_import_in_port_sources():
    pat = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+pienerf_tpu"
                     r"(\.|\s|$)|from\s+pienerf_tpu(\.|\s))", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PKG):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    for path in files:
        with open(path) as f:
            src = f.read()
        assert not pat.search(src), path
