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


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread a test: the tensors here are small, and the test
    workers share the machine's cores, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    # the reference's .pth import is not ported: named, latest, or by path
    ck = tmp_path / "ws" / "checkpoints"
    ck.mkdir(parents=True)
    (ck / "ngp_ep0001.pth").write_bytes(b"")
    for extra in ([], ["--ckpt", str(ck / "ngp_ep0001.pth")],
                  ["--ckpt", "scratch", "--ckpt_path",
                   str(ck / "ngp_ep0001.pth")]):
        with pytest.raises(NotImplementedError, match="load_torch_ngp"):
            main_gui.main(base + extra)
    (ck / "ngp_ep0001.pth").unlink()
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
            "pienerf_tpu_torch.tools.micro_floor, "
            "pienerf_tpu_torch.ops.morton, pienerf_tpu_torch.ops.grid, "
            "pienerf_tpu_torch.data.rays, pienerf_tpu_torch.data.provider, "
            "pienerf_tpu_torch.ops.raymarch, "
            "pienerf_tpu_torch.models.hash_encoder, "
            "pienerf_tpu_torch.models.network, "
            "pienerf_tpu_torch.render.renderer, "
            "pienerf_tpu_torch.render.fast, "
            "pienerf_tpu_torch.ops.spatial_hash, "
            "pienerf_tpu_torch.ops.bending, "
            "pienerf_tpu_torch.render.deformed, "
            "pienerf_tpu_torch.sim.solver, pienerf_tpu_torch.io.checkpoint, "
            "pienerf_tpu_torch.main_render, "
            "pienerf_tpu_torch.data.synthetic, "
            "pienerf_tpu_torch.train.optim, "
            "pienerf_tpu_torch.train.metrics, "
            "pienerf_tpu_torch.train.trainer, "
            "pienerf_tpu_torch.train.distill, "
            "pienerf_tpu_torch.utils.mesh, pienerf_tpu_torch.weights, "
            "pienerf_tpu_torch.main_train, pienerf_tpu_torch.main_distill; "
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


def _tree(seed):
    """A finite 64-wide mlp params tree, drawn from a seed."""
    rng = np.random.RandomState(seed)
    dims = ([51, 64, 64, 64, 16], [31, 64, 64, 3])
    return {k: [(rng.uniform(-1, 1, (a, b)) * np.sqrt(3.0 / a)).astype(
        np.float32) for a, b in zip(d, d[1:])]
        for k, d in zip(("sigma_net", "color_net"), dims)}


@pytest.fixture(scope="module")
def ckpt_runs(tmp_path_factory):
    """A workspace whose newest checkpoint is ngp_ep0002.npz (an older
    ep0001 beside it), a NaN checkpoint, and the frame of each reference
    run: ``latest`` on that workspace and the seeded field of an empty
    one."""
    from pienerf_tpu_torch.io.checkpoint import save_native
    root = tmp_path_factory.mktemp("ckpt")
    ck = root / "ws" / "checkpoints"
    ck.mkdir(parents=True)
    save_native(str(ck / "ngp_ep0001.npz"),
                {"params": _tree(1), "ema_params": _tree(1)})
    save_native(str(ck / "ngp_ep0002.npz"),
                {"params": _tree(2), "ema_params": _tree(3)})
    bad = _tree(2)
    bad["color_net"][1][5, 7] = np.nan
    # only params are checked (trainer.py:937-948): a finite ema is refused
    # all the same
    save_native(str(root / "nan.npz"), {"params": bad,
                                        "ema_params": _tree(3)})
    runs = dict(root=root, ckpt=ck / "ngp_ep0002.npz", nan=root / "nan.npz")
    runs["latest"], _ = _gui_frame(root, "latest", str(root / "ws"), [])
    runs["seeded"], _ = _gui_frame(root, "seeded", str(root / "empty"), [])
    return runs


def _gui_frame(root, name, workspace, extra):
    """One 32x32 frame of main_gui on the CPU -> (image, stdout)."""
    import contextlib
    import io
    from pienerf_tpu_torch import main_gui
    out = root / f"o_{name}"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main_gui.main(["--device", "cpu", "--workspace", workspace,
                       "--frames", "1", "--out_dir", str(out), "--H", "32",
                       "--W", "32", "--sim_cache", "0"] + GUI_FLAGS + extra)
    return _read_png(out / "frame_0000.png"), buf.getvalue()


@pytest.mark.parametrize("case", ["ckpt_path", "ckpt_path_latest",
                                  "ckpt_file", "scratch", "nan_refused"])
def test_main_gui_ckpt_follows_the_trainer(ckpt_runs, case):
    """main_gui picks its field as the reference's Trainer(use_checkpoint=
    cfg.ckpt) does: ``--ckpt_path`` or ``--ckpt <file>`` load that file
    (the frame equals ``latest`` on the workspace whose newest checkpoint
    it is), ``--ckpt latest`` does not read ``--ckpt_path``, ``--ckpt
    scratch`` ignores the workspace's checkpoints, and a checkpoint whose
    params are not finite is refused with the trainer's log line, keeping
    the seeded field."""
    r = ckpt_runs
    assert not np.array_equal(r["latest"], r["seeded"])
    empty = str(r["root"] / f"empty_{case}")
    ws = str(r["root"] / "ws")
    older = str(r["ckpt"].parent / "ngp_ep0001.npz")
    extra, workspace, want = {
        "ckpt_path": (["--ckpt", "scratch", "--ckpt_path", str(r["ckpt"])],
                      empty, "latest"),
        # the latest branch comes first (trainer.py:371)
        "ckpt_path_latest": (["--ckpt_path", older], ws, "latest"),
        "ckpt_file": (["--ckpt", str(r["ckpt"])], empty, "latest"),
        "scratch": (["--ckpt", "scratch"], ws, "seeded"),
        # --ckpt_path wins over --ckpt <file> (trainer.py:374)
        "nan_refused": (["--ckpt", str(r["ckpt"]), "--ckpt_path",
                         str(r["nan"])], ws, "seeded"),
    }[case]
    img, log = _gui_frame(r["root"], case, workspace, extra)
    np.testing.assert_array_equal(img, r[want])
    if case == "nan_refused":
        assert f"[ckpt] REFUSING to load {r['nan']}: params contain " \
            "non-finite values" in log, log
    elif want == "latest":
        assert f"[ckpt] loaded {r['ckpt']}" in log, log


@pytest.mark.parametrize("flags", [
    [], ["--ckpt_path", "{ep1}"], ["--ckpt", "scratch"],
    ["--ckpt", "scratch", "--ckpt_path", "{ep1}"], ["--ckpt", "{ep1}"],
    ["--ckpt", "{ep1}", "--ckpt_path", "{nan}"]],
    ids=["latest", "latest_ckpt_path", "scratch", "scratch_ckpt_path",
         "file", "file_nan_ckpt_path"])
def test_checkpoint_choice_equals_the_trainers(ckpt_runs, monkeypatch,
                                               flags):
    """On one workspace and one set of flags, the file main_gui picks and
    whether it refuses it (``_checkpoint_path``, ``_params_finite``) equal
    what the reference ``Trainer(use_checkpoint=cfg.ckpt)`` opens and
    adopts."""
    from pienerf_tpu.config import PieNeRFConfig
    from pienerf_tpu.io import checkpoint as jax_ckpt
    from pienerf_tpu.train import trainer as jax_trainer
    from pienerf_tpu_torch import main_gui
    from pienerf_tpu_torch.config import get_shared_opts
    from pienerf_tpu_torch.io.checkpoint import load_native
    r = ckpt_runs
    ws = str(r["root"] / "ws")
    names = dict(ep1=str(r["ckpt"].parent / "ngp_ep0001.npz"),
                 nan=str(r["nan"]))
    argv = ["--workspace", ws, "--backbone", "mlp"] + [
        f.format(**names) for f in flags]
    cfg = get_shared_opts(None, argv)

    opened, adopted = [], []
    load = jax_ckpt.load_native
    monkeypatch.setattr(jax_ckpt, "load_native",
                        lambda path: opened.append(path) or load(path))
    monkeypatch.setattr(jax_trainer.Trainer, "_adopt_mlp_arch",
                        lambda self, params: adopted.append(True))
    ref_cfg = PieNeRFConfig(workspace=ws, backbone="mlp", ckpt=cfg.ckpt,
                            ckpt_path=cfg.ckpt_path).finalize()
    jax_trainer.Trainer("ngp", ref_cfg, workspace=ws,
                        use_checkpoint=ref_cfg.ckpt, seed=0)

    path = main_gui._checkpoint_path(cfg)
    assert opened == ([] if path is None else [path]), (opened, path)
    port_adopts = path is not None and main_gui._params_finite(
        load_native(path)[0]["params"])
    assert bool(adopted) == port_adopts, (path, adopted)
