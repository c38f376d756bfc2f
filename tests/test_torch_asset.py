"""The port's asset-validation chain against the JAX package (CPU):
``tools/validate_asset.py`` at the JAX test's toy sizes
(tests/test_validate_asset.py) with JAX's report keys, the orbit poses,
``tools/hashgrid_chain.py`` on a toy seeded hash-grid workspace (its
export / re-import, sampling and annotation, and what it hands
validate_asset), ``.pth`` files crossing between the packages bit for bit,
and the annotation's pins on one PLY equal to JAX's rule. Each tolerance
is stated where it is checked."""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from pienerf_tpu.io import checkpoint as jck
from pienerf_tpu.io import ply as jply
from pienerf_tpu.models import hash_encoder as jhe
from pienerf_tpu.models import network as jnet
from pienerf_tpu_torch.io import checkpoint as tck
from pienerf_tpu_torch.io.ply import write_ply
from pienerf_tpu_torch.models import hash_encoder as the
from pienerf_tpu_torch.models import network as tnet
from pienerf_tpu_torch.tools import hashgrid_chain, validate_asset
from pienerf_tpu_torch.weights import field_to_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID_KW = dict(num_levels=4, log2_hashmap_size=12, desired_resolution=64)
# tools/validate_asset.py's report and its sections' keys
REPORT_KEYS = {"pth", "ply", "bound", "import", "distill", "field_agreement",
               "image_agreement", "sim_init", "interactive", "verdict"}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread a test: the tensors here are small, and the test
    workers share the machine's cores, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_spec(bound):
    """The default hash-grid field on a small table: the grid update, which
    image_agreement runs over 128^3 cells, costs 6 s here and 35 s on the
    default table, at one thread."""
    return tnet.make_spec(bound=bound, backbone="hashgrid")._replace(
        grid=the.make_spec(**GRID_KW))


def cube_ply(path):
    """tests/test_validate_asset.py's annotated cube (the verify recipe's
    known-stable configuration)."""
    g = np.linspace(0.3, 0.7, 8) - 0.5
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    p = np.stack([x.ravel(), y.ravel(), z.ravel()], 1)
    n = len(p)
    write_ply(path, p, vp=np.full(n, 1e-3),
              pin=(p[:, 1] > 0.15).astype(float), lam=np.full(n, 1e4),
              mu=np.full(n, 1e4), mass=np.full(n, 0.1))


def test_orbit_poses_are_jaxs():
    """orbit_pose equals tools/validate_asset.py's, bit for bit."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import validate_asset as jva
    finally:
        sys.path.pop(0)
    for i in range(8):
        args = (np.pi / 3 + 0.2 * (i % 3), 2 * np.pi * i / 8, 2.5 * 0.7)
        np.testing.assert_array_equal(validate_asset.orbit_pose(*args),
                                      jva.orbit_pose(*args))


def test_validate_asset_at_the_jax_tests_sizes(tmp_path):
    """run() at tests/test_validate_asset.py's sizes (bound 0.5, 2 poses at
    32x32, 25 distill steps, Wd 64, the cube at sim_dx 0.2, kres 4, 2
    frames, 16 samples, one grid update, the sim cache) on a seeded .pth:
    JAX's report keys and the JAX test's checks; the frames timed on the
    host clock (the CPU)."""
    spec = small_spec(0.5)
    pth = str(tmp_path / "ngp_ep0300.pth")
    tck.save_torch_ngp(pth, field_to_numpy(tnet.FieldMLP(
        spec, generator=torch.Generator().manual_seed(3))))
    ply = str(tmp_path / "cube.ply")
    cube_ply(ply)
    out = str(tmp_path / "report.json")
    report = validate_asset.run(
        pth, ply, out, bound=0.5, n_poses=2, H=32, W=32, distill_steps=25,
        student_width=64, sim_dx=0.2, kres=4, bench_frames=2,
        render_samples=16, n_grid_updates=1,
        cache_dir=str(tmp_path / "cache"), teacher_spec=spec, device="cpu")
    with open(out) as f:
        saved = json.load(f)
    assert set(saved) == REPORT_KEYS
    assert saved["import"]["ok"] and saved["import"]["extra_keys"] == []
    assert np.isfinite(saved["distill"]["final_loss"])
    assert saved["distill"]["steps"] == 25 and saved["distill"]["width"] == 64
    assert set(saved["field_agreement"]) == {
        "sigma_logmse", "rgb_mse_weighted", "occupancy_iou"}
    ia = saved["image_agreement"]
    assert {"psnr_per_view", "ssim_per_view", "psnr_mean", "ssim_mean",
            "seconds"} == set(ia)
    assert len(ia["psnr_per_view"]) == 2
    assert all(np.isfinite(v) for v in ia["psnr_per_view"])
    assert {"fps", "H", "W", "frames", "samples"} <= set(
        saved["interactive"])
    assert saved["interactive"]["fps"] > 0
    assert saved["interactive"]["device"] == "cpu"
    assert set(saved["verdict"]) == {"image_psnr_ge_30",
                                     "interactive_fps_ge_30"}
    assert report["sim_init"]["n_ip"] > 0
    assert len(os.listdir(tmp_path / "cache")) == 1


def toy_workspace(ws, spec):
    """A workspace as quality_run leaves one: a native checkpoint of a
    seeded hash grid with density in part of the box (the sigma head's
    first column raised) and its curve."""
    tree = field_to_numpy(tnet.FieldMLP(
        spec, generator=torch.Generator().manual_seed(0)))
    tree["encoder"] = tree["encoder"] * 1000.0
    tree["sigma_net"][-1][:, 0] = 1.0
    os.makedirs(os.path.join(ws, "checkpoints"))
    tck.save_native(os.path.join(ws, "checkpoints", "ngp_ep0002.npz"),
                    {"params": tree, "ema_params": tree}, {"epoch": 2})
    with open(os.path.join(ws, "curve.json"), "w") as f:
        json.dump([{"step": 1000, "loss": 0.1, "psnr": 20.0, "wall_s": 5.0},
                   {"step": 2000, "loss": 0.05, "psnr": 24.5,
                    "wall_s": 9.0}], f)
    return tree


def test_hashgrid_chain_on_a_toy_workspace(tmp_path, monkeypatch):
    """The chain on a toy workspace (sub_res 16): the newest checkpoint's
    EMA params exported to .pth and re-imported bit for bit; the cloud
    sampled from the re-imported field and annotated (its pins are JAX's
    rule on the written PLY, read by JAX's reader); the .pth and the PLY
    handed to validate_asset.run with the chain's settings (recorded
    here: validate_asset has its own test above); the report and the
    chain_summary line in JAX's schema."""
    ws = str(tmp_path / "ws")
    spec = small_spec(1.0)
    tree = toy_workspace(ws, spec)
    calls = []

    def asset(pth, ply, out, **kw):
        calls.append((pth, ply, out, kw))
        return {"image_agreement": {"psnr_mean": 21.0},
                "interactive": {"fps": 9.0}}

    monkeypatch.setattr(validate_asset, "run", asset)
    report = hashgrid_chain.run(ws, sub_res=16, distill_steps=7, H=32, W=32,
                                n_poses=2, teacher_spec=spec, device="cpu")
    rt = report["pth_roundtrip"]
    assert rt["bit_exact"] and rt["max_abs_err"] == 0.0
    assert rt["native"].endswith("ngp_ep0002.npz") and rt["n_tensors"] == 6
    jp, _ = jck.load_torch_ngp(rt["pth"])
    for a, b in zip(jax.tree_util.tree_leaves(jp),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert report["train"] == {"final_step": 2000, "final_eval_psnr": 24.5,
                               "peak_eval_psnr": 24.5, "wall_s": 9.0}
    n = report["sampling"]["n_points"]
    assert n > 200
    ply = os.path.join(ws, "physics.ply")
    d = jply.read_physics_ply(ply)
    assert d["pos"].shape == (n, 3)
    pin = d["pos"][:, 2] < np.quantile(d["pos"][:, 2], 0.12)
    np.testing.assert_array_equal(d["pin"], pin)
    assert report["annotation"]["n_pinned"] == int(pin.sum()) > 0
    for k, v in (("lam", 1e5), ("mu", 1e5), ("mass", 0.1)):
        np.testing.assert_array_equal(d[k], np.full(n, v))
    (pth, ply_arg, out, kw), = calls
    assert (pth, ply_arg) == (rt["pth"], ply)
    assert out == os.path.join(ws, "hashgrid_chain_report.json.asset.json")
    assert kw["distill_steps"] == 7 and kw["student_width"] == 64
    assert (kw["H"], kw["W"], kw["n_poses"], kw["sim_dx"]) == (32, 32, 2,
                                                               0.05)
    with open(os.path.join(ws, "hashgrid_chain_report.json")) as f:
        assert set(json.load(f)) == {"workspace", "train", "pth_roundtrip",
                                     "sampling", "annotation", "asset"}


def test_pth_files_cross_between_the_packages(tmp_path):
    """A .pth the port writes loads in JAX bit for bit, and one JAX writes
    loads in the port bit for bit (a small hash grid, seeded)."""
    jspec = jnet.make_spec(bound=1.0, backbone="hashgrid")._replace(
        grid=jhe.make_spec(**GRID_KW))
    jp = jax.device_get(jnet.init_params(jax.random.PRNGKey(4), jspec))
    a = str(tmp_path / "jax.pth")
    jck.save_torch_ngp(a, jp)
    tp, _ = tck.load_torch_ngp(a)
    b = str(tmp_path / "port.pth")
    tck.save_torch_ngp(b, tp)
    back, _ = jck.load_torch_ngp(b)
    for x, y, z in zip(jax.tree_util.tree_leaves(jp),
                       jax.tree_util.tree_leaves(tp),
                       jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(y), np.asarray(x))
        np.testing.assert_array_equal(np.asarray(z), np.asarray(x))


def test_annotation_pins_as_jax_on_one_ply(tmp_path):
    """annotate() on a sampled-cloud PLY: its pins are JAX's inline rule
    (tools/hashgrid_chain.py:137-145) applied to the same PLY, exactly;
    positions and volumes unchanged."""
    rs = np.random.RandomState(0)
    pos = rs.rand(1000, 3) * 2 - 1
    vp = rs.rand(1000)
    path = str(tmp_path / "physics.ply")
    write_ply(path, pos, vp=vp)
    d = jply.read_physics_ply(path)
    want = (d["pos"][:, 2] < np.quantile(d["pos"][:, 2], 0.12)).astype(
        np.float64)
    n_pin = hashgrid_chain.annotate(path)
    got = jply.read_physics_ply(path)
    assert n_pin == int(want.sum()) == 120
    np.testing.assert_array_equal(got["pin"], want.astype(bool))
    np.testing.assert_array_equal(got["pos"], d["pos"])
    np.testing.assert_array_equal(got["vp"], d["vp"])
