"""The port's workflow tools against the JAX package (CPU): one
distill_table teacher-fit step against the same step in JAX + optax;
distill_table and quality_run end to end at a toy size; quality_run's
device quadrature against the numpy oracle. Each tolerance is stated where
it is checked."""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pienerf_tpu.models import hash_encoder as jhe
from pienerf_tpu.models import network as jnet
from pienerf_tpu_torch import weights as W
from pienerf_tpu_torch.data import synthetic
from pienerf_tpu_torch.models import hash_encoder as the
from pienerf_tpu_torch.models import network as tnet
from pienerf_tpu_torch.tools import distill_table, quality_run
from pienerf_tpu_torch.train import distill
from pienerf_tpu_torch.train.optim import Adam

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = torch.as_tensor
GRID_KW = dict(num_levels=4, log2_hashmap_size=12, desired_resolution=64)
G_FLOOR = 1e-6       # |g| / max|g| of its leaf above which params compare
MAX_FLIPS = 2        # params below the floor that moved the other way


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread a test: the tensors here are small, and the test
    workers share the machine's cores, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- distill_table ---------------------------------------------------------

def test_teacher_fit_step_matches_jax_and_optax():
    """One fit step on a small hash grid from the same params and batch:
    the port's make_fit_step against network.forward + optax.adam(
    exponential_decay(1e-2, 100, 0.1), 0.9, 0.99, eps 1e-15) written here
    as tools/distill_table.py writes it. Loss within 1e-6 relative; the
    updated params within 1e-6 where |g| > 1e-6 of the leaf's largest,
    and at most 2 flips a leaf below that floor (Adam moves a param by
    +-lr whatever the size of its gradient)."""
    jspec = jnet.make_spec(bound=1.0, backbone="hashgrid")._replace(
        grid=jhe.make_spec(**GRID_KW))
    tspec = tnet.make_spec(bound=1.0, backbone="hashgrid")._replace(
        grid=the.make_spec(**GRID_KW))
    p = jnet.init_params(jax.random.PRNGKey(0), jspec)
    p["encoder"] = p["encoder"] * 1000.0
    rs = np.random.RandomState(0)
    n = 512
    x = rs.uniform(-1, 1, (n, 3)).astype(np.float32)
    d = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (n, 1))
    sig_np, rgb_np = synthetic.scene_field("sphere", x)
    sig_gt = np.asarray(sig_np, np.float32)
    rgb_gt = np.asarray(rgb_np, np.float32)

    opt = optax.adam(optax.exponential_decay(1e-2, 100, 0.1), b1=0.9,
                     b2=0.99, eps=1e-15)
    alpha = 1.0 - jnp.exp(-jnp.clip(sig_gt, 0.0, 1e4) * 0.01)

    def loss_fn(pp):
        sig, rgb = jnet.forward(pp, jspec, jnp.asarray(x), jnp.asarray(d))
        l_sig = jnp.mean((jnp.log1p(sig) - jnp.log1p(sig_gt)) ** 2)
        l_rgb = jnp.mean(alpha[:, None] * (rgb - rgb_gt) ** 2)
        return l_sig + 4.0 * l_rgb

    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(p)
    upd, _ = opt.update(jg, opt.init(p), p)
    jp = optax.apply_updates(p, upd)

    field = W.field_from_numpy(jax.device_get(p), tspec, "cpu",
                               trainable=True)
    topt = Adam(1e-2, 100, 0.1, b1=0.9, b2=0.99, eps=1e-15,
                max_consecutive_errors=None)
    step = distill_table.make_fit_step(topt)
    _, tl = step(field, topt.init(field.leaves()), T(x), T(d), T(sig_gt),
                 T(rgb_gt))
    assert abs(float(tl) / float(jl) - 1.0) <= 1e-6, (float(tl), float(jl))
    for a, b, g in zip(W._tree_leaves(jax.device_get(jp)),
                       [q.detach().numpy() for q in field.leaves()],
                       W._tree_leaves(jax.device_get(jg))):
        big = np.abs(g) > G_FLOOR * np.abs(g).max()
        np.testing.assert_allclose(b[big], a[big], atol=1e-6)
        assert int((np.abs(b - a) > 1e-6)[~big].sum()) <= MAX_FLIPS


def test_fit_batch_draws():
    """The fit's batch: half uniform in the box, half about the sphere
    shell, direction +z, the analytic field as the target."""
    gen = torch.Generator().manual_seed(1)
    x, d, sig, rgb = distill_table.fit_batch(gen, 1000, 1.0, "sphere",
                                             torch.device("cpu"))
    assert x.shape == (1000, 3) and sig.shape == (1000,)
    assert float(x[:500].abs().max()) <= 1.0
    r = x[500:].norm(dim=1)
    assert abs(float(r.mean()) - 0.5) < 0.02
    assert torch.equal(d, torch.tensor([[0.0, 0.0, 1.0]]).expand(1000, 3))
    s_np, c_np = synthetic.scene_field("sphere", x.numpy())
    np.testing.assert_allclose(sig.numpy(), s_np, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(rgb.numpy(), c_np, atol=1e-6)


def test_distill_table_end_to_end(tmp_path, monkeypatch, capsys):
    """The tool at a toy size (a 4-level hash grid, 3 + 3 steps, 32x32
    frames for the images and the rate, one pose, the teacher's occupancy
    grid left empty: image_agreement's march is held to JAX in
    tests/test_torch_distill.py): the table in the JAX tool's schema, the
    markdown rows, the teacher cached beside the table. A rerun loads the
    cached teacher (it fits none) and gives the same row."""
    make_spec = tnet.make_spec

    def small(**kw):
        spec = make_spec(**kw)
        return (spec._replace(grid=the.make_spec(**GRID_KW))
                if kw.get("backbone") == "hashgrid" else spec)

    monkeypatch.setattr(tnet, "make_spec", small)
    monkeypatch.setattr(distill, "image_agreement", functools.partial(
        distill.image_agreement, n_grid_updates=0))
    monkeypatch.setattr(distill_table, "fused_frame_fps", functools.partial(
        distill_table.fused_frame_fps, H=32, W=32))
    out = str(tmp_path / "t" / "table.json")
    argv = ["--device", "cpu", "--teacher_steps", "3", "--distill_steps",
            "3", "--H", "32", "--n_poses", "1", "--fps_reps", "1",
            "--widths", "64", "--out", out]
    t1 = distill_table.main(argv)
    assert os.path.exists(tmp_path / "t" / "torch_distill_teacher_s3.npz")
    assert "| 64 |" in capsys.readouterr().out
    with open(out) as f:
        table = json.load(f)
    with open(os.path.join(ROOT, "runs/distill_table.json")) as f:
        jax_table = json.load(f)
    assert set(jax_table) <= set(table)
    assert set(jax_table["rows"][0]) == set(table["rows"][0])
    assert set(table["rows"][0]["field"]) == set(
        jax_table["rows"][0]["field"])
    row = table["rows"][0]
    assert np.isfinite(row["image_psnr"]) and row["fps_800"] > 0

    def no_fit(**kw):
        raise AssertionError("the cached teacher was fitted again")

    monkeypatch.setattr(distill_table, "fit_hashgrid_teacher", no_fit)
    t2 = distill_table.main(argv)
    assert "cached" in capsys.readouterr().out
    assert t2["teacher_fit_seconds"] is None
    for key in ("final_loss", "field", "image_psnr", "image_ssim"):
        assert t2["rows"][0][key] == t1["rows"][0][key], key


# ---- quality_run -----------------------------------------------------------

def test_device_quadrature_equals_the_oracle():
    """quality_run's ground truth on a torch device (float64) against the
    numpy oracle at 64x64: the JAX tool's gate is 55 dB (it integrates in
    f32); the same float64 integral reads above 100 dB."""
    assert quality_run.validate_device_gt(torch.device("cpu")) > 100.0
    intr = (0.9 * 32, 0.9 * 32, 16.0, 16.0)
    pose = synthetic.orbit_poses(1, seed=3)[0]
    np.testing.assert_allclose(
        synthetic.render_gt(pose, intr, 32, 32, device=torch.device("cpu")),
        synthetic.render_gt(pose, intr, 32, 32), atol=1e-6)


def test_quality_run_end_to_end_and_resume(tmp_path):
    """The tool at a toy size: curve.json and summary.json in the JAX
    tool's schema, an evaluation every 2 steps, the final PNGs; a second
    run with more steps resumes from the newest checkpoint and extends the
    curve."""
    ws = str(tmp_path / "q")
    argv = ["--device", "cpu", "--workspace", ws, "--H", "16", "--W", "16",
            "--n_train", "3", "--n_test", "1", "--eval_views", "1",
            "--eval_every", "2", "--num_rays", "64", "--train_max_samples",
            "16"]
    s = quality_run.main(argv + ["--iters", "4"])
    with open(os.path.join(ROOT, "runs/quality_mlp_800/summary.json")) as f:
        jax_summary = json.load(f)
    assert set(jax_summary) <= set(s)
    assert set(s["curve"][0]) == set(jax_summary["curve"][0])
    assert [e["step"] for e in s["curve"]] == [2, 4] and s["iters"] == 4
    assert np.isfinite(s["final_psnr"])
    assert len([p for p in os.listdir(os.path.join(ws, "validation"))
                if p.endswith(".png")]) == 2
    assert sorted(p for p in os.listdir(ws) if p.endswith(".npz")) == [
        "dataset_16x16_1v_s99.npz", "dataset_16x16_3v_s0.npz"]
    s2 = quality_run.main(argv + ["--iters", "6"])
    assert [e["step"] for e in s2["curve"]] == [2, 4, 6]
    with open(os.path.join(ws, "summary.json")) as f:
        assert json.load(f)["iters"] == 6


@pytest.mark.parametrize("tool", ["distill_table", "quality_run"])
def test_tools_refuse_a_missing_card(tool):
    """On a machine without CUDA the tools raise unless --device cpu: no
    quiet fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    mod = {"distill_table": distill_table, "quality_run": quality_run}[tool]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main([])
