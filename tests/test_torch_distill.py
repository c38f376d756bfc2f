"""Port parity of distillation against the JAX package (CPU): one distill
step, the importance resampling given JAX's draws, field_agreement,
image_agreement at 32x32 (the student through the tile kernel's static
mode: the port's plain version, JAX's Pallas kernel in interpret mode),
the student spec; the candidate prep against JAX's contract; and the
entry points end to end: main_train on a written dataset, main_distill on
its workspace, the student served by main_gui's loader and loaded by JAX's
Trainer. Each tolerance is stated where it is checked."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pienerf_tpu.config import PieNeRFConfig as JCfg
from pienerf_tpu.models import hash_encoder as jhe
from pienerf_tpu.models import network as jnet
from pienerf_tpu.ops import beam_bend as jbb
from pienerf_tpu.ops import grid as jgrid
from pienerf_tpu.ops.pallas import tile_kernel as jtk
from pienerf_tpu.train import distill as jdis
from pienerf_tpu.train import trainer as jtr
from pienerf_tpu_torch import weights as W
from pienerf_tpu_torch.kernels import tile as ttk
from pienerf_tpu_torch.models import hash_encoder as the
from pienerf_tpu_torch.models import network as tnet
from pienerf_tpu_torch.ops import beam_bend as tbb
from pienerf_tpu_torch.train import distill as tdis
from pienerf_tpu_torch.train import optim as topt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = torch.as_tensor
GRID_KW = dict(num_levels=4, log2_hashmap_size=12, desired_resolution=64)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread a test: the tensors here are small, and the test
    workers share the machine's cores, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def A(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def teacher():
    """A small hash-grid teacher with structure (JAX and port)."""
    js = jnet.make_spec(bound=1.0, backbone="hashgrid")._replace(
        grid=jhe.make_spec(**GRID_KW))
    ts = tnet.make_spec(bound=1.0, backbone="hashgrid")._replace(
        grid=the.make_spec(**GRID_KW))
    p = jnet.init_params(jax.random.PRNGKey(7), js)
    p["encoder"] = p["encoder"] * 3000.0
    return js, ts, p


def test_student_spec():
    """make_student_spec at both widths: JAX's fields."""
    js, ts, _ = teacher()
    for w in (64, 128):
        a, b = jdis.make_student_spec(js, w), tdis.make_student_spec(ts, w)
        for k in ("backbone", "n_freqs", "num_layers", "hidden_dim",
                  "hidden_dim_color", "num_layers_color", "bound",
                  "compute_dtype", "sh_degree"):
            assert getattr(a, k) == getattr(b, k), k


def test_distill_step_and_agreement_match_jax():
    """One distill step (Adam eps 1e-8 under the decay) from the same
    student on the same batch: loss 1e-6 relative; updated params 1e-6
    where |g| > 1e-6 of the leaf's largest, at most 2 flips a leaf below
    that floor (Adam's first step is +-lr for a gradient of either sign).
    field_agreement with JAX's draws (PRNGKey(1), split, as distill.py
    draws them): every number 1e-5 relative. _importance_positions with
    JAX's draws: 1e-7."""
    js, ts, tp = teacher()
    ss = jdis.make_student_spec(js, 64)
    sp = jnet.init_params(jax.random.PRNGKey(0), ss)
    rs = np.random.RandomState(0)
    x = rs.uniform(-1, 1, (1024, 3)).astype(np.float32)
    d = rs.randn(1024, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    jopt = optax.adam(optax.exponential_decay(5e-3, 100, 0.1), b1=0.9,
                      b2=0.99)
    step = jdis.make_distill_step(js, ss, jopt)
    jsp, _, jloss = step(tp, sp, jopt.init(sp), jnp.asarray(x),
                         jnp.asarray(d))
    tt = W.field_from_numpy(tp, ts, "cpu")
    tsf = W.field_from_numpy(sp, tdis.make_student_spec(ts, 64), "cpu",
                             trainable=True)
    topt_ = topt.Adam(5e-3, 100, 0.1, eps=1e-8, max_consecutive_errors=None)
    tstep = tdis.make_distill_step(ts, tsf.spec, topt_)
    _, tloss = tstep(tt, tsf, topt_.init(tsf.leaves()), T(x), T(d))
    assert abs(float(tloss) / float(jloss) - 1) <= 1e-6

    def jl(p):
        sig_t, rgb_t = jnet.forward(tp, js, jnp.asarray(x), jnp.asarray(d))
        a_t = 1.0 - jnp.exp(-jnp.clip(sig_t, 0.0, 1e4) * 0.01)
        sig_s, rgb_s = jnet.forward(p, ss, jnp.asarray(x), jnp.asarray(d))
        return (jnp.mean((jnp.log1p(sig_s) - jnp.log1p(sig_t)) ** 2)
                + 4.0 * jnp.mean(a_t[:, None] * (rgb_s - rgb_t) ** 2))

    jg = W._tree_leaves(jax.grad(jl)(sp))
    for a, b, g in zip(W._tree_leaves(jax.device_get(jsp)),
                       [A(q) for q in tsf.leaves()], jg):
        g = np.abs(np.asarray(g))
        big = g > 1e-6 * g.max()
        np.testing.assert_allclose(b[big], a[big], atol=1e-6)
        assert int((np.abs(b - a) > 1e-6)[~big].sum()) <= 2

    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    xa = jax.random.uniform(k1, (512, 3), minval=-1.0, maxval=1.0)
    da = jax.random.normal(k2, (512, 3))
    da = da / jnp.linalg.norm(da, axis=1, keepdims=True)
    want = jdis.field_agreement(tp, js, jsp, ss, n=512)
    got = tdis.field_agreement(tt, ts, tsf, tsf.spec, x=T(np.asarray(xa)),
                               d=T(np.asarray(da)))
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-5 * max(abs(want[k]), 1e-6), k

    pool = jnp.asarray(x)
    w = jnp.asarray(rs.rand(1024).astype(np.float32))
    jpos = jdis._importance_positions(jax.random.PRNGKey(3), pool, w, 300,
                                      1.0)
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    ids = jax.random.categorical(k1, jnp.log(w + 1e-8), shape=(300,))
    jit = jax.random.normal(k2, (300, 3))
    tpos = tdis._importance_positions(None, T(x), T(A(w)), 300, 1.0,
                                      ids=T(np.asarray(ids)),
                                      jitter=T(np.asarray(jit)))
    np.testing.assert_allclose(A(tpos), np.asarray(jpos), atol=1e-7)


def test_image_agreement_matches_jax():
    """image_agreement at 32x32 on a shared occupancy grid: the teacher
    through the occupancy renderer, the student through the tile kernel's
    static frame (JAX's Pallas kernel in interpret mode, the port's plain
    version); PSNR within 0.01 dB and SSIM within 1e-4 of JAX's per view.
    Without a grid the port builds one from its own draws and reads
    finite numbers."""
    js, ts, tp = teacher()
    ss = jdis.make_student_spec(js, 64)
    sp = jnet.init_params(jax.random.PRNGKey(0), ss)
    g = jgrid.init(1)
    rs = np.random.RandomState(2)
    dens = jnp.asarray(rs.rand(*g.density.shape).astype(np.float32) * 20)
    g = g._replace(density=dens, bitfield=jgrid.packbits(dens, 10.0))
    poses = []
    for z in (-2.5, -2.2):
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = (0.1, 0.0, z)
        poses.append(pose)
    intr = (30.0, 30.0, 16.0, 16.0)
    want = jdis.image_agreement(tp, js, sp, ss, poses, intr, 32, 32, grid=g,
                                student_samples=32)
    tt = W.field_from_numpy(tp, ts, "cpu")
    tsf = W.field_from_numpy(sp, tdis.make_student_spec(ts, 64), "cpu")
    got = tdis.image_agreement(tt, ts, tsf, tsf.spec, poses, intr, 32, 32,
                               grid=W.grid_from_numpy(jax.device_get(g),
                                                      "cpu"),
                               student_samples=32)
    np.testing.assert_allclose(got["psnr_per_view"], want["psnr_per_view"],
                               atol=0.01)
    np.testing.assert_allclose(got["ssim_per_view"], want["ssim_per_view"],
                               atol=1e-4)
    assert got["images"][0].shape == (32, 32, 3)
    own = tdis.image_agreement(tt, ts, tsf, tsf.spec, poses[:1], intr, 16,
                               16, n_grid_updates=1, student_samples=16)
    assert np.isfinite(own["psnr_mean"]) and np.isfinite(own["ssim_mean"])


@pytest.mark.parametrize("tighten", [0.0, 0.3])
def test_prep_candidates_keeps_the_contract(tighten):
    """The port's candidate prep (always the exact top-k; the settings'
    prep_approx_topk is not read) meets the contract that
    tests/test_tile_kernel.py:72 holds JAX's approx_max_k prep to (valid
    rows depth-sorted first, monotone prefix counts ending at the valid
    count) and equals JAX's exact prep exactly, with the tile range
    tightened to the candidates' span and without."""
    c = np.arange(-0.45, 0.45 + 1e-6, 0.1, dtype=np.float32)
    xx, yy, zz = np.meshgrid(c, c, c, indexing="ij")
    p = np.stack([xx.ravel(), yy.ravel(), zz.ravel()], 1)
    p = p[np.linalg.norm(p, axis=1) <= 0.5]
    n = p.shape[0]
    F = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
    dF = np.zeros((n, 3, 3, 3), np.float32)
    A_, P, nb = 3, 64, 34
    origin = np.tile(np.array([[0.0, 0.0, -2.5]], np.float32), (A_, 1))
    axis = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (A_, 1))
    rest = (np.full(A_, 0.02, np.float32), np.full(A_, 1.5, np.float32),
            np.full(A_, 3.5, np.float32))
    kw = dict(n_cand=P, n_bins=nb, beam_margin=0.08, tighten_margin=tighten)
    jpack = jbb.pack_ip_data_fast(*map(jnp.asarray, (p, p, F, dF)))
    jout = jtk.prep_candidates(
        jpack, jnp.asarray(p), jnp.asarray(origin), jnp.asarray(axis),
        *map(jnp.asarray, rest), **kw)
    tpack = tbb.pack_ip_data_fast(*map(T, (p, p, F, dF)))
    tout = ttk.prep_candidates(tpack, T(p), T(origin), T(axis),
                               *map(T, rest), **kw)
    tc, tb = tout[:2]
    proj = np.einsum("apd,ad->ap", A(tc)[..., :3] - origin[:, None], axis)
    valid = A(tc)[..., 15] > 0
    for a in range(A_):
        assert np.all(np.diff(proj[a][valid[a]]) >= -1e-6)
        assert np.all(np.diff(A(tb)[a]) >= 0)
        assert A(tb)[a][-1] == valid[a].sum() > 0
        assert not valid[a][valid[a].sum():].any()
    for t, j in zip(tout, jout):
        np.testing.assert_array_equal(A(t), np.asarray(j))
    if tighten:
        assert (A(tout[3]) > rest[1]).all() and (A(tout[4]) < rest[2]).all()


def _run(module, *args):
    r = subprocess.run([sys.executable, "-m", module, "--device", "cpu",
                        *args], cwd=ROOT, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return r.stdout


def test_train_distill_serve_end_to_end(tmp_path, monkeypatch, capsys):
    """main_train (hashgrid) on a 48x48 RGBA blender set, then
    python -m main_distill --student_width 128 on its workspace, on the
    CPU: the checkpoints, point cloud, loss trace and validation PNGs
    are written, the student lands after the teacher's checkpoint, main_gui's
    loader serves it at width 128 under --ckpt latest, and JAX's Trainer
    loads the same file with the same EMA weights."""
    from pienerf_tpu_torch import main_train
    from pienerf_tpu_torch.config import get_shared_opts
    from pienerf_tpu_torch.data import synthetic
    from pienerf_tpu_torch.main_gui import _load_field
    from pienerf_tpu_torch.train import trainer as ttr

    hw = 48
    f = 0.9 * hw
    intr = (f, f, hw / 2.0, hw / 2.0)
    poses = synthetic.orbit_poses(5, seed=0)
    imgs = [synthetic.render_gt(p, intr, hw, hw, alpha=True, n_steps=100)
            for p in poses]
    data = str(tmp_path / "data")
    synthetic.write_blender(data, {"train": (poses[:4], imgs[:4]),
                                   "val": (poses[4:], imgs[4:])}, intr, hw,
                            hw)
    ws = str(tmp_path / "ws")
    common = ["--workspace", ws, "--bound", "1.0", "--scale", "1.0",
              "--dt_gamma", "0", "--min_near", "0.05"]
    # main_train in process, its 256^3 point cloud cut to 32^3 (a minute
    # of density queries on the CPU otherwise)
    pc = ttr.Trainer.save_point_cloud
    monkeypatch.setattr(
        ttr.Trainer, "save_point_cloud",
        lambda self, path, resolution=256, threshold=None: pc(
            self, path, 32, threshold))
    main_train.main(["--device", "cpu", "--path", data, "--iters", "16",
                     "--num_rays", "128", "--train_max_samples", "16",
                     *common])
    assert "[final eval] PSNR=" in capsys.readouterr().out
    losses = np.load(os.path.join(ws, "train_losses.npy"))
    assert losses.shape == (16,) and np.isfinite(losses).all()
    assert os.path.getsize(os.path.join(ws, "point_cloud.ply")) > 0
    assert any(n.endswith("_depth.png")
               for n in os.listdir(os.path.join(ws, "validation")))
    ck = os.path.join(ws, "checkpoints")
    assert sorted(os.listdir(ck)) == ["ngp_ep0001.npz",
                                      "ngp_ep0001.npz.json"]
    out = _run("pienerf_tpu_torch.main_distill", "--steps", "12",
               "--batch", "512", "--student_width", "128", *common)
    assert "[distill] agreement:" in out
    assert sorted(os.listdir(ck))[-2:] == ["ngp_ep0002.npz",
                                           "ngp_ep0002.npz.json"]
    cfg = get_shared_opts(args=["--workspace", ws, "--backbone", "mlp",
                                "--bound", "1.0"])
    spec, pw = _load_field(cfg, torch.device("cpu"))
    assert (spec.hidden_dim, spec.n_freqs, tuple(pw.shape)) == (
        128, 10, (7, 128, 128))
    jt = jtr.Trainer("ngp", JCfg(workspace=ws, backbone="mlp",
                                 bound=1.0).finalize(),
                     use_checkpoint="latest")
    assert jt.spec.hidden_dim == 128 and jt.global_step == 16
    from pienerf_tpu_torch.io.checkpoint import load_native
    tree, _ = load_native(os.path.join(ck, "ngp_ep0002.npz"))
    for a, b in zip(W._tree_leaves(jax.device_get(jt.state.ema_params)),
                    W._tree_leaves(tree["ema_params"])):
        np.testing.assert_array_equal(np.asarray(a), b)
