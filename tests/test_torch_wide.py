"""Port parity for the 128-wide distilled student (CPU): the width-128 pack,
the field kernel's and the tile kernel's plain versions at Wd = 128 against
the Pallas kernels in interpret mode, the wide fused frame against the JAX
package, main_gui adopting a wide checkpoint, and a 64-wide checkpoint
embedded exactly in the wide architecture."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pienerf_tpu.models import network as jnet
from pienerf_tpu.ops import beam_bend as jbb
from pienerf_tpu.ops.pallas import field_kernel as jfk
from pienerf_tpu.ops.pallas import tile_kernel as jtk
from pienerf_tpu.render import interactive as jint
from pienerf_tpu_torch.io.checkpoint import load_native, save_native
from pienerf_tpu_torch.kernels import field as tfk
from pienerf_tpu_torch.kernels import tile as ttk
from pienerf_tpu_torch.models import network as tnet
from pienerf_tpu_torch.ops import beam_bend as tbb
from pienerf_tpu_torch.render import interactive as tint
from pienerf_tpu_torch.weights import field_from_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "runs/quality_mlp_800/checkpoints/ngp_ep0015.npz")
CPU = torch.device("cpu")
WIDE = dict(hidden_dim=128, hidden_dim_color=128, n_freqs=10)
CB = np.asarray([0.0, 0.5, -0.5, 0.5, -0.5, 0.5], np.float32)
COUNTERS = ("n_active", "n_tile_overflow", "dropped_beam", "dropped_window")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread a test: the tensors here are small, and the test
    workers share the machine's cores, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _specs(dtype="float32"):
    return (jnet.make_spec(bound=1.0, backbone="mlp", compute_dtype=dtype,
                           **WIDE),
            tnet.make_spec(bound=1.0, compute_dtype=dtype, **WIDE))


def _wide_params(seed=0):
    """Random 63-128-128-128-16 / 31-128-128-3 weights from numpy
    (Kaiming-uniform bounds)."""
    rng = np.random.RandomState(seed)

    def lay(dims):
        return [rng.uniform(-1, 1, (dims[i], dims[i + 1])).astype(np.float32)
                * np.float32(np.sqrt(3.0 / dims[i]))
                for i in range(len(dims) - 1)]
    return {"sigma_net": lay([63, 128, 128, 128, 16]),
            "color_net": lay([31, 128, 128, 3])}


def embed_wide(params):
    """A 64-wide n_freqs-8 params tree embedded in the 128-wide n_freqs-10
    architecture: the same field, zero weights everywhere else. Per axis the
    encoding rows [x, sin 0..7, cos 0..7] move to [x, sin 0..7, cos 0..7] of
    the 21-row block [x, sin 0..9, cos 0..9]."""
    rows = np.concatenate([21 * a + np.r_[0, 1:9, 11:19] for a in range(3)])
    s, c = params["sigma_net"], params["color_net"]

    def pad(w, shape):
        out = np.zeros(shape, np.float32)
        out[:w.shape[0], :w.shape[1]] = w
        return out

    s0 = np.zeros((63, 128), np.float32)
    s0[rows, :64] = s[0]
    sig = [s0, pad(s[1], (128, 128)), pad(s[2], (128, 128)),
           pad(s[3], (128, 16))]
    col = [pad(c[0], (31, 128)), pad(c[1], (128, 128)), pad(c[2], (128, 3))]
    return {"sigma_net": sig, "color_net": col}


def _points(n, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return x, d


def test_pack_weights_matches_jax_at_128():
    jspec, tspec = _specs()
    params = jax.device_get(jnet.init_params(jax.random.PRNGKey(0), jspec))
    tpw = tfk.pack_weights(field_from_numpy(params, tspec, CPU), tspec, CPU)
    assert tfk.kernel_width(tspec) == jfk.kernel_width(jspec) == 128
    np.testing.assert_array_equal(tpw.numpy(),
                                  np.asarray(jfk.pack_weights(params, jspec)))
    assert tfk.check_kernel_spec(tspec, tpw) == 128
    with pytest.raises(NotImplementedError):   # 128 wide at n_freqs 8
        tfk.check_kernel_spec(tspec._replace(n_freqs=8), tpw)
    # a 64-wide net on a [7, 128, 128] pack: neither its own layout nor the
    # paired one ([4, 128, 128], which the tile kernel alone takes)
    with pytest.raises(NotImplementedError):
        tfk.check_kernel_spec(tnet.make_spec(bound=1.0), tpw,
                              allow_paired=True)
    assert tfk.check_kernel_spec(tnet.make_spec(bound=1.0), tpw[:4],
                                 allow_paired=True) == 64


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_field_eval_plain_matches_pallas_interpret_w128(dtype):
    jspec, tspec = _specs(dtype)
    params = _wide_params(1)
    x, d = _points(2048, seed=1)
    jpw = jfk.pack_weights(params, jspec)
    js, jr = jfk.field_eval(jpw, jspec,
                            tuple(jnp.asarray(x[:, i]) for i in range(3)),
                            tuple(jnp.asarray(d[:, i]) for i in range(3)))
    tpw = tfk.pack_weights(field_from_numpy(params, tspec, CPU), tspec, CPU)
    ts, tr = tfk.field_eval(tpw, tspec, torch.from_numpy(x.T.copy()),
                            torch.from_numpy(d.T.copy()))
    js, jr = np.asarray(js), np.asarray(jr)
    assert js.std() > 0.1 * js.mean()           # a field with some contrast
    if dtype == "float32":
        # f32 reordering scale over 128-term sums
        np.testing.assert_allclose(ts.numpy(), js, rtol=1e-5)
        np.testing.assert_allclose(tr.numpy(), jr, rtol=1e-5, atol=1e-6)
    else:
        # one bf16 ulp (2^-8 relative) can flip with summation order and
        # propagate through the layers
        np.testing.assert_allclose(tr.numpy(), jr, atol=1e-2)
        np.testing.assert_allclose(ts.numpy(), js, rtol=2e-2)


def _cloud():
    """The twisted IP ball of tests/test_torch_cut.py, centred."""
    c = np.arange(-0.3, 0.3 + 1e-6, 0.08, dtype=np.float32)
    xx, yy, zz = np.meshgrid(c, c, c, indexing="ij")
    p = np.stack([xx.ravel(), yy.ravel(), zz.ravel()], 1)
    p = p[np.linalg.norm(p, axis=1) <= 0.34]
    ang = 0.5 * p[:, 1]
    ca, sa = np.cos(ang), np.sin(ang)
    p_def = np.stack([ca * p[:, 0] + sa * p[:, 2], p[:, 1],
                      -sa * p[:, 0] + ca * p[:, 2]], 1)
    n = p.shape[0]
    F = np.zeros((n, 3, 3), np.float32)
    F[:, 0, 0] = ca; F[:, 0, 2] = sa; F[:, 1, 1] = 1.0
    F[:, 2, 0] = -sa; F[:, 2, 2] = ca
    return (p_def.astype(np.float32), p.astype(np.float32), F,
            np.zeros((n, 3, 3, 3), np.float32))


def _settings(tspec, jspec=None, **kw):
    common = dict(tile=16, samples=16, active_frac=1.0, tile_chunk=2,
                  min_near=0.05, bound=1.0, bend_window=16)
    common.update(kw)
    bend = dict(num_seek_ip=3, max_iter_num=1, ip_dx=0.084, ips_per_tile=64)
    tst = tint.InteractiveSettings(spec=tspec,
                                   bend=tbb.BeamBendSettings(**bend), **common)
    jst = None if jspec is None else jint.InteractiveSettings(
        spec=jspec, bend=jbb.BeamBendSettings(**bend), **common)
    return tst, jst


H = W = 32
INTR = (40.0, 40.0, 16.0, 16.0)


def _pose():
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (0.0, 0.0, -2.5)
    return pose


@pytest.mark.parametrize("mode", ["deformed", "static", "cut"])
def test_render_tiles_plain_w128_matches_pallas(mode):
    """The tile kernel's three modes at Wd = 128: the port's plain version
    against the Pallas kernel on the port's prepped inputs."""
    jspec, tspec = _specs()
    params = _wide_params(2)
    tpw = tfk.pack_weights(field_from_numpy(params, tspec, CPU), tspec, CPU)
    tst, _ = _settings(tspec, deformed=mode != "static", cut=mode == "cut")
    ta = tuple(torch.from_numpy(a) for a in _cloud())
    pack = tbb.pack_ip_data_fast(*ta)
    pose = torch.from_numpy(_pose())
    (_, o, bbmin, bbmax, ids, mask, _, _) = tint.active_tiles(
        tst, ta[0], pose, INTR, H, W, tst.tile_chunk)
    args, kw, _ = tint.tile_kernel_inputs(
        tst, pack, ta[0], o, pose, INTR, H, W, ids, mask, bbmin, bbmax,
        deformed=tst.deformed, cut=tst.cut, cut_bounds=torch.from_numpy(CB))
    tout = ttk.render_tiles_plain(tspec, tpw, *args, **kw).numpy()
    jout = np.asarray(jtk.render_tiles(
        jspec, jfk.pack_weights(params, jspec),
        *(jnp.asarray(a.numpy()) for a in args), interpret=True, **kw))
    assert jout[:, 4].max() > 0.1                 # real coverage
    if mode != "static":
        assert jout[:, 5, 0].sum() > 0            # window overflow exercised
    # f32 summation order in the MLP and composite
    np.testing.assert_allclose(tout[:, 0:5], jout[:, 0:5], atol=1e-4)
    np.testing.assert_array_equal(tout[:, 5], jout[:, 5])


def test_wide_fused_frame_matches_jax():
    """A 48x48 deformed fused frame with the wide student, both packages
    (the JAX tile kernel in interpret mode)."""
    jspec, tspec = _specs()
    params = _wide_params(3)
    tst, jst = _settings(tspec, jspec, tighten_sampling=True)
    arrs = _cloud()
    ja = tuple(jnp.asarray(a) for a in arrs)
    ta = tuple(torch.from_numpy(a) for a in arrs)
    intr = (56.0, 56.0, 24.0, 24.0)
    jo = jint.render_frame_fused(
        jst, jfk.pack_weights(params, jspec), jbb.pack_ip_data_fast(*ja),
        ja[0], jnp.asarray(_pose()), intr, 48, 48, jnp.float32(1.0))
    to = tint.render_frame_fused(
        tst, tfk.pack_weights(field_from_numpy(params, tspec, CPU), tspec,
                              CPU), tbb.pack_ip_data_fast(*ta), ta[0],
        torch.from_numpy(_pose()), intr, 48, 48, 1.0)
    assert np.abs(np.asarray(jo["tiles_image"]) - 1.0).max() > 0.1
    for k in ("tiles_image", "tiles_depth", "tiles_ws"):
        # f32 summation order in the MLP and composite
        np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]),
                                   atol=1e-4, err_msg=k)
    for k in COUNTERS:
        assert int(to[k]) == int(jo[k]), k


def test_embedded_checkpoint_frame_matches_64_wide():
    """The committed 64-wide checkpoint embedded in the 128-wide
    architecture renders the 64-wide frame: the zero padding adds exact
    zeros, and CPU BLAS may group the nonzero terms differently at K = 128,
    hence 1e-5 rather than bit equality."""
    tree, _ = load_native(CKPT)
    p64 = tree["ema_params"]
    p128 = embed_wide(p64)
    spec64 = tnet.make_spec(bound=1.0)
    spec128 = tnet.make_spec(bound=1.0, **WIDE)
    pw64 = tfk.pack_weights(field_from_numpy(p64, spec64, CPU), spec64, CPU)
    pw128 = tfk.pack_weights(field_from_numpy(p128, spec128, CPU), spec128,
                             CPU)
    x, d = _points(4096, seed=4)
    f64 = tfk.field_eval_plain(pw64, spec64, torch.from_numpy(x.T.copy()),
                               torch.from_numpy(d.T.copy()))
    f128 = tfk.field_eval_plain(pw128, spec128, torch.from_numpy(x.T.copy()),
                                torch.from_numpy(d.T.copy()))
    for a, b in zip(f128, f64):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)
    ta = tuple(torch.from_numpy(a) for a in _cloud())
    pack = tbb.pack_ip_data_fast(*ta)
    outs = []
    for spec, pw in ((spec64, pw64), (spec128, pw128)):
        tst, _ = _settings(spec, samples=32, tighten_sampling=True)
        outs.append(tint.render_frame_fused(
            tst, pw, pack, ta[0], torch.from_numpy(_pose()),
            (56.0, 56.0, 24.0, 24.0), 48, 48, 1.0))
    assert float(outs[0]["tiles_ws"].max()) > 0.1
    for k in ("tiles_image", "tiles_depth", "tiles_ws"):
        np.testing.assert_allclose(outs[1][k].numpy(), outs[0][k].numpy(),
                                   atol=1e-5, err_msg=k)
    for k in COUNTERS:
        assert int(outs[1][k]) == int(outs[0][k]), k


def test_main_gui_cpu_adopts_wide_checkpoint(tmp_path):
    """main_gui reads the 128-wide student's architecture from the weight
    shapes (hidden 128, n_freqs 10) and renders it."""
    from pienerf_tpu_torch import main_gui
    from pienerf_tpu_torch.config import get_shared_opts
    ck = tmp_path / "ws" / "checkpoints"
    ck.mkdir(parents=True)
    save_native(str(ck / "ngp_ep0001.npz"), {"ema_params": _wide_params(5)},
                extra={"epoch": 1})
    flags = ["--workspace", str(tmp_path / "ws"), "--exp_name", "cube",
             "--backbone", "mlp", "--sim_dx", "0.2", "--bound", "0.5",
             "--radius", "2.5", "--max_iter_num", "1", "--num_seek_IP", "3"]
    cfg = get_shared_opts(None, flags)
    spec, pw = main_gui._load_field(cfg, CPU)
    assert (spec.hidden_dim, spec.hidden_dim_color, spec.n_freqs) == (128,
                                                                      128, 10)
    assert tuple(pw.shape) == (7, 128, 128)
    out = tmp_path / "frames"
    cmd = [sys.executable, "-m", "pienerf_tpu_torch.main_gui", "--device",
           "cpu", "--kres", "4", "--H", "32", "--W", "32", "--render_samples",
           "16", "--frames", "2", "--out_dir", str(out)] + flags
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "[ckpt] loaded" in r.stdout and "wrote 2 frames" in r.stdout
    assert sorted(os.listdir(out)) == ["frame_0000.png", "frame_0001.png"]
