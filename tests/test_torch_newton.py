"""Port parity for the binned Newton frame (CPU): ``beam_bend``'s 48-wide
pack, candidate compaction, depth bins, packed Newton solve and bending,
``interactive.render_frame`` in its three modes, the committed golden frame
and ``main_gui`` at its default ``--max_iter_num``, each held against the
JAX package on the same numpy inputs (its field kernel in interpret
mode)."""

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
from pienerf_tpu.render import interactive as jint
from pienerf_tpu_torch.kernels import field as tfk
from pienerf_tpu_torch.models import network as tnet
from pienerf_tpu_torch.ops import beam_bend as tbb
from pienerf_tpu_torch.render import interactive as tint
from pienerf_tpu_torch.weights import field_from_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
CB = np.asarray([0.0, 0.5, -0.5, 0.5, -0.5, 0.5], np.float32)
COUNTERS = ("n_active", "n_tile_overflow", "dropped_beam", "dropped_window")


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _twisted(dx=0.08, r0=0.4, amp=0.6, seed=0):
    """A twisted IP ball with a random dF and a slightly perturbed F, so
    the Newton solve takes several steps: (p_def, p_ori, F, dF) numpy."""
    rng = np.random.RandomState(seed)
    c = np.arange(-r0, r0 + 1e-6, dx, dtype=np.float32)
    xx, yy, zz = np.meshgrid(c, c, c, indexing="ij")
    p = np.stack([xx.ravel(), yy.ravel(), zz.ravel()], 1)
    p = p[np.linalg.norm(p, axis=1) <= r0 + dx / 2]
    ang = amp * p[:, 1]
    ca, sa = np.cos(ang), np.sin(ang)
    p_def = np.stack([ca * p[:, 0] + sa * p[:, 2], p[:, 1],
                      -sa * p[:, 0] + ca * p[:, 2]], 1)
    n = p.shape[0]
    F = np.zeros((n, 3, 3), np.float32)
    F[:, 0, 0] = ca; F[:, 0, 2] = sa; F[:, 1, 1] = 1.0
    F[:, 2, 0] = -sa; F[:, 2, 2] = ca
    F += 0.05 * rng.randn(n, 3, 3).astype(np.float32)
    dF = (0.3 * rng.randn(n, 3, 3, 3)).astype(np.float32)
    return p_def.astype(np.float32), p.astype(np.float32), F, dF


def _beams(C=3, seed=1):
    """C tile beams from a camera at z = -2.5 toward the ball."""
    rng = np.random.RandomState(seed)
    origin = np.tile(np.asarray([[0.0, 0.0, -2.5]], np.float32), (C, 1))
    axis = np.concatenate([0.08 * rng.randn(C, 2), np.ones((C, 1))], 1)
    axis = (axis / np.linalg.norm(axis, axis=1, keepdims=True))
    return (origin, axis.astype(np.float32),
            np.full((C,), 0.06, np.float32), np.full((C,), 1.9, np.float32),
            np.full((C,), 3.1, np.float32))


def test_pack_ip_data_and_pack_for_match_jax():
    arrs = _twisted()
    ja = tuple(jnp.asarray(a) for a in arrs)
    ta = tuple(_t(a) for a in arrs)
    np.testing.assert_array_equal(_np(tbb.pack_ip_data(*ta)),
                                  np.asarray(jbb.pack_ip_data(*ja)))
    for it in (1, 100):
        jst = jbb.BeamBendSettings(max_iter_num=it)
        tst = tbb.BeamBendSettings(max_iter_num=it)
        tp, jp = tbb.pack_for(tst, *ta), jbb.pack_for(jst, *ja)
        assert tp.shape[1] == (16 if it == 1 else 48)
        # the fast pack's closed-form F^-1 rounds as in the JAX package
        np.testing.assert_allclose(_np(tp), np.asarray(jp), rtol=1e-6,
                                   atol=1e-7)
    for span in (0.2, 1.0, 3.0):
        assert tbb.auto_halo(0.105, span, 32) == jbb.auto_halo(0.105, span,
                                                               32)


@pytest.fixture(scope="module")
def cands():
    """Both packages' candidate compaction on the same beams; the ball is
    doubled so that every projection is tied with another one."""
    p_def, p_ori, F, dF = _twisted()
    p_def, p_ori = np.concatenate([p_def] * 2), np.concatenate([p_ori] * 2)
    F, dF = np.concatenate([F] * 2), np.concatenate([dF] * 2)
    pack = np.asarray(jbb.pack_ip_data(*(jnp.asarray(a)
                                         for a in (p_def, p_ori, F, dF))))
    beams = _beams()
    kw = dict(num_seek_ip=3, max_iter_num=100, ip_dx=0.1, ips_per_tile=96,
              bin_capacity=4)
    jst, tst = jbb.BeamBendSettings(**kw), tbb.BeamBendSettings(**kw)
    jout = jbb.select_tile_candidates(
        jst, jnp.asarray(pack), jnp.asarray(p_def),
        *(jnp.asarray(b) for b in beams), return_dropped=True)
    tout = tbb.select_tile_candidates(tst, _t(pack), _t(p_def),
                                      *(_t(b) for b in beams))
    return dict(jst=jst, tst=tst, jout=jout, tout=tout, beams=beams)


def test_select_tile_candidates_matches_jax(cands):
    (jc, jp, jm, jd), (tc, tp, tm, td) = cands["jout"], cands["tout"]
    # exact: the rank compaction keeps the first P in-beam IPs in IP order
    np.testing.assert_array_equal(_np(tm), np.asarray(jm))
    np.testing.assert_array_equal(_np(td), np.asarray(jd))
    np.testing.assert_array_equal(_np(tc), np.asarray(jc))
    assert int(td.sum()) > 0 and bool(tm.all(1).any())   # capacity hit
    # a 3-term dot product: f32 rounding only
    np.testing.assert_allclose(_np(tp), np.asarray(jp), atol=1e-6)


def test_bin_candidates_matches_jax(cands):
    """Fed the same candidates and projections, the bins and the overflow
    count are exactly equal: tied bins keep candidate order (a stable sort,
    as jnp.argsort)."""
    jc, jp, jm, _ = cands["jout"]
    _, _, _, t0, t1 = cands["beams"]
    K = 16
    for halo in (1, 2):
        jst = cands["jst"]._replace(halo_bins=halo)
        tst = cands["tst"]._replace(halo_bins=halo)
        jb, jdr = jbb.bin_candidates(jst, jc, jp, jm, jnp.asarray(t0),
                                     jnp.asarray((t1 - t0) / K),
                                     K + 2 * halo, return_dropped=True)
        tb, tdr = tbb.bin_candidates(tst, _t(jc), _t(jp), _t(jm), _t(t0),
                                     _t((t1 - t0) / K), K + 2 * halo)
        np.testing.assert_array_equal(_np(tb), np.asarray(jb))
        np.testing.assert_array_equal(_np(tdr), np.asarray(jdr))
        assert int(tdr.sum()) > 0                  # bin overflow exercised


@pytest.mark.parametrize("max_iter", [2, 100])
def test_newton_invert_packed_matches_jax(max_iter):
    rng = np.random.RandomState(3)
    p_def, p_ori, F, dF = _twisted(seed=4)
    pack = np.asarray(jbb.pack_ip_data(*(jnp.asarray(a)
                                         for a in (p_def, p_ori, F, dF))))
    idx = rng.randint(0, pack.shape[0], (5, 40))
    sel = np.moveaxis(pack[idx], -1, 0)                       # [48, 5, 40]
    sel[:, 0, 0] = 0.0                                         # singular J
    x = (sel[0:3] + 0.05 * rng.randn(3, 5, 40)).astype(np.float32)
    jr = jbb.newton_invert_packed(tuple(jnp.asarray(x[i]) for i in range(3)),
                                  jnp.asarray(sel), max_iter)
    tr = tbb.newton_invert_packed(_t(x), _t(sel), max_iter)
    # f32 rounding of the 3x3 algebra, converged: no growth over steps
    np.testing.assert_allclose(_np(tr), np.stack([np.asarray(r) for r in jr]),
                               atol=2e-6)
    q = _np(tr) - sel[3:6]
    assert np.abs(q).max() > 0.01                  # the solve moved things


@pytest.mark.parametrize("width", [48, 16])
def test_bend_tile_samples_matches_jax(cands, width):
    """The same bins and samples through both packages' bending, with the
    48-wide rows (100 Newton steps) and the 16-wide fast rows."""
    p_def, p_ori, F, dF = _twisted()
    ja = tuple(jnp.asarray(a) for a in (p_def, p_ori, F, dF))
    jpack = (jbb.pack_ip_data if width == 48 else jbb.pack_ip_data_fast)(*ja)
    origin, axis, th, t0, t1 = cands["beams"]
    K, T2 = 16, 12
    jst = cands["jst"]._replace(bin_capacity=8, ips_per_tile=128)
    tst = cands["tst"]._replace(bin_capacity=8, ips_per_tile=128)
    jc, jp, jm = jbb.select_tile_candidates(
        jst, jpack, ja[0], *(jnp.asarray(b) for b in cands["beams"]))
    bins = jbb.bin_candidates(jst, jc, jp, jm, jnp.asarray(t0),
                              jnp.asarray((t1 - t0) / K), K + 2)
    rng = np.random.RandomState(5)
    d = axis[:, None, :] + 0.03 * rng.randn(3, T2, 3)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    kk = (np.arange(K, dtype=np.float32) + 0.5) / K
    t = t0[:, None] + (t1 - t0)[:, None] * kk[None]
    xs = [(origin[:, None, None, i] + t[:, None, :] * d[..., i, None])
          .astype(np.float32) for i in range(3)]
    jxm, jf = jbb.bend_tile_samples(jst, bins, tuple(jnp.asarray(a)
                                                     for a in xs))
    txm, tf = tbb.bend_tile_samples(tst, _t(bins), tuple(_t(a) for a in xs))
    np.testing.assert_array_equal(_np(tf), np.asarray(jf))
    assert 0.2 < float(tf.float().mean()) < 1.0
    for i in range(3):
        # f32 order of the Newton algebra and the 1/dist blend
        np.testing.assert_allclose(_np(txm[i]), np.asarray(jxm[i]),
                                   atol=1e-5)


def _np_params(seed=0):
    """Random mlp-backbone weights from numpy (Kaiming-uniform bounds)."""
    rng = np.random.RandomState(seed)
    sd, cd = [51, 64, 64, 64, 16], [31, 64, 64, 3]

    def lay(dims):
        return [rng.uniform(-1, 1, (dims[i], dims[i + 1])).astype(np.float32)
                * np.float32(np.sqrt(3.0 / dims[i]))
                for i in range(len(dims) - 1)]
    return {"sigma_net": lay(sd), "color_net": lay(cd)}


@pytest.mark.parametrize("mode", ["deformed", "static", "cut"])
def test_render_frame_matches_jax(mode):
    """A 32x32 frame (2-tile chunks, K = 16) of the twisted ball at 3
    Newton steps with 2 seeks, the bins small enough to overflow (the JAX
    frame unrolls its Newton loop under jit, so 100 steps are held by
    test_newton_invert_packed_matches_jax and the main_gui test)."""
    params = _np_params(1)
    arrs = _twisted(dx=0.1, r0=0.35)
    bend = dict(num_seek_ip=2, max_iter_num=3, ip_dx=0.1, ips_per_tile=64,
                bin_capacity=3)
    common = dict(tile=16, samples=16, active_frac=1.0, tile_chunk=2,
                  min_near=0.05, deformed=mode != "static", cut=mode == "cut",
                  bound=0.5)
    jspec = jnet.make_spec(bound=1.0, backbone="mlp")
    tspec = tnet.make_spec(bound=1.0)
    jst = jint.InteractiveSettings(spec=jspec,
                                   bend=jbb.BeamBendSettings(**bend), **common)
    tst = tint.InteractiveSettings(spec=tspec,
                                   bend=tbb.BeamBendSettings(**bend), **common)
    ja = tuple(jnp.asarray(a) for a in arrs)
    ta = tuple(_t(a) for a in arrs)
    H = W = 32
    intr = (40.0, 40.0, W / 2, H / 2)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (0.0, 0.0, -2.5)
    cut = mode == "cut"
    jo = jint.render_frame(jst, jfk.pack_weights(params, jspec),
                           jbb.pack_for(jst.bend, *ja), ja[0],
                           jnp.asarray(pose), intr, H, W, jnp.float32(1.0),
                           jnp.asarray(CB) if cut else None)
    to = tint.render_frame(tst, tfk.pack_weights(
        field_from_numpy(params, tspec, CPU), tspec, CPU),
        tbb.pack_for(tst.bend, *ta), ta[0], _t(pose), intr, H, W, 1.0,
        _t(CB) if cut else None)
    assert np.abs(np.asarray(jo["tiles_image"]) - 1.0).max() > 0.1
    for k in ("tiles_image", "tiles_depth", "tiles_ws"):
        # f32 order of the Newton algebra, the MLP and the composite
        np.testing.assert_allclose(_np(to[k]), np.asarray(jo[k]), atol=1e-4,
                                   err_msg=k)
    for k in COUNTERS:
        assert int(to[k]) == int(jo[k]), k
    if mode != "static":
        assert int(to["dropped_window"]) > 0


def test_render_frame_matches_committed_golden():
    """The port's render_frame on the scene of tests/test_goldens.py
    (weights from the JAX package's seed-42 init, the twist, the 48x48
    view) against the committed deformed golden, at its 2e-3."""
    spec = jnet.make_spec(bound=1.0, backbone="mlp")
    params = jax.device_get(jnet.init_params(jax.random.PRNGKey(42), spec))
    tspec = tnet.make_spec(bound=1.0)
    pw = tfk.pack_weights(field_from_numpy(params, tspec, CPU), tspec, CPU)
    g = np.arange(-0.4, 0.41, 0.08, dtype=np.float32)
    xx, yy, zz = np.meshgrid(g, g, g, indexing="ij")
    p_ori = np.stack([xx.ravel(), yy.ravel(), zz.ravel()], 1)
    p_ori = p_ori[np.linalg.norm(p_ori, axis=1) <= 0.42]
    ang = 0.6 * p_ori[:, 1]
    ca, sa = np.cos(ang), np.sin(ang)
    p_def = np.stack([ca * p_ori[:, 0] + sa * p_ori[:, 2], p_ori[:, 1],
                      -sa * p_ori[:, 0] + ca * p_ori[:, 2]],
                     1).astype(np.float32)
    n = p_ori.shape[0]
    F = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
    F[:, 0, 0] = ca; F[:, 0, 2] = sa
    F[:, 2, 0] = -sa; F[:, 2, 2] = ca
    dF = np.zeros((n, 3, 3, 3), np.float32)
    bst = tbb.BeamBendSettings(num_seek_ip=3, max_iter_num=1, ip_dx=0.085,
                               bin_capacity=12)
    pack = tbb.pack_for(bst, *(_t(a) for a in (p_def, p_ori, F, dF)))
    ist = tint.InteractiveSettings(spec=tspec, bend=bst, tile=16,
                                   samples=32, active_frac=1.0, tile_chunk=3,
                                   min_near=0.05)
    H = W = 48
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (0, 0, -2.5)
    out = tint.render_frame(ist, pw, pack, _t(p_def), _t(pose),
                            (56.0, 56.0, 24.0, 24.0), H, W, 1.0)
    img = tint.tiles_to_image(out["tiles_image"], H, W, 16)
    golden = np.load(os.path.join(ROOT, "tests", "goldens",
                                  "frames_v1.npz"))["deformed"]
    np.testing.assert_allclose(img, golden, atol=2e-3)
    assert np.abs(golden - 1.0).max() > 0.1


def test_main_gui_cpu_default_newton_writes_frames(tmp_path):
    """main_gui without --max_iter_num runs the Newton frame (100 steps,
    one seek); a small frame and K keep it quick on the CPU."""
    out = tmp_path / "frames"
    cmd = [sys.executable, "-m", "pienerf_tpu_torch.main_gui", "--device",
           "cpu", "--workspace", str(tmp_path / "ws"), "--exp_name", "cube",
           "--backbone", "mlp", "--sim_dx", "0.2", "--bound", "0.5",
           "--radius", "2.5", "--kres", "4", "--H", "32", "--W", "32",
           "--render_samples", "16", "--frames", "2", "--out_dir", str(out)]
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "wrote 2 frames" in r.stdout
    assert sorted(os.listdir(out)) == ["frame_0000.png", "frame_0001.png"]


def test_render_frame_uncapped_matches_exact_oracle():
    """With every IP a candidate and the window widened to the bend reach
    (auto_halo, no bin overflow), the binned Newton frame at 100 steps
    finds the oracle's nearest IPs and renders the oracle's frame; at the
    default capacities both kinds of drop are counted."""
    spec = tnet.make_spec(bound=1.0)
    pw = tfk.pack_weights(field_from_numpy(_np_params(1), spec, CPU), spec,
                          CPU)
    ta = tuple(_t(a) for a in _twisted(dx=0.1, r0=0.35))
    pose = _t(np.eye(4, dtype=np.float32))
    pose[2, 3] = -2.5
    intr = (40.0, 40.0, 16.0, 16.0)
    K = 32
    imgs = {}
    for name, kw in (("default", {}),
                     ("uncapped", dict(ips_per_tile=4096, bin_capacity=32,
                                       halo_bins=tbb.auto_halo(0.2, 0.7, K)))):
        bend = tbb.BeamBendSettings(num_seek_ip=3, max_iter_num=100,
                                    ip_dx=0.1, **kw)
        st = tint.InteractiveSettings(spec=spec, bend=bend, samples=K,
                                      active_frac=1.0, tile_chunk=2,
                                      min_near=0.05)
        out = tint.render_frame(st, pw, tbb.pack_for(bend, *ta), ta[0], pose,
                                intr, 32, 32, 1.0)
        drops = int(out["dropped_beam"]) + int(out["dropped_window"])
        assert (drops > 0) == (name == "default"), (name, drops)
        imgs[name] = tint.tiles_to_image(out["tiles_image"], 32, 32)
    exact = tint.render_frame_exact(st, pw, *ta, pose, intr, 32, 32, 1.0)
    img_x = tint.tiles_to_image(exact["tiles_image"], 32, 32)
    # the oracle's Newton stops at convergence, the frame's runs all 100
    # steps: f32 rounding of the converged solve and the composite
    np.testing.assert_allclose(imgs["uncapped"], img_x, atol=1e-5)
    assert np.abs(imgs["default"] - img_x).max() > 0.05
