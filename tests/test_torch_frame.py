"""Port parity for the slice as a whole: the coupled interactive frame, the
exact-bending oracle, and the trained-field golden (CPU)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pienerf_tpu.models import network as jnet
from pienerf_tpu.ops import beam_bend as jbb
from pienerf_tpu.ops.pallas import field_kernel as jfk
from pienerf_tpu.render import interactive as jint
from pienerf_tpu.render import pipeline as jpipe
from pienerf_tpu.sim import solver as jsim
from pienerf_tpu_torch.io.checkpoint import load_native
from pienerf_tpu_torch.kernels import field as tfk
from pienerf_tpu_torch.models import network as tnet
from pienerf_tpu_torch.ops import beam_bend as tbb
from pienerf_tpu_torch.render import interactive as tint
from pienerf_tpu_torch.render import pipeline as tpipe
from pienerf_tpu_torch.sim import solver as tsim
from pienerf_tpu_torch.weights import field_from_numpy

CPU = torch.device("cpu")
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "trained_96_v1.npz")
CKPT = os.path.join(os.path.dirname(__file__), "..",
                    "runs/quality_mlp_800/checkpoints/ngp_ep0015.npz")


def _np_params(seed=0):
    """Random mlp-backbone weights from numpy (Kaiming-uniform bounds)."""
    rng = np.random.RandomState(seed)
    sd = [51, 64, 64, 64, 16]
    cd = [31, 64, 64, 3]

    def lay(dims):
        return [rng.uniform(-1, 1, (dims[i], dims[i + 1])).astype(np.float32)
                * np.float32(np.sqrt(3.0 / dims[i]))
                for i in range(len(dims) - 1)]
    return {"sigma_net": lay(sd), "color_net": lay(cd)}


def _both_settings(params, dtype="float32", K=32, P=128, tighten=True,
                   ip_dx=0.105, active_frac=0.5, chunk=4):
    jspec = jnet.make_spec(bound=1.0, backbone="mlp", compute_dtype=dtype)
    tspec = tnet.make_spec(bound=1.0, compute_dtype=dtype)
    kw = dict(tile=16, samples=K, active_frac=active_frac, tile_chunk=chunk,
              min_near=0.05, tighten_sampling=tighten)
    jst = jint.InteractiveSettings(
        spec=jspec, bend=jbb.BeamBendSettings(
            num_seek_ip=3, max_iter_num=1, ip_dx=ip_dx, ips_per_tile=P), **kw)
    tst = tint.InteractiveSettings(
        spec=tspec, bend=tbb.BeamBendSettings(
            num_seek_ip=3, max_iter_num=1, ip_dx=ip_dx, ips_per_tile=P), **kw)
    jpw = jfk.pack_weights(params, jspec)
    tpw = tfk.pack_weights(field_from_numpy(params, tspec, CPU), tspec, CPU)
    return jst, jpw, tst, tpw


def _pose(z=-2.5):
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (0.0, 0.0, z)
    return pose


def _sphere(dx=0.1, r0=0.45):
    c = np.arange(-r0, r0 + 1e-6, dx)
    xx, yy, zz = np.meshgrid(c, c, c, indexing="ij")
    pts = np.stack([xx.ravel(), yy.ravel(), zz.ravel()], 1)
    return pts[np.linalg.norm(pts, axis=1) <= r0]


def test_interactive_frame_step_matches_jax_three_frames():
    pts = _sphere()
    n = pts.shape[0]
    args = (pts, np.full(n, 0.1), np.full(n, 1e5), np.full(n, 1e5),
            pts[:, 2] < -0.3)
    kw = dict(dt=1e-2, iters=10, bbox=np.array([2.0, 2.0, 2.0]), kres=7,
              dx=0.1, gravity=(0.0, 0.0, 0.0), stiff=1e5,
              base=np.array([-1.0, -1.0, -1.0]))
    jc, js, _ = jsim.sim_init(*args, **kw)
    tc, ts, _ = tsim.sim_init(*args, **kw, device=CPU)
    jst, jpw, tst, tpw = _both_settings(_np_params(), ip_dx=0.105)
    H = W = 64
    intr = (1.2 * H, 1.2 * H, W / 2, H / 2)
    vid = int(np.argmax(np.asarray(jc.ip_pos)[:, 2]))
    pose = _pose()
    for fi in range(3):
        f = np.asarray([3e3, -2e3 * fi, 0.0], np.float32)
        js, jo = jpipe.interactive_frame_step(
            jst, jc, js, jpw, jnp.asarray(pose), intr, H, W,
            jnp.float32(1.0), jnp.int32(vid), jnp.asarray(f))
        ts, to = tpipe.interactive_frame_step(
            tst, tc, ts, tpw, torch.from_numpy(pose), intr, H, W, 1.0,
            vid, torch.from_numpy(f))
        img_j = np.asarray(jo["tiles_image"])
        img_t = to["tiles_image"].numpy()
        assert np.isfinite(img_t).all()
        # f32 sim reordering (~1e-5 of the state) plus MLP/composite order
        assert np.abs(img_t - img_j).max() <= 1e-4, (fi, np.abs(
            img_t - img_j).max())
        for k in ("n_active", "n_tile_overflow", "dropped_beam",
                  "dropped_window"):
            assert int(to[k]) == int(jo[k]), (fi, k)
    assert int(to["n_active"]) > 0 and float(js.ddof.std()) > 0


def _twist_state(dx=0.08, r0=0.45, amp=0.6):
    """The deterministic analytic twist of tests/test_trained_golden.py
    (copied, so both goldens keep their meaning)."""
    c = np.arange(-r0, r0 + 1e-6, dx, dtype=np.float32)
    xx, yy, zz = np.meshgrid(c, c, c, indexing="ij")
    p_ori = np.stack([xx.ravel(), yy.ravel(), zz.ravel()], 1)
    p_ori = p_ori[np.linalg.norm(p_ori, axis=1) <= r0]
    ang = amp * p_ori[:, 1]
    ca, sa = np.cos(ang), np.sin(ang)
    p_def = np.stack([ca * p_ori[:, 0] + sa * p_ori[:, 2], p_ori[:, 1],
                      -sa * p_ori[:, 0] + ca * p_ori[:, 2]],
                     1).astype(np.float32)
    n = p_ori.shape[0]
    F = np.zeros((n, 3, 3), np.float32)
    F[:, 0, 0] = ca; F[:, 0, 2] = sa
    F[:, 1, 1] = 1.0
    F[:, 2, 0] = -sa; F[:, 2, 2] = ca
    dF = np.zeros((n, 3, 3, 3), np.float32)
    dF[:, 0, 0, 1] = -amp * sa; dF[:, 0, 2, 1] = amp * ca
    dF[:, 2, 0, 1] = -amp * ca; dF[:, 2, 2, 1] = -amp * sa
    return p_ori, p_def, F, dF, dx


def test_render_frame_exact_matches_jax():
    p_ori, p_def, F, dF, dx = _twist_state(dx=0.1)
    jst, jpw, tst, tpw = _both_settings(_np_params(1), K=16,
                                        tighten=False, ip_dx=1.05 * dx,
                                        active_frac=1.0, chunk=2)
    H = W = 32
    intr = (1.2 * H, 1.2 * H, W / 2, H / 2)
    pose = _pose()
    jo = jint.render_frame_exact(jst, jpw, *(jnp.asarray(a) for a in
                                             (p_def, p_ori, F, dF)),
                                 jnp.asarray(pose), intr, H, W,
                                 jnp.float32(1.0))
    to = tint.render_frame_exact(tst, tpw, *(torch.from_numpy(a) for a in
                                             (p_def, p_ori, F, dF)),
                                 torch.from_numpy(pose), intr, H, W, 1.0)
    img_j = np.asarray(jo["tiles_image"])
    img_t = to["tiles_image"].numpy()
    assert np.abs(img_j - 1.0).max() > 0.1          # the object is there
    # f32 order of the Newton einsums, MLP and composite
    np.testing.assert_allclose(img_t, img_j, atol=1e-4)
    assert int(to["n_active"]) == int(jo["n_active"])
    img = tint.tiles_to_image(to["tiles_image"], H, W)
    assert img.shape == (H, W, 3)


def _psnr(a, b):
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return 10.0 * np.log10(1.0 / max(mse, 1e-12))


def test_trained_96_frame_matches_goldens():
    """The port's fused frame of the trained field under the golden twist
    must clear the floors of tests/test_trained_golden.py (55 dB against
    both the committed fused frame and the exact-bending oracle)."""
    tree, _ = load_native(os.path.abspath(CKPT))
    params = tree["ema_params"]
    nf = (params["sigma_net"][0].shape[0] // 3 - 1) // 2
    spec = tnet.make_spec(bound=1.0, n_freqs=nf,
                          num_layers=len(params["sigma_net"]))
    pw = tfk.pack_weights(field_from_numpy(params, spec, CPU), spec, CPU)
    p_ori, p_def, F, dF, dx = _twist_state()
    st = tint.InteractiveSettings(
        spec=spec, bend=tbb.BeamBendSettings(
            num_seek_ip=3, max_iter_num=1, ip_dx=1.05 * dx,
            ips_per_tile=256),
        tile=16, samples=128, active_frac=1.0, tile_chunk=16, min_near=0.05,
        tighten_sampling=False)
    res = 96
    pack = tbb.pack_ip_data_fast(*(torch.from_numpy(a) for a in
                                   (p_def, p_ori, F, dF)))
    out = tint.render_frame_fused(
        st, pw, pack, torch.from_numpy(p_def), torch.from_numpy(_pose()),
        (1.2 * res, 1.2 * res, res / 2.0, res / 2.0), res, res, 1.0)
    img = tint.tiles_to_image(out["tiles_image"], res, res)
    g = np.load(GOLDEN)
    assert np.isfinite(img).all()
    p_fused = _psnr(img, g["fused"].astype(np.float32))
    p_exact = _psnr(img, g["exact"].astype(np.float32))
    assert p_fused >= 55.0, p_fused
    assert p_exact >= 55.0, p_exact
