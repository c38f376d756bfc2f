"""Port parity for the cut-mode and static interactive paths (CPU): the tile
kernel's static and cut modes, static frames, the cut-split frame, the
static cache, the cut-mode exact oracle and coupled cut frames, each held
against the JAX package on the same numpy inputs (its Pallas kernels in
interpret mode)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pienerf_tpu.models import network as jnet
from pienerf_tpu.ops import beam_bend as jbb
from pienerf_tpu.ops.pallas import field_kernel as jfk
from pienerf_tpu.ops.pallas import tile_kernel as jtk
from pienerf_tpu.render import interactive as jint
from pienerf_tpu.render import pipeline as jpipe
from pienerf_tpu.sim import solver as jsim
from pienerf_tpu_torch.kernels import field as tfk
from pienerf_tpu_torch.kernels import tile as ttk
from pienerf_tpu_torch.models import network as tnet
from pienerf_tpu_torch.ops import beam_bend as tbb
from pienerf_tpu_torch.render import interactive as tint
from pienerf_tpu_torch.render import pipeline as tpipe
from pienerf_tpu_torch.sim import solver as tsim
from pienerf_tpu_torch.weights import field_from_numpy

CPU = torch.device("cpu")
# the off-centre cloud and cut box of tests/test_tile_kernel.py:287-293
CENTER = np.asarray([0.45, 0.0, 0.0], np.float32)
CB = np.asarray([0.05, 0.85, -0.4, 0.4, -0.4, 0.4], np.float32)
H = W = 64
INTR = (64.0, 64.0, W / 2, H / 2)
COUNTERS = ("n_active", "n_tile_overflow", "dropped_beam", "dropped_window")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread a test: the tensors here are small, and the test
    workers share the machine's cores, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _cloud(dx=0.08, r0=0.3, amp=0.5):
    """The off-centre IP cloud, twisted about its centre's y axis so that
    bending moves samples: (p_def, p_ori, F, dF) as numpy."""
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
    F[:, 0, 0] = ca; F[:, 0, 2] = sa
    F[:, 1, 1] = 1.0
    F[:, 2, 0] = -sa; F[:, 2, 2] = ca
    dF = np.zeros((n, 3, 3, 3), np.float32)
    dF[:, 0, 0, 1] = -amp * sa; dF[:, 0, 2, 1] = amp * ca
    dF[:, 2, 0, 1] = -amp * ca; dF[:, 2, 2, 1] = -amp * sa
    return ((p_def + CENTER).astype(np.float32),
            (p + CENTER).astype(np.float32), F, dF)


def _pose():
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (0.0, 0.0, -2.5)
    return pose


def _both(params, K=16, P=64, Wn=16, seek=1, **kw):
    """(JAX settings, JAX pack, port settings, port pack) for one
    configuration: cut mode, every tile a slot (active_frac 1.0), and
    tightening asked for, as main_gui asks for it (cut mode turns it off)."""
    common = dict(tile=16, samples=K, active_frac=1.0, tile_chunk=2,
                  min_near=0.05, cut=True, bound=1.0, bend_window=Wn,
                  tighten_sampling=True)
    common.update(kw)
    bend = dict(num_seek_ip=seek, max_iter_num=1, ip_dx=0.084,
                ips_per_tile=P)
    jspec = jnet.make_spec(bound=1.0, backbone="mlp")
    tspec = tnet.make_spec(bound=1.0)
    jst = jint.InteractiveSettings(spec=jspec,
                                   bend=jbb.BeamBendSettings(**bend), **common)
    tst = tint.InteractiveSettings(spec=tspec,
                                   bend=tbb.BeamBendSettings(**bend), **common)
    return (jst, jfk.pack_weights(params, jspec), tst,
            tfk.pack_weights(field_from_numpy(params, tspec, CPU), tspec, CPU))


@pytest.fixture(scope="module")
def scene():
    """Both packages' settings, weights and IP packs for the cut scene."""
    jst, jpw, tst, tpw = _both(_np_params())
    arrs = _cloud()
    ja = tuple(jnp.asarray(a) for a in arrs)
    ta = tuple(torch.from_numpy(a) for a in arrs)
    return dict(jst=jst, jpw=jpw, tst=tst, tpw=tpw, ja=ja, ta=ta,
                jpack=jbb.pack_ip_data_fast(*ja),
                tpack=tbb.pack_ip_data_fast(*ta),
                jpose=jnp.asarray(_pose()), tpose=torch.from_numpy(_pose()),
                jcb=jnp.asarray(CB), tcb=torch.from_numpy(CB))


def _fused(sc, jst=None, tst=None, **kw):
    """The same fused frame from both packages."""
    jst = jst or sc["jst"]
    tst = tst or sc["tst"]
    jcb = sc["jcb"] if jst.cut else None
    tcb = sc["tcb"] if tst.cut else None
    jo = jint.render_frame_fused(jst, sc["jpw"], sc["jpack"], sc["ja"][0],
                                 sc["jpose"], INTR, H, W, jnp.float32(1.0),
                                 jcb, **kw)
    to = tint.render_frame_fused(tst, sc["tpw"], sc["tpack"], sc["ta"][0],
                                 sc["tpose"], INTR, H, W, 1.0, tcb, **kw)
    return jo, to


def _assert_frames_close(jo, to, atol=1e-4):
    """Image, depth and ws within atol (f32 summation order in the MLP and
    composite) and every counter equal."""
    for k in ("tiles_image", "tiles_depth", "tiles_ws"):
        np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]),
                                   atol=atol, err_msg=k)
    for k in COUNTERS:
        assert int(to[k]) == int(jo[k]), k


@pytest.mark.parametrize("mode", ["static", "cut"])
def test_render_tiles_plain_matches_pallas_modes(scene, mode):
    """The tile kernel's static and cut modes on one class of the cut
    split each: the port's plain version against the Pallas kernel."""
    sc = scene
    tst = sc["tst"]
    o, bbmin, bbmax, bend, static = tint.cut_classes(
        tst, sc["tpose"], INTR, H, W, sc["tcb"])
    ids, mask = (bend if mode == "cut" else static)[:2]
    assert int(mask.sum()) > 0
    cut = mode == "cut"
    args, kw, _ = tint.tile_kernel_inputs(
        tst, sc["tpack"], sc["ta"][0], o, sc["tpose"], INTR, H, W, ids, mask,
        bbmin, bbmax, deformed=cut, cut=cut, cut_bounds=sc["tcb"])
    tout = ttk.render_tiles_plain(tst.spec, sc["tpw"], *args, **kw).numpy()
    jout = np.asarray(jtk.render_tiles(
        sc["jst"].spec, sc["jpw"], *(jnp.asarray(a.numpy()) for a in args),
        interpret=True, **kw))
    assert jout[:, 4].max() > 0.1                 # real coverage
    if cut:
        assert jout[:, 5, 0].sum() > 0            # window overflow exercised
    else:
        assert not tout[:, 5].any()
    # f32 summation order in the MLP and composite
    np.testing.assert_allclose(tout[:, 0:5], jout[:, 0:5], atol=1e-4)
    np.testing.assert_array_equal(tout[:, 5], jout[:, 5])


def test_static_frame_matches_jax(scene):
    """A static frame (deformed=False) marches the scene box without
    bending; t_jitter=0.25 moves every sample off the bin centres."""
    sc = scene
    jst = sc["jst"]._replace(deformed=False, cut=False)
    tst = sc["tst"]._replace(deformed=False, cut=False)
    jo, to = _fused(sc, jst, tst, t_jitter=0.25)
    _assert_frames_close(jo, to)
    assert int(to["n_active"]) > 0
    _, to_c = _fused(sc, jst, tst)                # bin centres
    assert not torch.equal(to["tiles_image"], to_c["tiles_image"])


def test_cut_split_frame_matches_jax(scene):
    jo, to = _fused(scene)
    _assert_frames_close(jo, to)
    assert int(to["dropped_window"]) > 0


def test_cut_split_matches_single_pass(scene):
    """The split into bend and static classes is exact: the port's split
    frame equals its single-pass cut frame bit for bit."""
    sc = scene
    tst = sc["tst"]
    args = (sc["tpw"], sc["tpack"], sc["ta"][0], sc["tpose"], INTR, H, W,
            1.0, sc["tcb"])
    out_s = tint.render_frame_fused(tst._replace(cut_split=True), *args)
    out_1 = tint.render_frame_fused(tst._replace(cut_split=False), *args)
    assert int(out_s["n_active"]) == int(out_1["n_active"]) > 0
    _, _, _, bend, _ = tint.cut_classes(tst, sc["tpose"], INTR, H, W,
                                        sc["tcb"])
    assert 0 < int(bend[2]) < int(out_1["n_active"])   # both classes used
    for k in ("tiles_image", "tiles_depth", "tiles_ws"):
        assert torch.equal(out_s[k], out_1[k]), k
    assert int(out_s["n_tile_overflow"]) == 0


def test_cut_static_cache_bit_exact(scene):
    sc = scene
    tst = sc["tst"]
    cache = tint.render_static_cache(tst, sc["tpw"], sc["tpose"], INTR, H, W,
                                     sc["tcb"])
    assert int(cache["n"]) > 0
    args = (tst, sc["tpw"], sc["tpack"], sc["ta"][0], sc["tpose"], INTR, H,
            W, 1.0, sc["tcb"])
    out_c = tint.render_frame_fused(*args, static_cache=cache)
    out_u = tint.render_frame_fused(*args)
    for k in ("tiles_image", "tiles_depth", "tiles_ws"):
        assert torch.equal(out_c[k], out_u[k]), k
    for k in COUNTERS:
        assert int(out_c[k]) == int(out_u[k]), k


def test_render_static_cache_matches_jax(scene):
    sc = scene
    jc = jint.render_static_cache(sc["jst"], sc["jpw"], sc["jpose"], INTR, H,
                                  W, sc["jcb"], 0.25)
    tc = tint.render_static_cache(sc["tst"], sc["tpw"], sc["tpose"], INTR, H,
                                  W, sc["tcb"], t_jitter=0.25)
    assert sorted(tc) == sorted(jc)
    for k in ("ids", "mask", "n", "overflow"):
        np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]), k)
    for k in ("imgs", "depths", "ws"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   atol=1e-4, err_msg=k)
    assert int(tc["n"]) > 0 and float(tc["ws"].max()) > 0.1


def test_render_frame_exact_cut_matches_jax(scene):
    sc = scene
    h = w = 32
    intr = (32.0, 32.0, w / 2, h / 2)
    jo = jint.render_frame_exact(sc["jst"], sc["jpw"], *sc["ja"],
                                 sc["jpose"], intr, h, w, jnp.float32(1.0),
                                 cut_bounds=sc["jcb"])
    to = tint.render_frame_exact(sc["tst"], sc["tpw"], *sc["ta"],
                                 sc["tpose"], intr, h, w, 1.0,
                                 cut_bounds=sc["tcb"])
    assert np.abs(np.asarray(jo["tiles_image"]) - 1.0).max() > 0.1
    # f32 order of the Newton einsums, MLP and composite
    _assert_frames_close(jo, to)
    with pytest.raises(ValueError):
        tint.render_frame_exact(sc["tst"]._replace(deformed=False),
                                sc["tpw"], *sc["ta"], sc["tpose"], intr, h,
                                w, 1.0, cut_bounds=sc["tcb"])


def test_interactive_frame_step_cut_matches_jax_three_frames():
    """Three coupled frames (force, sim step, pack, cut-split render) of a
    pinned off-centre sphere with the cut box around it."""
    c = np.arange(-0.3, 0.3 + 1e-6, 0.1)
    xx, yy, zz = np.meshgrid(c, c, c, indexing="ij")
    pts = np.stack([xx.ravel(), yy.ravel(), zz.ravel()], 1)
    pts = pts[np.linalg.norm(pts, axis=1) <= 0.3] + CENTER
    n = pts.shape[0]
    args = (pts, np.full(n, 0.1), np.full(n, 1e5), np.full(n, 1e5),
            pts[:, 2] < -0.2)
    kw = dict(dt=1e-2, iters=10, bbox=np.array([2.0, 2.0, 2.0]), kres=7,
              dx=0.1, gravity=(0.0, 0.0, 0.0), stiff=1e5,
              base=np.array([-1.0, -1.0, -1.0]))
    jc, js, _ = jsim.sim_init(*args, **kw)
    tc, ts, _ = tsim.sim_init(*args, **kw, device=CPU)
    jst, jpw, tst, tpw = _both(_np_params(2))
    vid = int(np.argmax(np.asarray(jc.ip_pos)[:, 2]))
    pose = _pose()
    for fi in range(3):
        f = np.asarray([3e3, -2e3 * fi, 0.0], np.float32)
        js, jo = jpipe.interactive_frame_step(
            jst, jc, js, jpw, jnp.asarray(pose), INTR, H, W,
            jnp.float32(1.0), jnp.int32(vid), jnp.asarray(f),
            jnp.asarray(CB))
        ts, to = tpipe.interactive_frame_step(
            tst, tc, ts, tpw, torch.from_numpy(pose), INTR, H, W, 1.0, vid,
            torch.from_numpy(f), torch.from_numpy(CB))
        assert np.isfinite(to["tiles_image"].numpy()).all()
        # f32 sim reordering (~1e-5 of the state) plus MLP/composite order
        _assert_frames_close(jo, to)
    assert int(to["n_active"]) > 0 and float(js.ddof.std()) > 0
