"""Port parity of the deformed render paths against the JAX package (CPU):
the spatial hash, the IP search and bending, the deformed renderer, the
coupled frame ``pipeline.frame_step``, the ``Simulator`` facade and
``main_render``. Seeded numpy inputs go through both; each tolerance is
stated where it is checked."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pienerf_tpu.config import PieNeRFConfig as JConfig
from pienerf_tpu.data import rays as jrays
from pienerf_tpu.models import hash_encoder as jhe
from pienerf_tpu.models import network as jnet
from pienerf_tpu.ops import bending as jbend
from pienerf_tpu.ops import grid as jgrid
from pienerf_tpu.ops import spatial_hash as jsh
from pienerf_tpu.render import deformed as jdef
from pienerf_tpu.render import pipeline as jpipe
from pienerf_tpu.render import renderer as jren
from pienerf_tpu.sim import solver as jsim
from pienerf_tpu_torch.config import PieNeRFConfig as TConfig
from pienerf_tpu_torch.data import rays as trays
from pienerf_tpu_torch.models import hash_encoder as the
from pienerf_tpu_torch.models import network as tnet
from pienerf_tpu_torch.ops import bending as tbend
from pienerf_tpu_torch.ops import grid as tgrid
from pienerf_tpu_torch.ops import spatial_hash as tsh
from pienerf_tpu_torch.render import deformed as tdef
from pienerf_tpu_torch.render import pipeline as tpipe
from pienerf_tpu_torch.render import renderer as tren
from pienerf_tpu_torch.sim import solver as tsim
from pienerf_tpu_torch.weights import field_from_numpy

T = torch.as_tensor
CPU = torch.device("cpu")
ROOT = os.path.join(os.path.dirname(__file__), "..")


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


def psnr(a, b):
    return float(-10.0 * np.log10(np.mean((np.asarray(a, np.float64)
                                           - np.asarray(b)) ** 2)))


# ---- the spatial hash: exact -----------------------------------------------

@pytest.mark.parametrize("mpc", [3, 64])
def test_spatial_hash_equals_jax(mpc):
    """build_table (its order and, at max_per_cell 3, its drops), counts,
    the dilated occupancy and the 27-cell gather, all exact."""
    rng = np.random.RandomState(0)
    pts = np.concatenate([rng.uniform(-0.9, 0.9, (400, 3)),
                          rng.uniform(0.1, 0.3, (60, 3))]).astype(np.float32)
    lay_j = jsh.make_layout(bound=1.0, hgs=0.2, max_per_cell=mpc)
    lay_t = tsh.make_layout(bound=1.0, hgs=0.2, max_per_cell=mpc)
    assert tuple(lay_t) == tuple(lay_j)
    jt, jc = jsh.build_table(lay_j, jnp.asarray(pts))
    tt, tc = tsh.build_table(lay_t, T(pts))
    np.testing.assert_array_equal(A(tt), A(jt))
    np.testing.assert_array_equal(A(tc), A(jc))
    assert (A(jc) > mpc).any() == (mpc == 3)
    np.testing.assert_array_equal(A(tsh.dilated_occupancy(lay_t, tc)),
                                  A(jsh.dilated_occupancy(lay_j, jc)))
    q = rng.uniform(-1.2, 1.2, (300, 3)).astype(np.float32)
    jg = jsh.cell_of(lay_j, jnp.asarray(q))
    tg = tsh.cell_of(lay_t, T(q))
    np.testing.assert_array_equal(A(tg), A(jg))
    np.testing.assert_array_equal(A(tsh.cell_index(lay_t, tg)),
                                  A(jsh.cell_index(lay_j, jg)))
    np.testing.assert_array_equal(A(tsh.gather_neighborhood(lay_t, tt, tg)),
                                  A(jsh.gather_neighborhood(lay_j, jt, jg)))


# ---- the IP search and bending ----------------------------------------------

def test_topk_smallest_ids_equal_jax_with_ties():
    """Exact ids, ties included (the first minimum wins), and -1 where a
    row runs out of finite candidates."""
    rng = np.random.RandomState(1)
    cand = rng.randint(0, 500, (200, 24)).astype(np.int32)
    d2 = rng.randint(0, 6, (200, 24)).astype(np.float32)     # many ties
    d2[rng.rand(200, 24) < 0.3] = np.inf
    d2[:5] = np.inf
    jids, jd = jax.jit(jbend._topk_smallest, static_argnums=2)(
        jnp.asarray(cand), jnp.asarray(d2), 3)
    tids, td = tbend._topk_smallest(T(cand), T(d2), 3)
    np.testing.assert_array_equal(A(tids), A(jids))
    np.testing.assert_array_equal(A(td), A(jd))
    assert (A(jids)[:5] == -1).all()


def _deformed_ips(dx=0.1, r0=0.45, seed=2):
    """IPs on a lattice in a sphere, moved by a smooth twist with a small
    random F and dF (symmetric in its derivative indices)."""
    rng = np.random.RandomState(seed)
    c = np.arange(-r0, r0 + 1e-6, dx)
    xx, yy, zz = np.meshgrid(c, c, c, indexing="ij")
    p_ori = np.stack([xx.ravel(), yy.ravel(), zz.ravel()], 1)
    p_ori = p_ori[np.linalg.norm(p_ori, axis=1) <= r0].astype(np.float32)
    n = p_ori.shape[0]
    p_def = (p_ori + 0.03 * np.sin(3 * p_ori[:, [1, 2, 0]])
             + np.asarray([0.05, 0.0, 0.0])).astype(np.float32)
    F = (np.eye(3) + 0.05 * rng.randn(n, 3, 3)).astype(np.float32)
    raw = 0.2 * rng.randn(n, 3, 3, 3)
    dF = (0.5 * (raw + raw.transpose(0, 3, 2, 1))).astype(np.float32)
    return p_ori, p_def, F, dF, dx


def test_ip_search_and_bend_points_match_jax():
    """find_closest_ips, build_cell_candidates, the cached search: ids
    exact, distances within 1e-6; bend_points (both search paths, 2 and 1
    Newton steps) within 1e-5 absolute and found exact."""
    p_ori, p_def, F, dF, dx = _deformed_ips()
    lay_j = jsh.make_layout(bound=1.0, hgs=1.2 * dx, max_per_cell=16)
    lay_t = tsh.make_layout(bound=1.0, hgs=1.2 * dx, max_per_cell=16)
    jt, _ = jsh.build_table(lay_j, jnp.asarray(p_def))
    tt, _ = tsh.build_table(lay_t, T(p_def))
    rng = np.random.RandomState(3)
    x = rng.uniform(-0.5, 0.6, (3000, 3)).astype(np.float32)
    ji, jd = jax.jit(jbend.find_closest_ips, static_argnums=(0, 4))(
        lay_j, jt, jnp.asarray(p_def), jnp.asarray(x), 3)
    ti, td = tbend.find_closest_ips(lay_t, tt, T(p_def), T(x), 3)
    np.testing.assert_array_equal(A(ti), A(ji))
    np.testing.assert_allclose(A(td), A(jd), atol=1e-6)
    jcc = jax.jit(jbend.build_cell_candidates, static_argnums=(0, 3))(
        lay_j, jt, jnp.asarray(p_def), 8)
    tcc = tbend.build_cell_candidates(lay_t, tt, T(p_def), 8)
    np.testing.assert_array_equal(A(tcc), A(jcc))
    ji, jd = jax.jit(jbend.find_closest_ips_cached, static_argnums=(0, 4))(
        lay_j, jcc, jnp.asarray(p_def), jnp.asarray(x), 3)
    ti, td = tbend.find_closest_ips_cached(lay_t, tcc, T(p_def), T(x), 3)
    np.testing.assert_array_equal(A(ti), A(ji))
    np.testing.assert_allclose(A(td), A(jd), atol=1e-6)

    bbmin, bbmax = p_def.min(0) - 1e-3, p_def.max(0) + 1e-3
    for iters, cached in ((2, True), (1, False)):
        jst = jbend.BendSettings(num_seek_ip=3, max_iter_num=iters,
                                 ip_dx=1.05 * dx)
        tst = tbend.BendSettings(**jst._asdict())
        jx, jf = jax.jit(jbend.bend_points, static_argnums=(0, 1))(
            lay_j, jst, jt, *(jnp.asarray(a) for a in (p_def, p_ori, F, dF,
                                                        x, bbmin, bbmax)),
            jcc if cached else None)
        tx, tf = tbend.bend_points(
            lay_t, tst, tt, *(T(a) for a in (p_def, p_ori, F, dF, x, bbmin,
                                             bbmax)),
            cell_cand=tcc if cached else None)
        np.testing.assert_array_equal(A(tf), A(jf))
        assert 0 < A(jf).sum() < len(x)
        np.testing.assert_allclose(A(tx), A(jx), atol=1e-5)


# ---- the deformed renderer ---------------------------------------------------

def _small_specs():
    kw = dict(num_levels=4, log2_hashmap_size=12, desired_resolution=256)
    return (jnet.NetworkSpec(grid=jhe.make_spec(**kw), backbone="hashgrid",
                             num_layers=2),
            tnet.NetworkSpec(grid=the.make_spec(**kw), backbone="hashgrid",
                             num_layers=2))


def _np_tree(tspec, seed):
    rng = np.random.RandomState(seed)
    sd, cd = tnet.layer_dims(tspec)

    def lay(dims):
        return [(rng.uniform(-1, 1, (a, b)) * np.sqrt(3.0 / a)).astype(
            np.float32) for a, b in zip(dims, dims[1:])]
    p = {"sigma_net": lay(sd), "color_net": lay(cd)}
    if tspec.backbone == "hashgrid":
        p["encoder"] = rng.uniform(-1, 1, (tspec.grid.total_params, 2)
                                   ).astype(np.float32)
    return p


def _jp(p):
    return jax.tree_util.tree_map(jnp.asarray, p)


@pytest.fixture(scope="module")
def sphere_bits():
    """The JAX tests' sphere occupancy (cascade 1, r0 0.45), as JAX's
    grid.update gives it; the port's update from the same draws equals it
    bit for bit (tests/test_torch_render.py)."""
    g = jgrid.update(jgrid.init(1), lambda x: jnp.where(
        jnp.linalg.norm(x, axis=-1) <= 0.45, 50.0, 0.0), 1.0,
        density_thresh=10.0, rng=jax.random.PRNGKey(1))
    return g.bitfield, T(np.asarray(g.bitfield).view(np.int32))


def _rays(H=40, W=40, f=60.0):
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (0.0, 0.0, -2.5)
    jo, jd = jrays.get_rays_full(jnp.asarray(pose), (f, f, W / 2, H / 2), H,
                                 W)
    return jo, jd, T(A(jo)), T(A(jd))


@pytest.mark.parametrize("cut", [False, True])
def test_render_rays_deformed_matches_jax(sphere_bits, cut):
    """The whole deformed render on a twisted IP cloud (40x40 rays, 2
    Newton steps, 3 seeks; the cut box bends the half x > 0): image,
    depth and weights within 1e-4 absolute."""
    jb, tb = sphere_bits
    jspec, tspec = _small_specs()
    p = _np_tree(tspec, 0)
    p_ori, p_def, F, dF, dx = _deformed_ips(dx=0.06)
    base = jren.RenderSettings(bound=1.0, cascade=1, max_samples=48,
                               max_steps=512, min_near=0.05,
                               density_scale=20.0)
    lay = dict(bound=1.0, hgs=1.2 * dx, max_per_cell=16)
    bend = dict(num_seek_ip=3, max_iter_num=2, ip_dx=1.05 * dx, cut=cut)
    jst = jdef.DeformedSettings(base=base, bend=jbend.BendSettings(**bend),
                                layout=jsh.make_layout(**lay),
                                max_bend_samples=128)
    tst = tdef.DeformedSettings(
        base=tren.RenderSettings(**base._asdict()),
        bend=tbend.BendSettings(**bend), layout=tsh.make_layout(**lay),
        max_bend_samples=128)
    cb = np.asarray([0.0, 1.0, -1.0, 1.0, -1.0, 1.0], np.float32)
    jo, jd, to, td = _rays()
    jout = jdef.render_rays_deformed(
        _jp(p), jspec, jst, jb, *(jnp.asarray(a) for a in (p_def, p_ori, F,
                                                           dF)),
        jo, jd, jnp.float32(1.0), jnp.asarray(cb) if cut else None)
    field = field_from_numpy(p, tspec, CPU)
    tout = tdef.render_rays_deformed(
        field, tst, tb, *(T(a) for a in (p_def, p_ori, F, dF)), to, td, 1.0,
        T(cb) if cut else None)
    img = A(jout["image"])
    assert np.isfinite(img).all() and (A(jout["weights_sum"]) > 0.5).sum() > 50
    for k in ("image", "depth_raw", "weights_sum"):
        np.testing.assert_allclose(A(tout[k]), A(jout[k]), atol=1e-4,
                                   err_msg=k)
    # the chunked frame helper: the same rays, any chunk (within 1e-6: a
    # chunk's live samples set the field's matmul shape, and the CPU
    # library's summation order follows it)
    img_c = tdef.render_image_deformed(
        field, tst, tgrid.OccupancyGrid(None, tb, None, None),
        *(T(a) for a in (p_def, p_ori, F, dF)), _pose(), (60.0, 60.0, 20.0,
                                                          20.0),
        40, 40, chunk=256, cut_bounds=T(cb) if cut else None)
    np.testing.assert_allclose(A(img_c["image"]).reshape(-1, 3),
                               A(tout["image"]), atol=1e-6, rtol=0)


def _pose():
    pose = torch.eye(4)
    pose[2, 3] = -2.5
    return pose


# ---- the coupled frame --------------------------------------------------------

def _sim_scene(dx=0.1, r0=0.45, step=None, pinned=False):
    """A lattice of physics points in the sphere (spacing ``step``, dx by
    default), no gravity; ``pinned``: the points below z = -0.3."""
    c = np.arange(-r0, r0 + 1e-6, step or dx)
    xx, yy, zz = np.meshgrid(c, c, c, indexing="ij")
    pts = np.stack([xx.ravel(), yy.ravel(), zz.ravel()], 1)
    pts = pts[np.linalg.norm(pts, axis=1) <= r0]
    n = pts.shape[0]
    args = (pts, np.full(n, 0.1), np.full(n, 1e5), np.full(n, 1e5),
            pts[:, 2] < -0.3 if pinned else np.zeros(n, bool))
    kw = dict(dt=1e-2, iters=10, bbox=np.array([2.0, 2.0, 2.0]), kres=7,
              dx=dx, gravity=(0.0, 0.0, 0.0), stiff=1e5,
              base=np.array([-1.0, -1.0, -1.0]))
    return args, kw


def _spring(consts, ddof, vid, fi):
    """The bench's spring drag (tests/test_torch_sim.py), in numpy from
    JAX's state, so both sides get the same force."""
    nx = np.asarray(consts.IP_Nx[vid])
    kern = np.asarray(consts.IP_kernel[vid])
    rest = np.asarray(consts.ip_pos[vid])
    p_ip = rest + np.einsum("ia,iad->d", nx, ddof[kern])
    ang = 0.25 * fi
    target = rest + 0.25 * np.array([np.cos(ang), np.sin(ang), 0.0])
    return np.clip(1e5 * (target - p_ip), -5e5, 5e5).astype(np.float32)


def test_frame_step_matches_jax(sphere_bits):
    """The pinned sphere of tests/test_torch_sim.py under the bench's
    spring drag for two coupled frames, then one with the force gated off
    (force_vid -1): the state within the port's 2e-5 sim tolerance of its
    scale (the regime it is set for, PERF.md section 2), the image within
    1e-4 absolute."""
    jb, tb = sphere_bits
    jspec, tspec = _small_specs()
    p = _np_tree(tspec, 1)
    field = field_from_numpy(p, tspec, CPU)
    cfg = dict(bound=1.0, sim_dx=0.1, num_seek_IP=3, max_iter_num=2,
               max_steps=512, train_max_samples=24, min_near=0.05)
    jfs = jpipe.make_frame_settings(jspec, JConfig(**cfg).finalize(), 0.1)
    tfs = tpipe.make_frame_settings(tspec, TConfig(**cfg).finalize(), 0.1)
    assert tfs.deformed.layout == tuple(jfs.deformed.layout)
    assert tuple(tfs.deformed.base) == tuple(jfs.deformed.base)
    assert tuple(tfs.deformed.bend) == tuple(jfs.deformed.bend)
    args, kw = _sim_scene(pinned=True)
    jc, js, _ = jsim.sim_init(*args, **kw)
    tc, ts, _ = tsim.sim_init(*args, **kw, device=CPU)
    jo, jd, to, td = _rays(32, 32, 48.0)
    vid = int(np.argmax(np.asarray(jc.ip_pos)[:, 2]))
    for fi, v in enumerate((vid, vid, -1)):
        f = _spring(jc, np.asarray(js.ddof), vid, fi)
        js, jout = jpipe.frame_step(jfs, jc, js, _jp(p), jb, jo, jd,
                                    jnp.float32(1.0), jnp.int32(v),
                                    jnp.asarray(f))
        ts, tout = tpipe.frame_step(tfs, tc, ts, field, tb, to, td, 1.0,
                                    torch.tensor(v), T(f))
        jdd = np.asarray(js.ddof)
        err = np.abs(A(ts.ddof) - jdd).max() / np.abs(jdd).max()
        assert err <= 2e-5, (fi, err)
        np.testing.assert_array_equal(A(ts.dof_f) == 0,
                                      np.asarray(js.dof_f) == 0)
        np.testing.assert_allclose(A(tout["image"]), A(jout["image"]),
                                   atol=1e-4, err_msg=str(fi))
    assert np.abs(jdd).max() > 1e-4 and float(ts.dof_f.abs().sum()) == 0.0


def test_frame_step_rest_matches_static_render():
    """JAX's coupled scene (tests/test_pipeline.py:12-47: the sphere, the
    package's default hash grid with JAX's seeded weights, IPs on a dx/2
    lattice): the port's frame at rest reads >= 28 dB against its own
    static render_rays, the bar JAX's frame_step meets there."""
    cfg = TConfig(bound=1.0, sim_dx=0.1, num_seek_IP=3, max_iter_num=2,
                  max_steps=512, train_max_samples=24,
                  min_near=0.05).finalize()
    jspec = jnet.make_spec(bound=1.0)
    tspec = tnet.make_spec(bound=1.0, backbone="hashgrid")
    params = jax.device_get(jnet.init_params(jax.random.PRNGKey(0), jspec))
    field = field_from_numpy(params, tspec, CPU)
    g = tgrid.update(tgrid.init(1), lambda x: torch.where(
        torch.linalg.norm(x, dim=-1) <= 0.45, 50.0, 0.0), 1.0,
        density_thresh=10.0, generator=torch.Generator().manual_seed(1))
    args, kw = _sim_scene(step=0.05)
    consts, state, _ = tsim.sim_init(*args, **{**kw, "dt": cfg.sim_dt,
                                               "iters": cfg.sim_iters,
                                               "stiff": cfg.sim_stiff},
                                     device=CPU)
    fs = tpipe.make_frame_settings(tspec, cfg, 0.1)
    _, _, to, td = _rays(32, 32, 48.0)
    state2, out = tpipe.frame_step(fs, consts, state, field, g.bitfield, to,
                                   td, 1.0, torch.tensor(-1), torch.zeros(3))
    stat = tren.render_rays(field, fs.deformed.base, g.bitfield, to, td, 1.0)
    p = psnr(A(out["image"]), A(stat["image"]))
    assert p > 28.0, p
    assert float(state2.ddof.abs().max()) < 1e-5


# ---- the Simulator facade -------------------------------------------------------

def test_simulator_facade_equals_the_functions():
    """20 stepforwards with update_force through the facade are
    torch.equal to the same calls through the functions; substeps=2 is
    two steps at dt / 2, as the JAX facade's test pins it
    (tests/test_solver.py:258-265)."""
    args, kw = _sim_scene(dx=0.15)
    s = tsim.Simulator(**{k: v for k, v in kw.items()})
    s.initialize(*args)
    consts, state, _ = tsim.sim_init(*args, **kw, device=CPU)
    vid = int(np.argmax(A(consts.ip_pos)[:, 2]))
    for i in range(20):
        f = [1e3 * np.cos(0.3 * i), 5e2, 0.0]
        s.update_force(vid, f)
        s.stepforward()
        state = tsim.sim_step(consts, tsim.update_force(
            consts, state, vid, torch.tensor(f, dtype=torch.float32)))
        assert torch.equal(s.state.ddof, state.ddof), i
    for a, b in zip(s.get_IP_info(), tsim.get_ip_info(consts, state)):
        assert torch.equal(a, b)
    s.clear_force()
    assert float(s.state.dof_f.abs().sum()) == 0.0
    np.testing.assert_array_equal(
        s.update_pos(), A(tsim.point_positions(consts, state)))

    s2 = tsim.Simulator(substeps=2, **kw)
    s2.initialize(*args)
    s2.stepforward()
    c2, st2, _ = tsim.sim_init(*args, **{**kw, "dt": kw["dt"] / 2},
                               device=CPU)
    assert torch.equal(s2.state.ddof,
                       tsim.sim_step(c2, tsim.sim_step(c2, st2)).ddof)


# ---- main_render --------------------------------------------------------------

def test_main_render_cpu_equals_render_frame(tmp_path):
    """python -m pienerf_tpu_torch.main_render --device cpu on dumped IP
    state: its PNG equals render_frame's image on the same state, quantized
    the same way, pixel for pixel."""
    from pienerf_tpu_torch import main_render
    from pienerf_tpu_torch.io.framesink import read_png
    from pienerf_tpu_torch.kernels import field as tfk
    from pienerf_tpu_torch.ops import beam_bend
    from pienerf_tpu_torch.render import interactive

    p_ori, p_def, F, dF, dx = _deformed_ips(dx=0.1)
    dump = tmp_path / "dump"
    dump.mkdir()
    for name, a in (("ip_pos_3", p_def), ("ip_F_3", F.reshape(-1, 9)),
                    ("ip_dF_3", dF), ("ip_rest", p_ori)):
        np.save(dump / f"{name}.npy", a)
    out = tmp_path / "r.png"
    ws = os.path.join(ROOT, "runs", "quality_mlp_800")
    argv = ["--workspace", ws, "--backbone", "mlp", "--dump_dir", str(dump),
            "--frame", "3", "--out", str(out), "--H", "32", "--W", "32",
            "--sim_dx", str(dx), "--max_iter_num", "3", "--num_seek_IP", "2",
            "--device", "cpu"]
    main_render.main(argv)
    png = read_png(out)

    from pienerf_tpu_torch.config import get_shared_opts
    from pienerf_tpu_torch.main_gui import _load_field
    cfg = get_shared_opts(None, ["--workspace", ws, "--backbone", "mlp"])
    spec, pw = _load_field(cfg, CPU)
    bst = beam_bend.BeamBendSettings(num_seek_ip=2, max_iter_num=3,
                                     ip_dx=1.05 * dx)
    ist = interactive.InteractiveSettings(spec=spec, bend=bst, samples=96,
                                          min_near=cfg.min_near,
                                          T_thresh=cfg.T_thresh,
                                          bound=cfg.bound)
    focal = 32 / (2 * np.tan(np.radians(cfg.fovy) / 2))
    args = [T(a) for a in (p_def, p_ori, F, dF)]
    o = interactive.render_frame(ist, pw, beam_bend.pack_for(bst, *args),
                                 args[0], _pose(), (focal, focal, 16, 16),
                                 32, 32, 1.0)
    img = interactive.tiles_to_image(o["tiles_image"], 32, 32)
    want = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    np.testing.assert_array_equal(png, want)
    assert want.std() > 1 and tfk.kernel_width(spec) == 64
