"""Port parity of the physics point-cloud sampler against the JAX package
(CPU), on the committed trained field (runs/quality_mlp_800, its EMA
weights) at sub_res 28: the lattice's occupancy within 1e-5; with one
density function given to both samplers, points and volumes bit-equal;
from the two fields themselves, the points equal but in cells that each
package may round to the other side (named and counted); the vectorised
cell fill against JAX's loop; the cut lattice; and main_sample end to
end."""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pienerf_tpu.config import PieNeRFConfig as JCfg
from pienerf_tpu.io.checkpoint import load_native as jload
from pienerf_tpu.models import network as jnet
from pienerf_tpu.sample import AdaptiveUniformSampling as JSampler
from pienerf_tpu_torch import main_sample
from pienerf_tpu_torch import sample as tsample
from pienerf_tpu_torch.config import PieNeRFConfig as TCfg
from pienerf_tpu_torch.io.ply import read_ply
from pienerf_tpu_torch.models import network as tnet
from pienerf_tpu_torch.weights import field_from_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "runs/quality_mlp_800/checkpoints/ngp_ep0015.npz")
RES = 28
# sub_coeff 1.0 splits the sphere's boundary cells into 1 to 5 per axis
# (0.1, the default, splits none at this resolution)
KW = dict(bound=1.0, sub_res=RES, density_threshold=0.05, sub_coeff=1.0,
          sim_dx=0.05)
DENSITY_TOL = 1e-5     # the occupancy, JAX's f32 XLA against torch's


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread a test: the tensors here are small, and the test
    workers share the machine's cores, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ema():
    return jload(CKPT)[0]["ema_params"]


def samplers(ema, **over):
    kw = {**KW, **over}
    js = JSampler(JCfg(**kw).finalize(),
                  jax.tree_util.tree_map(jnp.asarray, ema),
                  jnet.make_spec(bound=1.0, backbone="mlp"))
    tspec = tnet.make_spec(bound=1.0, backbone="mlp")
    ts = tsample.AdaptiveUniformSampling(
        TCfg(**kw).finalize(), field_from_numpy(ema, tspec, "cpu"), tspec)
    return js, ts


def lattice_points(ts):
    xs, ys, zs = ts.lattice()
    g = np.meshgrid(xs, ys, zs, indexing="ij")
    return np.stack([a.ravel() for a in g], -1)


def test_lattice_occupancy_within_tolerance(ema):
    js, ts = samplers(ema)
    g = lattice_points(ts)
    dj, dt = js.get_density(g), ts.get_density(g)
    assert dt.dtype == np.float32 and dt.shape == (RES ** 3,)
    assert dj.max() > 0.2          # the trained sphere is on the lattice
    np.testing.assert_allclose(dt, dj, rtol=0, atol=DENSITY_TOL)


def test_shared_density_gives_bit_equal_points(ema):
    """Both samplers read one numpy density (JAX's field evaluated once
    per query): the lattice, the sub_dims, the shared random block, the
    cell fill, the threshold and the volumes are then the same
    arithmetic, so points and volumes are bit-equal."""
    js, ts = samplers(ema)
    jax_density = js._density

    def shared(x):
        return np.asarray(jax_density(jnp.asarray(np.asarray(x),
                                                  jnp.float32)))

    js._density = lambda x: shared(x)
    ts._density = lambda x: torch.from_numpy(shared(x.numpy()).copy())
    rj, rt = js.sample(seed=3), ts.sample(seed=3)
    assert rt["points"].shape[0] > RES ** 3 // 10
    np.testing.assert_array_equal(rt["points"], rj["points"])
    np.testing.assert_array_equal(rt["volumes"], rj["volumes"])


def grad_norm(d):
    """The norm of the 8-corner density gradient of each cell
    (sample.py's, unrounded)."""
    c = {(i, j, k): d[i:d.shape[0] - 1 + i, j:d.shape[1] - 1 + j,
                      k:d.shape[2] - 1 + k]
         for i in (0, 1) for j in (0, 1) for k in (0, 1)}
    gs = []
    for axis in range(3):
        hi = sum(v for key, v in c.items() if key[axis] == 1)
        lo = sum(v for key, v in c.items() if key[axis] == 0)
        gs.append(hi - lo)
    return np.sqrt(sum(g ** 2 for g in gs))


def _cell_of(p, xs, step):
    return tuple(np.floor((p - xs[0]) / step).astype(int))


def test_points_from_each_field_differ_only_in_named_cells(ema):
    """Each sampler on its own field. A point may differ only (a) in a
    cell whose gradient scale sits within f32 rounding of an integer, so
    that the two packages' sub_dims differ, or (b) where the two
    occupancies lie on either side of the threshold within the density
    tolerance. The cells are counted and named; every other point is
    bit-equal."""
    js, ts = samplers(ema)
    rj, rt = js.sample(), ts.sample()
    g = lattice_points(ts)
    dj = js.get_density(g).reshape(RES, RES, RES)
    dt = ts.get_density(g).reshape(RES, RES, RES)
    sj, st = ts.sub_dims(dj), ts.sub_dims(dt)
    scale = ts.grid_size * ts.cfg.sub_coeff * RES
    xs = ts.lattice()[0]
    step = xs[1] - xs[0]

    # (a) cells whose sub_dims differ: their unrounded values lie within
    # the occupancy tolerance's reach (8 corners) of the integer between
    # them
    dims_cells = [tuple(c) for c in np.argwhere(sj != st)]
    rj_, rt_ = scale * grad_norm(dj), scale * grad_norm(dt)
    for c in dims_cells:
        edge = max(sj[c], st[c])
        assert abs(int(sj[c]) - int(st[c])) == 1, (c, sj[c], st[c])
        assert abs(rt_[c] - edge) <= scale * 8 * DENSITY_TOL, (c, rt_[c])
        assert abs(rj_[c] - edge) <= scale * 8 * DENSITY_TOL, (c, rj_[c])

    # (b) every point that only one package kept
    pj = {tuple(p) for p in rj["points"]}
    pt = {tuple(p) for p in rt["points"]}
    only = [np.array(p) for p in (pj ^ pt)]
    threshold_cells, unexplained = set(), []
    for p in only:
        cell = _cell_of(p, xs, step)
        if cell in dims_cells:
            continue
        x = p[None].astype(np.float32)
        oj, ot = js.get_density(x)[0], ts.get_density(x)[0]
        if (abs(oj - ts.threshold) <= DENSITY_TOL
                and abs(ot - ts.threshold) <= DENSITY_TOL):
            threshold_cells.add(cell)
        else:
            unexplained.append((cell, float(oj), float(ot)))
    named = {"sub_dims": sorted(dims_cells),
             "threshold": sorted(threshold_cells)}
    print(f"differing cells: {named} ({len(only)} points of "
          f"{len(pt)})")
    assert not unexplained, (unexplained[:10], named)
    assert len(dims_cells) + len(threshold_cells) <= 4, named
    assert len(only) <= 0.001 * len(pt) + 125 * len(dims_cells), named


def test_fill_cells_equals_the_loop():
    """The vectorised fill against JAX's per-cell expression, bit for
    bit: mins[i] + block[:counts[i]] * step, cells in order."""
    rs = np.random.RandomState(0)
    dims = rs.randint(1, 5, 40)
    counts = dims ** 3
    mins = rs.uniform(-1, 1, (40, 3))
    block = rs.rand(int(dims.max()) ** 3, 3)
    step = np.array([0.07, 0.05, 0.09])
    loop = np.concatenate([mins[i] + block[:counts[i]] * step
                           for i in range(40)])
    np.testing.assert_array_equal(
        tsample._fill_cells(mins, counts, block, step), loop)


def test_cut_lattice_and_points(ema):
    """--cut samples the cut box clamped to the scene bound: the same
    axes as JAX's and the same points."""
    cut = dict(cut=True, cut_bounds=[-0.3, 2.0, -0.75, 0.6, -1.5, 0.75])
    js, ts = samplers(ema, **cut)
    xs, ys, zs = ts.lattice()
    assert xs[0] == -0.3 and xs[-1] == 1.0 and zs[0] == -1.0
    rj, rt = js.sample(seed=1), ts.sample(seed=1)
    np.testing.assert_array_equal(rt["points"], rj["points"])
    np.testing.assert_array_equal(rt["volumes"], rj["volumes"])


def test_main_sample_writes_the_ply(tmp_path, monkeypatch):
    """main_sample on the CPU: the workspace's newest checkpoint, its EMA
    field sampled into model/<workspace>/<exp_name>.ply under the current
    directory, as the port's sampler samples it; an empty workspace is
    refused."""
    ws = tmp_path / "ws"
    os.makedirs(ws / "checkpoints")
    for ext in ("", ".json"):
        shutil.copy(CKPT + ext, ws / "checkpoints" / f"ngp_ep0015.npz{ext}")
    monkeypatch.chdir(tmp_path)
    args = ["--device", "cpu", "--workspace", str(ws), "--exp_name",
            "sphere", "--backbone", "mlp", "--bound", "1.0", "--sub_res",
            "24", "--density_threshold", "0.05", "--sim_dx", "0.05"]
    out = main_sample.main(args)
    assert out == os.path.join("model", "ws", "sphere.ply")
    d = read_ply(str(tmp_path / out))
    _, ts = samplers(jload(CKPT)[0]["ema_params"], sub_res=24,
                     sub_coeff=TCfg().sub_coeff)
    ref = ts.sample()
    np.testing.assert_array_equal(
        np.stack([d["x"], d["y"], d["z"]], 1), ref["points"])
    np.testing.assert_array_equal(d["vp"], ref["volumes"])
    with pytest.raises(SystemExit, match="no checkpoint"):
        main_sample.main(["--device", "cpu", "--workspace",
                          str(tmp_path / "empty"), "--backbone", "mlp"])
