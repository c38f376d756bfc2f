"""Port parity for the large-scene simulator (CPU): a pinned sphere above
``DENSE_IP_THRESHOLD`` IPs, so that the cell-chunked operator runs, against
the JAX package on the same numpy scene; the dense operator against the
chunked one; bf16 operator storage; the sim_init cache; and the headless
``main_sim`` entry point."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pienerf_tpu.sim import solver as jsim
from pienerf_tpu_torch.io.ply import read_ply, write_ply
from pienerf_tpu_torch.sim import solver as tsim
from pienerf_tpu_torch.weights import sim_consts_from_numpy, \
    sim_state_from_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _scene(dx, kres):
    r0 = 0.45
    c = np.arange(-r0, r0 + 1e-6, dx)
    xx, yy, zz = np.meshgrid(c, c, c, indexing="ij")
    pts = np.stack([xx.ravel(), yy.ravel(), zz.ravel()], 1)
    pts = pts[np.linalg.norm(pts, axis=1) <= r0]
    n = pts.shape[0]
    args = (pts, np.full(n, 0.1), np.full(n, 1e5), np.full(n, 1e5),
            pts[:, 2] < -0.3)
    kw = dict(dt=1e-2, iters=10, bbox=np.array([2.0, 2.0, 2.0]), kres=kres,
              dx=dx, gravity=(0.0, 0.0, 0.0), stiff=1e5,
              base=np.array([-1.0, -1.0, -1.0]))
    return args, kw


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The suite runs several workers a machine: these larger products
    gain nothing from a thread per core and would crowd the neighbours."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def big():
    """6,940 IPs, one point a cell, a coarse 9^3 kernel grid: quick to
    build and to step, and above the threshold on both sides (a 5^3 grid
    sums 59 chunks into every node and reads 2.6e-5 on the trajectory). ``traj`` is the f32 spring-drag trajectory of
    both sides, run once for the tests that read it."""
    args, kw = _scene(0.038, 9)
    jc, js, jaux = jsim.sim_init(*args, **kw)
    tc, ts, taux = tsim.sim_init(*args, **kw, device=CPU)
    b = dict(args=args, kw=kw, jc=jc, js=js, jaux=jaux, tc=tc, ts=ts,
             taux=taux)
    b["traj"] = _trajectory(b, jc, tc, steps=10)
    return b


def _spring(consts, ddof, vid, fi):
    """The bench's spring drag (bench.py) in numpy: both sides get the
    same force."""
    nx = np.asarray(consts.IP_Nx[vid])
    kern = np.asarray(consts.IP_kernel[vid])
    rest = np.asarray(consts.ip_pos[vid])
    p_ip = rest + np.einsum("ia,iad->d", nx, ddof[kern])
    ang = 0.25 * fi
    target = rest + 0.25 * np.array([np.cos(ang), np.sin(ang), 0.0])
    return np.clip(1e5 * (target - p_ip), -5e5, 5e5).astype(np.float32)


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_chunked_constants_equal_jax(big):
    jc, tc = big["jc"], big["tc"]
    assert big["taux"]["n_ip"] == big["jaux"]["n_ip"] > tsim.DENSE_IP_THRESHOLD
    assert jc.B is None and tc.B is None      # auto-select: chunked only
    for name in tsim.SimConstants._fields:
        if name in ("node_gather", "B"):
            continue
        a, b = getattr(tc, name), getattr(jc, name)
        if isinstance(a, torch.Tensor):
            # the same f64 numpy precompute, cast once: exact
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=name)
        else:
            assert a == b, name
    C, S = tc.chunk_mu.shape
    assert tc.Dc.shape == (C, S, 3, 80) and C * S >= big["taux"]["n_ip"]
    # the JAX constants carried across rebuild the same scatter list
    tc2 = sim_consts_from_numpy(jax.device_get(jc), CPU)
    assert tc2.B is None
    np.testing.assert_array_equal(tc2.node_gather.numpy(),
                                  tc.node_gather.numpy())


def _trajectory(big, jc, tc, steps):
    """The spring-drag trajectory on both sides from rest; yields the
    relative ddof error after each step, then the end states."""
    vid = int(np.argmax(np.asarray(jc.ip_pos)[:, 2]))
    step_j = jax.jit(lambda c, s, f: jsim.sim_step(
        c, jsim.update_force(c, s, jnp.int32(vid), f)))
    js = big["js"]
    ts = sim_state_from_numpy(jax.device_get(js), CPU)
    errs = []
    for fi in range(steps):
        f = _spring(jc, np.asarray(js.ddof), vid, fi)
        js = step_j(jc, js, jnp.asarray(f))
        ts = tsim.sim_step(tc, tsim.update_force(tc, ts, vid,
                                                 torch.from_numpy(f)))
        jd = np.asarray(js.ddof)
        assert np.isfinite(jd).all() and np.abs(jd).max() > 0
        errs.append(_rel(ts.ddof.numpy(), jd))
    return errs, js, ts


def test_chunked_trajectory_matches_jax(big):
    errs, js, ts = big["traj"]
    # relative to the state's scale: f32 summation order of the global
    # solve and of the node sums (a fixed-axis sum here, segment_sum
    # there), the tolerance tests/test_torch_sim.py argues
    assert max(errs) <= 2e-5, errs
    jpts = np.asarray(jsim.point_positions(big["jc"], js))
    tpts = tsim.point_positions(big["tc"], ts).numpy()
    assert np.abs(tpts - jpts).max() <= 2e-5 * np.abs(jpts).max()
    pin = big["args"][4]
    np.testing.assert_allclose(tpts[pin], big["args"][0][pin], atol=2e-3)


def test_chunked_step_is_deterministic_and_matches_dense(big):
    """Two chunked steps from one state agree bit for bit (the node
    scatter is a gather and a fixed-axis sum), and the same scene through
    the dense operator agrees within the reordering tolerance."""
    tc, kw = big["tc"], big["kw"]
    td, ts_d, _ = tsim.sim_init(*big["args"], **kw, device=CPU,
                                dense_operator=True)
    assert td.B is not None and td.B.shape == (3 * big["taux"]["n_ip"],
                                               10 * big["taux"]["n_k"])
    vid = int(np.argmax(tc.ip_pos[:, 2].numpy()))
    ts_c = big["ts"]
    for fi in range(4):
        f = torch.from_numpy(_spring(tc, ts_c.ddof.numpy(), vid, fi))
        again = tsim.sim_step(tc, tsim.update_force(tc, ts_c, vid, f))
        ts_c = tsim.sim_step(tc, tsim.update_force(tc, ts_c, vid, f))
        assert torch.equal(again.ddof, ts_c.ddof)
        ts_d = tsim.sim_step(td, tsim.update_force(td, ts_d, vid, f))
        assert _rel(ts_d.ddof.numpy(), ts_c.ddof.numpy()) <= 2e-5, fi
    # one elastic right-hand side, operator against operator
    rc = tsim.rhs_elastic_delta(tc, ts_c.ddof).numpy()
    rd = tsim.rhs_elastic_delta(td, ts_c.ddof).numpy()
    assert _rel(rd, rc) <= 1e-5


def test_cast_B_bf16_matches_jax_bf16_step(big):
    jcb = jsim.cast_B_bf16(big["jc"])
    tcb = tsim.cast_B_bf16(big["tc"])
    assert tcb.Dc.dtype == torch.bfloat16 and tcb.global_inv.dtype == \
        torch.float32
    np.testing.assert_array_equal(tcb.Dc.float().numpy(),
                                  np.asarray(jcb.Dc.astype(jnp.float32)))
    # one right-hand side on the same state: the same bf16 operands, exact
    # products, f32 sums in another order (and the rare dP element that
    # lands on the other side of a bf16 rounding boundary)
    rng = np.random.RandomState(1)
    ddof = (1e-2 * rng.randn(*tcb.dof_rest.shape)).astype(np.float32)
    a = tsim.rhs_elastic_delta(tcb, torch.from_numpy(ddof)).numpy()
    b = np.asarray(jsim.rhs_elastic_delta(jcb, jnp.asarray(ddof)))
    assert _rel(a, b) <= 5e-5
    # a trajectory feeds each side its own state back: where the two
    # differ by the f32 reordering (1e-5), an element rounds to the other
    # bf16 neighbour (2^-8 of it) now and then, so the trajectories part
    # at the size of the bf16 rounding itself, which on this scene is the
    # 2-3e-3 that bf16 storage moves the JAX rhs from its own f32 one
    errs, js, ts = _trajectory(big, jcb, tcb, steps=10)
    assert max(errs) <= 5e-3, errs
    # and bf16 storage stays close to the f32 trajectory (~0.4% forces)
    js32 = big["traj"][1]
    assert _rel(ts.ddof.numpy(), np.asarray(js32.ddof)) <= 2e-2
    # the dense form casts too
    args, kw = _scene(0.1, 7)
    td = tsim.cast_B_bf16(tsim.sim_init(*args, **kw, device=CPU)[0])
    jd = jsim.cast_B_bf16(jsim.sim_init(*args, **kw)[0])
    assert td.B.dtype == torch.bfloat16
    rng = np.random.RandomState(0)
    ddof = (1e-3 * rng.randn(*td.dof_rest.shape)).astype(np.float32)
    a = tsim.rhs_elastic_delta(td, torch.from_numpy(ddof)).numpy()
    b = np.asarray(jsim.rhs_elastic_delta(jd, jnp.asarray(ddof)))
    assert _rel(a, b) <= 1e-3


def test_sim_init_cached_miss_then_hit(tmp_path):
    args, kw = _scene(0.1, 7)
    cache = str(tmp_path / "sim_cache")
    c1, s1, a1 = tsim.sim_init_cached(*args, cache_dir=cache, device=CPU,
                                      **kw)
    files = os.listdir(cache)
    assert len(files) == 1 and files[0].startswith("simconsts_")
    c2, s2, a2 = tsim.sim_init_cached(*args, cache_dir=cache, device=CPU,
                                      **kw)
    assert os.listdir(cache) == files                    # a hit
    for name in tsim.SimConstants._fields:
        a, b = getattr(c1, name), getattr(c2, name)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), name
        else:
            assert a == b and type(a) is type(b), name
    assert torch.equal(s2.ddof, s1.ddof) and int(a2["n_ip"]) == a1["n_ip"]
    np.testing.assert_array_equal(a2["is_pin"], a1["is_pin"])
    out1 = tsim.sim_step(c1, s1._replace(dof_vel=s1.dof_vel + 0.1))
    out2 = tsim.sim_step(c2, s2._replace(dof_vel=s2.dof_vel + 0.1))
    assert torch.equal(out1.ddof, out2.ddof)
    # an absent dense B is a size-0 array on disk and None again on a hit
    c3, _, _ = tsim.sim_init_cached(*args, cache_dir=cache, device=CPU,
                                    dense_operator=False, **kw)
    c4, _, _ = tsim.sim_init_cached(*args, cache_dir=cache, device=CPU,
                                    dense_operator=False, **kw)
    assert c3.B is None and c4.B is None and len(os.listdir(cache)) == 2
    # an edited input or parameter changes the key
    key = tsim._sim_cache_key(*args, kw)
    moved = (args[0] + 1e-9,) + args[1:]
    assert tsim._sim_cache_key(*moved, kw) != key
    assert tsim._sim_cache_key(*args, {**kw, "iters": 11}) != key
    assert tsim._sim_cache_key(*args, dict(kw)) == key


def test_main_sim_cpu_writes_finite_plys(tmp_path):
    """The cube of the verify recipe: finite clouds, the pinned side still,
    the free side sagging under gravity."""
    g = np.linspace(0.3, 0.7, 8) - 0.5
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    p = np.stack([x.ravel(), y.ravel(), z.ravel()], 1)
    n = len(p)
    pin = p[:, 1] > 0.15
    ply = str(tmp_path / "cube.ply")
    write_ply(ply, p, vp=np.full(n, 1e-3), pin=pin.astype(float),
              lam=np.full(n, 1e4), mu=np.full(n, 1e4), mass=np.full(n, 0.1))
    out = tmp_path / "sim_out"
    r = subprocess.run(
        [sys.executable, "-m", "pienerf_tpu_torch.main_sim", "--device",
         "cpu", "--ply", ply, "--steps", "21", "--sim_dx", "0.2", "--kres",
         "4", "--bound", "0.5", "--out_dir", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "dense operator" in r.stdout and "steps/s" in r.stdout
    names = sorted(os.listdir(out))
    assert names == ["pnt_00000.ply", "pnt_00010.ply", "pnt_00020.ply"]
    cloud = read_ply(str(out / names[-1]))
    last = np.stack([cloud[k] for k in ("x", "y", "z")], 1)
    assert last.shape == p.shape and np.isfinite(last).all()
    np.testing.assert_allclose(last[pin], p[pin], atol=5e-3)
    assert (last[~pin, 1] - p[~pin, 1]).mean() < -1e-4
    if not torch.cuda.is_available():
        from pienerf_tpu_torch import main_sim
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main_sim.main(["--ply", ply, "--out_dir", str(out)])
