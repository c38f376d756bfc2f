"""Port parity: the simulator (pienerf_tpu_torch.sim vs pienerf_tpu.sim on
the CPU), on a small pinned sphere driven by the bench's spring drag."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pienerf_tpu.sim import solver as jsim
from pienerf_tpu.sim import svd3 as jsvd
from pienerf_tpu_torch.sim import solver as tsim
from pienerf_tpu_torch.sim import svd3 as tsvd
from pienerf_tpu_torch.weights import sim_consts_from_numpy, \
    sim_state_from_numpy

CPU = torch.device("cpu")


def _scene(dx=0.1, r0=0.45):
    c = np.arange(-r0, r0 + 1e-6, dx)
    xx, yy, zz = np.meshgrid(c, c, c, indexing="ij")
    pts = np.stack([xx.ravel(), yy.ravel(), zz.ravel()], 1)
    pts = pts[np.linalg.norm(pts, axis=1) <= r0]
    n = pts.shape[0]
    args = (pts, np.full(n, 0.1), np.full(n, 1e5), np.full(n, 1e5),
            pts[:, 2] < -0.3)
    kw = dict(dt=1e-2, iters=10, bbox=np.array([2.0, 2.0, 2.0]), kres=7,
              dx=dx, gravity=(0.0, 0.0, 0.0), stiff=1e5,
              base=np.array([-1.0, -1.0, -1.0]))
    return args, kw


@pytest.fixture(scope="module")
def sims():
    args, kw = _scene()
    jc, js, jaux = jsim.sim_init(*args, **kw)
    tc, ts, taux = tsim.sim_init(*args, **kw, device=CPU)
    return jc, js, jaux, tc, ts, taux


def test_sim_init_constants_equal_jax(sims):
    jc, js, jaux, tc, ts, taux = sims
    assert jc.B is not None                  # the dense-operator scene
    for name in tsim.SimConstants._fields:
        a, b = getattr(tc, name), getattr(jc, name)
        if isinstance(a, torch.Tensor):
            # the same f64 numpy precompute, cast once: exact
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=name)
        else:
            assert a == b, name
    assert taux["n_ip"] == jaux["n_ip"] and taux["n_k"] == jaux["n_k"]
    # weights.sim_consts_from_numpy carries the JAX constants across
    tc2 = sim_consts_from_numpy(jax.device_get(jc), CPU)
    np.testing.assert_array_equal(tc2.B.numpy(), tc.B.numpy())
    assert tc2.IP_kernel.dtype == torch.int64


def _random_F(n, seed):
    rng = np.random.RandomState(seed)
    A = rng.randn(n, 3, 3).astype(np.float32) * 0.1
    Q, _ = np.linalg.qr(rng.randn(n, 3, 3))
    return (Q.astype(np.float32) @ (np.eye(3, dtype=np.float32) + A))


def test_corotated_delta_matches_jax():
    F = _random_F(1000, 0)
    jF = tuple(tuple(jnp.asarray(F[:, i, j]) for j in range(3))
               for i in range(3))
    tF = tuple(tuple(torch.from_numpy(F[:, i, j].copy()) for j in range(3))
               for i in range(3))
    jR, jV = jsvd.corotated_delta(jF)
    tR, tV = tsvd.corotated_delta(tF)
    for i in range(3):
        for j in range(3):
            # f32 transcendental (atan2/sin/cos) ulps through 6 sweeps
            np.testing.assert_allclose(tR[i][j].numpy(), np.asarray(jR[i][j]),
                                       atol=1e-6)
            np.testing.assert_allclose(tV[i][j].numpy(), np.asarray(jV[i][j]),
                                       atol=1e-6)


def test_svd3x3_matches_jax():
    F = _random_F(300, 1)
    jU, jS, jVt = jsvd.svd3x3(jnp.asarray(F))
    tU, tS, tVt = tsvd.svd3x3(torch.from_numpy(F))
    np.testing.assert_allclose(tS.numpy(), np.asarray(jS), atol=1e-5)
    rec = (tU * tS[:, None, :]) @ tVt
    np.testing.assert_allclose(rec.numpy(), F, atol=1e-4)


def _spring(consts, ddof, vid, fi, xp):
    """The bench's spring drag toward a target orbiting the IP's rest spot
    (bench.py), evaluated in numpy so both sides get identical forces."""
    nx = np.asarray(consts.IP_Nx[vid])
    kern = np.asarray(consts.IP_kernel[vid])
    rest = np.asarray(consts.ip_pos[vid])
    p_ip = rest + np.einsum("ia,iad->d", nx, ddof[kern])
    ang = 0.25 * fi
    target = rest + 0.25 * np.array([np.cos(ang), np.sin(ang), 0.0])
    return np.clip(1e5 * (target - p_ip), -5e5, 5e5).astype(np.float32)


def test_spring_trajectory_matches_jax(sims):
    jc, js, _, tc, ts, _ = sims
    vid = int(np.argmax(np.asarray(jc.ip_pos)[:, 2]))
    step_j = jax.jit(lambda c, s, f: jsim.sim_step(
        c, jsim.update_force(c, s, jnp.int32(vid), f)))
    ts = sim_state_from_numpy(jax.device_get(js), CPU)
    for fi in range(20):
        f = _spring(jc, np.asarray(js.ddof), vid, fi, np)
        js = step_j(jc, js, jnp.asarray(f))
        ts = tsim.sim_step(tc, tsim.update_force(tc, ts, vid,
                                                 torch.from_numpy(f)))
        jd = np.asarray(js.ddof)
        assert np.isfinite(jd).all()
        # relative to the state's scale. Two f32 libraries sum the
        # 3430-long rows of global_inv @ rhs in different orders; on this
        # scene that alone moves ddof by 0.5e-5..1.75e-5 of its scale per
        # step, without growth over the 20 steps (the same 1.75e-5 as the
        # JAX package's own sharded-sim reordering, MULTICHIP_r05)
        err = np.abs(ts.ddof.numpy() - jd).max() / np.abs(jd).max()
        assert err <= 2e-5, (fi, err)
    # material points of the end state carry the same relative error
    jpts = np.asarray(jsim.point_positions(jc, js))
    tpts = tsim.point_positions(tc, ts).numpy()
    assert np.abs(tpts - jpts).max() <= 2e-5 * np.abs(jpts).max()
    assert float(tsim.clear_force(ts).dof_f.abs().sum()) == 0.0


def test_get_ip_info_matches_jax_on_carried_state(sims):
    jc, js, _, tc, _, _ = sims
    rng = np.random.RandomState(3)
    ddof = (1e-2 * rng.randn(*np.asarray(js.ddof).shape)).astype(np.float32)
    js = js._replace(ddof=jnp.asarray(ddof))
    ts = sim_state_from_numpy(jax.device_get(js), CPU)
    # the same state on both sides: only the f32 order of the 80-term
    # shape-function sums differs (dF's second derivatives are the widest)
    got = tsim.get_ip_info(tc, ts) + (tsim.deformation_gradients(tc,
                                                                 ts.ddof),)
    ref = jsim.get_ip_info(jc, js) + (jsim.deformation_gradients(jc,
                                                                 js.ddof),)
    for a, b in zip(got, ref):
        b = np.asarray(b)
        err = np.abs(a.numpy() - b).max() / np.abs(b).max()
        assert err <= 1e-5, err
