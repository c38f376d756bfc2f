"""Port parity: bending math, the per-frame IP pack, the beam gate and the
candidate prep (pienerf_tpu_torch vs pienerf_tpu on the CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pienerf_tpu.ops import beam_bend as jbb
from pienerf_tpu.ops import bending as jbend
from pienerf_tpu.ops.pallas import tile_kernel as jtk
from pienerf_tpu_torch.kernels import tile as ttk
from pienerf_tpu_torch.ops import beam_bend as tbb
from pienerf_tpu_torch.ops import bending as tbend


def _t(a):
    return torch.from_numpy(np.array(a))


def _twisted_cloud(dx=0.1, r0=0.45, amp=0.6):
    c = np.arange(-r0, r0 + 1e-6, dx, dtype=np.float32)
    xx, yy, zz = np.meshgrid(c, c, c, indexing="ij")
    p_ori = np.stack([xx.ravel(), yy.ravel(), zz.ravel()], 1)
    p_ori = p_ori[np.linalg.norm(p_ori, axis=1) <= r0]
    ang = amp * p_ori[:, 1]
    ca, sa = np.cos(ang), np.sin(ang)
    p_def = np.stack([ca * p_ori[:, 0] + sa * p_ori[:, 2], p_ori[:, 1],
                      -sa * p_ori[:, 0] + ca * p_ori[:, 2]], 1)
    n = p_ori.shape[0]
    F = np.zeros((n, 3, 3), np.float32)
    F[:, 0, 0] = ca; F[:, 0, 2] = sa; F[:, 1, 1] = 1.0
    F[:, 2, 0] = -sa; F[:, 2, 2] = ca
    dF = np.zeros((n, 3, 3, 3), np.float32)
    dF[:, 0, 0, 1] = -amp * sa; dF[:, 0, 2, 1] = amp * ca
    dF[:, 2, 0, 1] = -amp * ca; dF[:, 2, 2, 1] = -amp * sa
    return (p_def.astype(np.float32), p_ori.astype(np.float32), F, dF)


def _random_mats(n, seed):
    rng = np.random.RandomState(seed)
    F = (np.eye(3) + 0.3 * rng.randn(n, 3, 3)).astype(np.float32)
    F[0] = 0.0                                    # singular: ok = False
    return F


def test_inv3x3_matches_jax():
    F = _random_mats(500, 0)
    ji, jok = jbend._inv3x3(jnp.asarray(F))
    ti, tok = tbend._inv3x3(_t(F))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    # same closed form, same operation order: f32 rounding only
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=1e-6,
                               atol=1e-6)


def test_newton_invert_matches_jax():
    rng = np.random.RandomState(1)
    M, k = 256, 3
    x = rng.uniform(-0.5, 0.5, (M, 3)).astype(np.float32)
    p_def = (x[:, None, :] + 0.05 * rng.randn(M, k, 3)).astype(np.float32)
    p_ori = (p_def + 0.02 * rng.randn(M, k, 3)).astype(np.float32)
    F = (np.eye(3) + 0.1 * rng.randn(M, k, 3, 3)).astype(np.float32)
    dF = (0.5 * rng.randn(M, k, 3, 3, 3)).astype(np.float32)
    for it in (1, 4):
        jp, _ = jbend.newton_invert(*(jnp.asarray(a) for a in
                                      (x, p_ori, p_def, F, dF)), it)
        tp, _ = tbend.newton_invert(*(_t(a) for a in
                                      (x, p_ori, p_def, F, dF)), it)
        # f32 einsum order; Newton contracts the differences
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6)


def test_pack_ip_data_fast_and_count_in_beam_match_jax():
    p_def, p_ori, F, dF = _twisted_cloud()
    jp = jbb.pack_ip_data_fast(*(jnp.asarray(a) for a in
                                 (p_def, p_ori, F, dF)))
    tp = tbb.pack_ip_data_fast(*(_t(a) for a in (p_def, p_ori, F, dF)))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-7)
    assert tp.shape == (p_def.shape[0], tbb.PACK_FAST)

    st_j = jbb.BeamBendSettings(ip_dx=0.105, ips_per_tile=64)
    st_t = tbb.BeamBendSettings(ip_dx=0.105, ips_per_tile=64)
    assert tbb.reach_of(st_t) == jbb.reach_of(st_j)
    assert tbb.margin_of(st_t) == jbb.margin_of(st_j)
    origin, axis, tan_half, t0, t1 = _beams(8)
    jc = jbb.count_in_beam(st_j, jnp.asarray(p_def), jnp.asarray(origin[0]),
                           jnp.asarray(axis), jnp.asarray(tan_half),
                           jnp.asarray(t0), jnp.asarray(t1))
    tc = tbb.count_in_beam(st_t, _t(p_def), _t(origin[0]), _t(axis),
                           _t(tan_half), _t(t0), _t(t1))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert int(tc.sum()) > 0


def _beams(A, seed=2, exact_z=False):
    """Beam origins/axes as the fused frame builds them: one camera origin,
    unit central axes fanning over the object."""
    rng = np.random.RandomState(seed)
    origin = np.tile(np.asarray([[0.02, -0.01, -2.5]], np.float32), (A, 1))
    if exact_z:
        axis = np.tile(np.asarray([[0.0, 0.0, 1.0]], np.float32), (A, 1))
    else:
        axis = np.concatenate([0.15 * rng.randn(A, 2), np.ones((A, 1))], 1)
        axis = (axis / np.linalg.norm(axis, axis=1, keepdims=True))
    tan_half = np.full((A,), 0.015, np.float32)
    t0 = np.full((A,), 1.9, np.float32) + 0.05 * rng.rand(A).astype(
        np.float32)
    t1 = np.full((A,), 3.1, np.float32) - 0.05 * rng.rand(A).astype(
        np.float32)
    return (origin, axis.astype(np.float32), tan_half, t0, t1)


@pytest.mark.parametrize("tmarg", [0.0, 0.315])
@pytest.mark.parametrize("scene", ["twist", "ties"])
def test_prep_candidates_exactly_equal_jax(scene, tmarg):
    p_def, p_ori, F, dF = _twisted_cloud(dx=0.08)
    if scene == "ties":
        # axis exactly +z through an unrotated grid: every z-layer of IPs
        # projects to the same depth, so the sort must break ties by index
        # as lax.top_k does; small P also exercises the -inf slot order
        p_def = p_ori.copy()
        beams = _beams(6, exact_z=True)
        P = 48
    else:
        beams = _beams(6)
        P = 160
    pack = np.asarray(jbb.pack_ip_data_fast(*(jnp.asarray(a) for a in
                                              (p_def, p_ori, F, dF))))
    K = 32
    kw = dict(n_cand=P, n_bins=K + 2, beam_margin=0.21, tighten_margin=tmarg)
    jout = jtk.prep_candidates(jnp.asarray(pack), jnp.asarray(p_def),
                               *(jnp.asarray(b) for b in beams), **kw)
    tout = ttk.prep_candidates(_t(pack), _t(p_def), *(_t(b) for b in beams),
                               **kw)
    names = ("cand", "bin_start", "n_dropped", "t0e", "t1e")
    for name, a, b in zip(names, tout, jout):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    assert tout[1].dtype == torch.int32 and tout[1].shape[1] == K + 4
    assert int(tout[1][:, -1].max()) > 0
    if scene == "ties":
        assert int(tout[2].max()) > 0          # capacity overflow exercised
