"""Port parity: the tile kernel's plain PyTorch version against the Pallas
tile kernel (interpret mode) on the same prepped inputs."""

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
from pienerf_tpu_torch.kernels import field as tfk
from pienerf_tpu_torch.kernels import tile as ttk
from pienerf_tpu_torch.models import network as tnet

K, KS, KSB = 32, 8, 4


def _cloud(dx=0.08, r0=0.45, amp=0.5):
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
    return p_def.astype(np.float32), p_ori, F, np.zeros((n, 3, 3, 3),
                                                         np.float32)


def _inputs(Wn, P, H=48):
    """Per-tile kernel inputs for every tile of an HxH frame, built with
    the JAX package's own frame helpers (as _fused_tile_pass does)."""
    p_def, p_ori, F, dF = (jnp.asarray(a) for a in _cloud())
    pack = jbb.pack_ip_data_fast(p_def, p_ori, F, dF)
    bst = jbb.BeamBendSettings(num_seek_ip=3, max_iter_num=1, ip_dx=0.084,
                               ips_per_tile=P)
    spec = jnet.make_spec(bound=1.0, backbone="mlp")
    st = jint.InteractiveSettings(spec=spec, bend=bst, samples=K)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (0.0, 0.0, -2.5)
    pose = jnp.asarray(pose)
    intr = (1.2 * H, 1.2 * H, H / 2, H / 2)
    n_tiles = (H // 16) ** 2
    tids = jnp.arange(n_tiles, dtype=jnp.int32)
    o, d = jint._tile_rays(tids, st, H, H, pose, intr)
    bbmin = jnp.min(p_def, 0) - 1e-3
    bbmax = jnp.max(p_def, 0) + 1e-3
    near, far = jint._near_far(o, d, bbmin, bbmax, st.min_near)
    thit = near < 1e30
    t0 = jnp.min(jnp.where(thit, near, jnp.inf), axis=1)
    t1 = jnp.max(jnp.where(thit, far, -jnp.inf), axis=1)
    hit = jnp.isfinite(t0)
    t0 = jnp.where(hit, t0, 1.0)
    t1 = jnp.where(hit, jnp.maximum(t1, t0 + 1e-3), 1.001)
    ax = jnp.stack([jnp.mean(d[i], 1) for i in range(3)], 1)
    ax = ax / jnp.linalg.norm(ax, axis=1, keepdims=True)
    cand, bs, _, t0, t1 = jtk.prep_candidates(
        pack, p_def, jnp.broadcast_to(o, (n_tiles, 3)), ax,
        jnp.full((n_tiles,), 16 * 0.75 / intr[0]), t0, t1, n_cand=P,
        n_bins=K + 2, beam_margin=jbb.margin_of(bst))
    dirs = jnp.zeros((n_tiles, 8, 256), jnp.float32)
    for i in range(3):
        dirs = dirs.at[:, i, :].set(d[i])
    # the last slot stays inactive: the kernel must write it as zeros
    tile_sc = jnp.zeros((n_tiles, 8), jnp.float32)
    tile_sc = tile_sc.at[:, 0].set(t0).at[:, 1].set(t1)
    tile_sc = tile_sc.at[:-1, 2].set(hit[:-1].astype(jnp.float32))
    params = jnp.zeros((24,), jnp.float32)
    params = params.at[0:3].set(o).at[3:6].set(bbmin).at[6:9].set(bbmax)
    params = params.at[9].set(1e-2).at[10].set(1.0).at[11].set(bst.ip_dx)
    params = params.at[12].set(0.05).at[19].set(0.5)
    params = params.at[20].set(jbb.reach_of(bst))
    return tuple(np.asarray(a) for a in (tile_sc, bs, params, dirs, cand))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_render_tiles_plain_matches_pallas_interpret(dtype):
    Wn, P = 32, 128
    ins = _inputs(Wn, P)
    jspec = jnet.make_spec(bound=1.0, backbone="mlp", compute_dtype=dtype)
    params = jnet.init_params(jax.random.PRNGKey(3), jspec)
    jpw = jfk.pack_weights(params, jspec)
    kw = dict(K=K, Ks=KS, Ksb=KSB, Wn=Wn, num_seek=3)
    jout = np.asarray(jtk.render_tiles(
        jspec, jpw, *(jnp.asarray(a) for a in ins), deformed=True,
        interpret=True, **kw))
    tspec = tnet.make_spec(bound=1.0, compute_dtype=dtype)
    tpw = torch.from_numpy(np.array(jpw))
    tout = ttk.render_tiles(tspec, tpw,
                            *(torch.from_numpy(np.array(a)) for a in ins),
                            **kw).numpy()
    assert tout.shape == jout.shape
    assert jout[:, 4].max() > 0.1            # real coverage, not empty
    assert jout[:, 5, 0].sum() > 0           # window overflow exercised
    np.testing.assert_array_equal(tout[-1], 0.0)   # inactive slot
    if dtype == "float32":
        # f32 summation order in the MLP and composite
        np.testing.assert_allclose(tout[:, 0:5], jout[:, 0:5], atol=1e-5)
    else:
        # bf16 layers: a flipped bf16 ulp moves a sample's color ~1e-2
        np.testing.assert_allclose(tout[:, 0:5], jout[:, 0:5], atol=2e-2)
    # the dropped count follows the same executed segments
    np.testing.assert_array_equal(tout[:, 5], jout[:, 5])


def test_render_tiles_checks_shapes():
    tspec = tnet.make_spec(bound=1.0)
    pw = torch.zeros((7, 64, 64))
    A, P = 2, 32
    args = (torch.zeros((A, 8)), torch.zeros((A, K + 4), dtype=torch.int32),
            torch.zeros(24), torch.ones((A, 8, 256)), torch.zeros((A, P, 16)))
    with pytest.raises(ValueError):
        ttk.render_tiles(tspec, pw, *args, K=K, Ks=KS, Ksb=KSB, Wn=64,
                         num_seek=3)
    out = ttk.render_tiles(tspec, pw, *args, K=K, Ks=KS, Ksb=KSB, Wn=32,
                           num_seek=3)
    assert torch.equal(out, torch.zeros((A, 8, 256)))   # all inactive
    with pytest.raises(NotImplementedError):
        tfk.check_kernel_spec(tnet.make_spec(hidden_dim=32), pw)
