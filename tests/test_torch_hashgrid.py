"""Port parity of the hash-grid field against the JAX package (CPU): the
encoder's layout and encode, the hashgrid backbone and background net of
the field, and the reference's .pth checkpoint layout. Seeded numpy
inputs go through both; each tolerance is stated where it is checked."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pienerf_tpu.io import checkpoint as jck
from pienerf_tpu.models import hash_encoder as jhe
from pienerf_tpu.models import network as jnet
from pienerf_tpu_torch.io import checkpoint as tck
from pienerf_tpu_torch.models import hash_encoder as the
from pienerf_tpu_torch.models import network as tnet
from pienerf_tpu_torch.weights import field_from_numpy

T = torch.as_tensor
CPU = torch.device("cpu")


def A(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def unit(rng, n):
    d = rng.randn(n, 3).astype(np.float32)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


# the hash encode: within 1e-5 relative, with embeddings from U(-1, 1) so
# that a wrong row cannot hide under the 1e-4 initial scale (features are
# O(1); 1e-6 absolute covers values near zero)
ENC_RTOL, ENC_ATOL = 1e-5, 1e-6

SPECS = {
    # dense coarse levels, hashed fine ones, at two bounds
    "mixed": dict(num_levels=4, log2_hashmap_size=12,
                  desired_resolution=256),
    # every level hashed (base 4, table 2^7)
    "hashed": dict(num_levels=4, base_resolution=4, log2_hashmap_size=7,
                   desired_resolution=None, per_level_scale=2.0),
    "smoothstep": dict(num_levels=4, log2_hashmap_size=10,
                       desired_resolution=128, interpolation="smoothstep"),
    # the background's 2-D grid
    "bg2d": dict(input_dim=2, num_levels=4, desired_resolution=2048),
}


def test_spec_layout_equals_jax():
    for kw in list(SPECS.values()) + [dict(desired_resolution=2048 * 2.0),
                                      dict()]:
        assert tuple(the.make_spec(**kw)) == tuple(jhe.make_spec(**kw)), kw


@pytest.mark.parametrize("name,bound", [("mixed", 1.0), ("mixed", 2.0),
                                        ("hashed", 1.0),
                                        ("smoothstep", 1.0),
                                        ("bg2d", 1.0)])
def test_encode_matches_jax(name, bound):
    kw = SPECS[name]
    js, ts = jhe.make_spec(**kw), the.make_spec(**kw)
    D = js.input_dim
    rng = np.random.RandomState(0)
    emb = rng.uniform(-1, 1, (js.total_params, js.level_dim)).astype(
        np.float32)
    x = rng.uniform(-bound, bound, (3000, D)).astype(np.float32)
    x[:40] *= 1.3                                  # some outside the box
    # JAX's encode op by op: under jit XLA may fuse x * scale + 0.5 into
    # one rounding, and the finest levels move by scale x 1 ulp
    want = A(jhe.encode(jnp.asarray(emb), js, jnp.asarray(x), bound))
    got = A(the.encode(T(emb), ts, T(x), bound))
    np.testing.assert_allclose(got, want, rtol=ENC_RTOL, atol=ENC_ATOL)
    oob = (np.abs(x) > bound).any(axis=1)
    assert oob.any() and (got[oob] == 0).all() and (got[~oob] != 0).any()
    # the component form and the feature-major layout
    comps = tuple(T(x[:, i].copy()) for i in range(D))
    np.testing.assert_array_equal(
        A(the.encode(T(emb), ts, comps, bound, feature_major=True)), got.T)
    if name == "hashed":
        np.testing.assert_allclose(got[:64], jhe.encode_np(
            emb, js, x[:64], bound), rtol=2e-5, atol=2e-6)


def test_full_spec_encode_matches_jax():
    """The package's default grid (16 levels x 2, 2^19 a level,
    desired_resolution 2048) on 4,096 points."""
    js = jhe.make_spec(desired_resolution=2048)
    ts = the.make_spec(desired_resolution=2048)
    rng = np.random.RandomState(1)
    emb = rng.uniform(-1, 1, (js.total_params, 2)).astype(np.float32)
    x = rng.uniform(-1, 1, (4096, 3)).astype(np.float32)
    want = A(jhe.encode(jnp.asarray(emb), js, jnp.asarray(x), 1.0))
    got = A(the.encode(T(emb), ts, T(x), 1.0))
    np.testing.assert_allclose(got, want, rtol=ENC_RTOL, atol=ENC_ATOL)


def test_init_embeddings_seeded_and_in_range():
    spec = the.make_spec(**SPECS["mixed"])
    a = the.init_embeddings(spec, torch.Generator().manual_seed(3))
    b = the.init_embeddings(spec, torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and a.shape == (spec.total_params, 2)
    assert float(a.abs().max()) <= 1e-4 and float(a.abs().max()) > 5e-5


def _small_net_specs(bg_radius=-1.0):
    kw = SPECS["mixed"]
    jbg = tbg = None
    if bg_radius > 0:
        jbg, tbg = (m.make_spec(**SPECS["bg2d"]) for m in (jhe, the))
    return (jnet.NetworkSpec(grid=jhe.make_spec(**kw), backbone="hashgrid",
                             num_layers=2, bg_radius=bg_radius, grid_bg=jbg),
            tnet.NetworkSpec(grid=the.make_spec(**kw), backbone="hashgrid",
                             num_layers=2, bg_radius=bg_radius, grid_bg=tbg))


def _np_tree(tspec, seed):
    rng = np.random.RandomState(seed)
    sd, cd = tnet.layer_dims(tspec)

    def lay(dims):
        return [(rng.uniform(-1, 1, (a, b)) * np.sqrt(3.0 / a)).astype(
            np.float32) for a, b in zip(dims, dims[1:])]
    p = {"sigma_net": lay(sd), "color_net": lay(cd),
         "encoder": rng.uniform(-1, 1, (tspec.grid.total_params, 2)).astype(
             np.float32)}
    if tspec.bg_radius > 0:
        p["bg_net"] = lay(tnet.bg_dims(tspec))
        p["encoder_bg"] = rng.uniform(
            -1, 1, (tspec.grid_bg.total_params, 2)).astype(np.float32)
    return p


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hashgrid_field_and_background_match_jax(dtype):
    """sigma within 1e-5 relative and rgb within 1e-5 absolute in f32; in
    bf16 (every layer rounded) rgb within 2e-2 and the median sigma
    within 1e-2 relative, a bf16 ulp flip apart at most."""
    jspec, tspec = _small_net_specs(bg_radius=3.0)
    jspec = jspec._replace(compute_dtype=dtype)
    tspec = tspec._replace(compute_dtype=dtype)
    p = _np_tree(tspec, 0)
    field = field_from_numpy(p, tspec, CPU)
    rng = np.random.RandomState(2)
    x = rng.uniform(-1, 1, (2048, 3)).astype(np.float32)
    d = unit(rng, 2048)
    js, jc = jax.jit(jnet.forward, static_argnums=1)(
        jax.tree_util.tree_map(jnp.asarray, p), jspec, jnp.asarray(x),
        jnp.asarray(d))
    ts_, tc = field(T(x), T(d))
    sph = rng.uniform(-1, 1, (2048, 2)).astype(np.float32)
    jb = jax.jit(jnet.background, static_argnums=1)(
        jax.tree_util.tree_map(jnp.asarray, p), jspec, jnp.asarray(sph),
        jnp.asarray(d))
    tb = field.background(T(sph), T(d))
    if dtype == "float32":
        np.testing.assert_allclose(A(ts_), A(js), rtol=1e-5)
        np.testing.assert_allclose(A(tc), A(jc), atol=1e-5)
        np.testing.assert_allclose(A(tb), A(jb), atol=1e-5)
    else:
        np.testing.assert_allclose(A(tc), A(jc), atol=2e-2)
        np.testing.assert_allclose(A(tb), A(jb), atol=2e-2)
        rel = np.abs(A(ts_) - A(js)) / np.abs(A(js))
        assert np.median(rel) <= 1e-2, np.median(rel)


def test_make_spec_and_seeded_field():
    """make_spec's hashgrid default (the full grid, a 2-layer sigma net),
    the seeded field's draws, and the mlp default left as it was."""
    for bound in (1.0, 2.0):
        jspec = jnet.make_spec(bound=bound, bg_radius=4.0)
        tspec = tnet.make_spec(bound=bound, backbone="hashgrid",
                               bg_radius=4.0)
        assert tuple(tspec.grid) == tuple(jspec.grid)
        assert tuple(tspec.grid_bg) == tuple(jspec.grid_bg)
        assert tspec.num_layers == jspec.num_layers == 2
        assert tnet.layer_dims(tspec)[0] == [32, 64, 16]
    mlp = tnet.make_spec(bound=1.0)
    assert mlp.backbone == "mlp" and mlp.num_layers == 4 and mlp.grid is None
    g = torch.Generator().manual_seed(5)
    f = tnet.FieldMLP(tnet.make_spec(backbone="hashgrid"), generator=g)
    assert f.encoder.shape == (jnet.make_spec().grid.total_params, 2)
    assert float(f.encoder.abs().max()) <= 1e-4
    # an mlp field of a seed draws its nets first and nothing more: its
    # first layer is the generator's first draw
    a = tnet.FieldMLP(mlp, generator=torch.Generator().manual_seed(5))
    bd = 1.0 / np.sqrt(51.0) * np.sqrt(3.0)   # FieldMLP's bound
    first = torch.rand((51, 64), generator=torch.Generator().manual_seed(5))
    assert not hasattr(a, "encoder")
    assert torch.equal(a.sigma_net[0], first * (2 * bd) - bd)


def test_torch_ngp_pth_both_ways(tmp_path):
    """A .pth written by JAX's save_torch_ngp reads back through the
    port's load_torch_ngp as equal arrays, and the port's export reads back
    through JAX's; the imported field renders JAX's values."""
    jspec, tspec = _small_net_specs(bg_radius=3.0)
    p = _np_tree(tspec, 1)
    extra = {"density_grid": np.random.RandomState(0).rand(
        1, 128 ** 3).astype(np.float32), "mean_density": 0.5, "epoch": 7}
    path = str(tmp_path / "ngp_ep0007.pth")
    jck.save_torch_ngp(path, jax.tree_util.tree_map(jnp.asarray, p), extra)
    tp, tex = tck.load_torch_ngp(path)
    assert sorted(tp) == sorted(p)
    for k in ("encoder", "encoder_bg"):
        np.testing.assert_array_equal(tp[k], p[k])
    for k in ("sigma_net", "color_net", "bg_net"):
        assert len(tp[k]) == len(p[k])
        for a, b in zip(tp[k], p[k]):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tex["density_grid"], extra["density_grid"])
    assert tex["epoch"] == 7 and tex["mean_density"] == 0.5

    path2 = str(tmp_path / "ngp_ep0008.pth")
    tck.save_torch_ngp(path2, tp, tex)
    jp, jex = jck.load_torch_ngp(path2)
    for a, b in zip(jax.tree_util.tree_leaves(jp),
                    jax.tree_util.tree_leaves(jax.tree_util.tree_map(
                        jnp.asarray, p))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(np.asarray(jex["density_grid"]),
                                  extra["density_grid"])

    field = field_from_numpy(tp, tspec, CPU)
    rng = np.random.RandomState(3)
    x = rng.uniform(-1, 1, (256, 3)).astype(np.float32)
    d = unit(rng, 256)
    js, jc = jax.jit(jnet.forward, static_argnums=1)(
        jp, jspec, jnp.asarray(x), jnp.asarray(d))
    ts_, tc = field(T(x), T(d))
    np.testing.assert_allclose(A(ts_), A(js), rtol=1e-5)
    np.testing.assert_allclose(A(tc), A(jc), atol=1e-5)
