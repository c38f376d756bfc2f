"""Port parity of the static render paths against the JAX package (CPU):
Morton codes, the occupancy grid, the lattice march, the static renderer
and the hierarchical renderer. Seeded numpy inputs go through both; each
tolerance is stated where it is checked."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pienerf_tpu.data import rays as jrays
from pienerf_tpu.models import hash_encoder as jhe
from pienerf_tpu.models import network as jnet
from pienerf_tpu.ops import grid as jgrid
from pienerf_tpu.ops import morton as jmorton
from pienerf_tpu.ops import raymarch as jrm
from pienerf_tpu.render import fast as jfast
from pienerf_tpu.render import renderer as jren
from pienerf_tpu_torch.data import rays as trays
from pienerf_tpu_torch.models import hash_encoder as the
from pienerf_tpu_torch.models import network as tnet
from pienerf_tpu_torch.ops import grid as tgrid
from pienerf_tpu_torch.ops import morton as tmorton
from pienerf_tpu_torch.ops import raymarch as trm
from pienerf_tpu_torch.render import fast as tfast
from pienerf_tpu_torch.render import renderer as tren
from pienerf_tpu_torch.weights import field_from_numpy

T = torch.as_tensor


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


def u32(words):
    """A bitfield's words as uint32, whichever signed type holds them."""
    return np.asarray(A(words)).view(np.uint32)


# ---- shared small scenes ---------------------------------------------------

def small_specs(levels=4, log2m=12, bg_radius=-1.0):
    """A 4-level hash grid (dense coarse levels, hashed fine ones) and the
    2-layer hashgrid nets, as JAX and port specs."""
    kw = dict(num_levels=levels, log2_hashmap_size=log2m,
              desired_resolution=256)
    jgrid_bg = tgrid_bg = None
    if bg_radius > 0:
        bkw = dict(input_dim=2, num_levels=4, desired_resolution=2048)
        jgrid_bg, tgrid_bg = jhe.make_spec(**bkw), the.make_spec(**bkw)
    jspec = jnet.NetworkSpec(grid=jhe.make_spec(**kw), backbone="hashgrid",
                             num_layers=2, bg_radius=bg_radius,
                             grid_bg=jgrid_bg)
    tspec = tnet.NetworkSpec(grid=the.make_spec(**kw), backbone="hashgrid",
                             num_layers=2, bg_radius=bg_radius,
                             grid_bg=tgrid_bg)
    return jspec, tspec


def np_params(tspec, seed=0, emb_scale=1.0):
    """Seeded numpy weights for a spec: Kaiming-uniform nets, embeddings
    from U(-emb_scale, emb_scale)."""
    rng = np.random.RandomState(seed)
    sd, cd = tnet.layer_dims(tspec)

    def lay(dims):
        return [(rng.uniform(-1, 1, (a, b)) * np.sqrt(3.0 / a)).astype(
            np.float32) for a, b in zip(dims, dims[1:])]
    p = {"sigma_net": lay(sd), "color_net": lay(cd)}
    if tspec.backbone == "hashgrid":
        p["encoder"] = (rng.uniform(-1, 1, (tspec.grid.total_params,
                                            tspec.grid.level_dim))
                        * emb_scale).astype(np.float32)
    if tspec.bg_radius > 0:
        p["bg_net"] = lay(tnet.bg_dims(tspec))
        p["encoder_bg"] = rng.uniform(-1, 1, (tspec.grid_bg.total_params,
                                              2)).astype(np.float32)
    return p


def jparams(p):
    return jax.tree_util.tree_map(jnp.asarray, p)


def sphere_density(r0=0.45):
    def jfn(x):
        return jnp.where(jnp.linalg.norm(x, axis=-1) <= r0, 50.0, 0.0)

    def tfn(x):
        return torch.where(torch.linalg.norm(x, dim=-1) <= r0, 50.0, 0.0)
    return jfn, tfn


def jax_full_noise(key, cascade, chunk=2 ** 18):
    """The U(-1, 1) jitter JAX's full grid.update draws, in its key order."""
    h3 = jgrid.GRID_SIZE ** 3
    out = []
    for _ in range(cascade):
        parts = []
        for _s in range(0, h3, chunk):
            key, k = jax.random.split(key)
            parts.append(np.asarray(jax.random.uniform(
                k, (chunk, 3), minval=-1, maxval=1)))
        out.append(np.concatenate(parts))
    return np.stack(out)


@pytest.fixture(scope="module")
def sphere_grid():
    """The JAX tests' sphere occupancy (cascade 1), one full update on each
    side from JAX's draws."""
    jfn, tfn = sphere_density()
    key = jax.random.PRNGKey(1)
    jg = jgrid.update(jgrid.init(1), jfn, 1.0, density_thresh=10.0, rng=key)
    tg = tgrid.update(tgrid.init(1), tfn, 1.0, density_thresh=10.0,
                      noise=T(jax_full_noise(key, 1)))
    return jg, tg


def camera(H=40, W=40, z=-2.5, f=60.0):
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (0.0, 0.0, z)
    intr = (f, f, W / 2, H / 2)
    return pose, intr


# ---- Morton codes: exact ---------------------------------------------------

def test_morton_codes_and_inverse_equal_jax():
    rng = np.random.RandomState(0)
    x, y, z = (rng.randint(0, 1024, 5000).astype(np.int32) for _ in range(3))
    want = A(jmorton.morton3d(x, y, z))
    np.testing.assert_array_equal(A(tmorton.morton3d(T(x), T(y), T(z))),
                                  want)
    np.testing.assert_array_equal(tmorton.morton3d_np(x, y, z), want)
    for a, b in zip(tmorton.morton3d_invert(T(want)),
                    jmorton.morton3d_invert(want)):
        np.testing.assert_array_equal(A(a), A(b))


# ---- occupancy grid --------------------------------------------------------

def test_packbits_and_occupied_equal_jax():
    """Exact: the words bit for bit, and every bit test."""
    rng = np.random.RandomState(0)
    density = rng.rand(2, 128 ** 3).astype(np.float32)
    jbf = jgrid.packbits(jnp.asarray(density), jnp.float32(0.5))
    tbf = tgrid.packbits(T(density), 0.5)
    np.testing.assert_array_equal(u32(tbf), u32(jbf))
    lvl = rng.randint(0, 2, 4000).astype(np.int32)
    code = rng.randint(0, 128 ** 3, 4000).astype(np.int32)
    np.testing.assert_array_equal(
        A(tgrid.occupied(tbf, T(lvl), T(code))),
        A(jgrid.occupied(jbf, jnp.asarray(lvl), jnp.asarray(code))))


def test_grid_full_update_equals_jax(sphere_grid):
    """From JAX's draws: density, mean and bitfield exact."""
    jg, tg = sphere_grid
    np.testing.assert_array_equal(A(tg.density), A(jg.density))
    assert float(tg.mean_density) == float(jg.mean_density)
    np.testing.assert_array_equal(u32(tg.bitfield), u32(jg.bitfield))
    assert int(tg.iter_density) == int(jg.iter_density) == 1
    assert u32(tg.bitfield).any()


def test_grid_partial_update_equals_jax(sphere_grid):
    """Past the full-update threshold: random cells from JAX's draws.
    Exact at every cell drawn at most once; a cell drawn more than once
    takes one of its draws, and the two libraries' scatters need not pick
    the same one (about 0.2% of the cells are drawn twice; only they may
    differ)."""
    jg, tg = sphere_grid
    jfn, tfn = sphere_density(0.3)
    jg = jg._replace(iter_density=jnp.int32(16))
    tg = tg._replace(iter_density=torch.tensor(16))
    key = jax.random.PRNGKey(7)
    _, k1, k2 = jax.random.split(key, 3)
    n = 128 ** 3 // 2
    coords = np.asarray(jax.random.randint(k1, (n, 3), 0, 128, jnp.int32))
    noise = np.asarray(jax.random.uniform(k2, (n, 3), minval=-1, maxval=1))
    jg2 = jgrid.update(jg, jfn, 1.0, density_thresh=10.0, rng=key)
    tg2 = tgrid.update(tg, tfn, 1.0, density_thresh=10.0,
                       coords=T(coords)[None], noise=T(noise)[None])
    codes = jmorton.morton3d_np(*coords.T)
    once = np.bincount(codes, minlength=128 ** 3) <= 1
    td, jd = A(tg2.density)[0], A(jg2.density)[0]
    np.testing.assert_array_equal(td[once], jd[once])
    assert (td != jd).sum() <= (~once).sum() // 100 + 100
    bits = [np.unpackbits(u32(g.bitfield).view(np.uint8), bitorder="little")
            for g in (tg2, jg2)]
    np.testing.assert_array_equal(bits[0][once], bits[1][once])
    # drawn from a generator instead, the update runs and marks cells
    g = torch.Generator().manual_seed(0)
    tg3 = tgrid.update(tg, tfn, 1.0, density_thresh=10.0, generator=g)
    assert int(tg3.iter_density) == 17 and u32(tg3.bitfield).any()


def test_mark_untrained_equals_jax():
    poses = np.stack([camera(z=-2.5)[0], camera(z=2.0)[0]])
    poses[1, :3, :3] = np.diag([-1.0, 1.0, -1.0])
    intr = (60.0, 60.0, 20.0, 20.0)
    jd = A(jgrid.mark_untrained(jgrid.init(1), poses, intr, 0.8).density)
    td = A(tgrid.mark_untrained(tgrid.init(1), poses, intr, 0.8).density)
    np.testing.assert_array_equal(td, jd)
    assert (td == -1).any() and (td == 0).any()


# ---- rays and the lattice march --------------------------------------------

def test_rays_near_far_and_sphere_coords_match_jax():
    """Rays and slab tests within 1e-6 absolute (a 3-term dot product in
    either library's order); misses equal."""
    pose, intr = camera(H=24, W=32)
    c, s = np.cos(0.15), np.sin(0.15)
    pose[:3, :3] = np.asarray([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]],
                              np.float32)
    jo, jd = jrays.get_rays_full(jnp.asarray(pose), intr, 24, 32)
    to, td = trays.get_rays_full(T(pose), intr, 24, 32)
    np.testing.assert_allclose(A(to), A(jo), atol=1e-6)
    np.testing.assert_allclose(A(td), A(jd), atol=1e-6)
    aabb = np.asarray([-0.5, -0.4, -0.3, 0.5, 0.4, 0.3], np.float32)
    jn, jf = jrm.near_far_from_aabb(jo, jd, jnp.asarray(aabb), 0.05)
    tn, tf = trm.near_far_from_aabb(T(A(jo)), T(A(jd)), T(aabb), 0.05)
    np.testing.assert_allclose(A(tn), A(jn), rtol=1e-6)
    np.testing.assert_allclose(A(tf), A(jf), rtol=1e-6)
    assert (A(jn) > 1e30).any() and (A(jn) < 1e30).any()
    np.testing.assert_allclose(
        A(trm.sph_from_ray(T(A(jo)), T(A(jd)), 3.0)),
        A(jrm.sph_from_ray(jo, jd, 3.0)), atol=1e-6)


@pytest.mark.parametrize("gamma", [0.0, 1.0 / 128, 1.0 / 64])
def test_t_lattice_matches_jax(gamma):
    """Exact at dt_gamma 0; at dt_gamma > 0 within 1e-6 relative (exp and
    log may round differently by an ulp)."""
    rng = np.random.RandomState(1)
    t0 = rng.uniform(0.05, 4.0, 64).astype(np.float32)
    dt_min = 2 * jrm.SQRT3 / 1024
    dt_max = 2 * jrm.SQRT3 * 2 / 128
    jt, jdt = jrm.t_lattice(jnp.asarray(t0), 300, gamma, dt_min, dt_max)
    tt, tdt = trm.t_lattice(T(t0), 300, gamma, dt_min, dt_max)
    if gamma == 0.0:
        np.testing.assert_array_equal(A(tt), A(jt))
        np.testing.assert_array_equal(A(tdt), A(jdt))
    else:
        np.testing.assert_allclose(A(tt), A(jt), rtol=1e-6, atol=0)
        np.testing.assert_allclose(A(tdt), A(jdt), rtol=1e-6, atol=0)


def test_mip_level_equals_jax():
    rng = np.random.RandomState(2)
    x = (rng.randn(5000, 3) * rng.choice([0.1, 0.6, 1.5, 3.0], (5000, 1))
         ).astype(np.float32)
    dt = rng.uniform(1e-3, 0.2, 5000).astype(np.float32)
    for cascade in (1, 3, 5):
        want = A(jrm.mip_level(jnp.asarray(x), jnp.asarray(dt), cascade))
        np.testing.assert_array_equal(
            A(trm.mip_level(T(x), T(dt), cascade)), want)
        np.testing.assert_array_equal(
            A(trm.mip_level_c(*(T(x[:, i]) for i in range(3)), T(dt),
                              cascade)), want)


def test_compact_samples_equals_jax():
    rng = np.random.RandomState(3)
    valid = rng.rand(37, 90) > 0.6
    compact = jax.jit(jrm.compact_samples, static_argnums=1)
    for k in (8, 100):
        jidx, jmask = compact(jnp.asarray(valid), k)
        tidx, tmask = trm.compact_samples(T(valid), k)
        np.testing.assert_array_equal(A(tidx), A(jidx))
        np.testing.assert_array_equal(A(tmask), A(jmask))


def test_composite_matches_jax():
    """Within 1e-6 absolute (scan order)."""
    rng = np.random.RandomState(4)
    n, k = 33, 40
    sig = (rng.rand(n, k) * 30).astype(np.float32)
    rgb = rng.rand(n, k, 3).astype(np.float32)
    dts = rng.uniform(0.002, 0.03, (n, k)).astype(np.float32)
    ts = np.cumsum(dts, 1) + 0.5
    mask = np.arange(k)[None] < rng.randint(0, k + 1, n)[:, None]
    want = jax.jit(jrm.composite)(*(jnp.asarray(a) for a in (
        sig, rgb, dts, ts, mask)))
    got = trm.composite(*(T(a) for a in (sig, rgb, dts, ts, mask)), 1e-2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(A(g), A(w), atol=1e-6)


def test_march_lattice_matches_jax(sphere_grid):
    """Cascade 2, dt_gamma > 0 and a perturbed start: t within 1e-6
    relative and the valid mask equal but for bits an ulp of t flips at a
    cell edge or at far (counted and bounded: at most 1 in 10^4)."""
    jg, tg = sphere_grid
    bf = np.concatenate([u32(jg.bitfield)] * 2)
    pose, intr = camera(H=16, W=16, f=24.0)
    jo, jd = jrays.get_rays_full(jnp.asarray(pose), intr, 16, 16)
    n = jo.shape[0]
    aabb = jnp.asarray([-2.0] * 3 + [2.0] * 3, jnp.float32)
    jn, jf = jrm.near_far_from_aabb(jo, jd, aabb, 0.05)
    noise = np.random.RandomState(5).rand(n).astype(np.float32)
    march = jax.jit(jrm.march_lattice, static_argnums=(5, 6, 7, 8, 9))
    jt, jdt, jv = march(jo, jd, jn, jf, jnp.asarray(bf), 2.0, 2, 384,
                        1.0 / 128, 512, jnp.asarray(noise))
    tt, tdt, tv = trm.march_lattice(T(A(jo)), T(A(jd)), T(A(jn)), T(A(jf)),
                                    T(bf.view(np.int32)), 2.0, 2, 384,
                                    1.0 / 128, 512, noise=T(noise))
    np.testing.assert_allclose(A(tt), A(jt), rtol=1e-6, atol=0)
    flips = int((A(tv) != A(jv)).sum())
    assert A(jv).sum() > 500
    assert flips <= A(jv).size // 10000, flips


# ---- the static renderer ---------------------------------------------------

def _render_both(sphere_grid, jspec, tspec, p, settings, perturb=False,
                 H=40, W=40, bg=1.0):
    jg, tg = sphere_grid
    pose, intr = camera(H=H, W=W)
    jo, jd = jrays.get_rays_full(jnp.asarray(pose), intr, H, W)
    key = jax.random.PRNGKey(3)
    jout = jren.render_rays(jparams(p), jspec, settings, jg.bitfield, jo, jd,
                            jnp.float32(bg), rng=key, perturb=perturb)
    noise = (T(np.asarray(jax.random.uniform(key, (H * W,))))
             if perturb else None)
    field = field_from_numpy(p, tspec, torch.device("cpu"))
    tset = tren.RenderSettings(**settings._asdict())
    tout = tren.render_rays(field, tset, tg.bitfield, T(A(jo)), T(A(jd)), bg,
                            perturb=perturb, noise=noise)
    return jout, tout, field, tset


@pytest.mark.parametrize("case", ["hashgrid", "hashgrid_perturb_bg",
                                  "mlp_cascade2_gamma"])
def test_render_rays_matches_jax(sphere_grid, case):
    """The whole static render: image within 1e-4 absolute, depth and
    weights within 1e-4 (the field's summation order)."""
    if case == "mlp_cascade2_gamma":
        jspec = jnet.make_spec(bound=1.0, backbone="mlp")
        tspec = tnet.make_spec(bound=1.0)
        st = jren.RenderSettings(bound=1.0, cascade=2, max_samples=48,
                                 max_steps=512, min_near=0.05,
                                 dt_gamma=1.0 / 256)
        sg = sphere_grid
        sphere_grid = (sg[0]._replace(bitfield=jnp.concatenate(
            [sg[0].bitfield] * 2)), sg[1]._replace(bitfield=torch.cat(
                [sg[1].bitfield] * 2)))
    else:
        bg_r = 3.0 if case == "hashgrid_perturb_bg" else -1.0
        jspec, tspec = small_specs(bg_radius=bg_r)
        st = jren.RenderSettings(bound=1.0, cascade=1, max_samples=48,
                                 max_steps=512, min_near=0.05,
                                 bg_radius=bg_r)
    p = np_params(tspec, seed=1, emb_scale=1.0)
    jout, tout, _, _ = _render_both(sphere_grid, jspec, tspec, p, st,
                                    perturb=case == "hashgrid_perturb_bg")
    img = A(jout["image"])
    assert np.isfinite(img).all() and img.std() > 1e-3
    for key in ("image", "depth_raw", "weights_sum", "depth"):
        np.testing.assert_allclose(A(tout[key]), A(jout[key]), atol=1e-4,
                                   err_msg=key)


def test_render_image_chunks_and_padding(sphere_grid):
    """render_image over uneven chunks (the last padded with 1.0) equals
    render_rays over all the rays at once, within 1e-6 (a chunk's live
    samples set the field's matmul shape, and the CPU library's summation
    order follows it)."""
    jspec, tspec = small_specs()
    p = np_params(tspec, seed=2)
    st = tren.RenderSettings(bound=1.0, max_samples=32, max_steps=256,
                             min_near=0.05)
    field = field_from_numpy(p, tspec, torch.device("cpu"))
    _, tg = sphere_grid
    pose, intr = camera(H=24, W=20)
    whole = tren.render_rays(field, st, tg.bitfield,
                             *trays.get_rays_full(T(pose), intr, 24, 20), 1.0)
    img = tren.render_image(field, st, tg, T(pose), intr, 24, 20, chunk=256)
    assert img["image"].shape == (24, 20, 3)
    np.testing.assert_allclose(A(img["image"]).reshape(-1, 3),
                               A(whole["image"]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(A(img["weights_sum"]).reshape(-1),
                               A(whole["weights_sum"]), atol=1e-6, rtol=0)


# ---- the hierarchical renderer ---------------------------------------------

def test_sample_pdf_matches_jax():
    """Within 1e-5 absolute on t in [0.5, 3] (the CDF's cumsum order moves
    a sample by a few ulps); the one-hot contractions equal gathers."""
    rng = np.random.RandomState(6)
    t_mid = np.sort(rng.uniform(0.5, 3.0, (20, 31)), 1).astype(np.float32)
    w = (rng.rand(20, 31) ** 4).astype(np.float32)
    u = rng.rand(20, 48).astype(np.float32)
    want = A(jax.jit(jfast.sample_pdf, static_argnums=2)(
        jnp.asarray(t_mid), jnp.asarray(w), 48, jnp.asarray(u)))
    np.testing.assert_allclose(A(tfast.sample_pdf(T(t_mid), T(w), 48, T(u))),
                               want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", ["hashgrid", "mlp_map_fn"])
def test_render_rays_fast_matches_jax(case):
    """With JAX's two draws (key_c, key_f) passed in: image, depth and
    weights within 1e-4 absolute."""
    if case == "mlp_map_fn":
        jspec = jnet.make_spec(bound=1.0, backbone="mlp")
        tspec = tnet.make_spec(bound=1.0)
    else:
        jspec, tspec = small_specs()
    p = np_params(tspec, seed=3, emb_scale=0.5)
    st = jfast.FastSettings(bound=1.0, num_coarse=24, num_fine=24)
    pose, intr = camera(H=20, W=20, f=30.0)
    jo, jd = jrays.get_rays_full(jnp.asarray(pose), intr, 20, 20)
    key = jax.random.PRNGKey(4)

    jmap = tmap = None
    if case == "mlp_map_fn":
        def jmap(xs):
            return (xs[0] + 0.1, xs[1], xs[2]), xs[1] > -0.2

        def tmap(xs):
            return (xs[0] + 0.1, xs[1], xs[2]), xs[1] > -0.2
    jout = jfast.render_rays_fast(jparams(p), jspec, st, jo, jd,
                                  jnp.float32(0.5), key, map_fn=jmap)
    kc, kf = jax.random.split(key)
    n = jo.shape[0]
    uc = T(np.asarray(jax.random.uniform(kc, (n, 24))))
    uf = T(np.asarray(jax.random.uniform(kf, (n, 24))))
    field = field_from_numpy(p, tspec, torch.device("cpu"))
    tout = tfast.render_rays_fast(
        field, tfast.FastSettings(**st._asdict()), T(A(jo)), T(A(jd)), 0.5,
        map_fn=tmap, u_coarse=uc, u_fine=uf)
    assert A(jout["weights_sum"]).max() > 0.05
    for k in ("image", "depth_raw", "weights_sum"):
        np.testing.assert_allclose(A(tout[k]), A(jout[k]), atol=1e-4,
                                   err_msg=k)


def test_render_image_fast_draws_and_generator():
    """Passed draws give the same frame whatever the chunk; a generator's
    draws give a finite frame of the right shape."""
    jspec, tspec = small_specs()
    field = field_from_numpy(np_params(tspec, seed=4), tspec,
                             torch.device("cpu"))
    st = tfast.FastSettings(num_coarse=16, num_fine=16)
    pose, intr = camera(H=18, W=20, f=30.0)
    g = torch.Generator().manual_seed(0)
    draws = tfast.draw(18 * 20, st, g, torch.device("cpu"))
    a = tfast.render_image_fast(field, st, T(pose), intr, 18, 20,
                                draws=draws, chunk=256)
    b = tfast.render_image_fast(field, st, T(pose), intr, 18, 20,
                                draws=draws, chunk=4096)
    assert torch.equal(a["image"], b["image"])
    c = tfast.render_image_fast(field, st, T(pose), intr, 18, 20,
                                generator=torch.Generator().manual_seed(1))
    assert c["image"].shape == (18, 20, 3)
    assert bool(torch.isfinite(c["image"]).all())
