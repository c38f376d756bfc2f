"""Port parity of training against the JAX package (CPU): trunc_exp's
gradient, the SH degrees, the hash encode's and the network's gradients,
the TV gradient, the optimizer against optax, one train step on each path
(the occupancy march with a hash grid, the hierarchical renderer with the
mlp), the EMA decay, the error map, the train state carried across both
ways, and checkpoints that each package's Trainer loads from the other.
Seeded numpy inputs go through both; where JAX draws inside, the test draws
with JAX's keys as the JAX code does and passes the draws to the port.
Each tolerance is stated where it is checked."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pienerf_tpu.config import PieNeRFConfig as JCfg
from pienerf_tpu.models import hash_encoder as jhe
from pienerf_tpu.models import network as jnet
from pienerf_tpu.models import sh_encoder as jsh
from pienerf_tpu.ops import grid as jgrid
from pienerf_tpu.render import fast as jfast
from pienerf_tpu.render import renderer as jren
from pienerf_tpu.train import trainer as jtr
from pienerf_tpu_torch import weights as W
from pienerf_tpu_torch.config import PieNeRFConfig as TCfg
from pienerf_tpu_torch.models import hash_encoder as the
from pienerf_tpu_torch.models import network as tnet
from pienerf_tpu_torch.models import sh_encoder as tsh
from pienerf_tpu_torch.render import renderer as tren
from pienerf_tpu_torch.train import optim as topt
from pienerf_tpu_torch.train import trainer as ttr

T = torch.as_tensor


def A(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


GRID_KW = dict(num_levels=4, log2_hashmap_size=12, desired_resolution=64)


def specs(backbone, dtype="float32"):
    """A small hash grid (dense coarse levels, hashed fine ones) or the
    default mlp, as JAX and port specs."""
    j = jnet.make_spec(bound=1.0, backbone=backbone, compute_dtype=dtype)
    t = tnet.make_spec(bound=1.0, backbone=backbone, compute_dtype=dtype)
    if backbone == "hashgrid":
        j = j._replace(grid=jhe.make_spec(**GRID_KW))
        t = t._replace(grid=the.make_spec(**GRID_KW))
    return j, t


def jparams(jspec, seed=0):
    p = jnet.init_params(jax.random.PRNGKey(seed), jspec)
    if "encoder" in p:          # embeddings with structure, not ~1e-4
        p["encoder"] = p["encoder"] * 1000.0
    return p


# ---- gradients of the model ------------------------------------------------

def test_trunc_exp_gradient_is_the_clamped_exp():
    """The JAX custom VJP g * exp(clip(x, -15, 15)), beyond +-15 too
    (a plain clamp would give 0 there); 1e-6 relative."""
    x = np.array([-40.0, -15.1, 0.0, 14.9, 15.1, 40.0], np.float32)
    jg = np.asarray(jax.grad(lambda v: jnp.sum(jnet.trunc_exp(v) * 0.5))(
        jnp.asarray(x)))
    xt = T(x).requires_grad_()
    (tnet.trunc_exp(xt) * 0.5).sum().backward()
    np.testing.assert_allclose(A(xt.grad), jg, rtol=1e-6)
    assert A(xt.grad)[-1] > 1e6            # a raw 40 is still pulled down
    np.testing.assert_allclose(A(tnet.trunc_exp(T(x))),
                               np.asarray(jnet.trunc_exp(jnp.asarray(x))),
                               rtol=1e-6)


@pytest.mark.parametrize("degree", range(1, 9))
def test_sh_degrees_and_their_gradients(degree):
    """Every degree 1-8 against JAX's basis (values 1e-6 relative to the
    largest, gradients of a weighted sum likewise)."""
    rs = np.random.RandomState(degree)
    d = rs.randn(200, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    c = rs.randn(200, degree ** 2).astype(np.float32)
    jv = np.asarray(jsh.sh_encode(jnp.asarray(d), degree))
    dt = T(d).requires_grad_()
    tv = tsh.sh_encode(dt, degree)
    np.testing.assert_allclose(A(tv), jv, atol=1e-6 * np.abs(jv).max())
    jg = np.asarray(jax.grad(lambda v: jnp.sum(
        jsh.sh_encode(v, degree) * c))(jnp.asarray(d)))
    if degree == 1:                 # the constant band: no gradient
        assert not tv.requires_grad and not jg.any()
        return
    (tv * T(c)).sum().backward()
    np.testing.assert_allclose(A(dt.grad), jg, atol=1e-6 * np.abs(jg).max())


def test_hash_encode_gradient_is_the_scatter_add():
    """The encode's gradient with respect to the embeddings (autograd's
    accumulating index_put_) against jax.grad of the gather, op by op;
    1e-6 of the largest entry. Out-of-box inputs add nothing."""
    grid = jhe.make_spec(**GRID_KW)
    tgrid = the.make_spec(**GRID_KW)
    rs = np.random.RandomState(3)
    emb = rs.uniform(-1, 1, (grid.total_params, 2)).astype(np.float32)
    x = rs.uniform(-1.05, 1.05, (3000, 3)).astype(np.float32)
    cot = rs.randn(3000, grid.output_dim).astype(np.float32)
    jg = np.asarray(jax.grad(lambda e: jnp.sum(
        jhe.encode(e, grid, jnp.asarray(x), 1.0) * cot))(jnp.asarray(emb)))
    et = T(emb).requires_grad_()
    (the.encode(et, tgrid, T(x), 1.0) * T(cot)).sum().backward()
    np.testing.assert_allclose(A(et.grad), jg, atol=1e-6 * np.abs(jg).max())
    assert (jg != 0).sum() > 1000


def test_total_variation_gradient():
    """grad_total_variation against JAX's and the numpy oracle of the
    reference kernel, on a hashed and a dense level (1e-6 relative)."""
    kw = dict(num_levels=3, log2_hashmap_size=9, desired_resolution=32,
              base_resolution=4)
    grid, tgrid = jhe.make_spec(**kw), the.make_spec(**kw)
    rs = np.random.RandomState(4)
    emb = rs.uniform(-1, 1, (grid.total_params, 2)).astype(np.float32)
    x = rs.uniform(-1.02, 1.02, (400, 3)).astype(np.float32)
    jv = np.asarray(jhe.grad_total_variation(jnp.asarray(emb), grid,
                                             jnp.asarray(x), 1e-3))
    tv = A(the.grad_total_variation(T(emb), tgrid, T(x), 1e-3))
    ov = the.tv_grad_np(emb, tgrid, x, 1e-3)
    scale = np.abs(jv).max()
    np.testing.assert_allclose(tv, jv, atol=1e-6 * scale)
    np.testing.assert_allclose(tv, ov, atol=1e-6 * scale)
    np.testing.assert_allclose(the.encode_np(emb, tgrid, x[:50]),
                               jhe.encode_np(emb, grid, x[:50]), rtol=0)


@pytest.mark.parametrize("backbone", ["mlp", "hashgrid"])
def test_network_gradients(backbone):
    """d(sum c1 sigma + sum c2 rgb)/d(every parameter), f32, against
    jax.grad: 1e-6 of each leaf's largest entry on the hash grid, 5e-6 on
    the mlp, whose inputs are sin / cos at up to 2^7 pi x, where the two
    libraries' f32 sin differs in the last place (measured 2.4e-6 on the
    first layer, 1.4e-6 on the second)."""
    jspec, tspec = specs(backbone)
    p = jparams(jspec)
    rs = np.random.RandomState(5)
    x = rs.uniform(-1, 1, (500, 3)).astype(np.float32)
    d = rs.randn(500, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    c1 = rs.rand(500).astype(np.float32) * 1e-3
    c2 = rs.randn(500, 3).astype(np.float32)

    def jloss(pp):
        s, rgb = jnet.forward(pp, jspec, jnp.asarray(x), jnp.asarray(d))
        return jnp.sum(s * c1) + jnp.sum(rgb * c2)

    jg = W._tree_leaves(jax.grad(jloss)(p))
    field = W.field_from_numpy(p, tspec, "cpu", trainable=True)
    s, rgb = field(T(x), T(d))
    tg = torch.autograd.grad((s * T(c1)).sum() + (rgb * T(c2)).sum(),
                             field.leaves())
    assert len(jg) == len(tg)
    tol = 5e-6 if backbone == "mlp" else 1e-6
    for a, b in zip(jg, tg):
        a = np.asarray(a)
        np.testing.assert_allclose(A(b), a, atol=tol * np.abs(a).max())


def test_init_params_layout_and_law():
    """init_params: JAX's tree layout and shapes, each layer inside its
    Kaiming-uniform bound and spread across it."""
    for backbone in ("mlp", "hashgrid"):
        jspec, tspec = specs(backbone)
        jp = jnet.init_params(jax.random.PRNGKey(0), jspec)
        tp = tnet.init_params(torch.Generator().manual_seed(0), tspec)
        assert sorted(jp) == sorted(tp)
        for a, b in zip(W._tree_leaves(jp), W._tree_leaves(tp)):
            assert tuple(a.shape) == tuple(b.shape)
            bd = (np.sqrt(3.0 / a.shape[0]) if a.shape[0] < 10000
                  else 1e-4)
            assert float(b.abs().max()) <= bd
            assert float(b.abs().max()) > 0.9 * bd
            assert not b.requires_grad


# ---- the optimizer ---------------------------------------------------------

@pytest.mark.parametrize("max_errors", [100, 2])
def test_optimizer_matches_optax(max_errors):
    """apply_if_finite(adam(exponential_decay)) against optax itself over
    30 gradients spanning 9 decades with non-finite entries, one a run of
    four in a row (max_errors 2 reaches the apply-anyway branch): params
    within 1e-6 of their scale, every count equal."""
    rs = np.random.RandomState(0)
    shapes = [(5, 4), (7,), (3, 3)]
    p0 = [rs.randn(*s).astype(np.float32) for s in shapes]
    ox = optax.apply_if_finite(optax.adam(optax.exponential_decay(
        1e-2, 50, 0.1), b1=0.9, b2=0.99, eps=1e-15),
        max_consecutive_errors=max_errors)
    opt = topt.Adam(1e-2, 50, 0.1, max_consecutive_errors=max_errors)
    jupdate = jax.jit(ox.update)
    jp = [jnp.asarray(a) for a in p0]
    js = ox.init(jp)
    tp = [T(a.copy()) for a in p0]
    ts = opt.init(tp)
    for i in range(30):
        g = [rs.randn(*s).astype(np.float32) * 10 ** rs.uniform(-8, 1)
             for s in shapes]
        if i in (3, 10, 11, 12, 13, 20):
            g[1][2] = np.nan if i % 2 else np.inf
        u, js = jupdate([jnp.asarray(a) for a in g], js, jp)
        jp = optax.apply_updates(jp, u)
        tu, ts = opt.update([T(a) for a in g], ts)
        topt.apply_updates(tp, tu)
        for a, b in zip(jp, tp):
            a = np.asarray(a)
            fin = np.isfinite(a)
            assert (fin == np.isfinite(A(b))).all()
            np.testing.assert_allclose(A(b)[fin], a[fin],
                                       atol=1e-6 * np.abs(p0[0]).max())
        adam, sched = js.inner_state
        assert int(ts.count) == int(adam.count)
        assert int(ts.schedule_count) == int(sched.count)
        assert int(ts.notfinite_count) == int(js.notfinite_count)
        assert int(ts.total_notfinite) == int(js.total_notfinite)
        assert bool(ts.last_finite) == bool(js.last_finite)
    assert int(ts.count) == (24 if max_errors == 100 else 26)


# ---- one train step on each path --------------------------------------------

N_RAYS = 128
K = 32
SETTINGS = dict(bound=1.0, cascade=1, min_near=0.05, max_samples=K,
                max_steps=256)
G_FLOOR = 1e-6       # |g| / max|g| of its leaf above which params compare
MAX_FLIPS = 2        # per leaf: params below the floor moved the other way


def _step_inputs(backbone, dtype="float32"):
    """Specs, params, an all-occupied grid, a batch of RGBA targets and
    the JAX step's key with the draws it makes."""
    jspec, tspec = specs(backbone, dtype)
    p = jparams(jspec)
    g = jgrid.init(1)
    dens = jnp.full_like(g.density, 20.0)
    g = g._replace(density=dens, bitfield=jgrid.packbits(dens, 10.0))
    rs = np.random.RandomState(1)
    ro = np.tile(np.array([[0.1, 0.2, -2.5]], np.float32), (N_RAYS, 1))
    rd = rs.randn(N_RAYS, 3).astype(np.float32) * 0.25
    rd[:, 2] = 1.0
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    pix = rs.rand(N_RAYS, 4).astype(np.float32)
    batch = {"rays_o": ro, "rays_d": rd, "pixels": pix}
    rng = jax.random.PRNGKey(5)
    k_bg, k_perturb = jax.random.split(rng)         # trainer.py:108
    draws = {"bg": np.asarray(jax.random.uniform(k_bg, (N_RAYS, 3)))}
    if backbone == "mlp":                           # fast.py:147-168
        kc, kf = jax.random.split(k_perturb)
        draws["u_coarse"] = np.asarray(jax.random.uniform(kc, (N_RAYS,
                                                               K // 2)))
        draws["u_fine"] = np.asarray(jax.random.uniform(kf, (N_RAYS,
                                                             K // 2)))
    else:                                           # renderer.py:71
        draws["noise"] = np.asarray(jax.random.uniform(k_perturb,
                                                       (N_RAYS,)))
    return jspec, tspec, p, g, batch, rng, k_perturb, draws


def _jax_grads(backbone, jspec, p, g, batch, k_perturb, draws):
    st = jren.RenderSettings(**SETTINGS)
    bg = jnp.asarray(draws["bg"])
    px = jnp.asarray(batch["pixels"])
    tgt = px[:, :3] * px[:, 3:] + bg * (1 - px[:, 3:])

    def loss(pp):
        ro, rd = jnp.asarray(batch["rays_o"]), jnp.asarray(batch["rays_d"])
        if backbone == "mlp":
            fs = jfast.FastSettings(bound=1.0, min_near=0.05,
                                    num_coarse=K // 2, num_fine=K // 2)
            out = jfast.render_rays_fast(pp, jspec, fs, ro, rd, bg,
                                         k_perturb)
        else:
            out = jren.render_rays(pp, jspec, st, g.bitfield, ro, rd, bg,
                                   rng=k_perturb, perturb=True)
        return jnp.mean((out["image"] - tgt) ** 2)

    return [np.asarray(a) for a in W._tree_leaves(jax.grad(loss)(p))]


def _run_step(backbone, dtype="float32"):
    jspec, tspec, p, g, batch, rng, kp, draws = _step_inputs(backbone,
                                                             dtype)
    st = jren.RenderSettings(**SETTINGS)
    jopt = jtr.make_optimizer(1e-2, 100)
    jstep = jtr.make_train_step(jspec, st, jopt, ema_decay=0.9,
                                use_fast_path=backbone == "mlp")
    jstate = jtr.TrainState(p, jopt.init(p), p, jnp.zeros((), jnp.int32))
    jnew, jm = jstep(jstate, g.bitfield,
                     {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    tstate = W.train_state_from_numpy(jax.device_get(jstate), tspec, "cpu")
    tstep = ttr.make_train_step(tspec, tren.RenderSettings(**SETTINGS),
                                ttr.make_optimizer(1e-2, 100),
                                ema_decay=0.9,
                                use_fast_path=backbone == "mlp")
    tnew, tm = tstep(tstate, W.grid_from_numpy(jax.device_get(g),
                                               "cpu").bitfield,
                     {k: T(v) for k, v in batch.items()},
                     draws={k: T(v) for k, v in draws.items()})
    jg = _jax_grads(backbone, jspec, p, g, batch, kp, draws)
    return (jax.device_get(jnew), jm, W.train_state_to_numpy(tnew), tm, jg)


@pytest.mark.parametrize("backbone", ["hashgrid", "mlp"])
def test_train_step_matches_jax(backbone):
    """One f32 step from the same state and draws: the occupancy march
    with a hash grid, the hierarchical path with the mlp. Loss 1e-6
    relative; gradients 1e-5 absolute and 2e-4 of their leaf's largest;
    the EMA 1e-6 (where the params compare); the Adam moments and counts.
    Updated params 1e-6 where |g| > 1e-6 of the leaf's largest: below that
    floor a gradient of either sign moves a param by +-lr (Adam's eps
    1e-15), so those flips are counted and held to 2 a leaf."""
    jn, jm, tn, tm, jg = _run_step(backbone)
    assert abs(float(tm["loss"]) / float(jm["loss"]) - 1) <= 1e-6
    np.testing.assert_allclose(A(tm["per_ray_loss"]),
                               np.asarray(jm["per_ray_loss"]), rtol=1e-5,
                               atol=1e-7)
    assert len(jg) == len(tm["grads"])
    for a, b in zip(jg, tm["grads"]):
        err = np.abs(A(b) - a).max()
        assert err <= 1e-5 and err <= 2e-4 * np.abs(a).max(), err
    jpar, tpar = W._tree_leaves(jn.params), W._tree_leaves(tn["params"])
    jema, tema = (W._tree_leaves(jn.ema_params),
                  W._tree_leaves(tn["ema_params"]))
    for a, b, ea, eb, gg in zip(jpar, tpar, jema, tema, jg):
        big = np.abs(gg) > G_FLOOR * np.abs(gg).max()
        np.testing.assert_allclose(b[big], a[big], atol=1e-6)
        np.testing.assert_allclose(eb[big], ea[big], atol=1e-6)
        assert int((np.abs(b - a) > 1e-6)[~big].sum()) <= MAX_FLIPS
    adam, sched = jn.opt_state.inner_state
    tadam, tsched = tn["opt_state"]["inner_state"]
    assert int(tadam["count"]) == int(adam.count) == 1
    assert int(tsched["count"]) == int(sched.count) == 1
    for a, b in zip(W._tree_leaves(adam.mu), W._tree_leaves(tadam["mu"])):
        np.testing.assert_allclose(b, a, atol=2e-4 * np.abs(a).max())
    assert int(tn["step"]) == int(jn.step) == 1


@pytest.mark.parametrize("backbone", ["hashgrid", "mlp"])
def test_train_step_bf16_within_bound(backbone):
    """bf16 compute: every layer rounds to bf16, and the two libraries sum
    the layers in different orders, so the step holds to a stated bound:
    loss 1e-4 relative, gradients 5e-2 of their leaf's largest (measured
    1.7e-5 and 2.4e-2 on the mlp, 2.1e-6 and 3e-3 on the hash grid)."""
    jn, jm, tn, tm, jg = _run_step(backbone, "bfloat16")
    assert abs(float(tm["loss"]) / float(jm["loss"]) - 1) <= 1e-4
    for a, b in zip(jg, tm["grads"]):
        assert np.abs(A(b) - a).max() <= 5e-2 * np.abs(a).max()


# ---- trainer state ---------------------------------------------------------

def test_ema_decay_and_error_map_update():
    """The per-step EMA decay 0.95 ** (1 / n_views), exact, as JAX's
    trainer sets it; the error-map EMA update at the sampled cells, exact
    against JAX's .at[].set on the same inputs (distinct cells)."""
    for n in (1, 7, 40, 100):
        assert ttr.Trainer.__dict__["_ensure_ema_decay"]
        eff = float(0.95 ** (1.0 / max(int(n), 1)))
        jt = type("J", (), {"_ema_base": 0.95, "_ema_step_decay": 0.95,
                            "_rebuild_train_step": lambda s: None})()
        jtr.Trainer._ensure_ema_decay(jt, n)
        tt = type("P", (), {"_ema_base": 0.95, "_ema_step_decay": 0.95,
                            "_rebuild_train_step": lambda s: None})()
        ttr.Trainer._ensure_ema_decay(tt, n)
        assert tt._ema_step_decay == jt._ema_step_decay == eff
    rs = np.random.RandomState(2)
    emap = rs.rand(3, 128 * 128).astype(np.float32)
    coarse = rs.choice(128 * 128, 500, replace=False)
    per_ray = rs.rand(500).astype(np.float32)
    vi = 1
    jm = jnp.asarray(emap)
    err = 0.9 * jm[vi][coarse] + 0.1 * jnp.asarray(per_ray)
    jm = jm.at[vi, coarse].set(err)
    tm = T(emap.copy())
    vt, ct = torch.tensor(vi), T(coarse)
    tm[vt, ct] = 0.9 * tm[vt][ct] + 0.1 * T(per_ray)
    np.testing.assert_array_equal(A(tm), np.asarray(jm))


def test_train_state_carries_across_both_ways():
    """A JAX TrainState after two steps -> the port -> back: every array
    equal (params, EMA, moments, counts, step), and the occupancy grid's
    bits both ways."""
    jspec, tspec = specs("hashgrid")
    p = jparams(jspec)
    opt = jtr.make_optimizer(1e-2, 100)
    st = jren.RenderSettings(**SETTINGS)
    step = jtr.make_train_step(jspec, st, opt, use_fast_path=True)
    state = jtr.TrainState(p, opt.init(p), p, jnp.zeros((), jnp.int32))
    rs = np.random.RandomState(0)
    rd = rs.randn(64, 3).astype(np.float32)
    rd[:, 2] = 3.0
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    batch = {"rays_o": jnp.tile(jnp.asarray([[0.0, 0.0, -2.5]]), (64, 1)),
             "rays_d": jnp.asarray(rd),
             "pixels": jnp.asarray(rs.rand(64, 3).astype(np.float32))}
    for i in range(2):
        state, _ = step(state, None, batch, jax.random.PRNGKey(i))
    js = jax.device_get(state)
    back = W.train_state_to_numpy(W.train_state_from_numpy(js, tspec,
                                                           "cpu"))
    jl = jax.tree_util.tree_leaves(js)
    rebuilt = js._replace(
        params=back["params"], ema_params=back["ema_params"],
        step=back["step"],
        opt_state=js.opt_state._replace(
            notfinite_count=back["opt_state"]["notfinite_count"],
            last_finite=back["opt_state"]["last_finite"],
            total_notfinite=back["opt_state"]["total_notfinite"],
            inner_state=(js.opt_state.inner_state[0]._replace(
                count=back["opt_state"]["inner_state"][0]["count"],
                mu=back["opt_state"]["inner_state"][0]["mu"],
                nu=back["opt_state"]["inner_state"][0]["nu"]),
                js.opt_state.inner_state[1]._replace(
                    count=back["opt_state"]["inner_state"][1]["count"]))))
    tl = jax.tree_util.tree_leaves(rebuilt)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    g = jgrid.init(1)
    dens = jnp.asarray(rs.rand(*g.density.shape).astype(np.float32) * 20)
    g = g._replace(density=dens, bitfield=jgrid.packbits(dens, 10.0),
                   mean_density=jnp.float32(3.5),
                   iter_density=jnp.int32(7))
    gb = W.grid_to_numpy(W.grid_from_numpy(jax.device_get(g), "cpu"))
    for k in ("density", "bitfield", "mean_density", "iter_density"):
        np.testing.assert_array_equal(gb[k], np.asarray(getattr(g, k)))


# ---- checkpoints: one format ----------------------------------------------

def _cfgs(ws, backbone):
    kw = dict(workspace=ws, bound=1.0, backbone=backbone, min_near=0.05,
              dt_gamma=0.0, iters=100)
    return JCfg(**kw).finalize(), TCfg(**kw).finalize()


def _render_both(jt, tt, backbone):
    """Both trainers' EMA renders of one 16x16 pose; the mlp path's draws
    from JAX's render_image_fast keys (PRNGKey(0), split per chunk)."""
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (0.05, -0.1, -2.5)
    intr = (20.0, 20.0, 8.0, 8.0)
    draws = None
    if backbone == "mlp":
        _, k = jax.random.split(jax.random.PRNGKey(0))
        kc, kf = jax.random.split(k)
        draws = (T(np.asarray(jax.random.uniform(kc, (256, 128)))),
                 T(np.asarray(jax.random.uniform(kf, (256, 128)))))
    jo = jt.render_pose(pose, intr, 16, 16)
    to = tt.render_pose(pose, intr, 16, 16, draws=draws)
    return np.asarray(jo["image"]), to["image"]


@pytest.mark.parametrize("backbone", ["mlp", "hashgrid"])
@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_checkpoints_load_in_the_other_trainer(tmp_path, backbone,
                                               direction):
    """One package's Trainer saves ngp_ep0001.npz (+ .json), the other's
    loads it with --ckpt latest: params, EMA, density grid and counters
    arrive equal, and the two renders agree: within 1e-5 through the
    occupancy renderer (hashgrid), within 2e-4 through the hierarchical
    renderer (mlp), whose inverse-CDF sample placement moves a few pixels
    by about 1e-4 for 1-ulp differences in the coarse weights (measured
    1.1e-4 at 2 of 768 values; its own parity test holds 1e-4 on another
    scene, tests/test_torch_render.py)."""
    ws = str(tmp_path / "ws")
    jcfg, tcfg = _cfgs(ws, backbone)
    rs = np.random.RandomState(0)
    dens = rs.rand(1, 128 ** 3).astype(np.float32) * 30.0
    if direction == "port_to_jax":
        src = ttr.Trainer("ngp", tcfg, use_checkpoint="scratch",
                          device="cpu")
        with torch.no_grad():
            for q in src.state.ema_params.leaves():
                q.mul_(1.5)
        src.grid = src.grid._replace(density=T(dens),
                                     mean_density=torch.tensor(2.0),
                                     iter_density=torch.tensor(9))
        src.global_step = 77
        path = src.save_checkpoint()
        jt = jtr.Trainer("ngp", jcfg, use_checkpoint="latest")
        tt = src
        tt.grid = tt.grid._replace(bitfield=W.grid_from_numpy(
            jax.device_get(jt.grid), "cpu").bitfield)
    else:
        src = jtr.Trainer("ngp", jcfg, use_checkpoint="scratch")
        src.state = src.state._replace(ema_params=jax.tree_util.tree_map(
            lambda a: a * 1.5, src.state.ema_params))
        src.grid = src.grid._replace(density=jnp.asarray(dens),
                                     mean_density=jnp.float32(2.0),
                                     iter_density=jnp.int32(9))
        src.global_step = 77
        path = src.save_checkpoint()
        jt = src
        jt.grid = jt.grid._replace(bitfield=jgrid.packbits(
            jt.grid.density, jnp.minimum(jt.grid.mean_density, 10.0)))
        tt = ttr.Trainer("ngp", tcfg, use_checkpoint="latest", device="cpu")
    assert os.path.basename(path) == "ngp_ep0001.npz"
    assert os.path.exists(path + ".json")
    dst = jt if direction == "port_to_jax" else tt
    assert dst.global_step == 77 and dst.epoch == 1
    jl = W._tree_leaves(jax.device_get(jt.state.ema_params))
    tl = [A(q) for q in tt.state.ema_params.leaves()]
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(b, np.asarray(a))
    np.testing.assert_array_equal(A(tt.grid.density), np.asarray(
        jt.grid.density))
    np.testing.assert_array_equal(A(tt.grid.bitfield).view(np.uint32),
                                  np.asarray(jt.grid.bitfield))
    ji, ti = _render_both(jt, tt, backbone)
    assert np.isfinite(ti).all() and ti.std() > 1e-3
    np.testing.assert_allclose(ti, ji,
                               atol=2e-4 if backbone == "mlp" else 1e-5)


def test_checkpoint_rotation_and_guards(tmp_path):
    """max_keep_ckpt keeps the newest two (npz and json); a non-finite
    state is neither saved nor loaded; training refuses a non-finite
    state (the JAX trainer's guards)."""
    _, tcfg = _cfgs(str(tmp_path / "ws"), "mlp")
    tt = ttr.Trainer("ngp", tcfg, use_checkpoint="scratch", device="cpu")
    paths = [tt.save_checkpoint() for _ in range(3)]
    ck = sorted(os.listdir(tmp_path / "ws" / "checkpoints"))
    assert ck == ["ngp_ep0002.npz", "ngp_ep0002.npz.json",
                  "ngp_ep0003.npz", "ngp_ep0003.npz.json"]
    assert not os.path.exists(paths[0])
    with torch.no_grad():
        tt.state.params.sigma_net[0][0, 0] = float("nan")
    assert tt.save_checkpoint() == ""
    bad = str(tmp_path / "bad.npz")
    from pienerf_tpu_torch.io.checkpoint import save_native
    save_native(bad, {"params": W.field_to_numpy(tt.state.params),
                      "ema_params": W.field_to_numpy(tt.state.params)})
    fresh = ttr.Trainer("ngp", tcfg, use_checkpoint="scratch", device="cpu")
    assert fresh.load_checkpoint(bad) is False
    jt = jtr.Trainer("ngp", _cfgs(str(tmp_path / "ws"), "mlp")[0],
                     use_checkpoint="scratch")
    assert jt.load_checkpoint(bad) is False
    ds = type("D", (), {"poses": np.eye(4, dtype=np.float32)[None],
                        "images": np.ones((1, 8, 8, 3), np.float32),
                        "intrinsics": (8.0, 8.0, 4.0, 4.0), "H": 8,
                        "W": 8})()
    with pytest.raises(RuntimeError, match="non-finite"):
        tt.train_iterations(ds, 1)


def test_trainer_iterations_error_map_and_precision_tail(tmp_path):
    """The port's loop on a small sphere set: the error map starts at ones
    and moves, the per-step EMA is 0.95 ** (1 / n_views), the precision
    tail switches bf16 to f32 at its step, the losses are finite and
    recorded per step, and a patch run logs the LPIPS-less mode."""
    from pienerf_tpu_torch.data import synthetic
    ds = synthetic.make_dataset(n_views=4, H=24, W=24)
    _, tcfg = _cfgs(str(tmp_path / "ws"), "mlp")
    tcfg.error_map = True
    tcfg.num_rays = 256
    tcfg.train_max_samples = 32
    tcfg.compute_dtype = "bfloat16"
    tcfg.precision_tail_start = 3
    tt = ttr.Trainer("ngp", tcfg, use_checkpoint="scratch", device="cpu")
    loss = tt.train_iterations(ds, 5)
    assert np.isfinite(loss) and len(tt.loss_history) == 5
    assert tt._ema_step_decay == 0.95 ** 0.25
    assert tt.spec.compute_dtype == "float32"
    assert tt.state.params.spec.compute_dtype == "float32"
    assert tt.error_map.shape == (4, 128 * 128)
    assert float((tt.error_map != 1.0).sum()) > 0
    assert int(tt.state.opt_state.count) == 5


def test_host_dataset_guidance_and_geometry(tmp_path, monkeypatch, capsys):
    """Above $PIENERF_MAX_DEVICE_DATASET the images stay on the host and
    each step copies its pixels; without LPIPS / CLIP weights patch mode
    trains MSE-only and rand_pose 0 skips guidance with JAX's log lines;
    with a CLIP guide prepared from token ids (seeded tiny weights, as
    tests/test_torch_clip.py's), train_clip_iterations from JAX's state
    with JAX's draws builds the step JAX's trainer builds (the same frame
    size and intrinsics) and its loss equals JAX's step's within 1e-5
    relative, the orbit pose the reference's (test_torch_clip.py's
    jax_clip_step: JAX's own faces away from the scene);
    save_mesh and save_point_cloud write their files."""
    from pienerf_tpu_torch.data import synthetic
    ds = synthetic.make_dataset(n_views=2, H=32, W=32)
    _, tcfg = _cfgs(str(tmp_path / "ws"), "mlp")
    tcfg.num_rays, tcfg.train_max_samples = 256, 16
    monkeypatch.setenv("PIENERF_MAX_DEVICE_DATASET", "100")
    monkeypatch.delenv("PIENERF_LPIPS_WEIGHTS", raising=False)
    monkeypatch.delenv("PIENERF_CLIP_WEIGHTS", raising=False)
    tt = ttr.Trainer("ngp", tcfg, use_checkpoint="scratch", device="cpu")
    assert np.isfinite(tt.train_iterations(ds, 2))
    tcfg.patch_size = 16
    tp = ttr.Trainer("ngp", tcfg, use_checkpoint="scratch", device="cpu")
    assert "MSE-only patch loss" in capsys.readouterr().out
    assert np.isfinite(tp.train_iterations(ds, 1))
    tcfg.patch_size, tcfg.rand_pose = 1, 0
    tr = ttr.Trainer("ngp", tcfg, use_checkpoint="scratch", device="cpu")
    tr.train(ds, max_iters=3)
    assert "skipping CLIP guidance" in capsys.readouterr().out
    assert tr.global_step == 0
    from test_torch_clip import _clip_draws, hf_state_dict, jax_clip_step

    from pienerf_tpu.train import clip_guidance as jcg
    from pienerf_tpu_torch.train import clip_guidance as tcg
    jcfg, _ = _cfgs(str(tmp_path / "wsj"), "mlp")
    jcfg.num_rays, jcfg.train_max_samples = 256, 16
    # radius 2, as tests/test_clip_guidance.py: at the default 5 a few
    # grazing rays of the frame render NaN in both packages
    jcfg.radius = tr.cfg.radius = 2.0
    jt = jtr.Trainer("ngp", jcfg, use_checkpoint="scratch")
    tr.state = W.train_state_from_numpy(jax.device_get(jt.state),
                                        tr.spec, "cpu")
    cparams = jcg.import_hf_state_dict(hf_state_dict(), 2, 2)
    ids = np.random.RandomState(0).randint(0, 64, size=(1, 8))
    jt._clip_guide = jcg.CLIPGuidance(cparams)
    jt._clip_guide.prepare_text(ids=ids)
    tr._clip_guide = tcg.CLIPGuidance(cparams, device="cpu")
    tr._clip_guide.prepare_text(ids=ids)
    _, key = jax.random.split(jt.rng)               # trainer.py:683
    state0 = jt.state
    jt.train_clip_iterations(32, 32, ds.intrinsics, 1, clip_size=32)
    tl = tr.train_clip_iterations(32, 32, ds.intrinsics, 1, clip_size=32,
                                  draws=[_clip_draws(key, 256, 16)])
    rH, rW, intr, size = jt._clip_step_key
    assert tr._clip_step_key == (rH, rW, intr, size) == (16, 16, tuple(
        v / 2 for v in ds.intrinsics), 32)
    assert tr.global_step == jt.global_step == 1
    _, jl = jax_clip_step(jt.spec, jt.optimizer, cparams,
                          jt._clip_guide.text_z, rH, rW, intr, 2.0, 16,
                          32)(state0, key)
    assert np.isfinite(tl) and abs(tl / float(jl) - 1.0) <= 1e-5, (tl, jl)
    lin = np.linspace(-1, 1, 16, dtype=np.float32)
    thr = float(np.median(tt._density_np(np.stack(np.meshgrid(
        lin, lin, lin, indexing="ij"), -1).reshape(-1, 3))))
    mesh = tt.save_mesh(str(tmp_path / "m.obj"), resolution=16,
                        threshold=thr)
    pc = tt.save_point_cloud(str(tmp_path / "p.ply"), resolution=16,
                             threshold=thr)
    assert os.path.getsize(mesh) > 0 and os.path.getsize(pc) > 0
