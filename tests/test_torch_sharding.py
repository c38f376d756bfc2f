"""The port's multi-GPU paths (``parallel.sharding`` over
``torch.distributed``) against the JAX package's sharded ones (CPU). One
2-rank gloo run of ``parallel/dryrun.py`` (toy shapes) serves the module:
it holds each sharded path to the port's single-process result itself, and
its outputs are held here to JAX's ``make_sharded_train_step``,
``make_sharded_sim_step`` and ``render_frame_sharded`` on a 2-device mesh,
from the same inputs and draws. Each tolerance is stated where it is
checked."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pienerf_tpu.config import PieNeRFConfig as JCfg
from pienerf_tpu.models import network as jnet
from pienerf_tpu.ops import beam_bend as jbb
from pienerf_tpu.ops import grid as jgrid
from pienerf_tpu.ops.pallas import field_kernel as jfk
from pienerf_tpu.parallel import sharding as jsh
from pienerf_tpu.render import renderer as jren
from pienerf_tpu.sim import solver as jsim
from pienerf_tpu.train import trainer as jtr
from pienerf_tpu_torch import weights as W
from pienerf_tpu_torch.io.checkpoint import save_native
from pienerf_tpu_torch.parallel import dryrun, sharding
from pienerf_tpu_torch.sim import solver as tsim

T = torch.as_tensor
G_FLOOR = 1e-6       # |g| / max|g| of its leaf above which params compare
MAX_FLIPS = 2        # params below the floor that moved the other way (or
#                      1e-4 of those below it, on the hash table's millions)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread a test: the tensors here are small, and the test
    workers share the machine's cores, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=1)
def _train_inputs():
    """tests/test_sharding.py's step: the default hash grid from
    PRNGKey(0), 256 rays around +z from PRNGKey(1), the step's key
    PRNGKey(2) and the march noise JAX draws from it."""
    spec = jnet.make_spec(bound=1.0)
    params = jnet.init_params(jax.random.PRNGKey(0), spec)
    key = jax.random.PRNGKey(1)
    n = dryrun.TOY["train"]["rays"]
    d = jax.random.normal(key, (n, 3)) * 0.1 + jnp.asarray([0.0, 0.0, 1.0])
    batch = {"rays_o": np.tile(np.array([[0.0, 0.0, -2.5]], np.float32),
                               (n, 1)),
             "rays_d": np.asarray(d / jnp.linalg.norm(d, axis=-1,
                                                      keepdims=True)),
             "pixels": np.asarray(jax.random.uniform(key, (n, 3)))}
    _, k_perturb = jax.random.split(jax.random.PRNGKey(2))   # trainer.py
    noise = np.asarray(jax.random.uniform(k_perturb, (n,)))  # renderer.py
    return spec, params, batch, noise


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The dryrun's report and rank 0's outputs, from JAX's params and
    draws."""
    d = tmp_path_factory.mktemp("dryrun")
    _, params, batch, noise = _train_inputs()
    save_native(str(d / "train_params.npz"), jax.device_get(params))
    np.savez(d / "train_batch.npz", noise=noise, **batch)
    mspec = jnet.make_spec(bound=1.0, backbone="mlp")
    save_native(str(d / "frame_params.npz"), jax.device_get(
        jnet.init_params(jax.random.PRNGKey(0), mspec)))
    report = dryrun.run(2, fast=True, device="cpu", inputs=str(d),
                        arrays_out=str(d / "arrays.npz"))
    with np.load(d / "arrays.npz") as z:
        arrays = {k: z[k] for k in z.files}
    return report, arrays


def test_dp_step_matches_jaxs_sharded_step(run):
    """The 2-rank data-parallel step against JAX's make_sharded_train_step
    on a 2-device mesh from the same state, batch and draws: loss within
    1e-5 relative (and within 1e-5 of the port's single-process step);
    params within 1e-6, but for sign flips: Adam's first step (eps 1e-15)
    moves a param by +-lr whatever the size of its gradient, so a
    gradient whose sum nearly cancels can take the step the other way.
    Where |g| > 1e-6 of the leaf's largest, flips are at most 2 a leaf or
    1e-5 of its entries: a hash-table entry sums the rays' contributions
    of both signs (collisions), in another order on two ranks (measured 3
    of 620,563, the largest at 2.4e-4 of the leaf's largest gradient);
    below that floor, at most 2 a leaf or 1e-4 of the entries."""
    report, arrays = run
    spec, params, batch, noise = _train_inputs()
    cfg = JCfg(bound=1.0, num_rays=256, max_steps=128, train_max_samples=16,
               iters=100).finalize()
    opt = jtr.make_optimizer(cfg.lr, cfg.iters)
    st = jren.RenderSettings(bound=1.0, cascade=1, max_samples=16,
                             max_steps=128)
    step = jtr.make_train_step(spec, st, opt)
    state = jtr.TrainState(params, opt.init(params), params,
                           jnp.zeros((), jnp.int32))
    g = jgrid.init(1)
    g = g._replace(bitfield=jnp.full_like(g.bitfield, jnp.uint32(0xFFFFFFFF)))
    mesh = jsh.make_mesh(2)
    s2, m2 = jsh.make_sharded_train_step(step, mesh)(
        jsh.replicate(mesh, state), jsh.replicate(mesh, g.bitfield),
        jsh.shard_batch(mesh, {k: jnp.asarray(v) for k, v in batch.items()}),
        jax.random.PRNGKey(2))
    r = report["train_toy"]
    assert r["loss_rel"] <= 1e-5
    loss = float(arrays["train_toy/loss"])
    assert abs(loss / float(m2["loss"]) - 1.0) <= 1e-5, (loss, m2["loss"])

    def jloss(pp):
        out = jren.render_rays(pp, spec, st, g.bitfield,
                               jnp.asarray(batch["rays_o"]),
                               jnp.asarray(batch["rays_d"]),
                               jnp.ones((256, 3)), rng=jax.random.split(
                                   jax.random.PRNGKey(2))[1], perturb=True)
        return jnp.mean((out["image"] - jnp.asarray(batch["pixels"])) ** 2)

    grads = W._tree_leaves(jax.jit(jax.grad(jloss))(params))
    jpar = W._tree_leaves(jax.device_get(s2.params))
    for i, (a, gg) in enumerate(zip(jpar, grads)):
        a, gg = np.asarray(a), np.asarray(gg)
        b = arrays[f"train_toy/param{i}"]
        big = np.abs(gg) > G_FLOOR * np.abs(gg).max()
        flip = np.abs(b - a) > 1e-6
        assert int(flip[big].sum()) <= max(MAX_FLIPS, 1e-5 * big.sum())
        below = int((~big).sum())
        assert int(flip[~big].sum()) <= max(MAX_FLIPS, 1e-4 * below)


def test_sharded_sim_matches_jaxs(run):
    """Four IP-sharded steps of tests/test_sharding.py's cube (27 chunks:
    odd, so each rank pads to 14) against JAX's make_sharded_sim_step on
    a 2-device mesh, at that test's tolerances: ddof rtol 1e-3 atol 1e-4,
    dof_vel rtol 1e-3 atol 1e-2 (the cross-rank sum's f32 order)."""
    report, arrays = run
    r = report["sim_toy"]
    assert (r["chunks"], r["chunks_local"], r["steps"]) == (27, 14, 4)
    g = np.linspace(0.3, 0.7, 8) - 0.5
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    pos = np.stack([x.ravel(), y.ravel(), z.ravel()], 1)
    n = pos.shape[0]
    consts, state, _ = jsim.sim_init(
        pos, np.full(n, 0.1), np.full(n, 1e4), np.full(n, 1e4),
        pos[:, 1] > 0.15, dt=1e-2, iters=5, bbox=np.array([1.0, 1.0, 1.0]),
        kres=4, dx=0.2, gravity=(0.0, -9.8, 0.0), stiff=1e5,
        base=np.array([-0.5, -0.5, -0.5]))
    consts_sh, step = jsh.make_sharded_sim_step(jsh.make_mesh(2), consts)
    got = state
    for _ in range(4):
        got = step(consts_sh, got)
    np.testing.assert_allclose(arrays["sim_toy/ddof"], np.asarray(got.ddof),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(arrays["sim_toy/dof_vel"],
                               np.asarray(got.dof_vel), rtol=1e-3,
                               atol=1e-2)


def test_rank_shares_sum_to_the_whole_and_one_process_is_unchanged():
    """Without a process group: the two ranks' chunk shares of the cube
    (make_sharded_sim_step's padding and per-rank node_gather) give
    elastic partials that sum to the whole chunked term within 1e-6 of
    its scale; and the single-process step, with no reduce or with an
    identity reduce, is bit for bit the step."""
    consts, state = dryrun._sim_scene("cube", torch.device("cpu"))
    chunked = consts._replace(B=None)
    ddof = torch.randn(state.ddof.shape,
                       generator=torch.Generator().manual_seed(0)) * 0.01
    whole = tsim.rhs_elastic_delta(chunked, ddof)
    parts = []
    for rank in range(2):
        mesh = sharding.Mesh(rank, 2, torch.device("cpu"), None, "gloo")
        local, _ = sharding.make_sharded_sim_step(mesh, consts)
        assert local.Dc.shape[0] == 14 and local.B is None
        parts.append(tsim.rhs_elastic_delta(local, ddof))
    err = float((parts[0] + parts[1] - whole).abs().max())
    assert err <= 1e-6 * float(whole.abs().max()), err
    ref = tsim.sim_step(chunked, state)
    assert torch.equal(tsim.sim_step(chunked, state,
                                     reduce=lambda t: t).ddof, ref.ddof)
    with pytest.raises(ValueError):
        tsim.rhs_elastic_delta(consts, ddof, reduce=lambda t: t)


@pytest.mark.parametrize("max_iter_num", [1, 2])
def test_band_frame_matches_jaxs(run, max_iter_num):
    """tests/test_sharded_render.py's scene at 64x64 in two bands of 32
    rows (one Newton step: the fused tile kernel's plain version; two:
    render_frame) against JAX's render_frame_sharded on a 2-device mesh:
    within 2e-3 (that test's tolerance); against the port's whole frame
    within 2e-3 too (the dryrun's own check), no tile dropped."""
    report, arrays = run
    name = "frame_toy" if max_iter_num == 1 else "frame_toy_newton"
    r = report[name]
    assert r["max_abs"] < 2e-3 and r["drops"]["n_tile_overflow"] == 0
    spec = jnet.make_spec(bound=1.0, backbone="mlp")
    params = jnet.init_params(jax.random.PRNGKey(0), spec)
    pw = jfk.pack_weights(params, spec)
    g = np.arange(-0.4, 0.41, 0.1, dtype=np.float32)
    xx, yy, zz = np.meshgrid(g, g, g, indexing="ij")
    p = np.stack([xx.ravel(), yy.ravel(), zz.ravel()], 1)
    p = p[np.linalg.norm(p, axis=1) <= 0.42]
    n = p.shape[0]
    F = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
    dF = np.zeros((n, 3, 3, 3), np.float32)
    bst = jbb.BeamBendSettings(num_seek_ip=2, max_iter_num=max_iter_num,
                               ip_dx=0.105, bin_capacity=12)
    pack = jbb.pack_for(bst, jnp.asarray(p), jnp.asarray(p), jnp.asarray(F),
                        jnp.asarray(dF))
    from pienerf_tpu.render import interactive as jint
    ist = jint.InteractiveSettings(spec=spec, bend=bst, tile=16, samples=24,
                                   active_frac=1.0, tile_chunk=4,
                                   min_near=0.05)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (0.0, 0.0, -2.5)
    img, drops = jsh.render_frame_sharded(
        jsh.make_mesh(2), ist, pw, pack, jnp.asarray(p), jnp.asarray(pose),
        (64.0, 64.0, 32.0, 32.0), 64, 64, jnp.float32(1.0))
    got = arrays[f"{name}/image"]
    assert got.shape == (64, 64, 3) and drops["n_tile_overflow"] == 0
    np.testing.assert_allclose(got, img, atol=2e-3)
    np.testing.assert_allclose(got, arrays[f"{name}/single"], atol=2e-3)
    assert r["drops"]["dropped_beam"] == drops["dropped_beam"]


def test_dryrun_report_names_every_toy_check(run):
    """The dryrun ran each check at the toy shapes and only those (fast
    mode), each on two ranks."""
    report, _ = run
    assert sorted(report) == ["frame_toy", "frame_toy_newton", "sim_toy",
                              "train_toy"]
    assert report["train_toy"]["rays"] == 256
    assert os.environ.get("MASTER_ADDR") is None    # file:// rendezvous
