"""The port's LPIPS against the JAX package (CPU): the weight file in both
key layouts, the distance and its gradient, the patch-32 train step with
the perceptual term, the trainer's loading and the meter. The weights are
seeded random ones in AlexNet-LPIPS's real layout (the pretrained ones are
not in the repository), as tests/test_patch_lpips.py uses. Each tolerance
is stated where it is checked."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pienerf_tpu.models import network as jnet
from pienerf_tpu.render import renderer as jren
from pienerf_tpu.train import lpips as jlp
from pienerf_tpu.train import metrics as jmet
from pienerf_tpu.train import trainer as jtr
from pienerf_tpu_torch import weights as W
from pienerf_tpu_torch.config import PieNeRFConfig as TCfg
from pienerf_tpu_torch.data import synthetic
from pienerf_tpu_torch.models import network as tnet
from pienerf_tpu_torch.render import renderer as tren
from pienerf_tpu_torch.train import lpips as tlp
from pienerf_tpu_torch.train import metrics as tmet
from pienerf_tpu_torch.train import trainer as ttr

T = torch.as_tensor
G_FLOOR = 1e-6       # |g| / max|g| of its leaf above which params compare
MAX_FLIPS = 2        # params below the floor that moved the other way


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread a test: the tensors here are small, and the test
    workers share the machine's cores, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_weights(seed):
    """Canonical LPIPS-alex weights from a seed (conv biases nonzero, so
    every relu has work to do)."""
    rs = np.random.RandomState(seed)
    w = {}
    for i, (ci, co, k, _, _) in enumerate(jlp._ALEX):
        w[f"conv{i}_w"] = rs.randn(co, ci, k, k).astype(np.float32) * 0.05
        w[f"conv{i}_b"] = rs.randn(co).astype(np.float32) * 0.01
        w[f"lin{i}_w"] = np.abs(rs.randn(co)).astype(np.float32)
    return w


def raw_layout(w):
    """The same weights under the ``lpips`` package's state-dict keys."""
    raw = {}
    for i, fi in enumerate(jlp._FEATURE_IDX):
        raw[f"net.slice{i + 1}.{fi}.weight"] = w[f"conv{i}_w"]
        raw[f"net.slice{i + 1}.{fi}.bias"] = w[f"conv{i}_b"]
        raw[f"lin{i}.model.1.weight"] = w[f"lin{i}_w"].reshape(1, -1, 1, 1)
    return raw


def test_constants_are_jaxs():
    assert tlp._ALEX == jlp._ALEX and tlp._FEATURE_IDX == jlp._FEATURE_IDX
    np.testing.assert_array_equal(tlp._SHIFT, jlp._SHIFT)
    np.testing.assert_array_equal(tlp._SCALE, jlp._SCALE)


@pytest.mark.parametrize("layout", ["raw", "canonical"])
def test_weight_file_loads_as_jaxs(tmp_path, monkeypatch, layout):
    """Both key layouts load through $PIENERF_LPIPS_WEIGHTS into the same
    canonical arrays as JAX's loader, exactly; a wrong shape is refused."""
    w = random_weights(1)
    path = str(tmp_path / "lpips_alex.npz")
    np.savez(path, **(raw_layout(w) if layout == "raw" else w))
    monkeypatch.setenv("PIENERF_LPIPS_WEIGHTS", path)
    assert tlp.available() and tlp.weights_path() == path
    tw, jw = tlp.load_weights(), jlp.load_weights()
    assert sorted(tw) == sorted(jw)
    for k in jw:
        np.testing.assert_array_equal(tw[k], jw[k])
    bad = dict(w, conv2_w=w["conv2_w"][:, :10])
    np.savez(path, **bad)
    with pytest.raises(ValueError, match="conv2_w"):
        tlp.load_weights()
    monkeypatch.setenv("PIENERF_LPIPS_WEIGHTS", str(tmp_path / "none.npz"))
    assert not tlp.available()
    with pytest.raises(FileNotFoundError):
        tlp.load_weights()


def test_lpips_and_its_gradient_match_jax():
    """The distance per item within 1e-5 relative of JAX's, and its
    gradient with respect to the prediction within 1e-5 of the largest
    entry; zero for identical images, symmetric; the 32-pixel floor."""
    w = random_weights(0)
    tw = W.lpips_to_torch(w, "cpu")
    rs = np.random.RandomState(2)
    a = rs.rand(2, 48, 64, 3).astype(np.float32)
    b = rs.rand(2, 48, 64, 3).astype(np.float32)
    jv, jvjp = jax.vjp(jax.jit(lambda x: jlp.lpips(x, jnp.asarray(b), w)),
                       jnp.asarray(a))
    jv, jg = np.asarray(jv), np.asarray(jvjp(jnp.ones(2))[0])
    at = T(a).requires_grad_()
    tv = tlp.lpips(at, T(b), tw)
    np.testing.assert_allclose(tv.detach().numpy(), jv, rtol=1e-5)
    assert np.all(jv > 0)
    tv.sum().backward()
    np.testing.assert_allclose(at.grad.numpy(), jg,
                               atol=1e-5 * np.abs(jg).max())
    np.testing.assert_allclose(tlp.lpips(T(a), T(a), tw).numpy(), 0.0,
                               atol=1e-6)
    np.testing.assert_allclose(tlp.lpips(T(b), T(a), tw).numpy(),
                               tv.detach().numpy(), rtol=1e-5)
    with pytest.raises(ValueError, match="32px"):
        tlp.lpips(T(a[:, :31]), T(b[:, :31]), tw)


def test_patch_step_with_lpips_matches_jax():
    """One f32 patch-32 step with the perceptual term (1e-3 x the mean
    LPIPS of two 32x32 patches, rays patch-major) from JAX's state and
    with JAX's draws, on the occupancy march with a small hash grid (as
    tests/test_torch_train.py's step). Loss 1e-5 relative. Gradients 1e-5
    absolute and 2e-3 of their leaf's largest: with or without the term,
    the MSE's gradient on the hash table parts by 7.8e-4 here (2.5e-3 at
    1,024 rays, 1e-6 at 128), since a few rays' march differs at its
    early-exit threshold; the term's own gradient (the step's less the MSE-only
    step's) holds 1e-2 of its largest (measured 1.1e-4 to 3.4e-3: the
    difference keeps the sums' rounding, and on the hash table the term
    is 0.7% of the gradient). Params 1e-6 above the gradient
    floor (Adam's eps 1e-15 moves a param below it by +-lr whatever its
    gradient, so flips there are counted, at most 2 a leaf)."""
    from pienerf_tpu.models import hash_encoder as jhe
    from pienerf_tpu.ops import grid as jgrid
    from pienerf_tpu_torch.models import hash_encoder as the

    grid_kw = dict(num_levels=4, log2_hashmap_size=12, desired_resolution=64)
    w = random_weights(3)
    n, k, p = 2048, 32, 32
    jspec = jnet.make_spec(bound=1.0, backbone="hashgrid")._replace(
        grid=jhe.make_spec(**grid_kw))
    tspec = tnet.make_spec(bound=1.0, backbone="hashgrid")._replace(
        grid=the.make_spec(**grid_kw))
    params = jnet.init_params(jax.random.PRNGKey(0), jspec)
    params["encoder"] = params["encoder"] * 1000.0
    g = jgrid.init(1)
    dens = jnp.full_like(g.density, 20.0)
    g = g._replace(density=dens, bitfield=jgrid.packbits(dens, 10.0))
    rs = np.random.RandomState(4)
    rd = rs.randn(n, 3).astype(np.float32) * 0.25
    rd[:, 2] = 1.0
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    batch = {"rays_o": np.tile(np.array([[0.1, 0.2, -2.5]], np.float32),
                               (n, 1)),
             "rays_d": rd, "pixels": rs.rand(n, 3).astype(np.float32)}
    st = dict(bound=1.0, cascade=1, min_near=0.05, max_samples=k,
              max_steps=256)
    jst = jren.RenderSettings(**st)
    jopt = jtr.make_optimizer(1e-2, 100)
    jstep = jtr.make_train_step(jspec, jst, jopt, ema_decay=0.9,
                                patch_size=p, lpips_weights=w)
    jstate = jtr.TrainState(params, jopt.init(params), params,
                            jnp.zeros((), jnp.int32))
    rng = jax.random.PRNGKey(7)
    jb = {a: jnp.asarray(b) for a, b in batch.items()}
    jnew, jm = jstep(jstate, g.bitfield, jb, rng)
    _, k_perturb = jax.random.split(rng)            # trainer.py:108
    noise = np.asarray(jax.random.uniform(k_perturb, (n,)))   # renderer.py

    def jloss(pp, lam):
        out = jren.render_rays(pp, jspec, jst, g.bitfield, jb["rays_o"],
                               jb["rays_d"], jnp.ones((n, 3)),
                               rng=k_perturb, perturb=True)
        tgt = jb["pixels"]
        return jnp.mean((out["image"] - tgt) ** 2) + lam * jnp.mean(
            jlp.lpips(out["image"].reshape(-1, p, p, 3),
                      tgt.reshape(-1, p, p, 3), w))

    jgrad = jax.jit(jax.grad(jloss))
    jg, jg0 = ([np.asarray(a) for a in W._tree_leaves(jgrad(params, lam))]
               for lam in (1e-3, 0.0))
    bitfield = W.grid_from_numpy(jax.device_get(g), "cpu").bitfield
    tbatch = {a: T(b) for a, b in batch.items()}

    def port_step(weights):
        step = ttr.make_train_step(
            tspec, tren.RenderSettings(**st), ttr.make_optimizer(1e-2, 100),
            ema_decay=0.9, patch_size=p, lpips_weights=weights)
        return step(W.train_state_from_numpy(jax.device_get(jstate), tspec,
                                             "cpu"), bitfield, tbatch,
                    draws={"noise": T(noise)})

    tnew, tm = port_step(W.lpips_to_torch(w, "cpu"))
    assert abs(float(tm["loss"]) / float(jm["loss"]) - 1) <= 1e-5
    for a, b in zip(jg, tm["grads"]):
        err = np.abs(b.numpy() - a).max()
        assert err <= 1e-5 and err <= 2e-3 * np.abs(a).max(), err
    jpar = W._tree_leaves(jax.device_get(jnew).params)
    tpar = W._tree_leaves(W.field_to_numpy(tnew.params))
    for a, b, gg in zip(jpar, tpar, jg):
        big = np.abs(gg) > G_FLOOR * np.abs(gg).max()
        np.testing.assert_allclose(b[big], np.asarray(a)[big], atol=1e-6)
        assert int((np.abs(b - a) > 1e-6)[~big].sum()) <= MAX_FLIPS
    # the same step without weights is the MSE alone, smaller by the term
    _, pm = port_step(None)
    assert float(tm["loss"]) - float(pm["loss"]) > 1e-4
    for a, a0, b, b0 in zip(jg, jg0, tm["grads"], pm["grads"]):
        term = a - a0
        err = np.abs((b - b0).numpy() - term).max()
        assert err <= 1e-2 * np.abs(term).max(), err


def test_trainer_loads_weights_and_the_meter_equals_jaxs(tmp_path,
                                                         monkeypatch,
                                                         capsys):
    """With a weight file: the patch-32 trainer loads it (no MSE-only
    line) and trains finite steps; the meter's values equal JAX's meter
    within 1e-5 relative."""
    w = random_weights(5)
    path = str(tmp_path / "w.npz")
    np.savez(path, **raw_layout(w))
    monkeypatch.setenv("PIENERF_LPIPS_WEIGHTS", path)
    rs = np.random.RandomState(6)
    tm_, jm_ = tmet.LPIPSMeter("cpu"), jmet.LPIPSMeter()
    assert tmet.LPIPSMeter.available() and jmet.LPIPSMeter.available()
    for _ in range(2):
        a = rs.rand(48, 40, 3)
        b = np.clip(a + 0.1 * rs.randn(48, 40, 3), 0, 1)
        tm_.update(a, b)
        jm_.update(a, b)
    np.testing.assert_allclose(tm_.vals, jm_.vals, rtol=1e-5)
    assert tm_.measure() > 0 and tm_.report().startswith("LPIPS = ")

    ds = synthetic.make_dataset(n_views=2, H=40, W=40, seed=0)
    cfg = TCfg(bound=1.0, dt_gamma=0.0, iters=20, num_rays=1024,
               max_steps=64, train_max_samples=8, backbone="mlp",
               patch_size=32, workspace=str(tmp_path / "ws")).finalize()
    tr = ttr.Trainer("ngp", cfg, use_checkpoint="scratch", device="cpu")
    assert "MSE-only" not in capsys.readouterr().out
    assert sorted(tr._lpips_weights) == sorted(w)
    assert np.isfinite(tr.train_iterations(ds, 2))
