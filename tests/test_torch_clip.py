"""The port's CLIP guidance against the JAX package (CPU): the HF weight
import, both towers, the bilinear resize up and down, the loss and its
gradient, the orbit pose, three CLIP train steps with JAX's draws, and
the guidance API.
The weights are a seeded HF-layout state dict of the tiny config of
tests/test_clip_guidance.py (vision 32 wide, 2 layers, 2 heads, 32 px,
patch 8; text 16 wide, 2 layers, 2 heads, vocabulary 64, 16 positions;
projection 20), drawn by ``clip_guidance.seeded_state_dict``, so no
``transformers`` is needed.
Each tolerance is stated where it is checked."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pienerf_tpu.models import network as jnet
from pienerf_tpu.train import clip_guidance as jcg
from pienerf_tpu.train import trainer as jtr
from pienerf_tpu_torch import weights as W
from pienerf_tpu_torch.models import network as tnet
from pienerf_tpu_torch.train import clip_guidance as tcg
from pienerf_tpu_torch.train import trainer as ttr

T = torch.as_tensor
VOCAB = 64


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread a test: the tensors here are small, and the test
    workers share the machine's cores, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def hf_state_dict(seed=0):
    """The tiny config's HF-layout state dict from a seed."""
    return tcg.seeded_state_dict(seed, vision=(2, 32, 2, 64, 8, 32),
                                 text=(2, 16, 2, 32, VOCAB, 16), proj=20)


@pytest.fixture(scope="module")
def tiny():
    """(the JAX params, the port's params on the CPU)."""
    sd = hf_state_dict()
    return (jcg.import_hf_state_dict(sd, 2, 2),
            W.clip_to_torch(tcg.import_hf_state_dict(sd, 2, 2), "cpu"))


def test_import_and_the_weight_file_are_jaxs(tmp_path, monkeypatch):
    """The canonical tree from the state dict, and from the exported npz
    through $PIENERF_CLIP_WEIGHTS, equal JAX's exactly (the
    ``pre_layrnorm`` key, the head counts); the preprocessing constants
    are JAX's."""
    np.testing.assert_array_equal(tcg._MEAN, jcg._MEAN)
    np.testing.assert_array_equal(tcg._STD, jcg._STD)
    sd = hf_state_dict()
    path = str(tmp_path / "clip.npz")
    np.savez(path, **sd, __v_heads__=2, __t_heads__=2)
    monkeypatch.setenv("PIENERF_CLIP_WEIGHTS", path)
    assert tcg.available() and tcg.weights_path() == path
    for t, j in ((tcg.import_hf_state_dict(sd, 2, 2),
                  jcg.import_hf_state_dict(sd, 2, 2)),
                 (tcg.load_weights(), jcg.load_weights())):
        jl, jtree = jax.tree_util.tree_flatten(j)
        tl, ttree = jax.tree_util.tree_flatten(t)
        assert jtree == ttree
        for a, b in zip(jl, tl):
            np.testing.assert_array_equal(b, a)
    monkeypatch.setenv("PIENERF_CLIP_WEIGHTS", str(tmp_path / "none.npz"))
    assert not tcg.available()
    with pytest.raises(FileNotFoundError):
        tcg.load_weights()


def test_both_towers_match_jax(tiny):
    """Image features of two 32-px images, text features pooled at
    argmax(ids) and at the first eos: within 1e-6 of JAX's (unit
    vectors)."""
    jp, tp = tiny
    rs = np.random.RandomState(1)
    px = rs.rand(2, 3, 32, 32).astype(np.float32)
    np.testing.assert_allclose(
        tcg.encode_image(tp, T(px)).numpy(),
        np.asarray(jax.jit(lambda x: jcg.encode_image(jp, x))(
            jnp.asarray(px))), atol=1e-6)
    ids = rs.randint(0, VOCAB, size=(3, 12))
    ids[np.arange(3), rs.randint(0, 12, 3)] = VOCAB - 1
    for eos in (None, 5):
        np.testing.assert_allclose(
            tcg.encode_text(tp, T(ids), eos_token_id=eos).numpy(),
            np.asarray(jax.jit(lambda i: jcg.encode_text(
                jp, i, eos_token_id=eos))(jnp.asarray(ids, jnp.int32))),
            atol=1e-6)


@pytest.mark.parametrize("shape", [(64, 64, 224), (300, 200, 224),
                                   (33, 17, 32)])
def test_resize_matches_jax_up_and_down(shape):
    """``resize_bilinear`` against ``jax.image.resize(..., "bilinear")``
    (its triangle kernel renormalised at the borders and, shrinking,
    widened by the scale): within 1e-6 of JAX's computed op by op (each
    op alone, as the hash encode's tests hold JAX), and within 3e-5 of
    JAX's jitted resize, in which XLA fuses the sample positions' multiply
    and add into one FMA and moves them by an ulp (measured 1.4e-5 at
    300x200 -> 224, 1.8e-6 at 64 -> 224). F.interpolate is not JAX's:
    shrinking, it does not widen the kernel."""
    h, w, s = shape
    x = np.random.RandomState(h * w).rand(2, h, w, 3).astype(np.float32)
    got = tcg.resize_bilinear(T(x), s).numpy()
    with jax.disable_jit():
        op = np.asarray(jax.image.resize(jnp.asarray(x), (2, s, s, 3),
                                         method="bilinear"))
    jit = np.asarray(jax.image.resize(jnp.asarray(x), (2, s, s, 3),
                                      method="bilinear"))
    np.testing.assert_allclose(got, op, atol=1e-6)
    np.testing.assert_allclose(got, jit, atol=3e-5)
    if h > s:
        interp = torch.nn.functional.interpolate(
            T(x).permute(0, 3, 1, 2), size=(s, s), mode="bilinear",
            align_corners=False).permute(0, 2, 3, 1).numpy()
        assert np.abs(interp - op).max() > 1e-3


def test_clip_loss_and_its_gradient_match_jax(tiny):
    """The negative mean cosine at size 32 from 24-px frames: within 1e-6
    of JAX's, its gradient with respect to the frames within 1e-5 of the
    largest entry; the loss is a cosine and descends along -grad."""
    jp, tp = tiny
    rs = np.random.RandomState(3)
    imgs = rs.rand(2, 24, 24, 3).astype(np.float32)
    ids = rs.randint(0, VOCAB, size=(1, 8))
    jz = jax.jit(lambda i: jcg.encode_text(jp, i))(
        jnp.asarray(ids, jnp.int32))
    tz = tcg.encode_text(tp, T(ids))
    jl, jg = jax.jit(jax.value_and_grad(
        lambda im: jcg.clip_loss(jp, im, jz, size=32)))(jnp.asarray(imgs))
    jl, jg = float(jl), np.asarray(jg)
    it = T(imgs).requires_grad_()
    tl = tcg.clip_loss(tp, it, tz, size=32)
    tl.backward()
    assert abs(float(tl) - jl) <= 1e-6 and -1.0 <= jl <= 1.0
    np.testing.assert_allclose(it.grad.numpy(), jg,
                               atol=1e-5 * np.abs(jg).max())
    with torch.no_grad():
        lower = tcg.clip_loss(tp, it - 10.0 * it.grad, tz, size=32)
    assert float(lower) < float(tl)


def _clip_draws(key, n, k):
    """The draws JAX's CLIP step makes from ``key`` (trainer.py:191-193,
    fast.py:148): the pose's two uniforms and the renderer's."""
    k_pose, k_perturb = jax.random.split(key)
    kc, kf = jax.random.split(k_perturb)
    return {"u_pose": T(np.asarray(jax.random.uniform(k_pose, (2,)))),
            "u_coarse": T(np.asarray(jax.random.uniform(kc, (n, k // 2)))),
            "u_fine": T(np.asarray(jax.random.uniform(kf, (n, k - k // 2))))}


def reference_pose(u1, u2, radius):
    """The orbit pose of JAX's CLIP step's draws as the reference's
    rand_poses builds it (pienerf_tpu/data/provider.py:28-53): looking at
    the origin."""
    theta = jnp.pi / 3.0 + u1 * jnp.pi / 3.0
    phi = u2 * 2.0 * jnp.pi
    center = radius * jnp.stack([jnp.sin(theta) * jnp.sin(phi),
                                 jnp.cos(theta),
                                 jnp.sin(theta) * jnp.cos(phi)])

    def norm(v):
        return v / (jnp.linalg.norm(v) + 1e-10)

    forward = -norm(center)
    right = norm(jnp.cross(forward, jnp.asarray([0.0, -1.0, 0.0])))
    up2 = norm(jnp.cross(right, forward))
    return jnp.eye(4).at[:3, 0].set(right).at[:3, 1].set(up2).at[
        :3, 2].set(forward).at[:3, 3].set(center)


def jax_clip_step(spec, optimizer, clip_params, text_z, rH, rW, intrinsics,
                  radius, num_samples, clip_size, ema_decay=0.95):
    """JAX's make_clip_step (pienerf_tpu/train/trainer.py:159-228) with
    the reference's orbit pose in place of its own, which faces away from
    the scene (ROADMAP section 3): the same draws, render, loss, optimizer
    and EMA, in JAX."""
    import optax

    from pienerf_tpu.data.rays import get_rays_full
    from pienerf_tpu.render import fast as jfast

    fs = jfast.FastSettings(bound=1.0, num_coarse=num_samples // 2,
                            num_fine=num_samples - num_samples // 2)

    @jax.jit
    def step(state, rng):
        k_pose, k_perturb = jax.random.split(rng)
        u1, u2 = jax.random.uniform(k_pose, (2,))
        ro, rd = get_rays_full(reference_pose(u1, u2, radius), intrinsics,
                               rH, rW)

        def loss_fn(params):
            out = jfast.render_rays_fast(params, spec, fs, ro, rd,
                                         jnp.ones((ro.shape[0], 3)),
                                         k_perturb)
            return jcg.clip_loss(clip_params, out["image"].reshape(
                1, rH, rW, 3), text_z, size=clip_size)

        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        updates, opt_state = optimizer.update(grads, state.opt_state,
                                              state.params)
        params = optax.apply_updates(state.params, updates)
        ema = jax.tree_util.tree_map(
            lambda e, p: ema_decay * e + (1.0 - ema_decay) * p,
            state.ema_params, params)
        return jtr.TrainState(params, opt_state, ema, state.step + 1), loss

    return step


def test_the_orbit_pose_looks_at_the_scene():
    """The port's orbit pose is the reference's rand_poses construction
    (its rays, along the third column, head for the origin) within 1e-6;
    JAX's CLIP step puts -forward there and so renders the space behind
    its camera, where the box lies: the near / far test gives reversed
    intervals, and its 64x64 frame at radius 2.5 is no image (values far
    outside [0, 1], up to 4e36 here; NaN at other draws), while the
    frame of the same field and draw from the port's pose is one."""
    from pienerf_tpu.data.rays import get_rays_full
    from pienerf_tpu.render import fast as jfast

    u = np.array([0.3, 0.7], np.float32)
    pose = ttr.orbit_pose(T(u), 2.5).numpy()
    np.testing.assert_allclose(pose, np.asarray(reference_pose(
        jnp.float32(u[0]), jnp.float32(u[1]), 2.5)), atol=1e-6)
    toward = -pose[:3, 3] / np.linalg.norm(pose[:3, 3])
    assert pose[:3, 2] @ toward > 0.999
    # JAX's own step's pose, as trainer.py:197-208 builds it
    fwd = jnp.asarray(toward)
    right = jnp.cross(fwd, jnp.asarray([0.0, 1.0, 0.0]))
    right = right / jnp.linalg.norm(right)
    jpose = jnp.eye(4).at[:3, 0].set(right).at[:3, 1].set(
        jnp.cross(right, fwd)).at[:3, 2].set(-fwd).at[:3, 3].set(
        jnp.asarray(pose[:3, 3]))
    spec = jnet.make_spec(bound=1.0, backbone="mlp")
    params = jnet.init_params(jax.random.PRNGKey(0), spec)
    fs = jfast.FastSettings(bound=1.0, num_coarse=16, num_fine=16)
    intr = (57.6, 57.6, 32.0, 32.0)

    @jax.jit
    def frame(p):
        ro, rd = get_rays_full(p, intr, 64, 64)
        return jfast.render_rays_fast(params, spec, fs, ro, rd,
                                      jnp.ones((4096, 3)),
                                      jax.random.PRNGKey(1))["image"]

    imgs = [np.asarray(frame(p)) for p in (jpose, jnp.asarray(pose))]
    def is_image(img):
        return bool(np.isfinite(img).all() and img.min() >= 0.0
                    and img.max() <= 1.0 + 1e-5)

    assert not is_image(imgs[0]) and is_image(imgs[1])
    assert (np.abs(imgs[1] - 1.0) > 1e-2).mean() > 0.1


def test_three_clip_steps_match_jax(tiny):
    """Three CLIP steps of a small mlp (16x16 frames from random orbit
    poses at radius 2, 8 samples, CLIP at 32 px) from JAX's state, with
    JAX's draws, against JAX's step with the reference's pose
    (``jax_clip_step``): each loss within 1e-5 relative; after the steps,
    the params and the EMA within 1e-4 where they moved by more than 1e-3
    in JAX (Adam's first steps move a param by about lr whatever the size
    of its gradient, so a param whose gradient is near zero may move
    either way: those are counted, at most 0.5% of a leaf); the step
    count; finite losses and moved params."""
    jp, tp = tiny
    rs = np.random.RandomState(5)
    ids = rs.randint(0, VOCAB, size=(1, 8))
    jz = jax.jit(lambda i: jcg.encode_text(jp, i))(
        jnp.asarray(ids, jnp.int32))
    tz = tcg.encode_text(tp, T(ids))
    jspec = jnet.make_spec(bound=1.0, backbone="mlp", n_freqs=2,
                           num_layers=2)
    tspec = tnet.make_spec(bound=1.0, backbone="mlp", n_freqs=2,
                           num_layers=2)
    params = jnet.init_params(jax.random.PRNGKey(0), jspec)
    jopt = jtr.make_optimizer(1e-3, 100)
    jstate = jtr.TrainState(params, jopt.init(params), params,
                            jnp.zeros((), jnp.int32))
    tstate = W.train_state_from_numpy(jax.device_get(jstate), tspec, "cpu")
    kw = dict(rH=16, rW=16, intrinsics=(16.0, 16.0, 8.0, 8.0), radius=2.0,
              num_samples=8, clip_size=32)
    jstep = jax_clip_step(jspec, jopt, jp, jz, **kw)
    tstep = ttr.make_clip_step(tspec, ttr.make_optimizer(1e-3, 100), tp, tz,
                               **kw)
    for i in range(3):
        key = jax.random.PRNGKey(i + 1)
        jstate, jl = jstep(jstate, key)
        tstate, tl = tstep(tstate, draws=_clip_draws(key, 256, 8))
        assert np.isfinite(float(tl))
        assert abs(float(tl) / float(jl) - 1.0) <= 1e-5, (i, tl, jl)
    assert int(tstate.step) == int(jstate.step) == 3
    jn = jax.device_get(jstate)
    tn = W.train_state_to_numpy(tstate)
    moved = 0.0
    for j0, jl_, tl_ in zip(W._tree_leaves(params), W._tree_leaves(
            jn.params), W._tree_leaves(tn["params"])):
        j0, jl_ = np.asarray(j0), np.asarray(jl_)
        big = np.abs(jl_ - j0) > 1e-3
        np.testing.assert_allclose(tl_[big], jl_[big], atol=1e-4)
        assert (np.abs(tl_ - jl_) > 1e-4).mean() <= 5e-3
        moved += float(np.abs(tl_ - j0).sum())
    assert moved > 0.0
    for a, b in zip(W._tree_leaves(jn.ema_params),
                    W._tree_leaves(tn["ema_params"])):
        np.testing.assert_allclose(b, np.asarray(a), atol=1e-4)


def test_guidance_api(tiny):
    """CLIPGuidance: a call before prepare_text raises, prepare_text
    needs ids or a tokenizer directory, and the prepared guide's loss is
    clip_loss with the ids' text features (held to JAX's above), exactly;
    the params go onto the guide's device."""
    jp, tp = tiny
    guide = tcg.CLIPGuidance(jp, device="cpu")
    with pytest.raises(RuntimeError, match="prepare_text"):
        guide(torch.zeros((1, 8, 8, 3)))
    with pytest.raises(ValueError, match="tokenizer_dir"):
        guide.prepare_text(["a chair"])
    rs = np.random.RandomState(4)
    ids = rs.randint(0, VOCAB, size=(1, 8))
    img = rs.rand(1, 16, 16, 3).astype(np.float32)
    guide.prepare_text(ids=ids)
    want = tcg.clip_loss(tp, T(img), tcg.encode_text(tp, T(ids)), size=32)
    assert float(guide(T(img), size=32)) == float(want)
    assert guide.params["vision"]["proj"].device.type == "cpu"
    assert guide.params["text"]["heads"] == 2
