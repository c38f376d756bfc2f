"""The port trainer's tensorboard scalars against the JAX trainer's (CPU):
the same tags at the same steps, from one state and JAX's draws, and the
scanned-chunk schedule at which JAX writes train/loss."""

import functools
import os
import struct

import jax
import numpy as np
import pytest
import torch

from pienerf_tpu.config import PieNeRFConfig as JCfg
from pienerf_tpu.data import rays as jrays
from pienerf_tpu.train import trainer as jtr
from pienerf_tpu_torch import weights as W
from pienerf_tpu_torch.config import PieNeRFConfig as TCfg
from pienerf_tpu_torch.data import synthetic
from pienerf_tpu_torch.train import trainer as ttr

T = torch.as_tensor


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread a test: the tensors here are small, and the test
    workers share the machine's cores, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scalars(logdir):
    """{tag: [(step, value)]} of the event files under ``logdir``: TFRecord
    framing (length, its CRC, the record, its CRC) around Event protos."""
    from tensorboardX.proto import event_pb2

    out = {}
    for name in sorted(os.listdir(logdir)):
        with open(os.path.join(logdir, name), "rb") as f:
            data = f.read()
        pos = 0
        while pos < len(data):
            (n,) = struct.unpack("<Q", data[pos:pos + 8])
            ev = event_pb2.Event.FromString(data[pos + 12:pos + 12 + n])
            pos += 16 + n
            for v in ev.summary.value:
                out.setdefault(v.tag, []).append((ev.step, v.simple_value))
    return out


def test_tensorboard_scalars_equal_jax(tmp_path, monkeypatch):
    """Both trainers from one state (JAX's, carried across), 16 steps on
    one view with JAX's draws handed to the port, then an evaluation:
    the same tags at the same steps (train/loss at each of JAX's 8-step
    scanned chunks, eval/psnr, eval/ssim); train/loss within the one-step
    tolerance of tests/test_torch_train.py (1e-6 relative); eval/psnr
    within 1e-5 and eval/ssim within 1e-4 relative (the hierarchical
    renders agree to 2e-4 abs, tests/test_torch_train.py; read here: 4e-7
    and 1.8e-5)."""
    n_rays, k, hw = 64, 16, 16
    kw = dict(bound=1.0, backbone="mlp", min_near=0.05, dt_gamma=0.0,
              iters=100, num_rays=n_rays, train_max_samples=k)
    jt = jtr.Trainer("ngp", JCfg(workspace=str(tmp_path / "j"),
                                 **kw).finalize(), use_checkpoint="scratch")
    tt = ttr.Trainer("ngp", TCfg(workspace=str(tmp_path / "t"),
                                 **kw).finalize(), use_checkpoint="scratch",
                     device="cpu")
    assert jt.writer is not None and tt.writer is not None
    tt.state = W.train_state_from_numpy(jax.device_get(jt.state), tt.spec,
                                        "cpu")
    ds = synthetic.make_dataset(n_views=1, H=hw, W=hw, seed=0)

    # JAX's draws: a key per chunk, a key per step, split in three (view,
    # pixels, step); the step's split in two (background, perturb), the
    # perturb's in two (coarse, fine) (trainer.py:253-283, :108;
    # fast.py:148-163)
    inds, draws = [], []
    rng = jt.rng
    for _ in range(2):
        rng, kc = jax.random.split(rng)
        for key in jax.random.split(kc, 8):
            _, k2, k3 = jax.random.split(key, 3)
            inds.append(np.asarray(jrays.sample_pixel_indices(
                k2, hw, hw, n_rays)[0]))
            _, kp = jax.random.split(k3)
            a, b = jax.random.split(kp)
            draws.append({"u_coarse": T(np.array(jax.random.uniform(
                a, (n_rays, k // 2)))), "u_fine": T(np.array(
                    jax.random.uniform(b, (n_rays, k - k // 2))))})
    it_inds, it_draws = iter(inds), iter(draws)
    monkeypatch.setattr(ttr, "sample_pixel_indices",
                        lambda *a, **kw: (T(np.array(next(it_inds))).long(),
                                         None))
    step = tt._train_step
    tt._train_step = lambda st, bf, batch, generator=None: step(
        st, bf, batch, draws=next(it_draws))
    jt.train_iterations(ds, 16)
    tt.train_iterations(ds, 16)

    # the evaluation: JAX's render key PRNGKey(0), one chunk of 256 rays
    _, kr = jax.random.split(jax.random.PRNGKey(0))
    a, b = jax.random.split(kr)
    ev = (T(np.array(jax.random.uniform(a, (hw * hw, 128)))),
          T(np.array(jax.random.uniform(b, (hw * hw, 128)))))
    render = tt.render_pose
    tt.render_pose = functools.partial(render, draws=ev)
    jt.evaluate(ds, save_images=False)
    tt.evaluate(ds, save_images=False)
    jt.writer.close()          # drains the writers' queues
    tt.writer.close()

    js = _scalars(os.path.join(jt.workspace, "run"))
    ts = _scalars(os.path.join(tt.workspace, "run"))
    assert sorted(ts) == sorted(js) == ["eval/psnr", "eval/ssim",
                                        "train/loss"]
    for tag, tol in (("train/loss", 1e-6), ("eval/psnr", 1e-5),
                     ("eval/ssim", 1e-4)):
        assert [s for s, _ in ts[tag]] == [s for s, _ in js[tag]], tag
        for (_, a), (_, b) in zip(ts[tag], js[tag]):
            assert abs(a / b - 1.0) <= tol, (tag, a, b)
    assert [s for s, _ in ts["train/loss"]] == [8, 16]
    assert [s for s, _ in ts["eval/psnr"]] == [16]


def test_scan_chunks_follow_jax():
    """The port writes train/loss where JAX's scanned loop ends a chunk:
    every 8 steps on the hierarchical path; on the march, up to each grid
    update (every update_extra_interval steps) and never across the
    precision tail's start (pienerf_tpu/train/trainer.py:534-546)."""
    def chunks(fast, step, n, uei=16, ts=None):
        t = type("T", (), {})()
        t._use_fast_train = fast
        t.global_step = step
        t.cfg = type("C", (), {"update_extra_interval": uei,
                               "precision_tail_start": ts})()
        out = []
        while n:
            c = ttr.Trainer._scan_chunk(t, n)
            out.append(c)
            t.global_step += c
            n -= c
        return out

    assert chunks(True, 0, 20) == [8, 8, 4]
    assert chunks(True, 5, 20, ts=9) == [4, 8, 8]
    assert chunks(False, 10, 30) == [6, 16, 8]
    assert chunks(False, 0, 20, uei=4, ts=6) == [4, 2, 2, 4, 4, 4]


def test_loss_scalars_at_jax_steps():
    """train/loss as the JAX trainer writes it (trainer.py:581-582,
    :637-638): each scanned chunk's f32 mean at the chunk's last step;
    with host-resident images (its eager loop) the step's own loss at
    every 50th step."""
    written = []
    t = type("T", (), {})()
    t.writer = type("W", (), {"add_scalar": lambda self, tag, v, step:
                              written.append((tag, v, step))})()
    losses = np.random.RandomState(0).rand(120).astype(np.float32)
    ttr.Trainer._write_losses(t, losses, 30, [8, 16, 20], False)
    assert written == [("train/loss", float(losses[a:b].mean()), 30 + b)
                       for a, b in ((0, 8), (8, 16), (16, 20))]
    written.clear()
    ttr.Trainer._write_losses(t, losses, 30, [], True)
    assert written == [("train/loss", float(losses[i]), 31 + i)
                       for i in (19, 69, 119)]
