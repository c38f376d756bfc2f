"""Port parity: the field model, the field kernel's plain version, and the
native checkpoint format (pienerf_tpu_torch vs pienerf_tpu on the CPU)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pienerf_tpu.io import checkpoint as jckpt
from pienerf_tpu.models import network as jnet
from pienerf_tpu.ops.pallas import field_kernel as jfk
from pienerf_tpu_torch.io import checkpoint as tckpt
from pienerf_tpu_torch.kernels import field as tfk
from pienerf_tpu_torch.models import network as tnet
from pienerf_tpu_torch.weights import field_from_numpy

CKPT = os.path.join(os.path.dirname(__file__), "..",
                    "runs/quality_mlp_800/checkpoints/ngp_ep0015.npz")
CPU = torch.device("cpu")


def _nets(dtype="float32", seed=0):
    jspec = jnet.make_spec(bound=1.0, backbone="mlp", compute_dtype=dtype)
    params = jax.device_get(jnet.init_params(jax.random.PRNGKey(seed), jspec))
    tspec = tnet.make_spec(bound=1.0, compute_dtype=dtype)
    return jspec, params, tspec, field_from_numpy(params, tspec, CPU)


def _points(n, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return x, d


def test_field_mlp_forward_matches_jax():
    # f32 both sides; rtol 1e-5 covers f32 summation-order differences
    jspec, params, tspec, field = _nets()
    x, d = _points(512)
    js, jr = jnet.forward(params, jspec, jnp.asarray(x), jnp.asarray(d))
    ts, tr = field(torch.from_numpy(x), torch.from_numpy(d))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_field_eval_plain_matches_pallas_interpret(dtype):
    jspec, params, tspec, field = _nets(dtype, seed=1)
    x, d = _points(2048, seed=1)
    jpw = jfk.pack_weights(params, jspec)
    js, jr = jfk.field_eval(jpw, jspec, tuple(jnp.asarray(x[:, i])
                                              for i in range(3)),
                            tuple(jnp.asarray(d[:, i]) for i in range(3)))
    tpw = tfk.pack_weights(field, tspec, CPU)
    np.testing.assert_array_equal(tpw.numpy(), np.asarray(jpw))
    ts, tr = tfk.field_eval(tpw, tspec, torch.from_numpy(x.T.copy()),
                            torch.from_numpy(d.T.copy()))
    js, jr = np.asarray(js), np.asarray(jr)
    if dtype == "float32":
        # f32 reordering scale
        np.testing.assert_allclose(ts.numpy(), js, rtol=1e-5)
        np.testing.assert_allclose(tr.numpy(), jr, rtol=1e-5, atol=1e-6)
    else:
        # one bf16 ulp (2^-8 relative) can flip with summation order and
        # propagate through the layers
        np.testing.assert_allclose(tr.numpy(), jr, atol=1e-2)
        np.testing.assert_allclose(ts.numpy(), js, rtol=2e-2)


def test_native_checkpoint_roundtrip(tmp_path):
    _, params, _, _ = _nets()
    path = str(tmp_path / "ck.npz")
    tckpt.save_native(path, {"ema_params": params},
                      extra={"epoch": 3, "grid": np.arange(4.0)})
    tree, extra = tckpt.load_native(path)
    for name in ("sigma_net", "color_net"):
        for a, b in zip(tree["ema_params"][name], params[name]):
            np.testing.assert_array_equal(a, b)
    assert extra["epoch"] == 3
    np.testing.assert_array_equal(extra["grid"], np.arange(4.0))
    # the JAX reader sees the same tree
    jtree, jextra = jckpt.load_native(path)
    np.testing.assert_array_equal(np.asarray(jtree["ema_params"]
                                             ["sigma_net"][0]),
                                  params["sigma_net"][0])
    assert jextra["epoch"] == 3


def test_trained_checkpoint_loads_like_jax():
    tree, extra = tckpt.load_native(os.path.abspath(CKPT))
    jtree, jextra = jckpt.load_native(os.path.abspath(CKPT))
    assert sorted(tree) == sorted(jtree)
    for key in ("params", "ema_params"):
        for name in ("sigma_net", "color_net"):
            assert len(tree[key][name]) == len(jtree[key][name])
            for a, b in zip(tree[key][name], jtree[key][name]):
                np.testing.assert_array_equal(a, np.asarray(b))
    assert set(extra) == set(jextra)
    p = tree["ema_params"]
    spec = tnet.make_spec(bound=1.0,
                          n_freqs=(p["sigma_net"][0].shape[0] // 3 - 1) // 2,
                          num_layers=len(p["sigma_net"]))
    pw = tfk.pack_weights(field_from_numpy(p, spec, CPU), spec, CPU)
    assert tuple(pw.shape) == (7, 64, 64)
