"""Port parity for the tile kernel's two schedule variants (CPU): the
paired pack (sigma chain beside the previous segment's color chain) and
``block_tiles`` (B tiles per block), through ``render_frame_fused`` against
the JAX package's Pallas kernel in interpret mode, in the deformed, static
and cut modes; and the port's own exactness claims: paired equals unpaired
and B = 3 equals B = 1, bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pienerf_tpu.models import network as jnet
from pienerf_tpu.ops import beam_bend as jbb
from pienerf_tpu.ops.pallas import field_kernel as jfk
from pienerf_tpu.render import interactive as jint
from pienerf_tpu_torch.kernels import field as tfk
from pienerf_tpu_torch.kernels import tile as ttk
from pienerf_tpu_torch.models import network as tnet
from pienerf_tpu_torch.ops import beam_bend as tbb
from pienerf_tpu_torch.render import interactive as tint
from pienerf_tpu_torch.weights import field_from_numpy

CPU = torch.device("cpu")
H = W = 64
INTR = (64.0, 64.0, W / 2, H / 2)
CB = np.asarray([-0.2, 0.3, -0.5, 0.5, -0.5, 0.5], np.float32)
MODES = ("deformed", "static", "cut")
COUNTERS = ("n_active", "n_tile_overflow", "dropped_beam", "dropped_window")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread a test: the tensors here are small, and the test
    workers share the machine's cores, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_params(seed=0):
    """Random mlp-backbone weights from numpy (Kaiming-uniform bounds)."""
    rng = np.random.RandomState(seed)

    def lay(dims):
        return [rng.uniform(-1, 1, (dims[i], dims[i + 1])).astype(np.float32)
                * np.float32(np.sqrt(3.0 / dims[i]))
                for i in range(len(dims) - 1)]
    return {"sigma_net": lay([51, 64, 64, 64, 16]),
            "color_net": lay([31, 64, 64, 3])}


def _ip_grid(r0=0.45, dx=0.1, shift=(0.1, 0.0, 0.0)):
    """The shifted IP ball of tests/test_tile_kernel.py:525-578."""
    c = np.arange(-r0, r0 + 1e-6, dx, dtype=np.float32)
    xx, yy, zz = np.meshgrid(c, c, c, indexing="ij")
    p = np.stack([xx.ravel(), yy.ravel(), zz.ravel()], 1)
    p = p[np.linalg.norm(p, axis=1) <= r0 + dx / 2]
    n = p.shape[0]
    F = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
    dF = np.zeros((n, 3, 3, 3), np.float32)
    return (p + np.asarray(shift, np.float32)).astype(np.float32), p, F, dF


def _pose():
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (0.0, 0.0, -2.5)
    return pose


def _settings(mod, bbmod, spec, mode, block_tiles=1):
    bst = bbmod.BeamBendSettings(num_seek_ip=3, max_iter_num=1,
                                 ip_dx=1.05 * 0.1, ips_per_tile=192)
    return mod.InteractiveSettings(
        spec=spec, bend=bst, tile=16, samples=16, active_frac=1.0,
        tile_chunk=4, min_near=0.05, deformed=mode != "static",
        cut=mode == "cut", block_tiles=block_tiles)


@pytest.fixture(scope="module")
def scene():
    """Inputs, both packs on both sides, and the JAX frames of the Pallas
    kernel in interpret mode: per mode one with the paired pack, and in the
    deformed mode one with block_tiles=3 (a B-tile body unrolls B times, so
    it compiles three times as long; four compiles in all, shared by every
    case of this module)."""
    params = _np_params()
    jspec = jnet.make_spec(bound=1.0, backbone="mlp", compute_dtype="float32")
    tspec = tnet.make_spec(bound=1.0, compute_dtype="float32")
    field = field_from_numpy(params, tspec, CPU)
    ips = _ip_grid()
    jips = tuple(jnp.asarray(a) for a in ips)
    tips = tuple(torch.from_numpy(a) for a in ips)
    s = dict(
        tspec=tspec, params=params,
        tpw=tfk.pack_weights(field, tspec, CPU),
        tpwp=tfk.pack_weights_paired(field, tspec, CPU),
        jpwp=jfk.pack_weights_paired(params, jspec),
        tpack=tbb.pack_ip_data_fast(*tips), tp_def=tips[0], jax={})
    jpack = jbb.pack_ip_data_fast(*jips)

    def jax_frame(mode, pw, B):
        kw = {"cut_bounds": jnp.asarray(CB)} if mode == "cut" else {}
        return jax.device_get(jint.render_frame_fused(
            _settings(jint, jbb, jspec, mode, B), pw, jpack, jips[0],
            jnp.asarray(_pose()), INTR, H, W, jnp.float32(1.0), **kw))
    for mode in MODES:
        s["jax"][mode, "paired"] = jax_frame(mode, s["jpwp"], 1)
    s["jax"]["deformed", "block"] = jax_frame(
        "deformed", jfk.pack_weights(params, jspec), 3)
    return s


def _port_frame(scene, mode, pw, block_tiles=1):
    kw = {"cut_bounds": torch.from_numpy(CB)} if mode == "cut" else {}
    return tint.render_frame_fused(
        _settings(tint, tbb, scene["tspec"], mode, block_tiles), pw,
        scene["tpack"], scene["tp_def"], torch.from_numpy(_pose()), INTR, H,
        W, 1.0, **kw)


def test_pack_weights_paired_equals_jax(scene):
    assert tuple(scene["tpwp"].shape) == (4, 128, 128)
    np.testing.assert_array_equal(scene["tpwp"].numpy(),
                                  np.asarray(scene["jpwp"]))
    spec = scene["tspec"]
    assert tfk.is_paired(spec, scene["tpwp"])
    assert not tfk.is_paired(spec, scene["tpw"])
    assert tfk.check_kernel_spec(spec, scene["tpwp"], allow_paired=True) == 64
    with pytest.raises(NotImplementedError):     # the field kernel's callers
        tfk.check_kernel_spec(spec, scene["tpwp"])
    with pytest.raises(ValueError):              # only a 64-wide net pairs
        tfk.pack_weights_paired(
            scene["params"], tnet.make_spec(bound=1.0, hidden_dim=128,
                                            hidden_dim_color=128,
                                            n_freqs=10), CPU)
    x = torch.zeros((3, 4))
    with pytest.raises(ValueError):              # no silent garbage
        tfk.field_eval(scene["tpwp"], spec, x, x + 1.0)


@pytest.mark.parametrize("variant", ["paired", "block"])
@pytest.mark.parametrize("mode", MODES)
def test_fused_frame_variant_matches_jax(scene, mode, variant):
    # the static and cut B = 3 frames are held to JAX's paired frame of
    # the mode: JAX's own tests hold its block and paired frames to its
    # default frame
    ref = scene["jax"].get((mode, variant), scene["jax"][mode, "paired"])
    out = (_port_frame(scene, mode, scene["tpwp"]) if variant == "paired"
           else _port_frame(scene, mode, scene["tpw"], block_tiles=3))
    img_j = np.asarray(ref["tiles_image"])
    assert np.abs(img_j - 1.0).max() > 0.1          # the object is there
    # f32 order of the MLP and composite sums, the tolerance of
    # tests/test_torch_frame.py
    assert np.abs(out["tiles_image"].numpy() - img_j).max() <= 1e-4
    np.testing.assert_allclose(out["tiles_depth"].numpy(),
                               np.asarray(ref["tiles_depth"]), atol=1e-4)
    for k in COUNTERS:
        assert int(out[k]) == int(ref[k]), k


@pytest.mark.parametrize("mode", MODES)
def test_paired_and_block_frames_equal_default_exactly(scene, mode):
    """The schedules change no sum's order: the paired frame and the B = 3
    frame (16 slots, so one padded slot) equal the default frame bit for
    bit, counters included."""
    base = _port_frame(scene, mode, scene["tpw"])
    for out in (_port_frame(scene, mode, scene["tpwp"]),
                _port_frame(scene, mode, scene["tpw"], block_tiles=3),
                _port_frame(scene, mode, scene["tpwp"], block_tiles=3)):
        for k in ("tiles_image", "tiles_depth", "tiles_ws"):
            assert torch.equal(out[k], base[k]), k
        for k in COUNTERS:
            assert int(out[k]) == int(base[k]), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_render_tiles_plain_paired_follows_pending_schedule(scene, dtype):
    """The paired plain version is its own computation (block-diagonal
    products, rgb one segment late, the drain), not a relabelled unpaired
    call: it still equals it exactly, in both compute types, and a pack
    whose color blocks are zeroed changes rgb but not depth."""
    spec = scene["tspec"]._replace(compute_dtype=dtype)
    st = _settings(tint, tbb, spec, "deformed")
    pose = torch.from_numpy(_pose())
    (_, o, bbmin, bbmax, ids, mask, _, _) = tint.active_tiles(
        st, scene["tp_def"], pose, INTR, H, W, st.tile_chunk)
    args, kw, _ = tint.tile_kernel_inputs(
        st, scene["tpack"], scene["tp_def"], o, pose, INTR, H, W, ids, mask,
        bbmin, bbmax)
    a = ttk.render_tiles_plain(spec, scene["tpw"], *args, **kw)
    b = ttk.render_tiles_plain(spec, scene["tpwp"], *args, **kw)
    assert a[:, 4].max() > 0.1
    assert torch.equal(a, b)
    broken = scene["tpwp"].clone()
    broken[:, 64:, 64:] = 0.0
    c = ttk.render_tiles_plain(spec, broken, *args, **kw)
    assert torch.equal(c[:, 3:6], a[:, 3:6])
    assert (c[:, 0:3] - a[:, 0:3]).abs().max() > 1e-2
    with pytest.raises(ValueError):       # paired demanded of a flat pack
        ttk.render_tiles_plain(spec, scene["tpw"], *args, **kw, paired=True)
    with pytest.raises(ValueError):       # and refused of a paired one
        ttk.render_tiles_plain(spec, scene["tpwp"], *args, **kw,
                               paired=False)
    with pytest.raises(ValueError):
        ttk.render_tiles(spec, scene["tpw"], *args, **kw, block_tiles=0)
