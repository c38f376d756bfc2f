"""torch-ngp's hash-grid field on the port's fused frame: its pack with the
embedding table, the schedules that refuse it, the CPU frame (the tile
kernel's plain twin) against the benchmark's plain reference, the device
counters' switch, and the entry points serving it. The emulated CUDA
kernel is held to the plain twin in ``test_torch_cuda_emu.py``."""

import contextlib
import io
import os
import sys

import numpy as np
import pytest
import torch

from pienerf_tpu_torch.kernels import field as tfk
from pienerf_tpu_torch.kernels import tile as ttk
from pienerf_tpu_torch.models import hash_encoder
from pienerf_tpu_torch.models import network as tnet
from pienerf_tpu_torch.ops import beam_bend as tbb
from pienerf_tpu_torch.render import interactive as tint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.reference import hashgrid as ref_grid  # noqa: E402
from benchmark.reference import render as ref_render  # noqa: E402

CPU = torch.device("cpu")
# the published net's 16 levels x 2 features at a small size: levels 0-1
# dense ((2 + 1)^3 and (4 + 1)^3 rows fit their 32 and 128), levels 2-15
# hashed into 128 rows each (per-level scale 2, as desired_resolution
# 2 x 2^15 gives it)
GRID_KW = dict(num_levels=16, level_dim=2, base_resolution=2,
               log2_hashmap_size=7, desired_resolution=65536)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread a test: the tensors here are small, and the test
    workers share the machine's cores, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _field(seed, bound=1.0, **kw):
    """A seeded hash-grid field at the small grid, its table drawn in
    [-1, 1] so that the encoding matters."""
    spec = tnet.make_spec(bound=bound, backbone="hashgrid", **kw)._replace(
        grid=hash_encoder.make_spec(**GRID_KW))
    gen = torch.Generator().manual_seed(seed)
    field = tnet.FieldMLP(spec, generator=gen)
    field.encoder.data = torch.rand(field.encoder.shape,
                                    generator=gen) * 2 - 1
    return spec, field


def _round_mantissa(t, drop):
    """``t`` (f32) rounded to nearest with its low ``drop`` mantissa bits
    cleared: 16 leaves bf16's 7 bits, 13 TF32's 10."""
    i = t.contiguous().view(torch.int32)
    return ((i + (1 << (drop - 1))) & ~((1 << drop) - 1)).view(torch.float32)


def test_grid_pack_carries_the_table_and_is_checked():
    spec, field = _field(1)
    pw = tfk.pack_weights(field, spec, CPU)
    assert isinstance(pw, tfk.GridPack) and tfk.is_grid_pack(pw)
    assert tuple(pw.shape) == (5, 64, 64)
    assert torch.equal(pw[0, :32], field.sigma_net[0])
    assert torch.equal(pw[4, :64, :3], field.color_net[2])
    assert torch.equal(pw.table, field.encoder)
    # an operation on the pack gives a plain tensor, without the table
    assert type(pw[0]) is torch.Tensor and not hasattr(pw + 0, "table")
    # a params tree whose encoder is a one-table list packs the same
    tree = {k: ([w.numpy() for w in v] if isinstance(v, list)
                else [v.numpy()]) for k, v in field.tree().items()}
    pw2 = tfk.pack_weights(tree, spec, CPU)
    assert torch.equal(pw2, pw) and torch.equal(pw2.table, pw.table)
    assert tfk.check_kernel_spec(spec, pw, allow_grid=True) == tfk.GRID_NET
    # the field kernel (the Newton frames) refuses it, naming the fused
    # frame
    with pytest.raises(NotImplementedError, match="render_frame_fused"):
        tfk.check_kernel_spec(spec, pw)
    with pytest.raises(NotImplementedError, match="render_frame_fused"):
        tfk.field_eval(pw, spec, torch.zeros(3, 4), torch.ones(3, 4))
    # a grid of other levels, or a table of other rows, is not the net
    g8 = hash_encoder.make_spec(**{**GRID_KW, "num_levels": 8})
    spec8 = spec._replace(grid=g8)
    f8 = tnet.FieldMLP(spec8, generator=torch.Generator().manual_seed(1))
    with pytest.raises(NotImplementedError, match="16 levels"):
        tfk.check_kernel_spec(spec8, tfk.pack_weights(f8, spec8, CPU),
                              allow_grid=True)
    short = tfk.GridPack(pw, pw.table[:-8])
    with pytest.raises(NotImplementedError, match="table"):
        tfk.check_kernel_spec(spec, short, allow_grid=True)
    # the Fourier nets keep their plain packs
    mspec = tnet.make_spec(bound=1.0)
    mpw = tfk.pack_weights(tnet.FieldMLP(mspec), mspec, CPU)
    assert type(mpw) is torch.Tensor and tuple(mpw.shape) == (7, 64, 64)


def _tile_args():
    """A static tile pass of one tile: the rays from (0, 0, -2.5) into the
    box, 16 samples."""
    tile_sc = torch.tensor([[1.5, 3.5, 1.0] + [0.0] * 5])
    params = torch.zeros(24)
    params[0:3] = torch.tensor([0.0, 0.0, -2.5])
    params[3:6], params[6:9] = -1.0, 1.0
    params[9], params[10], params[12], params[19] = 1e-2, 1.0, 0.05, 0.5
    dirs = torch.zeros((1, 8, 256))
    dirs[:, 2] = 1.0
    cand = torch.zeros((1, 16, 16))
    bs = torch.zeros((1, 20), dtype=torch.int32)
    return (tile_sc, bs, params, dirs, cand), dict(
        K=16, Ks=8, Ksb=4, Wn=16, num_seek=1, deformed=False, cut=False)


@pytest.mark.parametrize("what", ["bfloat16", "paired", "block"])
def test_grid_schedules_other_than_f32_default_raise(what):
    """The hash-grid net runs the tile kernel's f32 default schedule
    alone: bf16, the paired schedule and block_tiles > 1 raise, naming
    the net, on the CPU as on the card."""
    spec, field = _field(2)
    if what == "bfloat16":
        spec = spec._replace(compute_dtype="bfloat16")
    pw = tfk.pack_weights(field, spec, CPU)
    args, kw = _tile_args()
    extra = {"paired": {"paired": True}, "block": {"block_tiles": 2}}.get(
        what, {})
    with pytest.raises(NotImplementedError, match=tfk.GRID_NET):
        ttk.render_tiles(spec, pw, *args, **kw, **extra)
    with pytest.raises(NotImplementedError, match=tfk.GRID_NET):
        ttk.render_tiles_plain(spec, pw, *args, **kw, **extra)


def test_grid_plain_pass_encodes_with_the_hash_grid():
    """The plain twin encodes a hash-grid pack with the grid (its table
    moves the frame; zeros outside the box leave nothing to read) and
    counts the live points inside the box."""
    spec, field = _field(3)
    pw = tfk.pack_weights(field, spec, CPU)
    args, kw = _tile_args()
    st = {}
    out = ttk.render_tiles_plain(spec, pw, *args, **kw, stats=st)
    assert out[0, 4].max() > 0.0
    assert st["points"] > 0 and st["inside"] == st["points"]
    flat = tfk.GridPack(pw, torch.zeros_like(pw.table))
    assert not torch.equal(ttk.render_tiles_plain(spec, flat, *args, **kw),
                           out)
    # the grid shrunk to a box the rays never enter: nothing inside
    small = spec._replace(bound=0.01)
    st = {}
    ttk.render_tiles_plain(small, pw, *args, **kw, stats=st)
    assert st["points"] > 0 and st["inside"] == 0


def _scene():
    """A twisted IP ball (the emulation tests' frame scene)."""
    c = np.arange(-0.3, 0.3 + 1e-6, 0.08, dtype=np.float32)
    xx, yy, zz = np.meshgrid(c, c, c, indexing="ij")
    p = np.stack([xx.ravel(), yy.ravel(), zz.ravel()], 1)
    p = p[np.linalg.norm(p, axis=1) <= 0.34]
    ang = 0.5 * p[:, 1]
    ca, sa = np.cos(ang), np.sin(ang)
    p_def = np.stack([ca * p[:, 0] + sa * p[:, 2], p[:, 1],
                      -sa * p[:, 0] + ca * p[:, 2]], 1).astype(np.float32)
    n = p.shape[0]
    F = np.zeros((n, 3, 3), np.float32)
    F[:, 0, 0] = ca
    F[:, 0, 2] = sa
    F[:, 1, 1] = 1.0
    F[:, 2, 0] = -sa
    F[:, 2, 2] = ca
    return tuple(torch.from_numpy(a) for a in (p_def, p, F))


def _frames(cut, pw, spec, table, layers):
    """The port's CPU frame (render_frame_fused on the plain twin) and the
    reference's hash-grid frame of the same scene: (image, counters)
    each."""
    p_def, p_ori, F = _scene()
    H = W = 48
    intr = (120.0, 120.0, 24.0, 24.0)
    pose = torch.eye(4)
    pose[2, 3] = -2.5
    cut_bounds = torch.tensor([0.0, 0.5, -0.5, 0.5, -0.5, 0.5])
    ip_dx = 0.084
    ist = tint.InteractiveSettings(
        spec=spec, bend=tbb.BeamBendSettings(
            num_seek_ip=3, max_iter_num=1, ip_dx=ip_dx, ips_per_tile=256),
        samples=16, active_frac=1.0, tile_chunk=2, min_near=0.05,
        T_thresh=1e-2, cut=cut, bound=1.0, tighten_sampling=True,
        bend_window=16, cut_static_frac=1.0)
    pack = tbb.pack_ip_data_fast(p_def, p_ori, F,
                                 torch.zeros((p_def.shape[0], 3, 3, 3)))
    out = tint.render_frame_fused(ist, pw, pack, p_def, pose, intr, H, W,
                                  1.0, cut_bounds if cut else None)
    port = (out["tiles_image"], torch.stack([
        out["n_active"], out["dropped_beam"], out["dropped_window"],
        out["n_tile_overflow"]]).to(torch.int64))
    st = ref_render.Settings(
        samples=16, num_seek=3, ip_dx=ip_dx, ips_per_tile=256,
        bend_window=16, active_frac=1.0, tile_chunk=2, min_near=0.05,
        T_thresh=1e-2, tighten=True, cut=cut, bound=1.0,
        cut_static_frac=1.0, n_freqs=0, backbone="hashgrid",
        grid=ref_grid.layout(**GRID_KW))
    ref = ref_render.render_frame(
        st, layers, ref_render.pack_ips(p_def, p_ori, F), p_def, pose, intr,
        H, W, 1.0, cut_bounds if cut else None, None, table)
    return port, ref


# The port's CPU frame against the benchmark's plain reference: the same
# f32 arithmetic but for the order of two sums (the reference sums a
# sample's 8 corners as one reduction over its stacked corners and runs
# its products unpadded; the port sums the corners in corner order and
# pads each layer to 64 with zeros), at most a few roundings of values of
# size <= 1 carried through the nets (the two frames are equal here, on
# this machine's BLAS). 2e-6 of a pixel leaves room for that; the weights
# and table rounded to TF32 (2e-5 here) or bf16 (9e-5) move the frame by
# more (asserted).
FRAME_ATOL = 2e-6


@pytest.mark.parametrize("cut", [False, True], ids=["deformed", "cut"])
def test_fused_frame_agrees_with_the_reference_hashgrid_branch(cut):
    spec, field = _field(4)
    pw = tfk.pack_weights(field, spec, CPU)
    layers = tuple([w.detach() for w in net]
                   for net in (field.sigma_net, field.color_net))
    table = field.encoder.detach()
    with torch.no_grad():
        (img, ctr), (rimg, rctr) = _frames(cut, pw, spec, table, layers)
    assert int(ctr[0]) > 0 and float((1.0 - img).abs().max()) > 0.05
    assert torch.equal(ctr, rctr)
    gap = float((img - rimg).abs().max())
    assert gap <= FRAME_ATOL, gap
    for drop in (16, 13):                            # bf16, TF32
        rounded = tfk.GridPack(_round_mantissa(pw, drop),
                               _round_mantissa(pw.table, drop))
        with torch.no_grad():
            (cimg, _), _ = _frames(cut, rounded, spec, table, layers)
        assert float((cimg - rimg).abs().max()) > FRAME_ATOL, drop


def test_grid_counters_only_under_a_profiler(monkeypatch):
    """A hash-grid launch gets the device's counter buffer only while
    torch.profiler records (otherwise None: the kernel reads no clock);
    the sums read as zeros until a launch adds to them, and reading with
    ``zero`` zeroes them."""
    monkeypatch.setattr(ttk.render_tiles, "grid_counters", {})
    assert ttk.read_grid_counters() == dict.fromkeys(ttk.GRID_COUNTERS, 0)
    assert ttk.grid_counters_when_traced(CPU) is None
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        buf = ttk.grid_counters_when_traced(CPU)
    assert buf is not None and buf.dtype == torch.int64
    assert ttk.grid_counters_when_traced(CPU) is None
    buf += torch.tensor([5, 9, 2, 256])
    assert ttk.read_grid_counters(zero=True) == dict(
        encode_cycles=5, tile_cycles=9, samples=2, rows=256)
    assert ttk.read_grid_counters() == dict.fromkeys(ttk.GRID_COUNTERS, 0)


GUI_FLAGS = ["--exp_name", "cube", "--backbone", "hashgrid", "--sim_dx",
             "0.2", "--bound", "0.5", "--radius", "2.5", "--kres", "4",
             "--max_iter_num", "1", "--num_seek_IP", "3", "--H", "32",
             "--W", "32", "--sim_cache", "0", "--frames", "1"]


def _gui(root, name, extra):
    """One 32x32 main_gui frame of the hash-grid field on the CPU ->
    (frame, stdout)."""
    from pienerf_tpu_torch import main_gui
    from test_torch_entry import _read_png
    out = root / f"o_{name}"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main_gui.main(["--device", "cpu", "--out_dir", str(out)]
                      + GUI_FLAGS + extra)
    return _read_png(out / "frame_0000.png"), buf.getvalue()


def test_main_gui_serves_a_hashgrid_field(tmp_path, monkeypatch):
    """main_gui --backbone hashgrid writes its fused frames from a native
    hash-grid checkpoint (the encoder table and both nets, as main_train
    writes them), from the same field as a reference .pth (the same
    frame), and from a seeded random field. The Newton frame and a background net refuse it,
    each naming why."""
    from pienerf_tpu_torch.io.checkpoint import save_native, save_torch_ngp
    from pienerf_tpu_torch.weights import field_to_numpy
    monkeypatch.chdir(ROOT)                     # assets/cube.ply
    spec = tnet.make_spec(bound=0.5, backbone="hashgrid")
    field = tnet.FieldMLP(spec, generator=torch.Generator().manual_seed(7))
    field.encoder.data = torch.rand(
        field.encoder.shape, generator=torch.Generator().manual_seed(8)) - 0.5
    tree = field_to_numpy(field)
    ck = tmp_path / "ws" / "checkpoints"
    ck.mkdir(parents=True)
    save_native(str(ck / "ngp_ep0003.npz"),
                {"params": tree, "ema_params": tree})
    save_torch_ngp(str(tmp_path / "field.pth"), tree)
    native, log = _gui(tmp_path, "native",
                       ["--workspace", str(tmp_path / "ws")])
    assert f"loaded {ck / 'ngp_ep0003.npz'}" in log
    pth, _ = _gui(tmp_path, "pth", ["--workspace", str(tmp_path / "e"),
                                    "--ckpt", str(tmp_path / "field.pth")])
    np.testing.assert_array_equal(pth, native)
    seeded, log = _gui(tmp_path, "seeded",
                       ["--workspace", str(tmp_path / "e2")])
    assert "random field" in log and not np.array_equal(seeded, native)
    assert native.min() < 255
    with pytest.raises(NotImplementedError, match="fused frame"):
        _gui(tmp_path, "newton", ["--workspace", str(tmp_path / "e3"),
                                  "--max_iter_num", "100"])
    with pytest.raises(NotImplementedError, match="background net"):
        _gui(tmp_path, "bg", ["--workspace", str(tmp_path / "e4"),
                              "--bg_radius", "2.0"])


def test_fused_frame_refuses_a_background_net_and_repeats_itself():
    """render_frame_fused renders a hash-grid field's sigma and color nets
    and no background net: a spec with ``bg_radius > 0`` is refused with a
    message (``interactive.check_fused_spec``), before any work. Without
    one, two calls on the same inputs give the same outputs bit for bit,
    as fresh tensors."""
    spec, field = _field(5)
    pw = tfk.pack_weights(field, spec, CPU)
    p_def, p_ori, F = _scene()
    pack = tbb.pack_ip_data_fast(p_def, p_ori, F,
                                 torch.zeros((p_def.shape[0], 3, 3, 3)))
    ist = tint.InteractiveSettings(
        spec=spec, bend=tbb.BeamBendSettings(num_seek_ip=3, max_iter_num=1,
                                             ip_dx=0.084, ips_per_tile=64),
        samples=16, active_frac=1.0, tile_chunk=2, bend_window=16)
    pose = torch.eye(4)
    pose[2, 3] = -2.5
    args = (pack, p_def, pose, (60.0, 60.0, 16.0, 16.0), 32, 32, 1.0)
    with pytest.raises(NotImplementedError, match="background net"):
        tint.render_frame_fused(ist._replace(spec=spec._replace(
            bg_radius=2.0)), pw, *args)
    tint.check_fused_spec(spec)
    with torch.no_grad():
        a = tint.render_frame_fused(ist, pw, *args)
        b = tint.render_frame_fused(ist, pw, *args)
    assert set(a) == set(b) and "tiles_image" in a
    for k in a:
        assert torch.equal(a[k], b[k]) and a[k] is not b[k]


def test_fused_frame_captures_nothing_off_the_card(monkeypatch):
    """render_frame_fused replays a CUDA graph only on the card, outside a
    profiler, without a static cache and with the background a number
    (``interactive._graph_key``): a CPU frame runs op by op and keeps no
    capture, and ``drop_frame_graphs`` forgets every capture."""
    from types import SimpleNamespace

    from torch.profiler import ProfilerActivity, profile

    spec, field = _field(5)
    pw = tfk.pack_weights(field, spec, CPU)
    p_def, p_ori, F = _scene()
    pack = tbb.pack_ip_data_fast(p_def, p_ori, F,
                                 torch.zeros((p_def.shape[0], 3, 3, 3)))
    ist = tint.InteractiveSettings(
        spec=spec, bend=tbb.BeamBendSettings(num_seek_ip=3, max_iter_num=1,
                                             ip_dx=0.084, ips_per_tile=64),
        samples=16, active_frac=1.0, tile_chunk=2, bend_window=16)
    pose = torch.eye(4)
    pose[2, 3] = -2.5
    intr = (60.0, 60.0, 16.0, 16.0)
    args = (ist, pw, pack, p_def, pose, intr, 32, 32, 1.0, None, 0.5, None)
    assert tint._graph_key(*args) is None
    # the same frame with its pose on the card (outside any capture, which
    # a CPU build cannot ask): a key, but for host data, a static cache or
    # a profiler
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    card = SimpleNamespace(device=torch.device("cuda", 0),
                           dtype=torch.float32)
    on_card = (ist, pw, pack, p_def, card, intr, 32, 32, 1.0, None, 0.5,
               None)
    assert tint._graph_key(*on_card) is not None
    assert tint._graph_key(*on_card[:8], [1.0, 1.0, 1.0],
                           *on_card[9:]) is None
    assert tint._graph_key(*on_card[:11], {"imgs": None}) is None
    with profile(activities=[ProfilerActivity.CPU]):
        assert tint._graph_key(*on_card) is None
    before = dict(tint._FRAME_GRAPHS)
    with torch.no_grad():
        a = tint.render_frame_fused(*args)
        b = tint.render_frame_fused(*args)
    assert dict(tint._FRAME_GRAPHS) == before
    for k in a:
        assert torch.equal(a[k], b[k]) and a[k] is not b[k]
    tint._FRAME_GRAPHS[("stale",)] = None
    tint.drop_frame_graphs()
    assert not tint._FRAME_GRAPHS
