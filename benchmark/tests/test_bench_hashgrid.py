"""The field's architecture as configuration data: the reference hash
encoding and hash-grid field against the port's plain ones, the stand-in
weights' fit, the hash encoding's work count, and the Fourier-MLP cells
read exactly as before the backbone became data."""

import hashlib
import os

import numpy as np
import pytest
import torch

from benchmark import cell, check, work
from benchmark.reference import fit, hashgrid
from benchmark.reference import render as ref_render

# dense level 0 ((4 + 1)^3 = 125 rows of 128), hashed levels 1-2 (128 rows)
SMALL_GRID = {"num_levels": 3, "level_dim": 2, "base_resolution": 4,
              "log2_hashmap_size": 7, "desired_resolution": 16}


def _points(rng, n=400):
    """Seeded points in [-1.1, 1.1]^3 (some outside the box), the box's
    faces and corners, and points on every level's cell faces (pos an
    integer)."""
    g = hashgrid.layout(**SMALL_GRID)
    pts = [rng.uniform(-1.1, 1.1, (n, 3)),
           np.array([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0], [1.0, -1.0, 0.2],
                     [0.0, 0.0, 0.0], [1.0 + 1e-6, 0.0, 0.0]])]
    for lvl in range(g.num_levels):
        scale = g.level(lvl)[0]
        k = rng.integers(1, int(scale), (50, 3))
        pts.append(2.0 * (k - 0.5) / scale - 1.0)        # x scale + 0.5 = k
    return np.concatenate(pts)


def test_grid_layout_is_the_port_s():
    from pienerf_tpu_torch.models import hash_encoder
    for grid in (SMALL_GRID, cell.load("configs", "ngp_hashgrid_f32")[
            "field"]["grid"]):
        ours, port = hashgrid.layout(**grid), hash_encoder.make_spec(**grid)
        assert ours.offsets == port.offsets
        assert ours.per_level_scale == port.per_level_scale
    g = hashgrid.layout(**SMALL_GRID)
    assert [g.level(lvl)[4] for lvl in range(3)] == [True, False, False]
    full = hashgrid.layout(**cell.load("configs", "ngp_hashgrid_f32")[
        "field"]["grid"])
    assert full.rows == 6_119_864                  # 49.0 MB in f32


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_reference_encoding_agrees_with_the_port(dtype):
    """float64 against the port's scalar-loop oracle ``encode_np``: the
    same products, summed over the 8 corners in another order, and the
    per-level scale's last bit (numpy's log2 against math's) may differ:
    ~1e-15 of a feature. float32 against the port's ``encode``, which also
    sums the 8 corners as one reduction, perhaps in another order: a few
    f32 roundings of features of size <= 1, under 1e-6."""
    from pienerf_tpu_torch.models import hash_encoder
    rng = np.random.default_rng(2 ** 33 + 1)
    spec = hash_encoder.make_spec(**SMALL_GRID)
    grid = hashgrid.layout(**SMALL_GRID)
    table = rng.uniform(-1.0, 1.0, (grid.rows, 2))
    pts = _points(rng)
    tdt = getattr(torch, dtype)
    ours = hashgrid.encode(torch.tensor(table, dtype=tdt), grid,
                           [torch.tensor(pts[:, i], dtype=tdt)
                            for i in range(3)], 1.0)
    outside = np.any(np.abs(pts) > 1.0, axis=1)
    assert outside.any() and torch.all(ours[:, torch.tensor(outside)] == 0)
    if dtype == "float64":
        port = torch.tensor(hash_encoder.encode_np(table, spec, pts)).T
        tol = 1e-12
    else:
        port = hash_encoder.encode(torch.tensor(table, dtype=tdt), spec,
                                   torch.tensor(pts, dtype=tdt), 1.0,
                                   feature_major=True)
        tol = 1e-6
    assert float((ours - port).abs().max()) <= tol


def test_reference_hashgrid_field_agrees_with_the_port():
    """``render.field`` over the reference encoding against the port's
    plain ``FieldMLP`` forward for ``backbone="hashgrid"`` on seeded
    weights (the table drawn in [-1, 1] so the encoding matters): both
    run the same f32 products in the same order, so the gap is the
    encoding's few roundings carried through the nets, relative 1e-5 on
    sigma (exp of a raw density of size ~1) and 1e-6 on the sigmoid's
    rgb."""
    from pienerf_tpu_torch.models import hash_encoder, network
    spec = network.make_spec(backbone="hashgrid")._replace(
        grid=hash_encoder.make_spec(**SMALL_GRID))
    gen = torch.Generator().manual_seed(2 ** 32 + 17)
    net = network.FieldMLP(spec, generator=gen)
    net.encoder.data = torch.rand(net.encoder.shape, generator=gen) * 2 - 1
    rng = np.random.default_rng(5)
    x = torch.tensor(_points(rng), dtype=torch.float32)
    d = torch.nn.functional.normalize(torch.randn(x.shape, generator=gen),
                                      dim=1)
    with torch.no_grad():
        sigma_p, rgb_p = net(x, d)
        tree = net.tree()
        layers = (list(tree["sigma_net"]), list(tree["color_net"]))
        enc = hashgrid.encode(tree["encoder"], hashgrid.layout(**SMALL_GRID),
                              [x[:, i] for i in range(3)], 1.0)
        sigma, rgb = ref_render.field(layers, enc, ref_render.sh_encode4(
            d[:, 0], d[:, 1], d[:, 2]))
    assert [w.shape[0] for w in layers[0] + layers[1]] == [6, 64, 31, 64, 64]
    assert torch.allclose(sigma, sigma_p, rtol=1e-5, atol=0.0)
    assert torch.allclose(rgb.T, rgb_p, rtol=0.0, atol=1e-6)


TINY_FIT = {"teacher": "runs/quality_mlp_800/checkpoints/ngp_ep0015.npz",
            "seed": 3, "steps": 12, "batch": 2048}
TINY_FIELD = {"grid": SMALL_GRID, "fit": TINY_FIT}


def _tiny_fit():
    z = cell._checkpoint(TINY_FIT["teacher"])
    return fit.fit((z["sigma_net"], z["color_net"]), 1.0,
                   hashgrid.layout(**SMALL_GRID), 64, 2, 3, TINY_FIT, "cpu")


@pytest.mark.parametrize("rows,n_freqs", [(51, 8), (63, 10), (3, 0)])
def test_teacher_frequencies_come_from_its_first_layer(rows, n_freqs):
    assert fit.teacher_n_freqs(rows) == n_freqs
    with pytest.raises(AssertionError):
        fit.teacher_n_freqs(rows + 3)
    assert cell._checkpoint(TINY_FIT["teacher"])["sigma_net"][0].shape[0] \
        == 51


def test_fit_is_deterministic_and_moves_every_weight():
    a, b = _tiny_fit(), _tiny_fit()
    assert sorted(a) == ["color_net", "encoder", "sigma_net"]
    for k in a:
        for u, v in zip(a[k], b[k]):
            assert torch.equal(u, v), k
    assert not torch.are_deterministic_algorithms_enabled()   # restored
    # the table moved far beyond its 1e-4 init, and every layer has its
    # configured shape
    assert float(a["encoder"][0].abs().max()) > 1e-3
    assert [tuple(w.shape) for w in a["sigma_net"] + a["color_net"]] == [
        (6, 64), (64, 16), (31, 64), (64, 64), (64, 3)]


def test_fit_cache_key_covers_the_code_and_torch(monkeypatch):
    """A change to the code that fits, or another torch, fits anew."""
    fc = {**TINY_FIELD, "width": 64, "sigma_layers": 2, "color_layers": 3}
    key = cell._fit_key(fc, 1.0, "cpu")
    assert cell._fit_key(fc, 1.0, "cpu") == key
    assert cell._fit_key(fc, 0.5, "cpu") != key
    sha = cell._sha256
    for name in cell.FIT_CODE:
        monkeypatch.setattr(cell, "_sha256", lambda p, name=name: (
            "changed" if p.endswith(os.sep + name) else sha(p)))
        assert cell._fit_key(fc, 1.0, "cpu") != key, name
    monkeypatch.setattr(cell, "_sha256", sha)
    monkeypatch.setattr(torch, "__version__", torch.__version__ + "x")
    assert cell._fit_key(fc, 1.0, "cpu") != key


def test_fitted_field_is_cached(tmp_path):
    """The first call fits in a child process and writes the cache, the
    second reads it back; the arrays are the in-process fit's."""
    cfg = cell._merge(cell.load("configs", "ngp_hashgrid_f32"),
                      {"field": TINY_FIELD})
    fc = cfg["field"]
    one = cell.fitted_field(fc, 1.0, cache_dir=str(tmp_path))
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".npz")
    stamp = os.stat(tmp_path / files[0]).st_mtime_ns
    two = cell.fitted_field(fc, 1.0, cache_dir=str(tmp_path))
    assert os.stat(tmp_path / files[0]).st_mtime_ns == stamp
    ref = _tiny_fit()
    for k in ref:
        for u, v, w in zip(one[k], two[k], ref[k]):
            assert np.array_equal(u, v) and np.array_equal(u, w.numpy()), k


def test_hashgrid_config_builds_inputs_settings_and_a_frame(tiny, tmp_path,
                                                           monkeypatch):
    """The configuration's field reaches the inputs, the reference's
    settings and a reference frame whose pass counts the encoding's
    work."""
    monkeypatch.setattr(cell, "FIT_CACHE", str(tmp_path))
    inp = cell.make_inputs("ngp_hashgrid_f32", "orbit", 2 ** 31 + 3,
                           {**tiny, "field": TINY_FIELD})
    assert sorted(inp.layers) == ["color_net", "encoder", "sigma_net"]
    st = check.settings(inp)
    assert st.backbone == "hashgrid" and st.grid == hashgrid.layout(
        **SMALL_GRID)
    ref = check.Reference(inp, torch.device("cpu"))
    passes = []
    img, ctr = ref.frame(0, passes)
    assert ctr[0] > 0 and np.all(np.isfinite(img))
    (p,) = passes
    assert p.samples > 0
    assert p.grid_flops == p.samples * hashgrid.flops_per_sample(st.grid)
    assert 0 < p.grid_bytes <= st.grid.rows * 2 * 4
    assert p.grid_bytes % 8 == 0
    # the program is handed the same architecture and weights
    from pienerf_tpu_torch.models import hash_encoder
    prog = cell.Program(inp, torch.device("cpu"), cache_dir=str(tmp_path))
    spec = prog.ist.spec
    assert (spec.backbone, spec.num_layers, spec.num_layers_color,
            spec.hidden_dim, spec.hidden_dim_color) == ("hashgrid", 2, 3, 64,
                                                         64)
    assert spec.grid == hash_encoder.make_spec(**SMALL_GRID)
    assert tuple(prog.pw.shape) == (5, 64, 64)
    assert torch.equal(prog.pw[0, :6], torch.as_tensor(
        inp.layers["sigma_net"][0]))


def test_distinct_row_bytes_match_a_hand_count():
    """A static pass of 256 rays along +z through the box's axis, 16
    samples at z = -1 + (k + 0.5) / 8, all needed (sigma = 1, T ends at
    e^-2). Level 0 (scale 3, dense): x = y = 0.5 sits at pos 2.0, so the
    corners take x, y in {2, 3} and z in {0, .., 4}: 20 rows. Levels 1-2
    (scales 7 and 15, hashed into 128 rows): counted below from the
    corners' coordinates by the hash's own arithmetic."""
    grid = hashgrid.layout(**SMALL_GRID)
    st = ref_render.Settings(
        samples=16, num_seek=1, ip_dx=0.05, ips_per_tile=64, bend_window=64,
        active_frac=1.0, tile_chunk=1, min_near=0.05, T_thresh=1e-2,
        tighten=False, cut=False, bound=1.0, cut_static_frac=1.0, n_freqs=0,
        backbone="hashgrid", grid=grid)
    layers = ([torch.zeros(s) for s in ((6, 64), (64, 16))],
              [torch.zeros(s) for s in ((31, 64), (64, 64), (64, 3))])
    table = torch.zeros((grid.rows, 2))
    tile_sc = torch.tensor([[1.0, 3.0, 1.0] + [0.0] * 5, [0.0] * 8])
    params = torch.zeros(24)
    params[0:3] = torch.tensor([0.0, 0.0, -2.0])
    params[3:6], params[6:9] = -1.0, 1.0
    params[9], params[10], params[12], params[19] = 1e-2, 1.0, 0.05, 0.5
    dirs = torch.zeros((2, 8, 256))
    dirs[:, 2] = 1.0
    w = {"samples": 0, "bend_rows": 0, "grid_flops": 0,
         "seen": torch.zeros(grid.rows, dtype=torch.bool)}
    ref_render.render_tiles(st, layers, tile_sc, None, params, dirs, None,
                            deformed=False, cut=False, work=w, table=table)
    assert w["samples"] == 256 * 16
    rows = set()
    for lvl, scale in enumerate((3, 7, 15)):
        first, size = grid.offsets[lvl], grid.offsets[lvl + 1] - grid.offsets[
            lvl]
        c = int(0.5 * scale + 0.5)
        zs = {int((k + 0.5) / 16 * scale + 0.5) for k in range(16)}
        for x in (c, c + 1):
            for y in (c, c + 1):
                for z in {z + dz for z in zs for dz in (0, 1)}:
                    if lvl == 0:
                        idx = x + 5 * y + 25 * z
                    else:
                        idx = (x ^ (y * 2654435761) ^ (z * 805459861)) \
                            & 0xFFFFFFFF
                    rows.add(first + idx % size)
    assert sum(r < 128 for r in rows) == 20
    assert int(w["seen"].sum()) == len(rows)
    assert w["grid_flops"] == 256 * 16 * 3 * (3 + 16 + 32)


def test_least_time_adds_the_encoding_s_work():
    p = ref_render.Pass(mode="static", slots=2, samples=4096, bend_rows=0,
                        bytes=1000)
    assert (p.grid_flops, p.grid_bytes) == (0, 0)
    macs = 9344
    hg = p._replace(grid_flops=4096 * 816, grid_bytes=10 ** 6)
    assert work.least_seconds([hg], macs, 1, "float32") == pytest.approx(
        (2 * 9344 * 4096 + 4096 * 816) / 67e12)
    heavy = hg._replace(grid_bytes=10 ** 10)
    assert work.least_seconds([heavy], macs, 1, "float32") == pytest.approx(
        (1000 + 1e10) / 3.35e12)
    assert work.mlp_flops([hg], macs) == 2 * 9344 * 4096


# what the Fourier-MLP path gave at TINY before the backbone became data
# (seed 2^32 + 9, pose 3): the inputs' SHA-256, the reference's settings,
# the frame's SHA-256 and counters, each pass's (mode, slots, samples, bend
# rows, bytes), the least time and the MLP's flops (float.hex)
MLP_BEFORE = {
    "bench_w128_f32.orbit": dict(
        layers="e60b998ff6a5e799f7e0ab3e74a00af6ce9f89dd93296b2b84cf6213018ce89d",
        settings=[16, 3, 0.052500000000000005, 256, 64, 0.5, 32, 0.05, 0.01,
                  True, False, 1.0, 0.95, 10, "float32", 8, 4],
        frame="aec5ecd9b486bf8b89ef3cea8b1b22c87b3bcfc44b0038242a1ae9d584cb4db7",
        counters=[4, 496, 1790, 0],
        passes=[("deformed", 32, 336, 65728, 1306720)],
        least="0x1.5c594914cbfa7p-21", mlp_flops="0x1.4628000000000p+25"),
    "trex_w64_f32.cut_orbit": dict(
        layers="e06fdb3e5e4dfc7533d95df1084724245aa4598a970bc8e11e18dab3ec00d30c",
        settings=[16, 1, 0.052500000000000005, 256, 64, 0.5, 32, 0.05, 0.05,
                  False, True, 1.0, 0.95, 8, "float32", 8, 4],
        frame="669910af9c942e9354cf884f78d96872d56bb13d0f6070a86046dbbfa066b23e",
        counters=[24, 594, 1236, 0],
        passes=[("cut", 32, 35854, 331110, 1127264),
                ("static", 32, 14734, 0, 600416)],
        least="0x1.dbd4795da1915p-16", mlp_flops="0x1.c457180000000p+30")}


@pytest.mark.parametrize("workload", sorted(MLP_BEFORE))
def test_mlp_cells_read_as_before(workload, tiny):
    before = MLP_BEFORE[workload]
    w = cell.workload(workload)
    inp = cell.make_inputs(w["config"], w["traffic"], 2 ** 32 + 9, tiny)
    assert sorted(inp.layers) == ["color_net", "sigma_net"]
    h = hashlib.sha256()
    for k in sorted(inp.layers):
        for a in inp.layers[k]:
            h.update(np.ascontiguousarray(a).tobytes())
    assert h.hexdigest() == before["layers"]
    st = check.settings(inp)
    assert list(st) == before["settings"] + ["mlp", None]
    ref = check.Reference(inp, torch.device("cpu"))
    assert ref.table is None
    passes = []
    img, ctr = ref.frame(3, passes)
    assert hashlib.sha256(img.tobytes()).hexdigest() == before["frame"]
    assert ctr.tolist() == before["counters"]
    assert [tuple(p[:5]) for p in passes] == before["passes"]
    assert all(p.grid_flops == 0 and p.grid_bytes == 0 for p in passes)
    macs = ref_render.macs_per_sample(ref.layers)
    assert work.least_seconds(passes, macs, st.num_seek,
                              st.dtype).hex() == before["least"]
    assert work.mlp_flops(passes, macs).hex() == before["mlp_flops"]
