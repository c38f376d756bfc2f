"""Port parity of the training data against the JAX package (CPU): the
procedural scenes, the ray samplers given JAX's draws, the dataset loaders
(blender and colmap, rand_poses and the slerp split) with the port's PNG
decoder and area resize held to cv2, the metrics and the mesh extraction.
Each tolerance is stated where it is checked."""

import json
import os
import struct
import zlib

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from pienerf_tpu.config import PieNeRFConfig as JCfg
from pienerf_tpu.data import provider as jprov
from pienerf_tpu.data import rays as jrays
from pienerf_tpu.data import synthetic as jsyn
from pienerf_tpu.train import lpips as jlpips
from pienerf_tpu.train import metrics as jmet
from pienerf_tpu.utils import mesh as jmesh
from pienerf_tpu_torch.config import PieNeRFConfig as TCfg
from pienerf_tpu_torch.data import provider as tprov
from pienerf_tpu_torch.data import rays as trays
from pienerf_tpu_torch.data import synthetic as tsyn
from pienerf_tpu_torch.io.framesink import read_png, write_png
from pienerf_tpu_torch.train import metrics as tmet
from pienerf_tpu_torch.utils import mesh as tmesh

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


# ---- the procedural scenes -------------------------------------------------

@pytest.mark.parametrize("scene", ["sphere", "hard"])
def test_synthetic_scenes_exact(scene):
    """orbit_poses, render_gt, make_dataset and scene_points: the same
    numpy arithmetic, so equal bit for bit. The float64 torch path (how
    the card renders a view) within 1e-6; the straight-alpha RGBA,
    composited on white, gives the RGB render within 1e-6."""
    np.testing.assert_array_equal(tsyn.orbit_poses(7, seed=3),
                                  jsyn.orbit_poses(7, seed=3))
    pose = jsyn.orbit_poses(5, seed=1)[2]
    intr = (40.0, 40.0, 18.0, 14.0)
    want = jsyn.render_gt(pose, intr, 28, 36, scene=scene, n_steps=200)
    np.testing.assert_array_equal(
        tsyn.render_gt(pose, intr, 28, 36, scene=scene, n_steps=200), want)
    dev = tsyn.render_gt(pose, intr, 28, 36, scene=scene, n_steps=200,
                         device="cpu", chunk=333)
    np.testing.assert_allclose(dev, want, atol=1e-6)
    rgba = tsyn.render_gt(pose, intr, 28, 36, scene=scene, n_steps=200,
                          alpha=True)
    np.testing.assert_allclose(rgba[..., :3] * rgba[..., 3:]
                               + (1 - rgba[..., 3:]), want, atol=1e-6)
    a, b = jsyn.make_dataset(3, 16, 16, scene=scene), tsyn.make_dataset(
        3, 16, 16, scene=scene)
    np.testing.assert_array_equal(b.images, a.images)
    np.testing.assert_array_equal(b.poses, a.poses)
    assert b.intrinsics == a.intrinsics
    np.testing.assert_array_equal(tsyn.scene_points(scene, 0.1),
                                  jsyn.scene_points(scene, 0.1))


# ---- the ray samplers ------------------------------------------------------

def test_rays_given_jax_draws():
    """With JAX's draws: uniform, error-map-weighted and patch indices and
    the coarse cells exact; ray origins exact; directions within 5e-7
    (the 3x3 rotation's f32 sums round in another order than XLA's dot)."""
    H, W, n = 40, 56, 700
    k = jax.random.PRNGKey(3)
    emap = jax.random.uniform(jax.random.PRNGKey(9), (128 * 128,))
    inds, coarse = jrays.sample_pixel_indices(k, H, W, n, emap)
    k1, k2 = jax.random.split(k)                        # rays.py:71-80
    co = jax.random.categorical(k1, jnp.log(emap + 1e-8), shape=(n,))
    u = jax.random.uniform(k2, (n, 2))
    ti, tc = trays.sample_pixel_indices(None, H, W, n, T(np.asarray(emap)),
                                        coarse=T(np.asarray(co)),
                                        u=T(np.asarray(u)))
    np.testing.assert_array_equal(A(ti), np.asarray(inds))
    np.testing.assert_array_equal(A(tc), np.asarray(coarse))
    ui, none = jrays.sample_pixel_indices(k, H, W, n)
    tu, tnone = trays.sample_pixel_indices(None, H, W, n,
                                           inds=T(np.asarray(ui)))
    np.testing.assert_array_equal(A(tu), np.asarray(ui))
    assert none is None and tnone is None
    pi = jrays.sample_patch_indices(k, H, W, 512, 8)
    x0 = jax.random.randint(k1, (8,), 0, H - 8)         # rays.py:52-54
    y0 = jax.random.randint(k2, (8,), 0, W - 8)
    tp = trays.sample_patch_indices(None, H, W, 512, 8,
                                    x0=T(np.asarray(x0)),
                                    y0=T(np.asarray(y0)))
    np.testing.assert_array_equal(A(tp), np.asarray(pi))
    rs = np.random.RandomState(0)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.linalg.qr(rs.randn(3, 3))[0]
    pose[:3, 3] = (0.3, -1.0, 2.5)
    intr = (50.0, 52.0, 28.0, 20.0)
    jo, jd = jrays.get_rays_sampled(jnp.asarray(pose), intr, H, W, inds)
    to, td = trays.get_rays_sampled(T(pose), intr, H, W, ti)
    np.testing.assert_array_equal(A(to), np.asarray(jo))
    np.testing.assert_allclose(A(td), np.asarray(jd), atol=5e-7, rtol=0)
    # a generator's draws: in range, and the weighted ones where the map is
    g = torch.Generator().manual_seed(0)
    hot = torch.zeros(128 * 128)
    hot[5 * 128 + 7] = 1.0
    gi, gc = trays.sample_pixel_indices(g, H, W, 300, hot)
    assert (gc == 5 * 128 + 7).float().mean() > 0.99
    assert int(gi.min()) >= 0 and int(gi.max()) < H * W


# ---- PNG decoding and the area resize --------------------------------------

def _chunk(tag, data):
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _filtered_png(path, img, filters):
    """A PNG whose row y uses filters[y % len(filters)] (PNG spec 9.2)."""
    h, w = img.shape[:2]
    cn = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, w * cn).astype(np.int64)
    out = []
    for y in range(h):
        f = filters[y % len(filters)]
        x = rows[y]
        up = rows[y - 1] if y else np.zeros_like(x)
        left = np.concatenate([np.zeros(cn, np.int64), x[:-cn]])
        ul = np.concatenate([np.zeros(cn, np.int64), up[:-cn]])
        if f == 0:
            pred = np.zeros_like(x)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = up
        elif f == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        out.append(bytes([f]) + ((x - pred) & 0xFF).astype(np.uint8)
                   .tobytes())
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[cn]
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n"
                 + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype,
                                               0, 0, 0))
                 + _chunk(b"IDAT", zlib.compress(b"".join(out)))
                 + _chunk(b"IEND", b""))


def _cv2_read(path):
    """cv2.imread(IMREAD_UNCHANGED) in RGB(A) order, as JAX's provider
    converts it."""
    im = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if im.ndim == 3 and im.shape[2] == 3:
        return cv2.cvtColor(im, cv2.COLOR_BGR2RGB)
    if im.ndim == 3 and im.shape[2] == 4:
        return cv2.cvtColor(im, cv2.COLOR_BGRA2RGBA)
    return im


@pytest.mark.parametrize("cn", [1, 3, 4])
def test_png_decoder_equals_cv2(tmp_path, cn):
    """read_png against cv2.imread, exact: files with each of the five row
    filters alone and mixed, files cv2 and PIL write (their adaptive
    filters), and write_png's own."""
    rs = np.random.RandomState(cn)
    h, w = 23, 31
    smooth = (np.add.outer(np.arange(h) * 5, np.arange(w) * 3) % 256)
    img = np.stack([(smooth + 40 * c + rs.randint(0, 9, (h, w))) % 256
                    for c in range(cn)], -1).astype(np.uint8)
    if cn == 1:
        img = img[..., 0]
    paths = []
    for filters in ([0], [1], [2], [3], [4], [0, 1, 2, 3, 4]):
        p = str(tmp_path / f"f{''.join(map(str, filters))}.png")
        _filtered_png(p, img, filters)
        paths.append(p)
    p = str(tmp_path / "cv2.png")
    cv2.imwrite(p, img if cn == 1 else cv2.cvtColor(
        img, cv2.COLOR_RGB2BGR if cn == 3 else cv2.COLOR_RGBA2BGRA))
    paths.append(p)
    p = str(tmp_path / "pil.png")
    Image.fromarray(img).save(p)
    paths.append(p)
    p = str(tmp_path / "ours.png")
    write_png(p, img)
    paths.append(p)
    for p in paths:
        got = read_png(p)
        np.testing.assert_array_equal(got, _cv2_read(p), err_msg=p)
        np.testing.assert_array_equal(got, img, err_msg=p)


@pytest.mark.parametrize("shape", [(64, 64, 3), (65, 49, 4), (37, 53, 1),
                                   (60, 90, 2)])
def test_area_resize_equals_cv2(shape):
    """resize_area against cv2.resize(INTER_AREA), exact, at integer
    factors (2, 3, 4: cv2's block sums) and fractional ones."""
    rs = np.random.RandomState(sum(shape))
    img = (rs.rand(*shape) * 255).astype(np.uint8)
    if shape[2] == 1:
        img = img[..., 0]
    H, W = shape[:2]
    for W2, H2 in [(W // 2, H // 2), (W // 3, H // 3), (W // 4, H // 4),
                   (int(W / 1.5), int(H / 1.5)), (int(W / 2.7),
                                                   int(H / 1.3))]:
        np.testing.assert_array_equal(
            tprov.resize_area(img, (W2, H2)),
            cv2.resize(img, (W2, H2), interpolation=cv2.INTER_AREA))


# ---- the dataset loaders ---------------------------------------------------

def _blender(root, H=24, W=24, n=(4, 2), json_hw=None):
    """A blender-layout set of the sphere, RGBA, via write_blender."""
    f = 0.9 * H
    intr = (f, f, W / 2.0, H / 2.0)
    poses = tsyn.orbit_poses(sum(n), seed=2)
    imgs = [tsyn.render_gt(p, intr, H, W, alpha=True, n_steps=100)
            for p in poses]
    tsyn.write_blender(root, {"train": (poses[:n[0]], imgs[:n[0]]),
                              "val": (poses[n[0]:], imgs[n[0]:])},
                       intr, H, W, scale=0.8)
    if json_hw is not None:
        for split in ("train", "val"):
            p = os.path.join(root, f"transforms_{split}.json")
            with open(p) as fh:
                t = json.load(fh)
            t["h"], t["w"] = json_hw
            with open(p, "w") as fh:
                json.dump(t, fh)
    return poses


@pytest.mark.parametrize("case", ["plain", "downscale2", "resized"])
def test_blender_loader_equals_jax(tmp_path, case):
    """NeRFDataset on a written blender set: poses, images (decoded and,
    where the size asks for it, area-resized), intrinsics, H, W and radius
    equal to JAX's cv2-based loader, exact. The ngp poses written come
    back exactly (scale 0.8)."""
    root = str(tmp_path / "ds")
    poses = _blender(root, json_hw=(18, 18) if case == "resized" else None)
    ds_kw = dict(downscale=2) if case == "downscale2" else {}
    out = {}
    for name, cls, prov in (("j", JCfg, jprov), ("t", TCfg, tprov)):
        cfg = cls(path=root, scale=0.8, bound=1.0).finalize()
        out[name] = (prov.NeRFDataset(cfg, type="train", **ds_kw),
                     prov.NeRFDataset(cfg, type="val", **ds_kw))
    for j, t in zip(out["j"], out["t"]):
        np.testing.assert_array_equal(t.poses, j.poses)
        np.testing.assert_array_equal(t.images, j.images)
        assert (t.H, t.W, t.intrinsics, t.radius) == (j.H, j.W,
                                                      j.intrinsics,
                                                      j.radius)
    assert out["t"][0].images.shape[-1] == 4
    np.testing.assert_allclose(out["t"][0].poses, poses[:4], atol=1e-6)
    if case == "resized":
        assert out["t"][0].images.shape[1:3] == (18, 18)


def test_colmap_loader_rand_poses_and_slerp(tmp_path):
    """A colmap transforms.json: the train / val split (frames[1:] /
    frames[:1]) and the slerp-interpolated test poses equal JAX's, exact;
    rand_poses equal JAX's, exact."""
    root = str(tmp_path / "colmap")
    os.makedirs(os.path.join(root, "images"))
    rs = np.random.RandomState(0)
    frames = []
    for i in range(5):
        img = (rs.rand(20, 30, 3) * 255).astype(np.uint8)
        cv2.imwrite(os.path.join(root, "images", f"{i}.png"),
                    cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        m = np.eye(4)
        m[:3, :3] = np.linalg.qr(rs.randn(3, 3))[0]
        m[:3, 3] = rs.randn(3)
        frames.append({"file_path": f"images/{i}.png",
                       "transform_matrix": m.tolist()})
    with open(os.path.join(root, "transforms.json"), "w") as fh:
        json.dump({"fl_x": 25.0, "fl_y": 26.0, "cx": 15.0, "cy": 10.0,
                   "frames": frames}, fh)
    for split in ("train", "val", "test"):
        jd = jprov.NeRFDataset(JCfg(path=root).finalize(), type=split,
                               n_test=6)
        td = tprov.NeRFDataset(TCfg(path=root).finalize(), type=split,
                               n_test=6)
        np.testing.assert_array_equal(td.poses, jd.poses)
        if jd.images is None:
            assert td.images is None
        else:
            np.testing.assert_array_equal(td.images, jd.images)
        assert (td.H, td.W, td.intrinsics) == (jd.H, jd.W, jd.intrinsics)
    np.testing.assert_array_equal(tprov.rand_poses(9, 1.7, seed=4),
                                  jprov.rand_poses(9, 1.7, seed=4))


# ---- metrics and meshes ------------------------------------------------------

def test_metrics_exact(monkeypatch, tmp_path):
    """psnr, ssim (gray and RGB) and the meters equal JAX's; LPIPS is
    unavailable without weights, and with a weight file (seeded random
    AlexNet-LPIPS weights) its meter equals JAX's within 1e-5 relative."""
    rs = np.random.RandomState(1)
    a = rs.rand(40, 44, 3).astype(np.float32)
    b = np.clip(a + rs.randn(40, 44, 3).astype(np.float32) * 0.05, 0, 1)
    assert tmet.psnr(a, b) == jmet.psnr(a, b)
    assert tmet.psnr(a, a) == jmet.psnr(a, a) == float("inf")
    assert tmet.ssim(a, b) == jmet.ssim(a, b)
    assert tmet.ssim(a[..., 0], b[..., 0]) == jmet.ssim(a[..., 0], b[..., 0])
    for tm_, jm_ in ((tmet.PSNRMeter(), jmet.PSNRMeter()),
                     (tmet.SSIMMeter(), jmet.SSIMMeter())):
        for _ in range(2):
            tm_.update(a, b)
            jm_.update(a, b)
        assert tm_.measure() == jm_.measure()
        assert tm_.report() == jm_.report()
    monkeypatch.delenv("PIENERF_LPIPS_WEIGHTS", raising=False)
    assert not tmet.LPIPSMeter.available()
    w = {}
    for i, (ci, co, k, _, _) in enumerate(jlpips._ALEX):
        w[f"conv{i}_w"] = rs.randn(co, ci, k, k).astype(np.float32) * 0.05
        w[f"conv{i}_b"] = np.zeros(co, np.float32)
        w[f"lin{i}_w"] = np.abs(rs.randn(co)).astype(np.float32)
    np.savez(tmp_path / "lpips_alex.npz", **w)
    monkeypatch.setenv("PIENERF_LPIPS_WEIGHTS",
                       str(tmp_path / "lpips_alex.npz"))
    assert tmet.LPIPSMeter.available() and jmet.LPIPSMeter.available()
    tl, jl = tmet.LPIPSMeter("cpu"), jmet.LPIPSMeter()
    tl.update(a, b)
    jl.update(a, b)
    assert tl.measure() > 0
    np.testing.assert_allclose(tl.measure(), jl.measure(), rtol=1e-5)


def test_mesh_extraction_exact(tmp_path):
    """extract_fields, extract_point_cloud, marching_tetrahedra and the
    OBJ writer equal JAX's on an analytic density, exact."""
    def dens(x):
        return 40.0 / (1.0 + np.exp(np.clip(-30 * (0.5 - np.linalg.norm(
            x, axis=-1)), -60, 60)))

    f_t = tmesh.extract_fields(dens, 24, 1.0, chunk=1000)
    np.testing.assert_array_equal(f_t, jmesh.extract_fields(dens, 24, 1.0,
                                                            chunk=1000))
    np.testing.assert_array_equal(
        tmesh.extract_point_cloud(dens, 20, 1.0, 10.0),
        jmesh.extract_point_cloud(dens, 20, 1.0, 10.0))
    vt, tt = tmesh.marching_tetrahedra(f_t, 10.0, 1.0)
    vj, tj = jmesh.marching_tetrahedra(f_t, 10.0, 1.0)
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(tt, tj)
    assert len(vt) > 100
    tmesh.save_mesh_obj(str(tmp_path / "t.obj"), vt, tt)
    jmesh.save_mesh_obj(str(tmp_path / "j.obj"), vj, tj)
    assert (tmp_path / "t.obj").read_bytes() == (tmp_path / "j.obj"
                                                 ).read_bytes()
