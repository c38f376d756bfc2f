"""Backbone distillation: hashgrid teacher -> mlp student (port of
``pienerf_tpu.train.distill``).

The interactive frames run the Fourier-feature mlp backbone; a hash-grid
field (a trained teacher, or an imported reference ``.pth``) serves them
after a few minutes of field-space distillation. Density is matched in log
space (sigma spans orders of magnitude) and color where the teacher has
mass (alpha-weighted). Sample positions mix uniform coverage with
density-importance resampling around the teacher's occupied set.

Random draws come from a ``torch.Generator`` seeded by ``seed``, or are
passed in (the tests pass JAX's). ``image_agreement`` renders the student
through ``interactive.render_frame_fused`` in static mode: on the card,
the tile kernel.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from pienerf_tpu_torch.models import network
from pienerf_tpu_torch.train.optim import Adam, apply_updates


def make_distill_step(teacher_spec: network.NetworkSpec,
                      student_spec: network.NetworkSpec, optimizer: Adam):
    """``step(teacher, student, opt_state, x, d) -> (opt_state, loss)``:
    one student update on a batch of positions x [N, 3] and unit
    directions d [N, 3], in place."""

    def step(teacher, student, opt_state, x, d):
        with torch.no_grad():
            sig_t, rgb_t = teacher(x, d)
            alpha_t = 1.0 - torch.exp(-torch.clamp(sig_t, 0.0, 1e4) * 0.01)
        sig_s, rgb_s = student(x, d)
        l_sig = ((torch.log1p(sig_s) - torch.log1p(sig_t)) ** 2).mean()
        l_rgb = (alpha_t[:, None] * (rgb_s - rgb_t) ** 2).mean()
        loss = l_sig + 4.0 * l_rgb
        leaves = student.leaves()
        grads = torch.autograd.grad(loss, leaves)
        updates, opt_state = optimizer.update(list(grads), opt_state)
        apply_updates(leaves, updates)
        return opt_state, loss.detach()

    return step


def _importance_positions(generator: Optional[torch.Generator],
                          x_pool: torch.Tensor, w_pool: torch.Tensor,
                          n: int, bound: float,
                          ids: Optional[torch.Tensor] = None,
                          jitter: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Positions near high-density pool points: ``ids`` [n] drawn in
    proportion to w_pool + 1e-8 (JAX's categorical on its log), jittered
    by ``jitter`` [n, 3] standard normals times 0.02 bound."""
    dev = x_pool.device
    g = generator.device if generator is not None else dev
    if ids is None:
        ids = torch.multinomial((w_pool + 1e-8).to(g), n, replacement=True,
                                generator=generator)
    if jitter is None:
        jitter = torch.randn((n, 3), generator=generator, device=g)
    ids, jitter = ids.to(dev), jitter.to(dev)
    return torch.clamp(x_pool[ids] + jitter * (bound * 0.02), -bound, bound)


def make_student_spec(teacher_spec: network.NetworkSpec,
                      width: int = 64) -> network.NetworkSpec:
    """The student: 64 wide (the classic net), or 128 wide with 10 Fourier
    frequencies (63 input rows still fit one 128 tile)."""
    assert width in (64, 128), width
    kw = {}
    if width == 128:
        kw = dict(hidden_dim=128, hidden_dim_color=128, n_freqs=10)
    return network.make_spec(
        bound=teacher_spec.bound, bg_radius=teacher_spec.bg_radius,
        compute_dtype=teacher_spec.compute_dtype, backbone="mlp", **kw)


def _uniform(generator, shape, lo, hi, device):
    g = generator.device if generator is not None else device
    u = torch.rand(shape, generator=generator, device=g)
    return (u * (hi - lo) + lo).to(device)


def _unit_normal(generator, n, device):
    g = generator.device if generator is not None else device
    d = torch.randn((n, 3), generator=generator, device=g).to(device)
    return d / torch.linalg.norm(d, dim=1, keepdim=True)


def distill(teacher: network.FieldMLP,
            teacher_spec: network.NetworkSpec,
            student_spec: Optional[network.NetworkSpec] = None,
            steps: int = 4000, batch: int = 8192, lr: float = 5e-3,
            seed: int = 0, log_every: int = 500, log_fn=print,
            student_width: int = 64
            ) -> Tuple[network.FieldMLP, network.NetworkSpec, float]:
    """Distill a hashgrid field into the interactive mlp backbone, on the
    teacher's device: (student field, its spec, final loss). Adam(0.9,
    0.99, eps 1e-8) under exponential_decay(lr, steps, 0.1), every step
    applied (the JAX package's plain optax.adam)."""
    assert teacher_spec.backbone == "hashgrid"
    bound = teacher_spec.bound
    dev = teacher.sigma_net[0].device
    if student_spec is None:
        student_spec = make_student_spec(teacher_spec, width=student_width)
    student = network.FieldMLP(
        student_spec, generator=torch.Generator().manual_seed(seed),
        device=dev, trainable=True)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    optimizer = Adam(lr, steps, 0.1, b1=0.9, b2=0.99, eps=1e-8,
                     max_consecutive_errors=None)
    opt_state = optimizer.init(student.leaves())
    step = make_distill_step(teacher_spec, student_spec, optimizer)

    # density-importance pool: one coarse teacher sweep
    x_pool = _uniform(gen, (1 << 16, 3), -bound, bound, dev)
    with torch.no_grad():
        w_pool = torch.clamp(teacher.density(x_pool)[0], min=0.0)

    t0 = time.time()
    loss_t = torch.tensor(float("nan"))
    for i in range(steps):
        n_u = batch // 2
        x_u = _uniform(gen, (n_u, 3), -bound, bound, dev)
        x_i = _importance_positions(gen, x_pool, w_pool, batch - n_u, bound)
        x = torch.cat([x_u, x_i], dim=0)
        d = _unit_normal(gen, batch, dev)
        opt_state, loss_t = step(teacher, student, opt_state, x, d)
        if (i + 1) % log_every == 0 or i == 0:
            log_fn(f"[distill] step {i + 1}/{steps} loss={float(loss_t):.5f} "
                   f"({time.time() - t0:.1f}s)")
    student.set_trainable(False)
    return student, student_spec, float(loss_t)


def field_agreement(teacher: network.FieldMLP,
                    t_spec: network.NetworkSpec,
                    student: network.FieldMLP,
                    s_spec: network.NetworkSpec, n: int = 4096,
                    seed: int = 1, x: Optional[torch.Tensor] = None,
                    d: Optional[torch.Tensor] = None) -> Dict[str, float]:
    """Held-out field-space agreement: sigma log-MSE, alpha-weighted rgb
    MSE and occupancy IoU at ``x`` (uniform in the box) along unit ``d``,
    drawn from ``seed`` when not passed."""
    dev = teacher.sigma_net[0].device
    gen = torch.Generator(device=dev).manual_seed(seed)
    if x is None:
        x = _uniform(gen, (n, 3), -t_spec.bound, t_spec.bound, dev)
    if d is None:
        d = _unit_normal(gen, n, dev)
    x, d = x.to(dev), d.to(dev)
    with torch.no_grad():
        sig_t, rgb_t = teacher(x, d)
        sig_s, rgb_s = student(x, d)
    a_t = 1.0 - torch.exp(-torch.clamp(sig_t, 0, 1e4) * 0.01)
    inter = ((sig_s > 1.0) & (sig_t > 1.0)).sum()
    union = ((sig_s > 1.0) | (sig_t > 1.0)).sum()
    return {
        "sigma_logmse": float(((torch.log1p(sig_s)
                                - torch.log1p(sig_t)) ** 2).mean()),
        "rgb_mse_weighted": float((a_t[:, None]
                                   * (rgb_s - rgb_t) ** 2).mean()),
        "occupancy_iou": float(inter / torch.clamp(union, min=1)),
    }


def image_agreement(teacher: network.FieldMLP,
                    t_spec: network.NetworkSpec,
                    student: network.FieldMLP,
                    s_spec: network.NetworkSpec, poses, intrinsics,
                    H: int, W: int, grid=None, n_grid_updates: int = 6,
                    teacher_max_samples: int = 256,
                    student_samples: int = 128, bg_color: float = 1.0,
                    teacher_chunk: int = 8192,
                    generator: Optional[torch.Generator] = None
                    ) -> Dict[str, Any]:
    """Image-space distillation fidelity: the teacher through the
    occupancy renderer, the student through the fused tile kernel's
    static frame, at the same poses; per-view and mean PSNR / SSIM
    (``images``: the student's frames). Without ``grid`` the teacher's
    occupancy grid is built by ``n_grid_updates`` full updates, their
    draws from ``generator`` (seeded 0 when absent). H, W: multiples of
    16 (the fused tile)."""
    from pienerf_tpu_torch.kernels import field as field_kernel
    from pienerf_tpu_torch.ops import beam_bend
    from pienerf_tpu_torch.ops import grid as gridlib
    from pienerf_tpu_torch.render import interactive
    from pienerf_tpu_torch.render import renderer as rlib
    from pienerf_tpu_torch.train.metrics import psnr as psnr_fn
    from pienerf_tpu_torch.train.metrics import ssim as ssim_fn

    assert H % 16 == 0 and W % 16 == 0, "fused tiles need 16-aligned frames"
    dev = teacher.sigma_net[0].device
    bound = t_spec.bound
    cascade = 1 + int(np.ceil(np.log2(max(bound, 1.0))))
    settings = rlib.RenderSettings(
        bound=bound, cascade=cascade, min_near=0.05,
        max_samples=teacher_max_samples, max_steps=1024)
    if grid is None:
        grid = gridlib.init(cascade, device=dev)
        gen = generator if generator is not None else torch.Generator(
            device=dev).manual_seed(0)

        def dens(x):
            with torch.no_grad():
                return teacher.density(x)[0]

        for _ in range(n_grid_updates):
            grid = gridlib.update(grid, dens, bound, 0.01, generator=gen)

    pw = field_kernel.pack_weights(student, s_spec, dev)
    bst = beam_bend.BeamBendSettings(num_seek_ip=1, max_iter_num=1)
    ist = interactive.InteractiveSettings(
        spec=s_spec, bend=bst, tile=16, samples=student_samples,
        active_frac=1.0, min_near=0.05, deformed=False, bound=bound)
    dummy_pack = torch.zeros((1, 16), device=dev)
    dummy_pdef = torch.zeros((1, 3), device=dev)

    psnrs, ssims, images = [], [], []
    for pose in poses:
        pose_t = torch.as_tensor(np.asarray(pose, np.float32), device=dev)
        with torch.no_grad():
            t_out = rlib.render_image(teacher, settings, grid, pose_t,
                                      intrinsics, H, W, bg_color,
                                      chunk=teacher_chunk)
            s_out = interactive.render_frame_fused(
                ist, pw, dummy_pack, dummy_pdef, pose_t, intrinsics, H, W,
                torch.tensor(bg_color, device=dev))
        s_img = interactive.tiles_to_image(s_out["tiles_image"], H, W, 16)
        t_img = t_out["image"].float().cpu().numpy()
        images.append(s_img)
        psnrs.append(float(psnr_fn(s_img, t_img)))
        ssims.append(float(ssim_fn(s_img, t_img)))
    return {
        "psnr_per_view": psnrs,
        "ssim_per_view": ssims,
        "psnr_mean": float(np.mean(psnrs)),
        "ssim_mean": float(np.mean(ssims)),
        "images": images,
    }
