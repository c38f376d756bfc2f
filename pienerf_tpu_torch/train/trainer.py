"""Training loop for the radiance field (port of
``pienerf_tpu.train.trainer``).

The functional core is ``make_train_step``; the ``Trainer`` facade has the
reference's workflow surface: train / evaluate / render, EMA weights, the
occupancy-grid refresh every ``update_extra_interval`` steps,
checkpoints in the JAX package's native format with rotation (reference
nerf/trainer.py:5-916). The optimizer is the JAX trainer's (``optim``):
Adam(0.9, 0.99, eps 1e-15) under an exponential decay over ``iters``,
skipping non-finite steps, and an EMA of the params.

The JAX package scans its iterations inside one jit and keeps an eager
loop for a TPU runtime that ran the scan wrongly; both are workarounds of
that runtime, so the port has one loop. A step makes no host sync apart
from the occupancy march's compaction; the losses come back once per
``train_iterations`` call. Random draws come from the trainer's
``torch.Generator`` on its device, or are passed to ``train_step``.
"""

from __future__ import annotations

import glob
import os
import time
from typing import Any, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from pienerf_tpu_torch.config import PieNeRFConfig
from pienerf_tpu_torch.data.rays import (get_rays_sampled,
                                         sample_patch_indices,
                                         sample_pixel_indices)
from pienerf_tpu_torch.io import checkpoint as ckpt_io
from pienerf_tpu_torch.io.framesink import write_png
from pienerf_tpu_torch.models import network
from pienerf_tpu_torch.ops import grid as gridlib
from pienerf_tpu_torch.render import fast as fastlib
from pienerf_tpu_torch.render import renderer
from pienerf_tpu_torch.train.metrics import LPIPSMeter, PSNRMeter, SSIMMeter
from pienerf_tpu_torch.train.optim import Adam, AdamState, apply_updates
from pienerf_tpu_torch.weights import field_from_numpy, field_to_numpy


class TrainState(NamedTuple):
    params: network.FieldMLP       # trainable: its parameters are leaves
    opt_state: AdamState
    ema_params: network.FieldMLP   # frozen
    step: torch.Tensor             # int32 scalar


def params_finite(params) -> bool:
    """True iff every float leaf of a field or a params tree (nested dicts
    and lists of arrays or tensors) is finite everywhere
    (pienerf_tpu/train/trainer.py:42-48)."""
    if isinstance(params, network.FieldMLP):
        return all(bool(torch.isfinite(p).all()) for p in params.leaves())
    if isinstance(params, dict):
        return all(params_finite(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return all(params_finite(v) for v in params)
    a = (params.detach().cpu().numpy() if isinstance(params, torch.Tensor)
         else np.asarray(params))
    return not np.issubdtype(a.dtype, np.floating) or bool(
        np.isfinite(a).all())


def make_optimizer(lr: float, total_iters: int,
                   lr_decay_rate: float = 0.1) -> Adam:
    """Adam(0.9, 0.99, eps 1e-15) under exponential_decay(lr, iters,
    lr_decay_rate), skipping non-finite steps (max 100 in a row):
    trainer.py:51-69 of the JAX package."""
    return Adam(lr, total_iters, lr_decay_rate, b1=0.9, b2=0.99, eps=1e-15,
                max_consecutive_errors=100)


def fast_settings(settings: renderer.RenderSettings,
                  max_samples: Optional[int] = None) -> fastlib.FastSettings:
    """The hierarchical path's settings: half the samples coarse."""
    k = settings.max_samples if max_samples is None else max_samples
    return fastlib.FastSettings(
        bound=settings.bound, min_near=settings.min_near,
        density_scale=settings.density_scale, T_thresh=settings.T_thresh,
        num_coarse=k // 2, num_fine=k - k // 2, bg_radius=settings.bg_radius)


def init_state(field: network.FieldMLP, optimizer: Adam,
               ema: Optional[network.FieldMLP] = None) -> TrainState:
    """A train state around a trainable field: fresh moments, the EMA
    ``ema`` (default: a frozen copy of the params), step 0."""
    dev = field.sigma_net[0].device
    if ema is None:
        ema = field_from_numpy(field.tree(), field.spec, dev)
    return TrainState(field, optimizer.init(field.leaves()), ema,
                      torch.zeros((), dtype=torch.int32, device=dev))


def make_train_step(spec: network.NetworkSpec,
                    settings: renderer.RenderSettings, optimizer: Adam,
                    ema_decay: float = 0.95, use_fast_path: bool = False,
                    patch_size: int = 1, lpips_weights=None,
                    reduce=None):
    """The train step.

    ``step(state, bitfield, batch, generator=None, draws=None)`` with batch
    {rays_o [N, 3], rays_d [N, 3], pixels [N, 3 or 4]} updates the state
    in place and returns (state, {"loss", "per_ray_loss"}). RGBA targets
    composite onto a random background (reference nerf/trainer.py:
    187-198). ``draws`` gives the step's random numbers, as JAX draws
    them: "bg" [N, 3] (RGBA targets only) and the renderer's, "noise" [N]
    on the occupancy march or "u_coarse" [N, K1] / "u_fine" [N, K2] on the
    hierarchical path (``use_fast_path``, the mlp backbone's); what is
    missing is drawn from ``generator`` in that order. ``spec`` is read
    from the field itself. With ``lpips_weights`` (tensors,
    ``weights.lpips_to_torch``) and ``patch_size`` >= 32, the rays arrive
    patch-major and the loss adds 1e-3 x the patches' mean LPIPS (the
    reference's perceptual patch loss, nerf/trainer.py:207-218).
    ``reduce`` (data parallelism, ``parallel.sharding``) averages a list
    of tensors over the ranks in place: the gradients before the
    optimizer, and the returned loss."""
    fst = fast_settings(settings) if use_fast_path else None
    use_lpips = patch_size >= 32 and lpips_weights is not None

    def train_step(state: TrainState, bitfield: torch.Tensor,
                   batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[Dict[str, torch.Tensor]] = None):
        d = dict(draws or {})
        pixels = batch["pixels"]
        n, dev = pixels.shape[0], pixels.device
        if pixels.shape[-1] == 4:
            bg = d.get("bg")
            if bg is None:
                gdev = generator.device if generator is not None else dev
                bg = torch.rand((n, 3), generator=generator, device=gdev)
            bg = bg.to(dev)
            target = pixels[:, :3] * pixels[:, 3:] + bg * (1.0
                                                           - pixels[:, 3:])
        else:
            bg = torch.ones((n, 3), device=dev)
            target = pixels
        field = state.params
        if use_fast_path:
            out = fastlib.render_rays_fast(
                field, fst, batch["rays_o"], batch["rays_d"], bg,
                generator=generator, u_coarse=d.get("u_coarse"),
                u_fine=d.get("u_fine"))
        else:
            out = renderer.render_rays(
                field, settings, bitfield, batch["rays_o"], batch["rays_d"],
                bg, perturb=True, generator=generator, noise=d.get("noise"))
        sq = (out["image"] - target) ** 2
        loss = sq.mean()
        per_ray = sq.mean(dim=-1)
        if use_lpips:
            from pienerf_tpu_torch.train import lpips as lp
            p = patch_size
            loss = loss + 1e-3 * lp.lpips(
                out["image"].reshape(-1, p, p, 3),
                target.reshape(-1, p, p, 3), lpips_weights).mean()
        new, grads = _descend(state, loss, optimizer, ema_decay, reduce)
        loss = loss.detach()
        if reduce is not None:
            reduce([loss])
        return new, {"loss": loss, "per_ray_loss": per_ray.detach(),
                     "grads": grads}

    return train_step


def _descend(state: TrainState, loss: torch.Tensor, optimizer: Adam,
             ema_decay: float, reduce=None):
    """The gradient of ``loss`` over the params (averaged over the ranks
    by ``reduce``), one optimizer update in place and the EMA: (the next
    state, the gradients)."""
    field = state.params
    leaves = field.leaves()
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, leaves)]
    if reduce is not None:
        reduce(grads)
    updates, opt_state = optimizer.update(grads, state.opt_state)
    apply_updates(leaves, updates)
    with torch.no_grad():
        for e, p in zip(state.ema_params.leaves(), leaves):
            e.copy_(ema_decay * e + (1.0 - ema_decay) * p)
    return TrainState(field, opt_state, state.ema_params,
                      state.step + 1), grads


def orbit_pose(u: torch.Tensor, radius: float) -> torch.Tensor:
    """The CLIP step's random orbit pose from two uniforms u [2]: theta in
    [pi/3, 2pi/3], phi in [0, 2pi), the camera on the sphere of ``radius``
    looking at the origin, built as the reference's rand_poses builds it
    (nerf/provider.py:57-91; ``data.provider.rand_poses``): [4, 4].

    The JAX package's CLIP step takes the same centre and writes -forward
    into the third column (pienerf_tpu/train/trainer.py:197-208), while
    its rays run along +third column (data/rays.py), so its camera faces
    away from the scene; where the box lies behind it, its near / far test
    returns a reversed interval and the frame is no image (NaN, or values
    far outside [0, 1]; ROADMAP section 3). The port looks at the scene,
    as the reference does."""
    theta = np.pi / 3.0 + u[0] * np.pi / 3.0
    phi = u[1] * 2.0 * np.pi
    center = radius * torch.stack([
        torch.sin(theta) * torch.sin(phi), torch.cos(theta),
        torch.sin(theta) * torch.cos(phi)])

    def norm(v):
        return v / (torch.linalg.norm(v) + 1e-10)

    forward = -norm(center)
    up = torch.tensor([0.0, -1.0, 0.0], device=u.device)
    right = norm(torch.linalg.cross(forward, up))
    up2 = norm(torch.linalg.cross(right, forward))
    return torch.cat([torch.stack([right, up2, forward, center], dim=1),
                      torch.tensor([[0.0, 0.0, 0.0, 1.0]], device=u.device)])


def make_clip_step(spec: network.NetworkSpec, optimizer: Adam, clip_params,
                   text_z: torch.Tensor, rH: int, rW: int, intrinsics,
                   radius: float = 1.0, bound: float = 1.0,
                   num_samples: int = 64, clip_size: int = 224,
                   ema_decay: float = 0.95):
    """The CLIP-guided step (reference rand_pose mode, nerf/trainer.py:
    163-178 + provider.py:277-297): a low-resolution full frame [rH, rW]
    from a random orbit pose (``orbit_pose``, facing the scene) through
    the hierarchical renderer on white, descending the negative
    image-text cosine similarity at ``clip_size``.

    ``step(state, generator=None, draws=None) -> (state, loss)`` updates
    the state in place. ``draws`` gives its random numbers as the JAX step
    draws them: "u_pose" [2], then the renderer's "u_coarse" [rH rW, K1]
    and "u_fine" [rH rW, K2]; what is missing is drawn from
    ``generator``."""
    from pienerf_tpu_torch.data.rays import get_rays_full
    from pienerf_tpu_torch.train import clip_guidance as cg

    fst = fastlib.FastSettings(bound=bound, num_coarse=num_samples // 2,
                               num_fine=num_samples - num_samples // 2)

    def clip_step(state: TrainState,
                  generator: Optional[torch.Generator] = None,
                  draws: Optional[Dict[str, torch.Tensor]] = None):
        d = dict(draws or {})
        dev = state.step.device
        u = d.get("u_pose")
        if u is None:
            gdev = generator.device if generator is not None else dev
            u = torch.rand((2,), generator=generator, device=gdev)
        pose = orbit_pose(u.to(dev), radius)
        rays_o, rays_d = get_rays_full(pose, intrinsics, rH, rW)
        out = fastlib.render_rays_fast(
            state.params, fst, rays_o, rays_d,
            torch.ones((rays_o.shape[0], 3), device=dev),
            generator=generator, u_coarse=d.get("u_coarse"),
            u_fine=d.get("u_fine"))
        img = out["image"].reshape(1, rH, rW, 3)
        loss = cg.clip_loss(clip_params, img, text_z, size=clip_size)
        new, _ = _descend(state, loss, optimizer, ema_decay)
        return new, loss.detach()

    return clip_step


class Trainer:
    """Workflow facade (reference nerf/trainer.py Trainer). Runs on the
    card unless ``device`` says otherwise."""

    def __init__(self, name: str, cfg: PieNeRFConfig,
                 spec: Optional[network.NetworkSpec] = None,
                 workspace: Optional[str] = None,
                 use_checkpoint: str = "latest",
                 eval_interval: int = 50, max_keep_ckpt: int = 2,
                 seed: Optional[int] = None, device=None):
        from pienerf_tpu_torch.device import resolve_device

        self.device = resolve_device(device)
        self.name = name
        self.cfg = cfg
        self.workspace = workspace or cfg.workspace
        self.eval_interval = eval_interval
        self.max_keep_ckpt = max_keep_ckpt
        self.epoch = 0
        self.global_step = 0
        self.stats: Dict[str, Any] = {"results": [], "checkpoints": []}
        self.error_map = None          # [B, 128*128] when cfg.error_map
        self.loss_history: list = []   # every step's loss, in order

        self.spec = spec or network.make_spec(
            bound=cfg.bound, bg_radius=cfg.bg_radius,
            compute_dtype=cfg.compute_dtype, backbone=cfg.backbone)
        self.settings = renderer.RenderSettings(
            bound=cfg.bound, cascade=cfg.cascade, min_near=cfg.min_near,
            dt_gamma=cfg.dt_gamma, max_steps=cfg.max_steps,
            T_thresh=cfg.T_thresh, max_samples=cfg.train_max_samples,
            bg_radius=cfg.bg_radius)
        seed = seed if seed is not None else cfg.seed
        field = network.FieldMLP(
            self.spec, generator=torch.Generator().manual_seed(seed),
            device=self.device, trainable=True)
        self.gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        # the reference applies EMA(0.95) once per epoch of one step per
        # image, so the per-step decay is 0.95 ** (1 / n_views), set when
        # training starts (_ensure_ema_decay)
        self._ema_base = 0.95
        self._ema_step_decay = self._ema_base
        self.optimizer = make_optimizer(cfg.lr, cfg.iters,
                                        getattr(cfg, "lr_decay_rate", 0.1))
        self.state = init_state(field, self.optimizer)
        self.grid = gridlib.init(cfg.cascade, device=self.device)
        self._use_fast_train = self.spec.backbone == "mlp"
        self._lpips_weights = None
        if cfg.patch_size > 1:
            from pienerf_tpu_torch.train import lpips as lp
            from pienerf_tpu_torch.weights import lpips_to_torch

            if lp.available():
                self._lpips_weights = lpips_to_torch(lp.load_weights(),
                                                     self.device)
            else:
                print("[trainer] patch mode without LPIPS weights: "
                      "MSE-only patch loss (see train/lpips.py to enable)")
        self._validated = False
        self._rebuild_train_step()

        os.makedirs(os.path.join(self.workspace, "checkpoints"),
                    exist_ok=True)
        self.log_path = os.path.join(self.workspace, "log_ngp.txt")
        # tensorboard scalars when tensorboardX imports, as the JAX trainer
        # writes them (reference nerf/trainer.py:655-657)
        self.writer = None
        try:
            from tensorboardX import SummaryWriter

            self.writer = SummaryWriter(os.path.join(self.workspace, "run"))
        except ImportError:
            pass
        if use_checkpoint == "latest":
            self.load_checkpoint(None)
        elif use_checkpoint not in ("scratch", None) or cfg.ckpt_path:
            self.load_checkpoint(cfg.ckpt_path or use_checkpoint)

    # -- internals ---------------------------------------------------------

    def _density(self, x, field: Optional[network.FieldMLP] = None):
        """sigma * density_scale of the params (or ``field``), no grad."""
        with torch.no_grad():
            f = self.state.params if field is None else field
            return f.density(x)[0] * self.settings.density_scale

    def log(self, msg: str) -> None:
        print(msg)
        with open(self.log_path, "a") as f:
            f.write(msg + "\n")

    def _rebuild_train_step(self) -> None:
        self._train_step = make_train_step(
            self.spec, self.settings, self.optimizer,
            ema_decay=self._ema_step_decay,
            use_fast_path=self._use_fast_train,
            patch_size=self.cfg.patch_size,
            lpips_weights=self._lpips_weights)

    def _set_fields(self, params, ema) -> None:
        """Put params / EMA trees on the device as the train state, with
        fresh optimizer moments (as the JAX trainer's load does)."""
        self.state = init_state(
            field_from_numpy(params, self.spec, self.device, trainable=True),
            self.optimizer, field_from_numpy(ema, self.spec, self.device))

    # -- training ----------------------------------------------------------

    def update_extra_state(self) -> None:
        self.grid = gridlib.update(self.grid, self._density, self.cfg.bound,
                                   self.cfg.density_thresh,
                                   generator=self.gen)

    def mark_untrained_grid(self, poses, intrinsics) -> None:
        self.grid = gridlib.mark_untrained(self.grid, poses, intrinsics,
                                           self.cfg.bound)

    def _ensure_ema_decay(self, n_views: int) -> None:
        """Per-step EMA decay 0.95 ** (1 / n_views): the reference's
        per-epoch EMA(0.95) (nerf/trainer.py:512-513, one step per image
        per epoch, provider.py:325-332)."""
        eff = float(self._ema_base ** (1.0 / max(int(n_views), 1)))
        if abs(eff - self._ema_step_decay) < 1e-12:
            return
        self._ema_step_decay = eff
        self._rebuild_train_step()

    def set_compute_dtype(self, dtype: str) -> None:
        """Switch the compute dtype mid-run (the params, EMA and moments
        are f32 master copies; only the forward changes)."""
        if self.spec.compute_dtype == dtype:
            return
        self.spec = self.spec._replace(compute_dtype=dtype)
        self.state.params.spec = self.spec
        self.state.ema_params.spec = self.spec
        self._rebuild_train_step()
        self.log(f"[trainer] compute dtype -> {dtype} "
                 f"at step {self.global_step}")

    def _maybe_precision_tail(self) -> None:
        """From cfg.precision_tail_start on, train in float32 (the JAX
        package's counter to coherent Adam drift at the bf16 floor)."""
        ts = getattr(self.cfg, "precision_tail_start", None)
        if (ts is not None and ts >= 0 and self.global_step >= ts
                and self.spec.compute_dtype != "float32"):
            self.set_compute_dtype("float32")

    def _scan_chunk(self, remaining: int) -> int:
        """The steps of the JAX trainer's next scanned chunk from this
        step on (pienerf_tpu/train/trainer.py:531-546): 8 on the
        hierarchical path, else up to the next grid update; never across
        the precision tail's start."""
        n = min(8 if self._use_fast_train
                else self.cfg.update_extra_interval, remaining)
        ts = getattr(self.cfg, "precision_tail_start", None)
        if ts is not None and ts >= 0 and self.global_step < ts:
            n = min(n, ts - self.global_step)
        if not self._use_fast_train:
            uei = self.cfg.update_extra_interval
            n = min(n, uei - self.global_step % uei)
        return n

    def _write_losses(self, loss_np: np.ndarray, first_step: int,
                      chunk_ends: list, host_images: bool) -> None:
        """``train/loss`` at the JAX trainer's steps and values: each
        scanned chunk's mean at its last step, or, with host-resident
        images (its eager loop), every 50th step's loss."""
        if host_images:
            for i, loss in enumerate(loss_np):
                if (first_step + i + 1) % 50 == 0:
                    self.writer.add_scalar("train/loss", float(loss),
                                           first_step + i + 1)
            return
        start = 0
        for end in chunk_ends:
            self.writer.add_scalar("train/loss",
                                   float(loss_np[start:end].mean()),
                                   first_step + end)
            start = end

    def train_iterations(self, dataset, n_iters: int) -> float:
        """Run n_iters steps, each on a random view of ``dataset`` (poses
        [B, 4, 4], images [B, H, W, C] in [0, 1], intrinsics, H, W); the
        mean loss. Above ``$PIENERF_MAX_DEVICE_DATASET`` bytes (2e9) the
        images stay in host memory and each step copies its pixels over.
        Refuses to train from a non-finite state. With tensorboardX,
        writes ``train/loss`` as the JAX trainer does."""
        self._ensure_ema_decay(len(dataset.poses))
        if not self._validated:
            if not params_finite(self.state.params):
                raise RuntimeError(
                    "training state is non-finite BEFORE the first "
                    "scanned chunk — corrupt checkpoint or init; "
                    "refusing to train from garbage")
            self._validated = True
        dev = self.device
        max_dev = float(os.environ.get("PIENERF_MAX_DEVICE_DATASET", 2e9))
        imgs = dataset.images
        img_bytes = (int(imgs.nbytes) if hasattr(imgs, "nbytes")
                     else len(imgs) * np.asarray(imgs[0]).nbytes)
        host_images = img_bytes > max_dev
        poses = torch.as_tensor(np.asarray(dataset.poses, np.float32),
                                device=dev)
        H, W = dataset.H, dataset.W
        B = poses.shape[0]
        if host_images:
            images_np = np.asarray(imgs, np.float32).reshape(B, H * W, -1)
        else:
            images = torch.as_tensor(np.asarray(imgs, np.float32),
                                     device=dev).reshape(B, H * W, -1)
        intr = dataset.intrinsics
        if self.cfg.error_map and self.error_map is None:
            self.error_map = torch.ones((B, 128 * 128), device=dev)

        losses, first_step = [], self.global_step
        chunk_ends, chunk_left = [], 0
        for i in range(n_iters):
            if chunk_left == 0:
                chunk_left = self._scan_chunk(n_iters - i)
            self._maybe_precision_tail()
            if (not self._use_fast_train and self.global_step
                    % self.cfg.update_extra_interval == 0):
                self.update_extra_state()
            vi = torch.randint(0, B, (), generator=self.gen, device=dev)
            if self.cfg.patch_size > 1:
                inds = sample_patch_indices(self.gen, H, W,
                                            self.cfg.num_rays,
                                            self.cfg.patch_size, device=dev)
                coarse = None
            else:
                emap = (self.error_map[vi] if self.error_map is not None
                        else None)
                inds, coarse = sample_pixel_indices(
                    self.gen, H, W, self.cfg.num_rays, emap, device=dev)
            rays_o, rays_d = get_rays_sampled(poses[vi], intr, H, W, inds)
            if host_images:
                pix = torch.as_tensor(
                    images_np[int(vi)][inds.cpu().numpy()], device=dev)
            else:
                pix = images[vi][inds]
            batch = {"rays_o": rays_o, "rays_d": rays_d, "pixels": pix}
            self.state, m = self._train_step(self.state, self.grid.bitfield,
                                             batch, generator=self.gen)
            if coarse is not None:
                err = 0.9 * self.error_map[vi][coarse] \
                    + 0.1 * m["per_ray_loss"]
                self.error_map[vi, coarse] = err
            self.global_step += 1
            losses.append(m["loss"])
            chunk_left -= 1
            if chunk_left == 0:
                chunk_ends.append(i + 1)
        loss_np = torch.stack(losses).float().cpu().numpy()
        self.loss_history += loss_np.tolist()
        if self.writer is not None:
            self._write_losses(loss_np, first_step, chunk_ends, host_images)
        return float(loss_np.mean())

    # -- CLIP guidance (reference rand_pose mode, trainer.py:138-141) ------

    def _clip_guidance(self):
        """The CLIPGuidance with its text prepared, or None with a logged
        reason (weights and tokenizer are not vendored: see
        train/clip_guidance.py). A caller may set ``_clip_guide`` to a
        guide prepared from token ids."""
        if hasattr(self, "_clip_guide"):
            return self._clip_guide
        from pienerf_tpu_torch.train import clip_guidance as cg

        self._clip_guide = None
        if not cg.available():
            self.log("[trainer] rand_pose mode without CLIP weights: "
                     "skipping CLIP guidance (see train/clip_guidance.py)")
            return None
        tok_dir = os.environ.get("PIENERF_CLIP_TOKENIZER")
        if not tok_dir:
            self.log("[trainer] CLIP weights present but no tokenizer "
                     "(set PIENERF_CLIP_TOKENIZER to a local "
                     "CLIPTokenizer dir); skipping CLIP guidance")
            return None
        guide = cg.CLIPGuidance(device=self.device)
        guide.prepare_text([self.cfg.clip_text], tokenizer_dir=tok_dir)
        self._clip_guide = guide
        return guide

    def train_clip_iterations(self, H: int, W: int, intrinsics,
                              n_iters: int, clip_size: int = 224,
                              draws: Optional[Sequence[dict]] = None
                              ) -> float:
        """``n_iters`` CLIP-guided steps at the reference's low-resolution
        full-frame economy (provider.py:287-289: rH = H / sqrt(H W /
        num_rays)); the mean loss, or NaN without a guide. ``draws``: each
        step's random numbers (``make_clip_step``), else the trainer's
        generator draws them."""
        guide = self._clip_guidance()
        if guide is None:
            return float("nan")
        s = float(np.sqrt(H * W / self.cfg.num_rays))
        rH, rW = max(int(H / s), 8), max(int(W / s), 8)
        intr = tuple(float(v) / s for v in intrinsics)
        key = (rH, rW, intr, clip_size)
        if getattr(self, "_clip_step_key", None) != key:
            self._clip_step_fn = make_clip_step(
                self.spec, self.optimizer, guide.params, guide.text_z,
                rH, rW, intr, radius=self.cfg.radius, bound=self.cfg.bound,
                num_samples=self.cfg.train_max_samples, clip_size=clip_size)
            self._clip_step_key = key
        losses = []
        for i in range(n_iters):
            self.state, loss = self._clip_step_fn(
                self.state, generator=self.gen,
                draws=draws[i] if draws is not None else None)
            self.global_step += 1
            losses.append(loss)
        return float(np.mean(torch.stack(losses).double().cpu().numpy()))

    def train(self, train_dataset, valid_dataset=None,
              max_iters: Optional[int] = None) -> None:
        total = max_iters or self.cfg.iters
        t0 = time.time()
        chunk = 500
        done = 0
        while done < total:
            n = min(chunk, total - done)
            if self.cfg.rand_pose == 0:
                loss = self.train_clip_iterations(
                    train_dataset.H, train_dataset.W,
                    train_dataset.intrinsics, n)
            else:
                loss = self.train_iterations(train_dataset, n)
                if self.cfg.rand_pose > 0:
                    self.train_clip_iterations(
                        train_dataset.H, train_dataset.W,
                        train_dataset.intrinsics,
                        max(n // self.cfg.rand_pose, 1))
            done += n
            self.log(f"[train] iter {self.global_step}/{total} "
                     f"loss={loss:.6f} ({(time.time() - t0):.1f}s)")
            if valid_dataset is not None and done % (chunk * 4) == 0:
                p = self.evaluate(valid_dataset)
                self.log(f"[eval] PSNR={p:.3f}")
            self.save_checkpoint()

    # -- evaluation / inference --------------------------------------------

    def infer_settings(self, max_samples: int = 256
                       ) -> renderer.RenderSettings:
        return self.settings._replace(max_samples=max_samples)

    def render_pose(self, pose, intrinsics, H, W, bg_color=1.0,
                    use_ema: bool = True, max_samples: int = 256,
                    draws=None) -> Dict[str, np.ndarray]:
        """A full frame as numpy: image [H, W, 3], depth [H, W],
        weights_sum [H, W]. The mlp backbone renders through the
        hierarchical path, whose draws come from ``draws`` (coarse [HW,
        K1], fine [HW, K2]) or a generator seeded 0."""
        field = self.state.ema_params if use_ema else self.state.params
        pose_t = torch.as_tensor(np.asarray(pose, np.float32),
                                 device=self.device)
        with torch.no_grad():
            if self._use_fast_train:
                out = fastlib.render_image_fast(
                    field, fast_settings(self.settings, max_samples),
                    pose_t, intrinsics, H, W, bg_color,
                    generator=torch.Generator(self.device).manual_seed(0),
                    chunk=self.cfg.render_ray_chunk, draws=draws)
            else:
                out = renderer.render_image(
                    field, self.infer_settings(max_samples), self.grid,
                    pose_t, intrinsics, H, W, bg_color,
                    chunk=self.cfg.render_ray_chunk)
        return {k: v.float().cpu().numpy() for k, v in out.items()}

    def test_gui(self, pose, intrinsics, W: int, H: int, bg_color=1.0,
                 downscale: float = 1.0, use_ema: bool = True,
                 max_samples: int = 128):
        """GUI render bridge (reference nerf/trainer.py:531-602): render
        at a downscaled resolution."""
        rH, rW = int(H * downscale), int(W * downscale)
        intr = tuple(v * downscale for v in intrinsics[:2]) + (
            intrinsics[2] * downscale, intrinsics[3] * downscale)
        out = self.render_pose(pose, intr, rH, rW, bg_color, use_ema,
                               max_samples)
        return {"image": out["image"], "depth": out["depth"]}

    def evaluate(self, dataset, n_views: Optional[int] = None,
                 save_images: bool = True) -> float:
        """Validation pass: PSNR and SSIM (LPIPS with its weights), and
        per-view PNGs under <workspace>/validation (reference
        nerf/trainer.py:748-787)."""
        meter, ssim_m = PSNRMeter(), SSIMMeter()
        lpips_m = (LPIPSMeter(self.device) if LPIPSMeter.available()
                   else None)
        out_dir = os.path.join(self.workspace, "validation")
        if save_images:
            os.makedirs(out_dir, exist_ok=True)
        B = len(dataset.poses)
        for vi in range(min(n_views or B, B)):
            out = self.render_pose(dataset.poses[vi], dataset.intrinsics,
                                   dataset.H, dataset.W)
            gt = np.asarray(dataset.images[vi], np.float32)
            if gt.shape[-1] == 4:
                gt = gt[..., :3] * gt[..., 3:] + 1.0 * (1 - gt[..., 3:])
            pred = out["image"]
            meter.update(pred, gt)
            ssim_m.update(pred, gt)
            if lpips_m is not None:
                lpips_m.update(pred, gt)
            if save_images:
                stem = os.path.join(out_dir, f"ngp_ep{self.global_step:06d}"
                                             f"_{vi:04d}")
                write_png(stem + ".png",
                          np.clip(pred * 255, 0, 255).astype(np.uint8))
                d = out["depth"]
                write_png(stem + "_depth.png", np.clip(
                    d / max(float(d.max()), 1e-6) * 255, 0,
                    255).astype(np.uint8))
        msg = f"[eval] {meter.report()} | {ssim_m.report()}"
        if lpips_m is not None:
            msg += f" | {lpips_m.report()}"
        self.log(msg)
        if self.writer is not None:
            self.writer.add_scalar("eval/psnr", meter.measure(),
                                   self.global_step)
            self.writer.add_scalar("eval/ssim", ssim_m.measure(),
                                   self.global_step)
        return meter.measure()

    # -- geometry export -----------------------------------------------------

    def _density_np(self, x):
        xt = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        return self._density(xt, self.state.ema_params).cpu().numpy()

    def _geometry_threshold(self, threshold):
        if threshold is not None:
            return threshold
        return min(float(self.grid.mean_density) or self.cfg.density_thresh,
                   self.cfg.density_thresh)

    def save_point_cloud(self, path: str, resolution: int = 256,
                         threshold: Optional[float] = None) -> str:
        """Density-thresholded grid point cloud (reference
        trainer.py:354)."""
        from pienerf_tpu_torch.io.ply import write_ply
        from pienerf_tpu_torch.utils import mesh as meshlib

        pts = meshlib.extract_point_cloud(self._density_np, resolution,
                                          self.cfg.bound,
                                          self._geometry_threshold(threshold))
        write_ply(path, pts.astype(np.float64))
        self.log(f"[point cloud] {len(pts)} pts -> {path}")
        return path

    def save_mesh(self, path: str, resolution: int = 256,
                  threshold: Optional[float] = None) -> str:
        """Isosurface mesh by marching tetrahedra (reference
        trainer.py:331)."""
        from pienerf_tpu_torch.utils import mesh as meshlib

        field = meshlib.extract_fields(self._density_np, resolution,
                                       self.cfg.bound)
        verts, tris = meshlib.marching_tetrahedra(
            field, self._geometry_threshold(threshold), self.cfg.bound)
        meshlib.save_mesh_obj(path, verts, tris)
        self.log(f"[mesh] {len(verts)} verts -> {path}")
        return path

    # -- checkpointing -------------------------------------------------------

    def _ckpt_file(self, epoch: int) -> str:
        return os.path.join(self.workspace, "checkpoints",
                            f"{self.name}_ep{epoch:04d}.npz")

    def save_checkpoint(self, full: bool = True) -> str:
        """``{name}_ep{epoch:04d}.npz`` + ``.json``, the JAX trainer's
        layout (params, ema_params; the density grid and counters as
        extras), keeping the newest ``max_keep_ckpt``. A non-finite state
        is never written."""
        if not params_finite(self.state.params):
            self.log("[ckpt] refusing to save: params are non-finite "
                     "(training diverged; fix the run, don't persist it)")
            return ""
        self.epoch += 1
        path = self._ckpt_file(self.epoch)
        extra = {
            "density_grid": self.grid.density.cpu().numpy(),
            "mean_density": float(self.grid.mean_density),
            "iter_density": int(self.grid.iter_density),
            "epoch": self.epoch,
            "global_step": self.global_step,
        }
        ckpt_io.save_native(path, {
            "params": field_to_numpy(self.state.params),
            "ema_params": field_to_numpy(self.state.ema_params),
        }, extra)
        self.stats["checkpoints"].append(path)
        while len(self.stats["checkpoints"]) > self.max_keep_ckpt:
            old = self.stats["checkpoints"].pop(0)
            for f in (old, old + ".json"):
                if os.path.exists(f):
                    os.remove(f)
        return path

    def _adopt_mlp_arch(self, params) -> None:
        """Rebuild the spec from loaded mlp weight shapes when they differ
        from the configured architecture (a 128-wide student loaded by a
        default-width trainer): sigma_net[0] is [3 * (1 + 2 * n_freqs),
        hidden_dim], color_net[0] is [31, hidden_dim_color]."""
        if self.spec.backbone != "mlp" or "sigma_net" not in params:
            return
        sn, cn = params["sigma_net"], params["color_net"]
        in_dim, hidden = sn[0].shape
        n_freqs = (in_dim // 3 - 1) // 2
        hidden_color = (cn[0].shape[1] if len(cn) > 1
                        else self.spec.hidden_dim_color)
        if (hidden == self.spec.hidden_dim
                and hidden_color == self.spec.hidden_dim_color
                and n_freqs == self.spec.n_freqs
                and len(sn) == self.spec.num_layers):
            return
        self.spec = self.spec._replace(
            n_freqs=n_freqs, hidden_dim=hidden,
            hidden_dim_color=hidden_color, num_layers=len(sn),
            num_layers_color=len(cn))
        self._rebuild_train_step()
        self.log(f"[ckpt] adopted mlp arch from checkpoint: "
                 f"hidden={hidden}/{hidden_color}, n_freqs={n_freqs}, "
                 f"layers={len(sn)}+{len(cn)}")

    def load_checkpoint(self, path: Optional[str] = None) -> bool:
        """The newest ``{name}_ep*.npz`` (else ``ngp_ep*.pth``) of the
        workspace, or ``path``; a checkpoint whose params hold a
        non-finite value is refused. The optimizer starts afresh, as the
        JAX trainer's does."""
        if path is None:
            ckdir = os.path.join(self.workspace, "checkpoints")
            cands = sorted(glob.glob(os.path.join(ckdir,
                                                  f"{self.name}_ep*.npz")))
            pths = sorted(glob.glob(os.path.join(ckdir, "ngp_ep*.pth")))
            path = cands[-1] if cands else (pths[-1] if pths else None)
        if path is None or not os.path.exists(path):
            return False
        if path.endswith(".pth"):
            params, extra = ckpt_io.load_torch_ngp(path)
            ema = params
        else:
            tree, extra = ckpt_io.load_native(path)
            params = tree.get("params", tree)
            ema = tree.get("ema_params", params)
        if not params_finite(params):
            self.log(f"[ckpt] REFUSING to load {path}: params contain "
                     "non-finite values (corrupt checkpoint)")
            return False
        if not path.endswith(".pth"):
            self._adopt_mlp_arch(params)
        self._set_fields(params, ema)
        dg = extra.get("density_grid")
        if dg is not None:
            dg = torch.as_tensor(np.asarray(dg, np.float32),
                                 device=self.device)
            md = torch.tensor(float(extra.get("mean_density", 0.0)),
                              device=self.device)
            thresh = torch.clamp(md, max=self.cfg.density_thresh)
            self.grid = gridlib.OccupancyGrid(
                density=dg, bitfield=gridlib.packbits(dg, thresh),
                mean_density=md,
                iter_density=torch.tensor(int(extra.get("iter_density", 16)),
                                          device=self.device))
        self.epoch = int(extra.get("epoch", 0))
        self.global_step = int(extra.get("global_step", 0))
        self.log(f"[ckpt] loaded {path} (epoch {self.epoch}, "
                 f"step {self.global_step})")
        return True
