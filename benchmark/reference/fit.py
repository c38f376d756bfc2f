"""Stand-in weights for a hash-grid field: torch-ngp's table and nets at
the configuration's widths, fitted by Adam to a committed Fourier-MLP
field (the teacher, evaluated by ``render.field``), in plain PyTorch.

No trained hash-grid field is committed, and random weights render a
uniform fog; the fit makes a field that looks like the committed scene,
so a frame needs about as many samples as one of the teacher's. Points
are drawn from the seed each step: a share uniform in the box [-bound,
bound]^3, the rest uniform in the cells of a coarse grid where the
teacher's raw density exceeds ``DENSE_ABOVE`` (or in a cell beside one),
each with a uniform direction. The loss is the squared gap of the raw
densities, each clamped below at ``RAW_FLOOR`` (below it a density adds
nothing a frame can show), plus the squared gap of the colors where the
teacher is dense. Adam as torch-ngp's trainer runs it (betas 0.9, 0.99,
eps 1e-15; the rates decay to a tenth over the fit), the table at 1e-2
and the nets at 1e-3. The configuration's ``fit`` gives the teacher, the
seed, the steps and the batch. It runs under
``torch.use_deterministic_algorithms``: on one kind of device the weights
are the same bit for bit on every run.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from . import hashgrid, render

SH_DIM, GEO_DIM = 16, 15
DENSE_SHARE = 0.5       # of a batch, drawn in the teacher's dense cells
DENSE_CELLS = 64        # the coarse grid's cells an axis
DENSE_ABOVE = 0.0       # a dense cell's least raw density
RAW_FLOOR = -8.0        # raw densities are compared clamped below here
LR_TABLE, LR_NET = 1e-2, 1e-3       # Adam's rates: the table, the nets


def teacher_n_freqs(sigma_in: int) -> int:
    """The teacher's frequencies from its first layer's rows, 3 (2 n + 1)."""
    n, rem = divmod(sigma_in // 3 - 1, 2)
    assert sigma_in % 3 == 0 and rem == 0 and n >= 0, sigma_in
    return n


def _teacher(layers, n_freqs: int, bound: float, x, sh):
    """(raw density, rgb [3, N]) of the Fourier-MLP teacher."""
    sigma, rgb = render.field(layers, render.freq_encode(x, n_freqs, bound),
                              sh)
    return torch.log(sigma), rgb


def _student(table, nets, grid, bound: float, x, sh):
    """(raw density, rgb [3, N]) of the hash-grid field being fitted."""
    sigma, rgb = render.field(nets, hashgrid.encode(table, grid, x, bound),
                              sh)
    return torch.log(sigma), rgb


def _sh(d):
    return render.sh_encode4(d[:, 0], d[:, 1], d[:, 2])


def fit(teacher, bound: float, grid: hashgrid.Grid, width: int,
        sigma_layers: int, color_layers: int, cfg: dict,
        device) -> Dict[str, List[torch.Tensor]]:
    """The fitted field in the port's checkpoint layout: {"encoder":
    [table [rows, C]], "sigma_net": [...], "color_net": [...]}, [in, out]
    f32 on ``device``. ``teacher`` = (sigma_net, color_net) of the
    Fourier MLP; ``cfg``: the configuration's ``fit`` (seed, steps,
    batch)."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        return _fit(teacher, bound, grid, width, sigma_layers, color_layers,
                    cfg, torch.device(device))
    finally:
        torch.use_deterministic_algorithms(was)


def _fit(teacher, bound, grid, width, sigma_layers, color_layers, cfg,
         dev):
    g = torch.Generator(device=dev).manual_seed(int(cfg["seed"]))
    teacher = tuple([torch.as_tensor(w, dtype=torch.float32, device=dev)
                     for w in net] for net in teacher)
    n_freqs = teacher_n_freqs(teacher[0][0].shape[0])

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=g, device=dev)

    def linear(fi, fo):            # torch.nn.Linear's default bound
        b = 1.0 / math.sqrt(fi)
        return uniform((fi, fo), -b, b).requires_grad_()

    sd = [grid.output_dim] + [width] * (sigma_layers - 1) + [1 + GEO_DIM]
    cd = [SH_DIM + GEO_DIM] + [width] * (color_layers - 1) + [3]
    nets = ([linear(sd[i], sd[i + 1]) for i in range(sigma_layers)],
            [linear(cd[i], cd[i + 1]) for i in range(color_layers)])
    # torch-ngp's table init (gridencoder/grid.py: uniform within 1e-4)
    table = uniform((grid.rows, grid.level_dim), -1e-4, 1e-4)
    table.requires_grad_()

    # the coarse cells where the teacher is dense, and their neighbours
    R = DENSE_CELLS
    step = 2.0 * bound / R
    c = -bound + (torch.arange(R, device=dev, dtype=torch.float32) + 0.5) \
        * step
    cx, cy, cz = torch.meshgrid(c, c, c, indexing="ij")
    with torch.no_grad():
        raw = _teacher(teacher, n_freqs, bound, [cx, cy, cz],
                       _sh(torch.zeros((R ** 3, 3), device=dev)
                           + torch.tensor([0.0, 0.0, 1.0], device=dev)))[0]
    occ = (raw > DENSE_ABOVE).float().reshape(1, 1, R, R, R)
    occ = torch.nn.functional.max_pool3d(occ, 3, stride=1, padding=1)
    cells = torch.nonzero(occ.reshape(-1))[:, 0]

    opt = torch.optim.Adam([{"params": [table], "lr": LR_TABLE},
                            {"params": nets[0] + nets[1], "lr": LR_NET}],
                           betas=(0.9, 0.99), eps=1e-15)
    base = [pg["lr"] for pg in opt.param_groups]
    B, steps = int(cfg["batch"]), int(cfg["steps"])
    n_dense = int(round(B * DENSE_SHARE))
    for it in range(steps):
        for pg, lr in zip(opt.param_groups, base):
            pg["lr"] = lr * 0.1 ** (it / steps)
        pick = cells[torch.randint(cells.numel(), (n_dense,), generator=g,
                                   device=dev)]
        ijk = torch.stack([pick // (R * R), (pick // R) % R, pick % R], 1)
        x = torch.cat([-bound + (ijk + uniform((n_dense, 3), 0.0, 1.0))
                       * step,
                       uniform((B - n_dense, 3), -bound, bound)], 0)
        d = torch.randn((B, 3), generator=g, device=dev)
        d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
        xs, sh = [x[:, 0], x[:, 1], x[:, 2]], _sh(d)
        with torch.no_grad():
            raw_t, rgb_t = _teacher(teacher, n_freqs, bound, xs, sh)
        raw_s, rgb_s = _student(table, nets, grid, bound, xs, sh)
        dense = (raw_t > DENSE_ABOVE).float()
        loss = (torch.mean((torch.clamp(raw_s, min=RAW_FLOOR)
                            - torch.clamp(raw_t, min=RAW_FLOOR)) ** 2)
                + torch.mean(dense * ((rgb_s - rgb_t) ** 2).sum(0)))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    return {"encoder": [table.detach()],
            "sigma_net": [w.detach() for w in nets[0]],
            "color_net": [w.detach() for w in nets[1]]}
