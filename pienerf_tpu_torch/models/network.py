"""Radiance field: position encoding -> sigma MLP; SH4(d) + geo features
-> color MLP; optionally a background net on a sphere.

Port of ``pienerf_tpu.models.network`` for both backbones:
``mlp`` (Fourier features; the fused kernels read its layout) and
``hashgrid`` (the reference's multiresolution hash encoding, with its
embeddings as a parameter). ``bg_radius > 0`` adds ``encoder_bg`` (a 2-D
hash grid of 4 levels) and ``bg_net`` (reference nerf/network.py:74-95).
Weights are bias-free and stored ``[in, out]`` as in the JAX params tree,
so a checkpoint carries across without transposes. Unlike the JAX
package, ``make_spec`` defaults to the mlp backbone, which every fused
path of the port serves (the hashgrid one serves only the fused frame's
tile kernel); pass ``backbone="hashgrid"`` for the other.

A field is built frozen (``requires_grad=False``), as every inference
path and the kernels' ``pack_weights`` read it; ``trainable=True`` (or
``set_trainable``) makes its parameters autograd leaves for the trainer.
``trunc_exp``'s gradient is JAX's custom VJP: ``g * exp(clamp(x))``, so a
raw density beyond +-15 still gets a gradient.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from pienerf_tpu_torch.models import freq_encoder, hash_encoder
from pienerf_tpu_torch.models.sh_encoder import sh_encode


class _TruncExp(torch.autograd.Function):
    """exp(clamp(x, -15, 15)) whose backward passes g * exp(clamp(x))
    (pienerf_tpu/models/network.py:28-58), not the clamp's zero."""

    @staticmethod
    def forward(ctx, x):
        y = torch.exp(torch.clamp(x, -15.0, 15.0))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * y


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    """exp saturating at exp(+-15); the JAX package and both fused kernels
    clamp identically. Under autograd its gradient is the straight-through
    clamped exp."""
    if x.requires_grad and torch.is_grad_enabled():
        return _TruncExp.apply(x)
    return torch.exp(torch.clamp(x, -15.0, 15.0))


GEO_FEAT_DIM = 15                 # sigma net outputs 1 sigma + 15 geo
SH_DIM = 16                       # degree-4 SH features (the fused kernels')


class NetworkSpec(NamedTuple):
    """Static architecture description (hashable)."""
    n_freqs: int = 8
    num_layers: int = 4
    hidden_dim: int = 64
    num_layers_color: int = 3
    hidden_dim_color: int = 64
    bound: float = 1.0
    compute_dtype: str = "float32"
    backbone: str = "mlp"
    grid: Optional[hash_encoder.HashGridSpec] = None
    bg_radius: float = -1.0
    grid_bg: Optional[hash_encoder.HashGridSpec] = None
    num_layers_bg: int = 2
    hidden_dim_bg: int = 64
    sh_degree: int = 4

    @property
    def sigma_in_dim(self) -> int:
        if self.backbone == "mlp":
            return freq_encoder.output_dim(3, self.n_freqs)
        return self.grid.output_dim


def make_spec(bound: float = 1.0, compute_dtype: str = "float32",
              backbone: str = "mlp", bg_radius: float = -1.0,
              **kw) -> NetworkSpec:
    """The JAX package's ``make_spec``: the hashgrid backbone takes the
    default grid at ``desired_resolution`` 2048 * bound and a 2-layer sigma
    net; ``bg_radius > 0`` adds the background grid."""
    grid = grid_bg = None
    if backbone == "hashgrid":
        grid = hash_encoder.make_spec(desired_resolution=2048 * bound)
        kw.setdefault("num_layers", 2)
    if bg_radius > 0:
        grid_bg = hash_encoder.make_spec(input_dim=2, num_levels=4,
                                         desired_resolution=2048)
    return NetworkSpec(bound=bound, compute_dtype=compute_dtype,
                       backbone=backbone, grid=grid, bg_radius=bg_radius,
                       grid_bg=grid_bg, **kw)


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def layer_dims(spec: NetworkSpec) -> Tuple[list, list]:
    sigma = ([spec.sigma_in_dim] + [spec.hidden_dim] * (spec.num_layers - 1)
             + [1 + GEO_FEAT_DIM])
    color = ([spec.sh_degree ** 2 + GEO_FEAT_DIM]
             + [spec.hidden_dim_color] * (spec.num_layers_color - 1) + [3])
    return sigma, color


def bg_dims(spec: NetworkSpec) -> list:
    return ([spec.grid_bg.output_dim + spec.sh_degree ** 2]
            + [spec.hidden_dim_bg] * (spec.num_layers_bg - 1) + [3])


def mlp_chain(layers, h: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """Feature-major bias-free MLP: h [F_in, N] -> [F_out, N].

    Every layer reads its input rounded to ``cdt``, accumulates in f32 and
    rounds its output back to ``cdt``; ReLU between layers, not after the
    last (the fused kernels' arithmetic)."""
    h = h.to(cdt)
    for i, w in enumerate(layers):
        h = (w.to(cdt).float().T @ h.float()).to(cdt)
        if i != len(layers) - 1:
            h = torch.relu(h)
    return h


class FieldMLP(nn.Module):
    """The field. ``sigma_net[i]`` / ``color_net[i]`` / ``bg_net[i]`` are
    ``[in, out]`` weight matrices; ``encoder`` (hashgrid) and
    ``encoder_bg`` (bg_radius > 0) the hash embeddings. The generator draws
    the nets first, then the embeddings, so an mlp field of a seed is the
    same field it always was. ``trainable`` makes every parameter an
    autograd leaf."""

    def __init__(self, spec: NetworkSpec,
                 generator: Optional[torch.Generator] = None,
                 device=None, trainable: bool = False):
        super().__init__()
        self.spec = spec
        sd, cd = layer_dims(spec)

        def init(fi, fo):
            # Kaiming-uniform bound of torch.nn.Linear's default init
            bd = 1.0 / math.sqrt(fi) * math.sqrt(3.0)
            w = torch.rand((fi, fo), generator=generator,
                           dtype=torch.float32) * (2 * bd) - bd
            return nn.Parameter(w.to(device), requires_grad=trainable)

        self.sigma_net = nn.ParameterList(
            [init(sd[i], sd[i + 1]) for i in range(spec.num_layers)])
        self.color_net = nn.ParameterList(
            [init(cd[i], cd[i + 1]) for i in range(spec.num_layers_color)])
        if spec.bg_radius > 0:
            bd_ = bg_dims(spec)
            self.bg_net = nn.ParameterList(
                [init(bd_[i], bd_[i + 1]) for i in range(spec.num_layers_bg)])
        if spec.backbone == "hashgrid":
            self.encoder = nn.Parameter(hash_encoder.init_embeddings(
                spec.grid, generator, device), requires_grad=trainable)
        if spec.bg_radius > 0:
            self.encoder_bg = nn.Parameter(hash_encoder.init_embeddings(
                spec.grid_bg, generator, device), requires_grad=trainable)

    def tree(self) -> Dict[str, Any]:
        """The parameters in the JAX package's params layout:
        {"sigma_net": [...], "color_net": [...]} plus "encoder" (hashgrid)
        and "encoder_bg" / "bg_net" (bg_radius > 0)."""
        out: Dict[str, Any] = {"sigma_net": list(self.sigma_net),
                               "color_net": list(self.color_net)}
        if self.spec.backbone == "hashgrid":
            out["encoder"] = self.encoder
        if self.spec.bg_radius > 0:
            out["encoder_bg"] = self.encoder_bg
            out["bg_net"] = list(self.bg_net)
        return out

    def leaves(self) -> List[torch.Tensor]:
        """The parameters in the order ``jax.tree_util.tree_leaves`` gives
        the params tree (its dict keys sorted, each list in order)."""
        tree = self.tree()
        out: List[torch.Tensor] = []
        for k in sorted(tree):
            v = tree[k]
            out += list(v) if isinstance(v, list) else [v]
        return out

    def set_trainable(self, flag: bool = True) -> "FieldMLP":
        for p in self.parameters():
            p.requires_grad_(flag)
        return self

    def density(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: [N, 3] (or 3 component tensors) -> (sigma [N], geo [15, N])."""
        cdt = torch_dtype(self.spec.compute_dtype)
        if self.spec.backbone == "mlp":
            enc = freq_encoder.freq_encode(x, self.spec.n_freqs,
                                           self.spec.bound,
                                           feature_major=True)
        else:
            enc = hash_encoder.encode(self.encoder, self.spec.grid, x,
                                      self.spec.bound, feature_major=True)
        h = mlp_chain(list(self.sigma_net), enc, cdt).float()
        return trunc_exp(h[0]), h[1:]

    def color(self, d, geo: torch.Tensor) -> torch.Tensor:
        """d: [N, 3] unit dirs (or components), geo [15, N] -> rgb [N, 3]."""
        cdt = torch_dtype(self.spec.compute_dtype)
        enc_d = sh_encode(d, self.spec.sh_degree, feature_major=True)
        h = torch.cat([enc_d.to(cdt), geo.to(cdt)], dim=0)
        h = mlp_chain(list(self.color_net), h, cdt).float()
        return torch.sigmoid(h).T

    def forward(self, x, d) -> Tuple[torch.Tensor, torch.Tensor]:
        """(sigma [N], rgb [N, 3])."""
        sigma, geo = self.density(x)
        return sigma, self.color(d, geo)

    def background(self, sph, d) -> torch.Tensor:
        """Background sphere color (reference nerf/network.py:133-148):
        sph [N, 2] in [-1, 1] (or components), d [N, 3] -> rgb [N, 3]."""
        cdt = torch_dtype(self.spec.compute_dtype)
        h_pos = hash_encoder.encode(self.encoder_bg, self.spec.grid_bg, sph,
                                    1.0, feature_major=True)
        enc_d = sh_encode(d, self.spec.sh_degree, feature_major=True)
        h = torch.cat([enc_d.to(cdt), h_pos.to(cdt)], dim=0)
        h = mlp_chain(list(self.bg_net), h, cdt).float()
        return torch.sigmoid(h).T


def init_params(generator: Optional[torch.Generator], spec: NetworkSpec,
                device=None) -> Dict[str, Any]:
    """A fresh params tree in the JAX package's layout and init law
    (pienerf_tpu/models/network.py:109-150): every layer Kaiming-uniform
    U(-sqrt(3 / fan_in), sqrt(3 / fan_in)) as [in, out], hash embeddings
    U(-1e-4, 1e-4). One generator draws the nets, then the embeddings (the
    JAX package splits one key per leaf)."""
    field = FieldMLP(spec, generator=generator, device=device)
    return {k: ([p.detach() for p in v] if isinstance(v, list)
                else v.detach())
            for k, v in field.tree().items()}

