"""Radiance field of the mlp backbone: Fourier features -> sigma MLP;
SH4(d) + geo features -> color MLP.

Port of ``pienerf_tpu.models.network`` for ``backbone="mlp"`` (the
hashgrid backbone is not ported yet; ROADMAP.md queue 1 item 10). Weights
are bias-free and stored ``[in, out]`` as in the JAX params tree, so a
checkpoint carries across without transposes.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from pienerf_tpu_torch.models import freq_encoder
from pienerf_tpu_torch.models.sh_encoder import sh_encode


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    """exp saturating at exp(+-15), forward only (inference). The JAX
    package and both fused kernels clamp identically."""
    return torch.exp(torch.clamp(x, -15.0, 15.0))


GEO_FEAT_DIM = 15                 # sigma net outputs 1 sigma + 15 geo
SH_DIM = 16                       # degree-4 SH direction features


class NetworkSpec(NamedTuple):
    """Static architecture description of the mlp backbone."""
    n_freqs: int = 8
    num_layers: int = 4
    hidden_dim: int = 64
    num_layers_color: int = 3
    hidden_dim_color: int = 64
    bound: float = 1.0
    compute_dtype: str = "float32"

    @property
    def sigma_in_dim(self) -> int:
        return freq_encoder.output_dim(3, self.n_freqs)


def make_spec(bound: float = 1.0, compute_dtype: str = "float32",
              **kw) -> NetworkSpec:
    return NetworkSpec(bound=bound, compute_dtype=compute_dtype, **kw)


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def layer_dims(spec: NetworkSpec) -> Tuple[list, list]:
    sigma = ([spec.sigma_in_dim] + [spec.hidden_dim] * (spec.num_layers - 1)
             + [1 + GEO_FEAT_DIM])
    color = ([SH_DIM + GEO_FEAT_DIM]
             + [spec.hidden_dim_color] * (spec.num_layers_color - 1) + [3])
    return sigma, color


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
    """The mlp-backbone field. ``sigma_net[i]`` / ``color_net[i]`` are
    ``[in, out]`` weight matrices."""

    def __init__(self, spec: NetworkSpec,
                 generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.spec = spec
        sd, cd = layer_dims(spec)

        def init(fi, fo):
            # Kaiming-uniform bound of torch.nn.Linear's default init
            bd = 1.0 / math.sqrt(fi) * math.sqrt(3.0)
            w = torch.rand((fi, fo), generator=generator,
                           dtype=torch.float32) * (2 * bd) - bd
            return nn.Parameter(w.to(device), requires_grad=False)

        self.sigma_net = nn.ParameterList(
            [init(sd[i], sd[i + 1]) for i in range(spec.num_layers)])
        self.color_net = nn.ParameterList(
            [init(cd[i], cd[i + 1]) for i in range(spec.num_layers_color)])

    def density(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: [N, 3] (or 3 component tensors) -> (sigma [N], geo [15, N])."""
        cdt = torch_dtype(self.spec.compute_dtype)
        enc = freq_encoder.freq_encode(x, self.spec.n_freqs, self.spec.bound,
                                       feature_major=True)
        h = mlp_chain(list(self.sigma_net), enc, cdt).float()
        return trunc_exp(h[0]), h[1:]

    def color(self, d, geo: torch.Tensor) -> torch.Tensor:
        """d: [N, 3] unit dirs (or components), geo [15, N] -> rgb [N, 3]."""
        cdt = torch_dtype(self.spec.compute_dtype)
        enc_d = sh_encode(d, feature_major=True)
        h = torch.cat([enc_d.to(cdt), geo.to(cdt)], dim=0)
        h = mlp_chain(list(self.color_net), h, cdt).float()
        return torch.sigmoid(h).T

    def forward(self, x, d) -> Tuple[torch.Tensor, torch.Tensor]:
        """(sigma [N], rgb [N, 3])."""
        sigma, geo = self.density(x)
        return sigma, self.color(d, geo)
