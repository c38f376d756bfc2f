"""Fourier-feature positional encoding of the mlp backbone.

Per axis: [x, sin(2^k pi x) for k < n_freqs, cos(2^k pi x) for k < n_freqs],
the sines and cosines from one sin/cos pair by the double-angle ladder, as
in ``pienerf_tpu.models.freq_encoder`` (the fused kernels use the same
ladder, so the three agree to f32 rounding).
"""

from __future__ import annotations

import math

import torch


def output_dim(input_dim: int, n_freqs: int) -> int:
    return input_dim * (2 * n_freqs + 1)


def freq_encode(inputs, n_freqs: int = 10, bound: float = 1.0,
                feature_major: bool = False) -> torch.Tensor:
    """inputs: [N, D] (or a tuple of D component tensors [N]).

    Returns [N, F] (or [F, N] with ``feature_major``)."""
    if isinstance(inputs, (tuple, list)):
        comps = [c.reshape(-1) for c in inputs]
    else:
        comps = [inputs[..., i].reshape(-1) for i in range(inputs.shape[-1])]
    rows = []
    for c in comps:
        cn = c / bound
        rows.append(cn)
        s = torch.sin(math.pi * cn)
        co = torch.cos(math.pi * cn)
        sins, coss = [s], [co]
        for _ in range(n_freqs - 1):
            s, co = 2.0 * s * co, co * co - s * s
            sins.append(s)
            coss.append(co)
        rows.extend(sins)
        rows.extend(coss)
    out = torch.stack(rows, dim=0)                                # [F, N]
    return out if feature_major else out.T
