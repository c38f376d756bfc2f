"""Fused field evaluation: the CUDA kernel ``csrc/field_kernel.cu`` and its
plain PyTorch version.

Port of ``pienerf_tpu.ops.pallas.field_kernel`` at both kernel widths (the
classic 64-wide net and the distilled 128-wide student; ``KERNEL_NETS``).
``field_eval`` launches the kernel for CUDA tensors and takes
``field_eval_plain`` only for CPU tensors; it never falls back from the card
to the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from pienerf_tpu_torch.kernels import _build
from pienerf_tpu_torch.models.network import (NetworkSpec, layer_dims,
                                              torch_dtype)
from pienerf_tpu_torch.models.sh_encoder import sh_encode
from pienerf_tpu_torch.models.freq_encoder import freq_encode

# The nets the CUDA kernels are built for, by pack width: (sigma layer
# dims, color layer dims). 128 is the distilled student of
# ``pienerf_tpu.train.distill.make_student_spec(width=128)`` (n_freqs 10).
KERNEL_NETS = {
    64: ([51, 64, 64, 64, 16], [31, 64, 64, 3]),
    128: ([63, 128, 128, 128, 16], [31, 128, 128, 3]),
}
WIDTHS = tuple(KERNEL_NETS)


def kernel_width(spec: NetworkSpec) -> int:
    """64 for the classic net, 128 when any layer is wider."""
    wd = max(64, spec.hidden_dim, spec.hidden_dim_color, spec.sigma_in_dim)
    if wd > 128:
        raise ValueError(f"fused kernels support widths <= 128, got {wd}")
    return 64 if wd <= 64 else 128


def pack_weights(params, spec: NetworkSpec, device) -> torch.Tensor:
    """Zero-pad every layer to a [Wd, Wd] tile and stack: [L, Wd, Wd] f32.

    ``params``: a FieldMLP or a tree with ``sigma_net`` / ``color_net``
    lists of [in, out] arrays or tensors."""
    wd = kernel_width(spec)
    layers = list(params.sigma_net) + list(params.color_net) if hasattr(
        params, "sigma_net") else (list(params["sigma_net"])
                                   + list(params["color_net"]))
    out = torch.zeros((len(layers), wd, wd), dtype=torch.float32,
                      device=device)
    for i, w in enumerate(layers):
        w = torch.as_tensor(w, dtype=torch.float32, device=device)
        out[i, :w.shape[0], :w.shape[1]] = w
    return out


def encode_rows(x, spec: NetworkSpec, cdt: torch.dtype) -> torch.Tensor:
    """Fourier features [F, N] rounded to cdt (the kernels' encoding)."""
    return freq_encode(x, spec.n_freqs, spec.bound,
                       feature_major=True).to(cdt)


def mlp_plain(packed_w: torch.Tensor, spec: NetworkSpec, enc: torch.Tensor,
              sh: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused kernels' MLP chain on feature-major inputs: enc [F, M]
    and sh [16, M], both already in the compute dtype. Returns (sigma [M]
    f32, rgb [3, M] f32)."""
    cdt = torch_dtype(spec.compute_dtype)
    wd = packed_w.shape[-1]
    ns, nc = spec.num_layers, spec.num_layers_color
    m = enc.shape[1]

    def chain(h, first, n):
        for li in range(n):
            w = packed_w[first + li].to(cdt).float()
            h = (w.T @ h.float()).to(cdt)
            if li != n - 1:
                h = torch.relu(h)
        return h

    z = torch.zeros((wd - enc.shape[0], m), dtype=cdt, device=enc.device)
    h = chain(torch.cat([enc, z], 0), 0, ns)
    sigma = torch.exp(torch.clamp(h[0].float(), -15.0, 15.0))
    z = torch.zeros((wd - 31, m), dtype=cdt, device=enc.device)
    hc = chain(torch.cat([sh, h[1:16], z], 0), ns, nc)
    return sigma, torch.sigmoid(hc[:3].float())


def _stack(x) -> torch.Tensor:
    return torch.stack(list(x), 0) if isinstance(x, (tuple, list)) else x


def field_eval_plain(packed_w: torch.Tensor, spec: NetworkSpec, x, d
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch field_eval: x, d are 3-tuples of [N] component
    tensors (or [3, N]). Returns (sigma [N], rgb [3, N])."""
    cdt = torch_dtype(spec.compute_dtype)
    x = _stack(x)
    d = _stack(d)
    enc = encode_rows(tuple(x), spec, cdt)
    sh = sh_encode(tuple(d), feature_major=True).to(cdt)
    return mlp_plain(packed_w, spec, enc, sh)


def check_kernel_spec(spec: NetworkSpec, packed_w: torch.Tensor) -> int:
    """The CUDA kernels are specialised to the nets of ``KERNEL_NETS``,
    each packed [7, Wd, Wd]. Returns Wd."""
    sd, cd = layer_dims(spec)
    for wd, dims in KERNEL_NETS.items():
        if (sd, cd) == dims and tuple(packed_w.shape) == (7, wd, wd):
            return wd
    raise NotImplementedError(
        f"the CUDA field kernels take the 51-64-64-64-16 / 31-64-64-3 net "
        f"packed [7, 64, 64] or the 63-128-128-128-16 / 31-128-128-3 net "
        f"packed [7, 128, 128]; got sigma {sd}, color {cd}, pack "
        f"{tuple(packed_w.shape)}")


def check_arg(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    """Raise unless a kernel argument has the device, dtype, shape and
    contiguity the kernel takes."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def field_eval(packed_w: torch.Tensor, spec: NetworkSpec, x, d
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Evaluate the field at N points (any N). x, d: 3-tuples of [N]
    tensors or [3, N]. Returns (sigma [N], rgb [3, N]) f32.

    CPU tensors take field_eval_plain; CUDA tensors launch the kernel at
    the pack's width and count the launch in ``field_eval.launches[Wd]``."""
    x = _stack(x)
    if x.device.type == "cpu":
        return field_eval_plain(packed_w, spec, x, d)
    d = _stack(d).contiguous()
    x = x.contiguous()
    n = x.shape[1]
    dev = x.device
    wd = check_kernel_spec(spec, packed_w)
    for t, name, shape in ((x, "x", (3, n)), (d, "d", (3, n)),
                           (packed_w, "packed_w", (7, wd, wd))):
        check_arg(t, name, torch.float32, shape, dev)
    out = torch.empty((4, n), dtype=torch.float32, device=dev)
    if n > 0:
        lib = _build.library("field")
        fn = lib.pienerf_field_eval
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), d.data_ptr(), packed_w.data_ptr(),
                out.data_ptr(), n, float(spec.bound),
                int(spec.compute_dtype == "bfloat16"), wd, n_sm, stream)
        _build.check(lib, rc, "field_eval")
        field_eval.launches[wd] += 1
    return out[0], out[1:4]


field_eval.launches = dict.fromkeys(WIDTHS, 0)
