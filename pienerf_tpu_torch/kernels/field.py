"""Fused field evaluation: the CUDA kernel ``csrc/field_kernel.cu`` and its
plain PyTorch version.

Port of ``pienerf_tpu.ops.pallas.field_kernel`` at both kernel widths (the
classic 64-wide net and the distilled 128-wide student; ``KERNEL_NETS``).
``field_eval`` launches the kernel for CUDA tensors and takes
``field_eval_plain`` only for CPU tensors; it never falls back from the card
to the plain version. With ``compute_dtype="bfloat16"`` the kernel runs the
MLP on the tensor cores (``csrc/mma_mlp.cuh``), with f32 on the CUDA cores;
the plain version rounds as both do.
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
    with torch.no_grad():            # a trainable field packs as a frozen one
        for i, w in enumerate(layers):
            w = torch.as_tensor(w, dtype=torch.float32, device=device)
            out[i, :w.shape[0], :w.shape[1]] = w
    return out


def pack_weights_paired(params, spec: NetworkSpec, device) -> torch.Tensor:
    """Block-diagonal sigma || color pairs for the paired tile kernel:
    position li holds diag(sigma_li or I, color_li or I) as one [128, 128]
    tile, [max(n_sigma, n_color), 128, 128] f32. The shorter chain is padded
    with identity blocks at the tail; the off-diagonal blocks are zero.
    Only a 64-wide net pairs (the wide student fills the tile alone)."""
    if kernel_width(spec) != 64:
        raise ValueError("paired packing co-schedules two 64-wide chains; "
                         "the 128-wide student packs with pack_weights")
    flat = pack_weights(params, spec, device)                 # [L, 64, 64]
    ns, nc = spec.num_layers, spec.num_layers_color
    lp = max(ns, nc)
    out = torch.zeros((lp, 128, 128), dtype=torch.float32, device=device)
    eye = torch.eye(64, dtype=torch.float32, device=device)
    for li in range(lp):
        out[li, :64, :64] = flat[li] if li < ns else eye
        out[li, 64:, 64:] = flat[ns + li] if li < nc else eye
    return out


def is_paired(spec: NetworkSpec, packed_w: torch.Tensor) -> bool:
    """A 128-wide pack for a 64-wide net can only be the paired layout
    (the wide student's spec has kernel width 128)."""
    return packed_w.shape[-1] == 128 and kernel_width(spec) == 64


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


def mlp_paired_plain(packed_w: torch.Tensor, spec: NetworkSpec, enc,
                     sh: torch.Tensor, geo_prev: torch.Tensor):
    """One pass of the paired chain (tile_kernel.py ``paired_chain``): this
    segment's sigma chain beside the previous segment's color chain, as
    max(n_sigma, n_color) block-diagonal [128, 128] products on the stacked
    column [enc | 0 ; sh | geo_prev | 0]. ReLU applies to a half only
    between its own chain's layers; the shorter chain's identity tail
    passes its output through. ``enc`` None is the drain pass (sigma input
    zeros). Inputs feature-major in the compute dtype, M columns. Returns
    (sigma [M] f32, geo [15, M] compute dtype, rgb_prev [3, M] f32)."""
    cdt = torch_dtype(spec.compute_dtype)
    ns, nc = spec.num_layers, spec.num_layers_color
    m = sh.shape[1]
    dev = sh.device
    top = torch.zeros((64, m), dtype=cdt, device=dev)
    if enc is not None:
        top[:enc.shape[0]] = enc
    hp = torch.cat([top, sh, geo_prev,
                    torch.zeros((33, m), dtype=cdt, device=dev)], 0)
    for li in range(max(ns, nc)):
        w = packed_w[li].to(cdt).float()
        hp = (w.T @ hp.float()).to(cdt)
        if li < ns - 1:
            hp[:64] = torch.relu(hp[:64])
        if li < nc - 1:
            hp[64:] = torch.relu(hp[64:])
    sigma = torch.exp(torch.clamp(hp[0].float(), -15.0, 15.0))
    return sigma, hp[1:16], torch.sigmoid(hp[64:67].float())


def _stack(x) -> torch.Tensor:
    return torch.stack(list(x), 0) if isinstance(x, (tuple, list)) else x


def field_eval_plain(packed_w: torch.Tensor, spec: NetworkSpec, x, d
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch field_eval: x, d are 3-tuples of [N] component
    tensors (or [3, N]). Returns (sigma [N], rgb [3, N])."""
    if is_paired(spec, packed_w):
        raise ValueError("field_eval takes the [7, Wd, Wd] pack; the paired "
                         "layout is the tile kernel's")
    cdt = torch_dtype(spec.compute_dtype)
    x = _stack(x)
    d = _stack(d)
    enc = encode_rows(tuple(x), spec, cdt)
    sh = sh_encode(tuple(d), feature_major=True).to(cdt)
    return mlp_plain(packed_w, spec, enc, sh)


def check_kernel_spec(spec: NetworkSpec, packed_w: torch.Tensor,
                      allow_paired: bool = False) -> int:
    """The CUDA kernels are specialised to the nets of ``KERNEL_NETS``,
    each packed [7, Wd, Wd]; with ``allow_paired`` (the tile kernel) the
    64-wide net may also come in the paired [4, 128, 128] layout of
    ``pack_weights_paired``. Returns the net's width Wd."""
    sd, cd = layer_dims(spec)
    shape = tuple(packed_w.shape)
    for wd, dims in KERNEL_NETS.items():
        if (sd, cd) == dims and (shape == (7, wd, wd) or (
                allow_paired and wd == 64 and shape == (4, 128, 128))):
            return wd
    raise NotImplementedError(
        f"the CUDA field kernels take the 51-64-64-64-16 / 31-64-64-3 net "
        f"packed [7, 64, 64] (the tile kernel also its paired [4, 128, 128] "
        f"layout) or the 63-128-128-128-16 / 31-128-128-3 net packed "
        f"[7, 128, 128]; got sigma {sd}, color {cd}, pack {shape}")


def check_aligned(t: torch.Tensor, name: str) -> None:
    """Raise unless ``t`` starts on a 16-byte boundary, as a bulk copy's
    address and a 16-byte vector load need (the fetch kernels' rows, the
    tile kernel's candidate windows)."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary "
                         f"(data_ptr {t.data_ptr():#x})")


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
    the pack's width and count the launch in
    ``field_eval.launches[(Wd, compute_dtype)]``."""
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
        bf16 = spec.compute_dtype == "bfloat16"
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), d.data_ptr(), packed_w.data_ptr(),
                out.data_ptr(), n, float(spec.bound),
                int(bf16), wd, n_sm, stream)
        _build.check(lib, rc, "field_eval")
        field_eval.launches[(wd, "bfloat16" if bf16 else "float32")] += 1
    return out[0], out[1:4]


field_eval.launches = {(w, t): 0 for w in WIDTHS
                       for t in ("float32", "bfloat16")}
