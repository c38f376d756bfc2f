"""Q-GMLS meshless hyperelasticity simulator in PyTorch.

Port of ``pienerf_tpu.sim.solver``. The elastic right-hand side is
assembled through one of two forms of the same operator: the cell-chunked
block-sparse ``Dc`` (every scene has it; storage nIP * 240 floats) or, for
scenes of at most ``DENSE_IP_THRESHOLD`` integration points (IPs), the
dense ``B`` [3 nIP, 10 K] that ``sim_init`` also builds by default there.
``rhs_elastic_delta`` dispatches on the presence of ``B``.

``sim_init`` is the same float64 numpy precompute as the JAX package (so
the constants agree exactly), with tensors on ``device`` at the end;
``sim_init_cached`` keeps it in a content-addressed npz. The step keeps the
delta formulation ``ddof = dof - dof_rest`` that makes float32 sufficient;
every contraction runs in true f32 (the package turns TF32 off), since a
reduced-precision sim pass diverges. The chunked form's node scatter is a
gather along a per-node list built once in ``sim_init`` and a sum along a
fixed axis: no float ``index_add_`` and no atomics, so two steps from the
same state agree bit for bit on the card.

``Simulator`` is the reference's stateful interface over these functions.

Conventions: dof [K, 10, 3]; F[d, c] = d phi_d / d p_c;
dF[j, d, c] = d^2 phi_d / (d p_c d p_j).
"""

from __future__ import annotations

import hashlib
import os
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from pienerf_tpu_torch.sim import gmls
from pienerf_tpu_torch.sim.svd3 import corotated_delta
from pienerf_tpu_torch.utils.trace import FRAME_IP_INFO, span

DENSE_IP_THRESHOLD = 6000


class SimConstants(NamedTuple):
    """Per-scene constants produced by sim_init (tensors on one device)."""
    global_inv: torch.Tensor   # [10K, 10K] masked regularized inverse
    mass_invt2: torch.Tensor   # [10K, 10K] mass matrix / dt^2
    # Cell-chunked F-assembly operator. Every IP of a kernel cell shares the
    # same 8 kernel nodes, so IPs sorted by cell and split into chunks of at
    # most S rows give exact dense blocks:
    #   F_delta[chunk k] = Dc[k] @ ddof[chunk_nodes[k]]
    #   rhs += Dc[k]^T @ dP[chunk k], summed per node through node_gather
    Dc: torch.Tensor           # [C, S, 3, 80], Dc[k, s, j, i*10+a] =
    #   IP_dNx[ip(k, s), i, j, a]; zero rows pad; f32, or bf16 storage
    #   after cast_B_bf16
    chunk_nodes: torch.Tensor  # [C, 8] int64 kernel-node ids per chunk
    chunk_mu: torch.Tensor     # [C, S] mu per chunk row (0 at padding)
    chunk_lam: torch.Tensor    # [C, S] lam per chunk row (0 at padding)
    node_gather: torch.Tensor  # [K, G] int64: per node, the rows of the
    #   [C * 8] chunk-node list that name it, padded with C * 8 (a zero row)
    rhs_gravity: torch.Tensor  # [K, 10, 3]
    dof_rest: torch.Tensor     # [K, 10, 3]
    ip_pos: torch.Tensor       # [nIP, 3] rest IP positions
    IP_kernel: torch.Tensor    # [nIP, 8] int64
    IP_Nx: torch.Tensor        # [nIP, 8, 10]
    IP_dNx: torch.Tensor       # [nIP, 8, 3, 10]
    IP_ddNx: torch.Tensor      # [nIP, 8, 3, 3, 10]
    IP_mu: torch.Tensor        # [nIP]
    IP_lam: torch.Tensor       # [nIP]
    IP_rho: torch.Tensor       # [nIP]
    pts_rest: torch.Tensor     # [npts, 3]
    pts_kernel: torch.Tensor   # [npts, 8] int64
    pts_Nx: torch.Tensor       # [npts, 8, 10]
    dt: float
    dx: float
    iters: int
    # Dense [3*nIP, 10K] F-assembly operator, present only for small scenes
    # (sim_init selects by IP count unless told):
    #   B[j*nIP + v, k*10 + a] = sum_i dNx[v, i, j, a] [IP_kernel[v,i]==k]
    B: Optional[torch.Tensor] = None


class SimState(NamedTuple):
    """Simulation state; ddof = dof - dof_rest."""
    ddof: torch.Tensor         # [K, 10, 3]
    dof_vel: torch.Tensor      # [K, 10, 3]
    dof_f: torch.Tensor        # [K, 10, 3]


def zero_state(consts: SimConstants) -> SimState:
    z = torch.zeros_like(consts.dof_rest)
    return SimState(ddof=z, dof_vel=z.clone(), dof_f=z.clone())


# ---------------------------------------------------------------------------
# init (host, float64 numpy)
# ---------------------------------------------------------------------------

def _corner_offsets() -> np.ndarray:
    return np.array([[(s >> 2) & 1, (s >> 1) & 1, s & 1] for s in range(8)],
                    dtype=np.int64)


def _assemble_scalar_matrix(dim: int, topo: np.ndarray,
                            blocks: np.ndarray) -> np.ndarray:
    """Scatter-add [n, 8, 10, 8, 10] blocks into a dense [dim, dim] matrix
    (deterministic bincount)."""
    n = topo.shape[0]
    rows = (topo[:, :, None] * 10 + np.arange(10)[None, None, :]).reshape(n, 80)
    flat = rows[:, :, None] * dim + rows[:, None, :]
    mat = np.bincount(flat.reshape(-1), weights=blocks.reshape(-1),
                      minlength=dim * dim)
    return mat.reshape(dim, dim)


def _elastic_blocks(dx, dt, mu, lam, rho, Nx, dNx, ddNx) -> np.ndarray:
    """Per-IP [80, 80] stiffness/mass blocks as Gram matrices S^T S."""
    n = Nx.shape[0]
    N = Nx.reshape(n, 1, 80)
    dN = dNx.transpose(0, 2, 1, 3).reshape(n, 3, 80)
    ddN = ddNx.transpose(0, 2, 3, 1, 4).reshape(n, 9, 80)
    c0 = rho * dx**3 / dt**2
    c1 = dx**3 * (rho * dx**2 / 12.0 / dt**2 + mu + lam)
    c2 = dx**5 * (mu + lam) / 12.0
    S = np.concatenate([
        np.sqrt(c0)[:, None, None] * N,
        np.sqrt(c1)[:, None, None] * dN,
        np.sqrt(c2)[:, None, None] * ddN,
    ], axis=1)
    return np.matmul(S.transpose(0, 2, 1), S)


def _pin_blocks(stiff: float, Nx_pin: np.ndarray) -> np.ndarray:
    n = Nx_pin.shape[0]
    N = Nx_pin.reshape(n, 1, 80)
    return stiff * np.matmul(N.transpose(0, 2, 1), N)


def node_gather_list(chunk_nodes: np.ndarray, n_k: int) -> np.ndarray:
    """Per kernel node, the positions in the flattened [C * 8] chunk-node
    list that name it, in increasing order, padded to the longest list with
    C * 8 (the index of a zero row the step appends): [n_k, G] int64."""
    flat = np.asarray(chunk_nodes, np.int64).reshape(-1)
    order = np.argsort(flat, kind="stable")
    counts = np.bincount(flat, minlength=n_k)
    G = max(1, int(counts.max()))
    out = np.full((n_k, G), flat.shape[0], np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    col = np.arange(flat.shape[0]) - np.repeat(starts, counts)
    out[flat[order], col] = order
    return out


def sim_init(
    pos: np.ndarray,
    mass: np.ndarray,
    mu: np.ndarray,
    lam: np.ndarray,
    is_pin: np.ndarray,
    dt: float = 1e-2,
    iters: int = 20,
    bbox: Optional[np.ndarray] = None,
    kres: int = 7,
    dx: float = 1.0,
    gravity: Tuple[float, float, float] = (0.0, -9.8, 0.0),
    stiff: float = 1e5,
    base: Optional[np.ndarray] = None,
    device: torch.device = torch.device("cpu"),
    dense_operator: Optional[bool] = None,
) -> Tuple[SimConstants, SimState, dict]:
    """Build all per-scene constants. Returns (constants, rest state, aux).
    ``dense_operator`` None builds the dense ``B`` for scenes of at most
    ``DENSE_IP_THRESHOLD`` IPs; the chunked operator is always built."""
    pos = np.asarray(pos, np.float64)
    mass = np.asarray(mass, np.float64)
    mu = np.asarray(mu, np.float64)
    lam = np.asarray(lam, np.float64)
    is_pin = np.asarray(is_pin, bool)
    bbox = np.asarray(bbox if bbox is not None else [1.0, 1.0, 1.0],
                      np.float64) * 1.02
    base = np.asarray(base if base is not None else [-0.5, -0.5, -0.5],
                      np.float64) * 1.01
    gravity = np.asarray(gravity, np.float64)

    res = (bbox // dx).astype(np.int64)

    grid_idx = np.clip(((pos - base) // dx).astype(np.int64), 0, res - 1)
    ip_mask = np.zeros(tuple(res), bool)
    ip_mask[grid_idx[:, 0], grid_idx[:, 1], grid_idx[:, 2]] = True
    n_ip = int(ip_mask.sum())
    ip_idx = -np.ones(tuple(res), np.int64)
    ip_idx[ip_mask] = np.arange(n_ip)
    pts_ip = ip_idx[grid_idx[:, 0], grid_idx[:, 1], grid_idx[:, 2]]
    ip_grid = np.argwhere(ip_mask)
    ip_pos = (ip_grid + 0.5) * dx + base

    kdx = float(res.max() * dx) / (kres - 1)
    corners = _corner_offsets()
    ip2k = np.clip(((ip_pos - base) // kdx).astype(np.int64), 0, kres - 2)
    pts2k = np.clip(((pos - base) // kdx).astype(np.int64), 0, kres - 2)

    kmask = np.zeros((kres, kres, kres), bool)
    cells = ip2k[:, None, :] + corners[None]
    kmask[cells[..., 0], cells[..., 1], cells[..., 2]] = True
    n_k = int(kmask.sum())
    kidx = np.zeros((kres, kres, kres), np.int64)
    kidx[kmask] = np.arange(n_k)

    ip_kernel = kidx[cells[..., 0], cells[..., 1], cells[..., 2]]
    pcells = pts2k[:, None, :] + corners[None]
    pts_kernel = kidx[pcells[..., 0], pcells[..., 1], pcells[..., 2]]

    kernel_grid = np.argwhere(kmask)
    kernel_pos = kernel_grid * kdx + base

    pts_Nx, pts_dNx, pts_ddNx = gmls.shape_functions(pos, pts_kernel,
                                                     kernel_pos, kdx)
    IP_Nx, IP_dNx, IP_ddNx = gmls.shape_functions(ip_pos, ip_kernel,
                                                  kernel_pos, kdx)

    w_mass = np.bincount(pts_ip, weights=mass, minlength=n_ip)
    IP_mu = np.bincount(pts_ip, weights=mu * mass, minlength=n_ip) / w_mass
    IP_lam = np.bincount(pts_ip, weights=lam * mass, minlength=n_ip) / w_mass
    IP_rho = w_mass / dx**3

    dim = n_k * 10
    blocks = _elastic_blocks(dx, dt, IP_mu, IP_lam, IP_rho, IP_Nx, IP_dNx,
                             IP_ddNx)
    mat = _assemble_scalar_matrix(dim, ip_kernel, blocks)
    if is_pin.any():
        mat += _assemble_scalar_matrix(
            dim, pts_kernel[is_pin], _pin_blocks(stiff, pts_Nx[is_pin]))

    active_nodes = np.diag(mat)[0::10] > 0.0
    act = np.repeat(active_nodes, 10)
    sub = mat[np.ix_(act, act)]
    sub[np.diag_indices_from(sub)] += 1e-3
    global_inv = np.zeros((dim, dim))
    global_inv[np.ix_(act, act)] = np.linalg.inv(sub)

    mblocks = _elastic_blocks(dx, dt, np.zeros(n_ip), np.zeros(n_ip), IP_rho,
                              IP_Nx, IP_dNx, IP_ddNx)
    mass_invt2 = _assemble_scalar_matrix(dim, ip_kernel, mblocks)

    dof_rest = np.zeros((n_k, 10, 3))
    dof_rest[:, 0, :] = kernel_pos
    for j in range(3):
        dof_rest[:, 1 + j, j] = 1.0

    m_ip = IP_rho * dx**3
    grav_contrib = (m_ip[:, None, None, None] * IP_Nx[..., None]
                    * gravity[None, None, None, :])
    rhs_gravity = np.zeros((n_k, 10, 3))
    np.add.at(rhs_gravity, ip_kernel.reshape(-1),
              grav_contrib.reshape(-1, 10, 3))

    # cell-chunked F-assembly operator (see SimConstants.Dc): IPs sorted by
    # kernel cell, each cell split into chunks of at most S rows; S is the
    # multiple of 8 (<= 128) within 10% of the least total padded rows
    cell_id = (ip2k[:, 0] * (kres - 1) + ip2k[:, 1]) * (kres - 1) + ip2k[:, 2]
    order = np.argsort(cell_id, kind="stable")
    _, cell_counts = np.unique(cell_id, return_counts=True)
    cmax = int(cell_counts.max())
    cands = [s for s in range(8, 136, 8) if s <= max(8, -(-cmax // 8) * 8)]
    padded = {s: int((-(-cell_counts // s)).sum() * s) for s in cands}
    best = min(padded.values())
    S = max(s for s in cands if padded[s] <= 1.1 * best)
    chunk_rows = []
    lo = 0
    for c in cell_counts:
        members = order[lo:lo + c]
        lo += c
        for s0 in range(0, c, S):
            chunk_rows.append(members[s0:s0 + S])
    C = len(chunk_rows)
    Dc = np.zeros((C, S, 3, 80))
    chunk_nodes = np.zeros((C, 8), np.int64)
    chunk_mu = np.zeros((C, S))
    chunk_lam = np.zeros((C, S))
    for k, v in enumerate(chunk_rows):
        n = len(v)
        chunk_nodes[k] = ip_kernel[v[0]]        # shared across the cell
        Dc[k, :n] = IP_dNx[v].transpose(0, 2, 1, 3).reshape(n, 3, 80)
        chunk_mu[k, :n] = IP_mu[v]
        chunk_lam[k, :n] = IP_lam[v]

    if dense_operator is None:
        dense_operator = n_ip <= DENSE_IP_THRESHOLD
    Bop = None
    if dense_operator:
        Bop = np.zeros((3 * n_ip, dim))
        bcols = (ip_kernel[:, :, None] * 10
                 + np.arange(10)[None, None, :]).reshape(n_ip, 80)
        bvrows = np.repeat(np.arange(n_ip)[:, None], 80, axis=1)
        for j in range(3):
            np.add.at(Bop, (j * n_ip + bvrows, bcols),
                      IP_dNx[:, :, j, :].reshape(n_ip, 80))

    ip_rest = np.einsum("via,viad->vd", IP_Nx, dof_rest[ip_kernel])
    pts_rest = np.einsum("via,viad->vd", pts_Nx, dof_rest[pts_kernel])

    def f(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=device)

    def i(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    consts = SimConstants(
        global_inv=f(global_inv), mass_invt2=f(mass_invt2), Dc=f(Dc),
        chunk_nodes=i(chunk_nodes), chunk_mu=f(chunk_mu),
        chunk_lam=f(chunk_lam),
        node_gather=i(node_gather_list(chunk_nodes, n_k)),
        rhs_gravity=f(rhs_gravity), dof_rest=f(dof_rest), ip_pos=f(ip_rest),
        IP_kernel=i(ip_kernel), IP_Nx=f(IP_Nx), IP_dNx=f(IP_dNx),
        IP_ddNx=f(IP_ddNx), IP_mu=f(IP_mu), IP_lam=f(IP_lam),
        IP_rho=f(IP_rho), pts_rest=f(pts_rest), pts_kernel=i(pts_kernel),
        pts_Nx=f(pts_Nx), dt=float(dt), dx=float(dx), iters=int(iters),
        B=None if Bop is None else f(Bop),
    )
    aux = dict(ip_pos=ip_pos, kernel_pos=kernel_pos, pts_ip=pts_ip, res=res,
               kdx=kdx, n_ip=n_ip, n_k=n_k, active_nodes=active_nodes,
               is_pin=is_pin, pos=pos)
    return consts, zero_state(consts), aux


_CACHE_VERSION = 3    # v3: optional dense B for small scenes


def _sim_cache_key(pos, mass, mu, lam, is_pin, kw) -> str:
    """Content hash of every sim_init input (the float64 precompute takes
    minutes at tens of thousands of IPs; it is cached per scene). The tag
    keeps these files apart from the JAX package's in a shared workspace:
    their constants differ (``node_gather``)."""
    h = hashlib.sha256()
    h.update(f"pienerf_tpu_torch {_CACHE_VERSION}".encode())
    for a in (pos, mass, mu, lam, is_pin):
        arr = np.ascontiguousarray(np.asarray(a))
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    for k in sorted(kw):
        v = kw[k]
        if isinstance(v, np.ndarray):
            h.update(f"{k}={v.tolist()}".encode())
        else:
            h.update(f"{k}={v}".encode())
    return h.hexdigest()[:24]


def sim_init_cached(pos, mass, mu, lam, is_pin, cache_dir: str,
                    device: torch.device = torch.device("cpu"),
                    **kw) -> Tuple[SimConstants, SimState, dict]:
    """sim_init with a content-addressed npz cache under ``cache_dir``.

    A hit rebuilds the constants, the rest state and aux from disk instead
    of re-running the f64 GMLS, assembly and dense inverse. The key covers
    every input but the device (point data and all scalars), so an edited
    PLY or a changed solver parameter never collides. An absent dense B is
    stored as a size-0 array."""
    key = _sim_cache_key(pos, mass, mu, lam, is_pin, kw)
    path = os.path.join(cache_dir, f"simconsts_{key}.npz")
    if os.path.exists(path):
        fields = {}
        with np.load(path, allow_pickle=False) as z:
            for name in SimConstants._fields:
                v = z[f"c_{name}"]
                if name == "B" and v.size == 0:
                    fields[name] = None
                elif v.ndim == 0:
                    fields[name] = v.item()
                else:
                    fields[name] = torch.as_tensor(v, device=device)
            aux = {k[2:]: z[k] for k in z.files if k.startswith("a_")}
        consts = SimConstants(**fields)
        return consts, zero_state(consts), aux

    consts, state, aux = sim_init(pos, mass, mu, lam, is_pin, device=device,
                                  **kw)
    os.makedirs(cache_dir, exist_ok=True)
    payload = {}
    for name in SimConstants._fields:
        v = getattr(consts, name)
        if v is None:                        # absent dense B
            v = np.zeros((0,), np.float32)
        elif isinstance(v, torch.Tensor):
            v = v.cpu().numpy()
        payload[f"c_{name}"] = np.asarray(v)
    for k, v in aux.items():
        payload[f"a_{k}"] = np.asarray(v)
    tmp = f"{path}.{os.getpid()}.tmp.npz"   # np.savez wants the .npz suffix
    np.savez(tmp, **payload)
    os.replace(tmp, path)
    return consts, state, aux


def cast_B_bf16(consts: SimConstants) -> SimConstants:
    """Opt-in bf16 storage of the assembly operator (``Dc``, and ``B`` where
    present): half its memory. The step rounds the contracted vectors to
    bf16 as well and accumulates the exact products in f32, as the JAX
    package does; see ``rhs_elastic_delta`` for the accuracy argument."""
    consts = consts._replace(Dc=consts.Dc.to(torch.bfloat16))
    if consts.B is not None:
        consts = consts._replace(B=consts.B.to(torch.bfloat16))
    return consts


# ---------------------------------------------------------------------------
# per-step physics
# ---------------------------------------------------------------------------

def _apply(op: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """op @ x (batched or not) in f32. A bf16 operator rounds x to bf16
    too: the products of two bf16 values are exact in f32, so this is the
    JAX package's bf16 contraction with f32 accumulation, up to summation
    order. The operator is widened for the product; only its storage is
    half size."""
    if op.dtype == torch.bfloat16:
        return torch.matmul(op.float(), x.to(torch.bfloat16).float())
    return torch.matmul(op, x)


def deformation_gradients(consts: SimConstants,
                          ddof: torch.Tensor) -> torch.Tensor:
    """F[v, d, j] = I + dNx . ddof at every IP."""
    ddof_g = ddof[consts.IP_kernel]                            # [n,8,10,3]
    dF = torch.einsum("vija,viad->vdj", consts.IP_dNx, ddof_g)
    return dF + torch.eye(3, dtype=ddof.dtype, device=ddof.device)


def _rhs_elastic_delta_dense(consts: SimConstants,
                             ddof: torch.Tensor) -> torch.Tensor:
    """E(dof) - E(rest) through the dense B operator: per IP
    dx^3 (mu (R - I) + lam (V - I)) contracted with dNx."""
    n_k = ddof.shape[0]
    B = consts.B
    n_ip = consts.IP_mu.shape[0]
    # Fd[j*nIP + v, d] = F_delta[v, d, j]
    Fd = _apply(B, ddof.reshape(n_k * 10, 3))
    F = tuple(
        tuple(Fd[j * n_ip:(j + 1) * n_ip, d] + (1.0 if d == j else 0.0)
              for j in range(3))
        for d in range(3))
    dR, dV = corotated_delta(F)
    dx3 = consts.dx ** 3
    mu, lam = consts.IP_mu, consts.IP_lam
    dP = torch.cat([
        torch.stack([dx3 * (mu * dR[d][j] + lam * dV[d][j])
                     for d in range(3)], dim=-1)
        for j in range(3)], dim=0)                              # [3*nIP, 3]
    return _apply(B.T, dP).reshape(n_k, 10, 3)


def rhs_elastic_delta(consts: SimConstants, ddof: torch.Tensor,
                      reduce: Optional[Callable] = None) -> torch.Tensor:
    """E(dof) - E(rest): per IP dx^3 (mu (R - I) + lam (V - I)) contracted
    with dNx; exactly zero at rest. Through the dense B where the constants
    hold one, else through the cell-chunked operator applied forward and
    transposed: two batched products over [C, 3S, 80] blocks, a [C, 8] node
    gather before and the per-node gather-and-sum after. With bf16 blocks
    (``cast_B_bf16``) the delta formulation keeps every contracted
    quantity O(deformation), so the 2^-8 relative rounding perturbs the
    forces by about 0.4%; global_inv and the mass product stay f32.

    ``reduce`` takes the chunked operator's [K, 10, 3] sum over the
    constants' chunks and returns the sum over every chunk of the scene:
    the IP-sharded step (``parallel.sharding``) holds a share of the chunks
    on each rank and all-reduces there. None: the constants hold them
    all."""
    if consts.B is not None:
        if reduce is not None:
            raise ValueError("a sharded step runs the chunked operator")
        return _rhs_elastic_delta_dense(consts, ddof)
    n_k = ddof.shape[0]
    C, S = consts.chunk_mu.shape
    dofc = ddof[consts.chunk_nodes].reshape(C, 80, 3)
    Dc = consts.Dc.reshape(C, S * 3, 80)
    Fd = _apply(Dc, dofc).reshape(C * S, 3, 3)          # [v, j, d]
    F = tuple(
        tuple(Fd[:, j, d] + (1.0 if d == j else 0.0) for j in range(3))
        for d in range(3))
    dR, dV = corotated_delta(F)
    dx3 = consts.dx ** 3
    mu = consts.chunk_mu.reshape(C * S)
    lam = consts.chunk_lam.reshape(C * S)
    # dP[v, j, d]; padded rows have mu = lam = 0 and contribute nothing
    dP = torch.stack([
        torch.stack([dx3 * (mu * dR[d][j] + lam * dV[d][j])
                     for d in range(3)], dim=-1)
        for j in range(3)], dim=1).reshape(C, S * 3, 3)
    contrib = _apply(Dc.transpose(1, 2), dP).reshape(C * 8, 10, 3)
    # node scatter as a gather: row C * 8 is the zero row the padding names
    contrib = torch.cat([contrib, contrib.new_zeros((1, 10, 3))], 0)
    out = contrib[consts.node_gather].sum(dim=1)
    return out if reduce is None else reduce(out)


def sim_step(consts: SimConstants, state: SimState,
             reduce: Optional[Callable] = None) -> SimState:
    """One implicit local-global step (delta form of the reference's
    dof = dof_rest + G^-1 (momentum + E(dof) - rhs_rest)). ``reduce``:
    see ``rhs_elastic_delta``."""
    n_k = state.ddof.shape[0]
    dim = n_k * 10
    ddof_tilde = state.ddof + consts.dt * state.dof_vel
    momentum = ((consts.mass_invt2 @ ddof_tilde.reshape(dim, 3))
                .reshape(n_k, 10, 3) + state.dof_f + consts.rhs_gravity)
    ddof = state.ddof
    for _ in range(consts.iters):
        rhs = momentum + rhs_elastic_delta(consts, ddof, reduce)
        ddof = (consts.global_inv @ rhs.reshape(dim, 3)).reshape(n_k, 10, 3)
    vel = (ddof - state.ddof) / consts.dt * 0.998
    return SimState(ddof=ddof, dof_vel=vel, dof_f=state.dof_f)


def get_ip_info(consts: SimConstants, state: SimState
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(p_def [n,3], F [n,3,3], dF [n,3,3,3]) float32 per IP."""
    with span(FRAME_IP_INFO):
        ddof_g = state.ddof[consts.IP_kernel]                  # [n,8,10,3]
        p = consts.ip_pos + torch.einsum("via,viad->vd", consts.IP_Nx,
                                         ddof_g)
        F = torch.eye(3, dtype=p.dtype, device=p.device) + torch.einsum(
            "vica,viad->vdc", consts.IP_dNx, ddof_g)
        dF = torch.einsum("vijca,viad->vjdc", consts.IP_ddNx, ddof_g)
        return p.float(), F.float(), dF.float()


def update_force(consts: SimConstants, state: SimState, vid: int,
                 f: torch.Tensor) -> SimState:
    """Scatter a picked-IP force into dof space. The IP's 8 kernel nodes
    are distinct, so the scatter has no colliding (order-dependent) adds."""
    m = consts.IP_rho[vid] * consts.dx ** 3
    contrib = m * consts.IP_Nx[vid][:, :, None] * f[None, None, :]
    dof_f = torch.zeros_like(state.ddof)
    dof_f.index_add_(0, consts.IP_kernel[vid], contrib)
    return state._replace(dof_f=dof_f)


def clear_force(state: SimState) -> SimState:
    return state._replace(dof_f=torch.zeros_like(state.dof_f))


def point_positions(consts: SimConstants, state: SimState) -> torch.Tensor:
    """Deformed material-point positions."""
    ddof_g = state.ddof[consts.pts_kernel]
    return consts.pts_rest + torch.einsum("via,viad->vd", consts.pts_Nx,
                                          ddof_g)


# ---------------------------------------------------------------------------
# the reference's stateful interface
# ---------------------------------------------------------------------------

class Simulator:
    """Stateful facade mirroring the reference Simulator (solver.py:12-617)
    over the functions above.

    ``substeps``: each ``stepforward`` runs ``substeps`` steps of dt /
    substeps (1 = the reference). ``bf16_b``: bf16 operator storage
    (``cast_B_bf16``). ``cache_dir``: keep the one-time f64 precompute
    per scene (``sim_init_cached``)."""

    def __init__(self, dt=1e-2, iters=20, bbox=(1.0, 1.0, 1.0), kres=7,
                 dx=1.0, gravity=(0.0, -9.8, 0.0), stiff=1e5,
                 base=(-0.5, -0.5, -0.5), substeps=1, bf16_b=False,
                 cache_dir: Optional[str] = None,
                 device: torch.device = torch.device("cpu")):
        self.substeps = int(substeps)
        self._cfg = dict(dt=dt / self.substeps, iters=iters,
                         bbox=np.asarray(bbox, np.float64), kres=kres, dx=dx,
                         gravity=gravity, stiff=stiff,
                         base=np.asarray(base, np.float64), device=device)
        self.bf16_b = bool(bf16_b)
        self.cache_dir = cache_dir
        self.device = device
        self.consts: Optional[SimConstants] = None
        self.state: Optional[SimState] = None
        self.aux: Optional[dict] = None
        self.dx = dx
        self.dt = dt

    def InitializeFromPly(self, path: str) -> None:
        from pienerf_tpu_torch.io.ply import read_physics_ply
        d = read_physics_ply(path)
        self.initialize(d["pos"], d["mass"], d["mu"], d["lam"], d["pin"])

    def initialize(self, pos, mass, mu, lam, is_pin) -> None:
        if self.cache_dir:
            self.consts, self.state, self.aux = sim_init_cached(
                pos, mass, mu, lam, is_pin, cache_dir=self.cache_dir,
                **self._cfg)
        else:
            self.consts, self.state, self.aux = sim_init(
                pos, mass, mu, lam, is_pin, **self._cfg)
        if self.bf16_b:
            self.consts = cast_B_bf16(self.consts)

    def stepforward(self) -> None:
        for _ in range(self.substeps):
            self.state = sim_step(self.consts, self.state)

    def get_IP_info(self):
        return get_ip_info(self.consts, self.state)

    def update_force(self, vid: int, f) -> None:
        self.state = update_force(self.consts, self.state, int(vid),
                                  torch.as_tensor(f, dtype=torch.float32,
                                                  device=self.device))

    def clear_force(self) -> None:
        self.state = clear_force(self.state)

    def update_pos(self) -> np.ndarray:
        return point_positions(self.consts, self.state).cpu().numpy()

    def OutputToPly(self, path: str) -> None:
        from pienerf_tpu_torch.io.ply import write_ply
        write_ply(path, self.update_pos())
