"""Q-GMLS meshless hyperelasticity simulator in PyTorch.

Port of ``pienerf_tpu.sim.solver`` for scenes of at most
``DENSE_IP_THRESHOLD`` integration points (IPs), which assemble the elastic
right-hand side through the dense ``B`` operator. The cell-chunked ``Dc``
operator of larger scenes is not ported yet (ROADMAP.md queue 1 item 3).

``sim_init`` is the same float64 numpy precompute as the JAX package (so
the constants agree exactly), with tensors on ``device`` at the end. The
step keeps the delta formulation ``ddof = dof - dof_rest`` that makes
float32 sufficient; every contraction runs in true f32 (the package turns
TF32 off), since a reduced-precision sim pass diverges.

Conventions: dof [K, 10, 3]; F[d, c] = d phi_d / d p_c;
dF[j, d, c] = d^2 phi_d / (d p_c d p_j).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from pienerf_tpu_torch.sim import gmls
from pienerf_tpu_torch.sim.svd3 import corotated_delta

DENSE_IP_THRESHOLD = 6000


class SimConstants(NamedTuple):
    """Per-scene constants produced by sim_init (tensors on one device)."""
    global_inv: torch.Tensor   # [10K, 10K] masked regularized inverse
    mass_invt2: torch.Tensor   # [10K, 10K] mass matrix / dt^2
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
    B: torch.Tensor            # [3*nIP, 10K] dense F-assembly operator,
    #   B[j*nIP + v, k*10 + a] = sum_i dNx[v, i, j, a] [IP_kernel[v,i]==k]
    dt: float
    dx: float
    iters: int


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
) -> Tuple[SimConstants, SimState, dict]:
    """Build all per-scene constants. Returns (constants, rest state, aux)."""
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
    if n_ip > DENSE_IP_THRESHOLD:
        raise NotImplementedError(
            f"{n_ip} IPs > {DENSE_IP_THRESHOLD}: the chunked Dc sim operator "
            f"is not ported yet (ROADMAP.md queue 1 item 3)")
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
        global_inv=f(global_inv), mass_invt2=f(mass_invt2),
        rhs_gravity=f(rhs_gravity), dof_rest=f(dof_rest), ip_pos=f(ip_rest),
        IP_kernel=i(ip_kernel), IP_Nx=f(IP_Nx), IP_dNx=f(IP_dNx),
        IP_ddNx=f(IP_ddNx), IP_mu=f(IP_mu), IP_lam=f(IP_lam),
        IP_rho=f(IP_rho), pts_rest=f(pts_rest), pts_kernel=i(pts_kernel),
        pts_Nx=f(pts_Nx), B=f(Bop), dt=float(dt), dx=float(dx),
        iters=int(iters),
    )
    aux = dict(ip_pos=ip_pos, kernel_pos=kernel_pos, pts_ip=pts_ip, res=res,
               kdx=kdx, n_ip=n_ip, n_k=n_k, active_nodes=active_nodes,
               is_pin=is_pin, pos=pos)
    return consts, zero_state(consts), aux


# ---------------------------------------------------------------------------
# per-step physics
# ---------------------------------------------------------------------------

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
    Fd = B @ ddof.reshape(n_k * 10, 3)       # Fd[j*nIP + v, d] = F_d[v,d,j]
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
    return (B.T @ dP).reshape(n_k, 10, 3)


def sim_step(consts: SimConstants, state: SimState) -> SimState:
    """One implicit local-global step (delta form of the reference's
    dof = dof_rest + G^-1 (momentum + E(dof) - rhs_rest))."""
    n_k = state.ddof.shape[0]
    dim = n_k * 10
    ddof_tilde = state.ddof + consts.dt * state.dof_vel
    momentum = ((consts.mass_invt2 @ ddof_tilde.reshape(dim, 3))
                .reshape(n_k, 10, 3) + state.dof_f + consts.rhs_gravity)
    ddof = state.ddof
    for _ in range(consts.iters):
        rhs = momentum + _rhs_elastic_delta_dense(consts, ddof)
        ddof = (consts.global_inv @ rhs.reshape(dim, 3)).reshape(n_k, 10, 3)
    vel = (ddof - state.ddof) / consts.dt * 0.998
    return SimState(ddof=ddof, dof_vel=vel, dof_f=state.dof_f)


def get_ip_info(consts: SimConstants, state: SimState
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(p_def [n,3], F [n,3,3], dF [n,3,3,3]) float32 per IP."""
    ddof_g = state.ddof[consts.IP_kernel]                      # [n,8,10,3]
    p = consts.ip_pos + torch.einsum("via,viad->vd", consts.IP_Nx, ddof_g)
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
