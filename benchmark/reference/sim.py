"""Plain reference of the meshless simulator the benchmark's set-up drives.

A frozen copy, in plain PyTorch and float64 numpy, of what the viewer's
set-up drag and its paused branch run: the Q-GMLS shape functions, the
one-time precompute with the dense F-assembly operator (every scene of the
benchmark has at most 6,000 integration points, IPs), the corotated
stress factors by cyclic Jacobi, the implicit local-global step, the
picked IP's force and the per-IP deformation (p_def, F, dF). It imports
nothing of the program under test and nothing of JAX: it rebuilds every
constant from the point cloud the benchmark makes.

Conventions: dof [K, 10, 3]; F[d, c] = d phi_d / d p_c;
dF[j, d, c] = d^2 phi_d / (d p_c d p_j); ddof = dof - dof_rest.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

# slot of monomial x_a * x_b in the basis [1, x, y, z, x^2, xy, xz, y^2,
# yz, z^2]
_QUAD_SLOT = np.zeros((3, 3), dtype=np.int64)
for _a in range(3):
    for _b in range(3):
        _lo, _hi = min(_a, _b), max(_a, _b)
        _QUAD_SLOT[_a, _b] = 4 + _hi if _lo == 0 else 5 + _lo + _hi


def _basis(p):
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    return np.stack([np.ones_like(x), x, y, z, x * x, x * y, x * z, y * y,
                     y * z, z * z], axis=-1)


def _basis_grad(p):
    out = np.zeros(p.shape[:-1] + (3, 10), dtype=p.dtype)
    for j in range(3):
        out[..., j, j + 1] = 1.0
        for i in range(3):
            out[..., j, _QUAD_SLOT[i, j]] += p[..., i]
        out[..., j, _QUAD_SLOT[j, j]] += p[..., j]
    return out


def _basis_hess():
    out = np.zeros((3, 3, 10))
    for j in range(3):
        for k in range(3):
            out[j, k, _QUAD_SLOT[j, k]] = 2.0 if j == k else 1.0
    return out


def _kernel_weight(r, p, q):
    """(1 - d^2)^3 with d = |p - q| / r, its gradient and Hessian."""
    diff = p - q
    u = np.sum(diff * diff, axis=-1) / (r * r)
    s = np.maximum(1.0 - u, 0.0)
    t = diff / (r * r)
    dw = -6.0 * (s ** 2)[..., None] * t
    ddw = ((-6.0 * (s ** 2) / (r * r))[..., None, None] * np.eye(3)
           + (24.0 * s)[..., None, None] * (t[..., :, None] * t[..., None, :]))
    return s ** 3, dw, ddw


def shape_functions(pos, topo, kernel_pos, r):
    """Q-GMLS (Nx [N,8,10], dNx [N,8,3,10], ddNx [N,8,3,3,10]), float64."""
    pos = np.asarray(pos, np.float64)
    kernel_pos = np.asarray(kernel_pos, np.float64)
    q = kernel_pos[topo]
    w, dw, ddw = _kernel_weight(r, pos[:, None, :], q)
    Pq, dPq, ddP = _basis(q), _basis_grad(q), _basis_hess()
    prim = np.einsum("nia,nib->niab", Pq, Pq, optimize=True)
    prim += np.einsum("nija,nijb->niab", dPq, dPq, optimize=True)
    prim = prim + np.einsum("jka,jkb->ab", ddP, ddP, optimize=True)
    G = np.einsum("ni,niab->nab", w, prim, optimize=True)
    dG = np.einsum("nix,niab->nxab", dw, prim, optimize=True)
    ddG = np.einsum("nixy,niab->nxyab", ddw, prim, optimize=True)

    Gi = np.linalg.inv(G)
    Pp, dPp, ddPp = _basis(pos), _basis_grad(pos), _basis_hess()
    Gp = np.einsum("nab,nb->na", Gi, Pp, optimize=True)
    Gi_dG = np.einsum("nab,nxbc->nxac", Gi, dG, optimize=True)
    dGp = (np.einsum("nab,nxb->nxa", Gi, dPp, optimize=True)
           - np.einsum("nxab,nb->nxa", Gi_dG, Gp, optimize=True))
    Gi_dPp = np.einsum("nab,nxb->nxa", Gi, dPp, optimize=True)
    ddGp = (
        np.einsum("nab,xyb->nxya", Gi, ddPp, optimize=True)
        - np.einsum("nxab,nyb->nxya", Gi_dG, Gi_dPp, optimize=True)
        - np.einsum("nyab,nxb->nxya", Gi_dG, Gi_dPp, optimize=True)
        - np.einsum("nab,nxybc,nc->nxya", Gi, ddG, Gp, optimize=True)
        + np.einsum("nyab,nxbc,nc->nxya", Gi_dG, Gi_dG, Gp, optimize=True)
        + np.einsum("nxab,nybc,nc->nxya", Gi_dG, Gi_dG, Gp, optimize=True))

    B = np.zeros(q.shape[:-1] + (10, 10))
    B[..., 0, :] = Pq
    B[..., 1:4, :] = dPq
    for s in range(4, 10):
        B[..., s, s] = 2.0
    BGp = np.einsum("nisb,nb->nis", B, Gp, optimize=True)
    BdGp = np.einsum("nisb,nxb->nixs", B, dGp, optimize=True)
    BddGp = np.einsum("nisb,nxyb->nixys", B, ddGp, optimize=True)
    Nx = w[..., None] * BGp
    dNx = dw[..., None] * BGp[:, :, None, :] + w[..., None, None] * BdGp
    ddNx = (ddw[..., None] * BGp[:, :, None, None, :]
            + dw[:, :, :, None, None] * BdGp[:, :, None, :, :]
            + dw[:, :, None, :, None] * BdGp[:, :, :, None, :]
            + w[..., None, None, None] * BddGp)
    return Nx, dNx, ddNx


class Scene(NamedTuple):
    """The constants the step needs, on one device."""
    global_inv: torch.Tensor   # [10K, 10K]
    mass_invt2: torch.Tensor   # [10K, 10K]
    B: torch.Tensor            # [3 nIP, 10K] dense F-assembly operator
    rhs_gravity: torch.Tensor  # [K, 10, 3]
    ip_pos: torch.Tensor       # [nIP, 3] rest IP positions
    IP_kernel: torch.Tensor    # [nIP, 8]
    IP_Nx: torch.Tensor        # [nIP, 8, 10]
    IP_dNx: torch.Tensor       # [nIP, 8, 3, 10]
    IP_ddNx: torch.Tensor      # [nIP, 8, 3, 3, 10]
    IP_mu: torch.Tensor
    IP_lam: torch.Tensor
    IP_rho: torch.Tensor
    dt: float
    dx: float
    iters: int


class State(NamedTuple):
    ddof: torch.Tensor
    dof_vel: torch.Tensor
    dof_f: torch.Tensor


def _assemble(dim, topo, blocks):
    n = topo.shape[0]
    rows = (topo[:, :, None] * 10 + np.arange(10)[None, None, :]).reshape(n, 80)
    flat = rows[:, :, None] * dim + rows[:, None, :]
    return np.bincount(flat.reshape(-1), weights=blocks.reshape(-1),
                       minlength=dim * dim).reshape(dim, dim)


def _gram_blocks(dx, dt, mu, lam, rho, Nx, dNx, ddNx):
    n = Nx.shape[0]
    S = np.concatenate([
        np.sqrt(rho * dx ** 3 / dt ** 2)[:, None, None] * Nx.reshape(n, 1, 80),
        np.sqrt(dx ** 3 * (rho * dx ** 2 / 12.0 / dt ** 2 + mu + lam))[
            :, None, None] * dNx.transpose(0, 2, 1, 3).reshape(n, 3, 80),
        np.sqrt(dx ** 5 * (mu + lam) / 12.0)[:, None, None]
        * ddNx.transpose(0, 2, 3, 1, 4).reshape(n, 9, 80)], axis=1)
    return np.matmul(S.transpose(0, 2, 1), S)


def scene_init(pos, mass, mu, lam, is_pin, *, dt, iters, bbox, kres, dx,
               gravity, stiff, base, device) -> Tuple[Scene, State]:
    """The one-time precompute in float64, then f32 tensors on ``device``;
    returns (scene, rest state)."""
    pos = np.asarray(pos, np.float64)
    mass, mu, lam = (np.asarray(a, np.float64) for a in (mass, mu, lam))
    is_pin = np.asarray(is_pin, bool)
    bbox = np.asarray(bbox, np.float64) * 1.02
    base = np.asarray(base, np.float64) * 1.01
    gravity = np.asarray(gravity, np.float64)
    res = (bbox // dx).astype(np.int64)

    gidx = np.clip(((pos - base) // dx).astype(np.int64), 0, res - 1)
    ip_mask = np.zeros(tuple(res), bool)
    ip_mask[gidx[:, 0], gidx[:, 1], gidx[:, 2]] = True
    n_ip = int(ip_mask.sum())
    ip_idx = -np.ones(tuple(res), np.int64)
    ip_idx[ip_mask] = np.arange(n_ip)
    pts_ip = ip_idx[gidx[:, 0], gidx[:, 1], gidx[:, 2]]
    ip_pos = (np.argwhere(ip_mask) + 0.5) * dx + base

    kdx = float(res.max() * dx) / (kres - 1)
    corners = np.array([[(s >> 2) & 1, (s >> 1) & 1, s & 1]
                        for s in range(8)], np.int64)
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
    kernel_pos = np.argwhere(kmask) * kdx + base

    pts_Nx, _, _ = shape_functions(pos, pts_kernel, kernel_pos, kdx)
    IP_Nx, IP_dNx, IP_ddNx = shape_functions(ip_pos, ip_kernel, kernel_pos,
                                             kdx)
    w_mass = np.bincount(pts_ip, weights=mass, minlength=n_ip)
    IP_mu = np.bincount(pts_ip, weights=mu * mass, minlength=n_ip) / w_mass
    IP_lam = np.bincount(pts_ip, weights=lam * mass, minlength=n_ip) / w_mass
    IP_rho = w_mass / dx ** 3

    dim = n_k * 10
    mat = _assemble(dim, ip_kernel, _gram_blocks(
        dx, dt, IP_mu, IP_lam, IP_rho, IP_Nx, IP_dNx, IP_ddNx))
    if is_pin.any():
        Np = pts_Nx[is_pin].reshape(-1, 1, 80)
        mat += _assemble(dim, pts_kernel[is_pin],
                         stiff * np.matmul(Np.transpose(0, 2, 1), Np))
    act = np.repeat(np.diag(mat)[0::10] > 0.0, 10)
    sub = mat[np.ix_(act, act)]
    sub[np.diag_indices_from(sub)] += 1e-3
    global_inv = np.zeros((dim, dim))
    global_inv[np.ix_(act, act)] = np.linalg.inv(sub)
    mass_invt2 = _assemble(dim, ip_kernel, _gram_blocks(
        dx, dt, np.zeros(n_ip), np.zeros(n_ip), IP_rho, IP_Nx, IP_dNx,
        IP_ddNx))

    dof_rest = np.zeros((n_k, 10, 3))
    dof_rest[:, 0, :] = kernel_pos
    for j in range(3):
        dof_rest[:, 1 + j, j] = 1.0
    grav = ((IP_rho * dx ** 3)[:, None, None, None] * IP_Nx[..., None]
            * gravity[None, None, None, :])
    rhs_gravity = np.zeros((n_k, 10, 3))
    np.add.at(rhs_gravity, ip_kernel.reshape(-1), grav.reshape(-1, 10, 3))

    Bop = np.zeros((3 * n_ip, dim))
    bcols = (ip_kernel[:, :, None] * 10
             + np.arange(10)[None, None, :]).reshape(n_ip, 80)
    brows = np.repeat(np.arange(n_ip)[:, None], 80, axis=1)
    for j in range(3):
        np.add.at(Bop, (j * n_ip + brows, bcols),
                  IP_dNx[:, :, j, :].reshape(n_ip, 80))
    ip_rest = np.einsum("via,viad->vd", IP_Nx, dof_rest[ip_kernel])

    def f(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=device)

    scene = Scene(
        global_inv=f(global_inv), mass_invt2=f(mass_invt2), B=f(Bop),
        rhs_gravity=f(rhs_gravity), ip_pos=f(ip_rest),
        IP_kernel=torch.as_tensor(ip_kernel, device=device),
        IP_Nx=f(IP_Nx), IP_dNx=f(IP_dNx), IP_ddNx=f(IP_ddNx),
        IP_mu=f(IP_mu), IP_lam=f(IP_lam), IP_rho=f(IP_rho), dt=float(dt),
        dx=float(dx), iters=int(iters))
    z = torch.zeros((n_k, 10, 3), dtype=torch.float32, device=device)
    return scene, State(ddof=z, dof_vel=z.clone(), dof_f=z.clone())


def _jacobi(a, sweeps=6):
    one = torch.ones_like(a[(0, 0)])
    zero = torch.zeros_like(one)
    v = {(i, j): (one if i == j else zero) for i in range(3) for j in range(3)}
    for _ in range(sweeps):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            app, aqq, apq = a[(p, p)], a[(q, q)], a[(p, q)]
            theta = 0.5 * torch.atan2(2.0 * apq, app - aqq)
            c, s = torch.cos(theta), torch.sin(theta)
            cc, ss, cs = c * c, s * s, c * s
            r = 3 - p - q
            arp = a[(min(r, p), max(r, p))]
            arq = a[(min(r, q), max(r, q))]
            a = dict(a)
            a[(p, p)] = cc * app + 2.0 * cs * apq + ss * aqq
            a[(q, q)] = ss * app - 2.0 * cs * apq + cc * aqq
            a[(p, q)] = torch.zeros_like(apq)
            a[(min(r, p), max(r, p))] = c * arp + s * arq
            a[(min(r, q), max(r, q))] = -s * arp + c * arq
            v = dict(v)
            for i in range(3):
                vip, viq = v[(i, p)], v[(i, q)]
                v[(i, p)] = c * vip + s * viq
                v[(i, q)] = -s * vip + c * viq
    return a, v


def corotated_delta(F, eps=1e-12):
    """(R - I, U proj(S) V^T - I) of F given as a 3x3 nested tuple of [N]
    tensors; proj is the 3-step Gauss-Newton det = 1 projection."""
    a = {(i, j): sum(F[k][i] * F[k][j] for k in range(3))
         for i in range(3) for j in range(i, 3)}
    a, v = _jacobi(a)
    w = [a[(0, 0)], a[(1, 1)], a[(2, 2)]]

    def cswap(i, j):
        swap = w[i] < w[j]
        w[i], w[j] = (torch.where(swap, w[j], w[i]),
                      torch.where(swap, w[i], w[j]))
        for r in range(3):
            vi, vj = v[(r, i)], v[(r, j)]
            v[(r, i)] = torch.where(swap, vj, vi)
            v[(r, j)] = torch.where(swap, vi, vj)

    cswap(0, 1)
    cswap(0, 2)
    cswap(1, 2)
    S = [torch.sqrt(torch.clamp(wc, min=0.0)) for wc in w]
    U = [[sum(F[i][j] * v[(j, c)] for j in range(3))
          / torch.clamp(S[c], min=eps) for c in range(3)] for i in range(3)]
    zero = torch.zeros_like(S[0])
    D = [zero, zero, zero]
    for _ in range(3):
        s0, s1, s2 = S[0] + D[0], S[1] + D[1], S[2] + D[2]
        C = s0 * s1 * s2 - 1.0
        dC = [s1 * s2, s0 * s2, s0 * s1]
        coef = ((sum(dC[c] * D[c] for c in range(3)) - C)
                / sum(dC[c] * dC[c] for c in range(3)))
        D = [coef * dC[c] for c in range(3)]
    Sp = [S[c] + D[c] for c in range(3)]
    dR = tuple(tuple(sum(U[i][c] * v[(j, c)] for c in range(3))
                     - (1.0 if i == j else 0.0) for j in range(3))
               for i in range(3))
    dV = tuple(tuple(sum(U[i][c] * Sp[c] * v[(j, c)] for c in range(3))
                     - (1.0 if i == j else 0.0) for j in range(3))
               for i in range(3))
    return dR, dV


def _rhs_elastic_delta(sc: Scene, ddof):
    n_k = ddof.shape[0]
    n_ip = sc.IP_mu.shape[0]
    Fd = sc.B @ ddof.reshape(n_k * 10, 3)
    F = tuple(tuple(Fd[j * n_ip:(j + 1) * n_ip, d] + (1.0 if d == j else 0.0)
                    for j in range(3)) for d in range(3))
    dR, dV = corotated_delta(F)
    dx3 = sc.dx ** 3
    dP = torch.cat([torch.stack([dx3 * (sc.IP_mu * dR[d][j]
                                        + sc.IP_lam * dV[d][j])
                                 for d in range(3)], dim=-1)
                    for j in range(3)], dim=0)
    return (sc.B.T @ dP).reshape(n_k, 10, 3)


def step(sc: Scene, st: State) -> State:
    """One implicit local-global step in the delta form."""
    n_k = st.ddof.shape[0]
    dim = n_k * 10
    tilde = st.ddof + sc.dt * st.dof_vel
    momentum = ((sc.mass_invt2 @ tilde.reshape(dim, 3)).reshape(n_k, 10, 3)
                + st.dof_f + sc.rhs_gravity)
    ddof = st.ddof
    for _ in range(sc.iters):
        rhs = momentum + _rhs_elastic_delta(sc, ddof)
        ddof = (sc.global_inv @ rhs.reshape(dim, 3)).reshape(n_k, 10, 3)
    return State(ddof=ddof, dof_vel=(ddof - st.ddof) / sc.dt * 0.998,
                 dof_f=st.dof_f)


def apply_force(sc: Scene, st: State, vid: int, f) -> State:
    """The picked IP's force in dof space (its 8 kernel nodes differ)."""
    m = sc.IP_rho[vid] * sc.dx ** 3
    dof_f = torch.zeros_like(st.ddof)
    dof_f.index_add_(0, sc.IP_kernel[vid],
                     m * sc.IP_Nx[vid][:, :, None] * f[None, None, :])
    return st._replace(dof_f=dof_f)


def ip_info(sc: Scene, st: State):
    """(p_def [n, 3], F [n, 3, 3], dF [n, 3, 3, 3]) per IP."""
    g = st.ddof[sc.IP_kernel]
    p = sc.ip_pos + torch.einsum("via,viad->vd", sc.IP_Nx, g)
    F = torch.eye(3, dtype=p.dtype, device=p.device) + torch.einsum(
        "vica,viad->vdc", sc.IP_dNx, g)
    dF = torch.einsum("vijca,viad->vjdc", sc.IP_ddNx, g)
    return p, F, dF


def spring_force(ip_pos, IP_kernel, IP_Nx, ddof, vid, fi, spring):
    """The viewer's spring drag on IP ``vid`` at drag frame ``fi``: a pull
    toward a target circling the IP's rest position in the xy plane,
    clamped per axis. ``spring``: radius, gain, clamp, rate (rad a frame)
    and phase (rad). Takes the constants by field so that the program's
    state can be dragged by the same rule."""
    rest = ip_pos[vid]
    p_ip = rest + torch.einsum("ia,iad->d", IP_Nx[vid], ddof[IP_kernel[vid]])
    ang = torch.tensor(spring["rate"] * fi + spring["phase"],
                       dtype=torch.float32, device=ddof.device)
    target = rest + spring["radius"] * torch.stack(
        [torch.cos(ang), torch.sin(ang), torch.zeros_like(ang)])
    return torch.clamp(spring["gain"] * (target - p_ip), -spring["clamp"],
                       spring["clamp"])
