"""Batched geometric solvers: triangulation, P3P, EPnP, Umeyama, the
two-view E/F/H solvers, and the generalized (multi-camera) GP6P and GR6P.

Port of colmap_pcd_tpu/ops/solvers.py. Every function broadcasts over
leading batch dims (typically [pairs, samples]) where the JAX package
vmaps, so a RANSAC bank of minimal samples over a block of image pairs is
one batched solve instead of a loop. Nullspaces come from `eigh` of the
d x d Gram matrix, 3x3 determinants are closed-form, and Nister's
five-point expansion is precomputed once as constant contraction tables.

`eigh` and `svd` have no `*_ex` variant: on CUDA each call checks its
status on the host, one sync per call (`_eigh` calls once per 16 384
matrices). The `linalg_syncs` counter of utils.logging_utils.PHASES
counts them.
"""

from __future__ import annotations

import functools
import itertools
import math

import torch

from ..utils.logging_utils import PHASES
from . import polynomial as poly_ops
from . import se3

Tensor = torch.Tensor


def _count_sync(x: Tensor):
    if x.is_cuda:
        PHASES.totals.setdefault("linalg_syncs", 0.0)
        PHASES.counts["linalg_syncs"] = PHASES.counts.get("linalg_syncs", 0) + 1


# cuSOLVER's batched eigh (the path torch takes for small matrices on CUDA)
# refuses 32768 or more matrices in one call; measured on an H100 with
# torch 2.11 / CUDA 12.8
_EIGH_BATCH = 16384


def _eigh(M: Tensor) -> tuple[Tensor, Tensor]:
    flat = M.reshape(-1, M.shape[-2], M.shape[-1])
    parts = []
    for start in range(0, max(flat.shape[0], 1), _EIGH_BATCH):
        _count_sync(M)
        parts.append(torch.linalg.eigh(flat[start : start + _EIGH_BATCH]))
    w = torch.cat([p[0] for p in parts]).reshape(M.shape[:-1])
    V = torch.cat([p[1] for p in parts]).reshape(M.shape)
    return w, V


def _svd(M: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    _count_sync(M)
    return torch.linalg.svd(M)


def det3(M: Tensor) -> Tensor:
    """Closed-form determinant of [..., 3, 3]."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def solve3(M: Tensor, b: Tensor) -> Tensor:
    """Closed-form solution x of M x = b for M [..., 3, 3], b [..., 3]
    (adjugate over determinant): no library call and no host sync, where a
    batched LU of thousands of 3x3 systems would cost both."""
    a, b_, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    c00, c01, c02 = e * i - f * h, f * g - d * i, d * h - e * g
    det = a * c00 + b_ * c01 + c * c02
    x0, x1, x2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([
        c00 * x0 + (c * h - b_ * i) * x1 + (b_ * f - c * e) * x2,
        c01 * x0 + (a * i - c * g) * x1 + (c * d - a * f) * x2,
        c02 * x0 + (b_ * g - a * h) * x1 + (a * e - b_ * d) * x2,
    ], dim=-1) / det[..., None]


def _homog(uv: Tensor) -> Tensor:
    return torch.cat([uv, torch.ones_like(uv[..., :1])], dim=-1)


# ---------------------------------------------------------------------------
# triangulation (reference: src/base/triangulation.cc)


def triangulate_dlt(proj1: Tensor, proj2: Tensor, uv1: Tensor, uv2: Tensor) -> Tensor:
    """DLT triangulation from two 3x4 projection matrices [..., 3, 4] and
    coords [..., 2] (normalized or pixel, matching the matrices); the
    nullvector comes from eigh of the 4x4 Gram matrix."""
    rows = torch.stack(
        torch.broadcast_tensors(
            uv1[..., 0, None] * proj1[..., 2, :] - proj1[..., 0, :],
            uv1[..., 1, None] * proj1[..., 2, :] - proj1[..., 1, :],
            uv2[..., 0, None] * proj2[..., 2, :] - proj2[..., 0, :],
            uv2[..., 1, None] * proj2[..., 2, :] - proj2[..., 1, :],
        ),
        dim=-2,
    )  # [...,4,4]
    M = rows.mT @ rows
    _, V = _eigh(M)
    X = V[..., :, 0]  # smallest-eigenvalue eigenvector
    w = X[..., 3]
    w = torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)
    return X[..., :3] / w[..., None]


def proj_matrix(q: Tensor, t: Tensor) -> Tensor:
    """[R|t] 3x4 from pose, batched."""
    return torch.cat([se3.quat_to_rotmat(q), t[..., :, None]], dim=-1)


def triangulation_angle(center1: Tensor, center2: Tensor, X: Tensor) -> Tensor:
    """Angle at X subtended by the two camera centers (radians)."""
    v1 = center1 - X
    v2 = center2 - X
    c = torch.sum(v1 * v2, dim=-1) / torch.clamp(
        torch.linalg.norm(v1, dim=-1) * torch.linalg.norm(v2, dim=-1), min=1e-12
    )
    return torch.arccos(torch.clamp(c, -1.0, 1.0))


def p3p(uv: Tensor, X: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """Quartic P3P (Gao's complete-classification form, the variant the
    reference ships): up to 4 world->camera poses from 3 2D-3D matches.

    uv [..., 3, 2] normalized camera coords, X [..., 3, 3] world points.
    Returns (qs [..., 4, 4], ts [..., 4, 3], valid [..., 4]). reference:
    estimators/absolute_pose.cc:47-172. The quartic in x = |PA|/|PC| is
    rooted by Durand-Kerner, y = |PB|/|PC| follows in closed form, and the
    rigid alignment is Umeyama (Kabsch).
    """
    f = torch.cat([uv, torch.ones_like(uv[..., :1])], dim=-1)
    f = f / torch.linalg.norm(f, dim=-1, keepdim=True)  # bearing vectors
    u, v, w = f[..., 0, :], f[..., 1, :], f[..., 2, :]
    cos_uv = torch.sum(u * v, dim=-1)
    cos_uw = torch.sum(u * w, dim=-1)
    cos_vw = torch.sum(v * w, dim=-1)
    AB2 = torch.sum((X[..., 0, :] - X[..., 1, :]) ** 2, dim=-1)
    AC2 = torch.sum((X[..., 0, :] - X[..., 2, :]) ** 2, dim=-1)
    BC2 = torch.sum((X[..., 1, :] - X[..., 2, :]) ** 2, dim=-1)
    ab2 = torch.clamp(AB2, min=1e-12)
    dist_AB = torch.sqrt(ab2)
    a = BC2 / ab2
    b = AC2 / ab2
    p = 2.0 * cos_vw
    q = 2.0 * cos_uw
    r = 2.0 * cos_uv
    a2, b2 = a * a, b * b
    p2, q2, r2 = p * p, q * q, r * r
    p3_, r3 = p2 * p, r2 * r
    r4, r5 = r3 * r, r3 * r2

    # quartic in x (coefficients highest-degree first)
    c4 = -2 * b + b2 + a2 + 1 + a * b * (2 - r2) - 2 * a
    c3 = (
        -2 * q * a2 - r * p * b2 + 4 * q * a + (2 * q + p * r) * b
        + (r2 * q - 2 * q + r * p) * a * b - 2 * q
    )
    c2 = (
        (2 + q2) * a2 + (p2 + r2 - 2) * b2 - (4 + 2 * q2) * a
        - (p * q * r + p2) * b - (p * q * r + r2) * a * b + q2 + 2
    )
    c1 = (
        -2 * q * a2 - r * p * b2 + 4 * q * a
        + (p * r + q * p2 - 2 * q) * b + (r * p + 2 * q) * a * b - 2 * q
    )
    c0 = a2 + b2 - 2 * a + (2 - p2) * b - 2 * a * b + 1
    x, okroot = poly_ops.real_roots(torch.stack([c4, c3, c2, c1, c0], dim=-1))  # [...,4]

    bb1 = (p2 - p * q * r + r2) * a + (p2 - r2) * b - p2 + p * q * r - r2
    b1 = b * bb1 * bb1
    b1_ok = torch.abs(b1) > 1e-10
    b1_safe = torch.where(b1_ok, b1, torch.ones_like(b1))

    # per-sample scalars broadcast against the 4 root slots
    a, b, p, q, r = (s[..., None] for s in (a, b, p, q, r))
    a2, b2, p2, q2, r2, p3_, r3, r4, r5 = (
        s[..., None] for s in (a2, b2, p2, q2, r2, p3_, r3, r4, r5)
    )
    ok = okroot & (x > 0.0) & b1_ok[..., None]
    x2 = x * x
    x3 = x2 * x
    b0 = ((1 - a - b) * x2 + (a - 1) * q * x - a + b + 1) * (
        r3 * (a2 + b2 - 2 * a - 2 * b + (2 - r2) * a * b + 1) * x3
        + r2 * (
            p + p * a2 - 2 * r * q * a * b + 2 * r * q * b - 2 * r * q
            - 2 * p * a - 2 * p * b + p * r2 * b + 4 * r * q * a
            + q * r3 * a * b - 2 * r * q * a2 + 2 * p * a * b + p * b2
            - r2 * p * b2
        ) * x2
        + (
            r5 * (b2 - a * b) - r4 * p * q * b
            + r3 * (q2 - 4 * a - 2 * q2 * a + q2 * a2 + 2 * a2 - 2 * b2 + 2)
            + r2 * (
                4 * p * q * a - 2 * p * q * a * b + 2 * p * q * b
                - 2 * p * q - 2 * p * q * a2
            )
            + r * (
                p2 * b2 - 2 * p2 * b + 2 * p2 * a * b - 2 * p2 * a + p2
                + p2 * a2
            )
        ) * x
        + (2 * p * r2 - 2 * r3 * q + p3_ - 2 * p2 * q * r + p * q2 * r2) * a2
        + (p3_ - 2 * p * r2) * b2
        + (
            4 * q * r3 - 4 * p * r2 - 2 * p3_ + 4 * p2 * q * r
            - 2 * p * q2 * r2
        ) * a
        + (-2 * q * r3 + p * r4 + 2 * p2 * q * r - 2 * p3_) * b
        + (2 * p3_ + 2 * q * r3 - 2 * p2 * q * r) * a * b
        + p * q2 * r2 - 2 * p2 * q * r + 2 * p * r2 + p3_ - 2 * r3 * q
    )
    y = b0 / b1_safe[..., None]

    # f32 rescue: polish (x, y) with Newton on the two law-of-cosines
    # constraints (normalized by |PC|^2), which are quadratic and
    # well-conditioned where the quartic is not:
    #   g1 = y^2 + 1 - p*y - a*nu,  g2 = x^2 + 1 - q*x - b*nu,
    #   nu = x^2 + y^2 - r*x*y
    for _ in range(3):
        nu_ = x * x + y * y - r * x * y
        g1 = y * y + 1.0 - p * y - a * nu_
        g2 = x * x + 1.0 - q * x - b * nu_
        dnx = 2.0 * x - r * y
        dny = 2.0 * y - r * x
        j11 = -a * dnx
        j12 = 2.0 * y - p - a * dny
        j21 = 2.0 * x - q - b * dnx
        j22 = -b * dny
        det = j11 * j22 - j12 * j21
        dsgn = torch.where(det < 0.0, -1.0, 1.0)  # sign-preserving floor
        det = dsgn * torch.clamp(torch.abs(det), min=1e-12)
        dx = (g1 * j22 - g2 * j12) / det
        dy = (g2 * j11 - g1 * j21) / det
        x, y = x - dx, y - dy
    nu = x * x + y * y - 2 * x * y * cos_uv[..., None]
    ok = ok & (nu > 1e-12) & (x > 0.0) & (y > 0.0)
    dist_PC = dist_AB[..., None] / torch.sqrt(torch.clamp(nu, min=1e-12))  # [...,4]
    Xc = torch.stack(
        [
            u[..., None, :] * (x * dist_PC)[..., None],
            v[..., None, :] * (y * dist_PC)[..., None],
            w[..., None, :] * dist_PC[..., None],
        ],
        dim=-2,
    )  # [...,4,3,3]
    # degenerate samples give non-finite camera points: align those slots
    # to the world points instead (a valid SVD input) and mark them invalid
    Xw = X[..., None, :, :].expand(Xc.shape)
    finite = torch.isfinite(Xc).all(-1).all(-1)
    ok = ok & finite
    Xc = torch.where(finite[..., None, None], Xc, Xw)
    qq, tt, _ = umeyama(Xw, Xc, with_scale=False)
    ok = ok & torch.isfinite(qq).all(-1) & torch.isfinite(tt).all(-1)
    ident = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=uv.dtype, device=uv.device)
    qs = torch.where(ok[..., None], qq, ident)
    ts = torch.where(ok[..., None], tt, torch.zeros_like(tt))
    return qs, ts, ok


def epnp(uv: Tensor, X: Tensor, mask: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """EPnP (N=1 nullspace case) + Procrustes, for non-minimal refits.

    uv [n,2] normalized coords, X [n,3], optional mask [n]. reference:
    estimators/absolute_pose.h:97 (EPNPEstimator).
    """
    n = uv.shape[0]
    m = torch.ones((n,), dtype=X.dtype, device=X.device) if mask is None else mask
    wsum = torch.clamp(torch.sum(m), min=1.0)
    centroid = torch.sum(X * m[:, None], dim=0) / wsum
    Xc = (X - centroid) * m[:, None]
    cov = Xc.T @ Xc / wsum
    eigval, eigvec = torch.linalg.eigh(cov)
    # control points: centroid + principal axes scaled
    axes = eigvec.T * torch.sqrt(torch.clamp(eigval, min=1e-12))[:, None]  # [3,3]
    C = torch.cat([centroid[None, :], centroid[None, :] + axes], dim=0)  # [4,3]
    # barycentric coords: X = alpha @ C with sum(alpha)=1
    ones4 = torch.ones((1, 4), dtype=X.dtype, device=X.device)
    Ch = torch.cat([C.T, ones4], dim=0)  # [4,4]
    Xh = torch.cat([X.T, torch.ones((1, n), dtype=X.dtype, device=X.device)], dim=0)  # [4,n]
    alpha = torch.linalg.solve(Ch, Xh).T  # [n,4]
    u, v = uv[:, 0], uv[:, 1]
    z4 = torch.zeros((n, 4), dtype=X.dtype, device=X.device)
    r1 = torch.cat([alpha, z4, -u[:, None] * alpha], dim=-1)
    r2 = torch.cat([z4, alpha, -v[:, None] * alpha], dim=-1)
    Mm = torch.cat([r1 * m[:, None], r2 * m[:, None]], dim=0)  # [2n,12]
    _, vvec = torch.linalg.eigh(Mm.T @ Mm)
    Cc = vvec[:, 0].reshape(3, 4).T  # control points in camera frame (up to scale)
    # fix sign: depths positive
    sign = torch.sign(torch.sum(alpha @ Cc[:, 2]))
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    Cc = Cc * sign
    # the nullspace fixes camera control points only up to a global scale
    # beta: Cc = beta (R C + t). Umeyama gives s = beta and t_u = beta t.
    q, t_u, s = umeyama(C, Cc, with_scale=True)
    return q, t_u / torch.clamp(s, min=1e-12)


def umeyama(src: Tensor, dst: Tensor, with_scale: bool = False, mask: Tensor | None = None):
    """Least-squares similarity/rigid transform src -> dst, batched over
    leading dims: src, dst [..., n, 3], optional weights mask [..., n].

    Returns (q [...,4], t [...,3], s [...]) with dst ~ s * R(q) src + t.
    reference: base/similarity_transform.cc (Umeyama).
    """
    if mask is None:
        w = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    else:
        w = mask.to(src.dtype)
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-12)
    mu_s = torch.sum(src * w[..., None], dim=-2) / wsum[..., None]
    mu_d = torch.sum(dst * w[..., None], dim=-2) / wsum[..., None]
    sc = src - mu_s[..., None, :]
    dc = dst - mu_d[..., None, :]
    cov = torch.einsum("...ni,...nj->...ij", dc * w[..., None], sc) / wsum[..., None, None]
    U, S, Vt = torch.linalg.svd(cov)
    d = torch.sign(torch.linalg.det(U) * torch.linalg.det(Vt))
    d = torch.where(d == 0, torch.ones_like(d), d)
    diag = torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1)
    R = U @ (diag[..., :, None] * Vt)
    if with_scale:
        var_s = torch.sum(torch.sum(sc * sc, dim=-1) * w, dim=-1) / wsum
        s = torch.sum(S * diag, dim=-1) / torch.clamp(var_s, min=1e-12)
    else:
        s = torch.ones_like(wsum)
    t = mu_d - s[..., None] * (R @ mu_s[..., None])[..., 0]
    return se3.rotmat_to_quat(R), t, s


# ---------------------------------------------------------------------------
# epipolar geometry


def _normalize_points(uv: Tensor, mask: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """Hartley normalization over the point axis: uv [..., n, 2] ->
    (uv_norm [..., n, 2], T [..., 3, 3]) with T @ uv_h = uv_norm_h.

    With a mask [..., n], mean and rms come from the masked rows only: an
    LO refit on an inlier subset must not let outlier coordinates skew the
    conditioning."""
    if mask is None:
        mean = torch.mean(uv, dim=-2)
        rms = torch.sqrt(torch.mean(torch.sum((uv - mean[..., None, :]) ** 2, dim=-1), dim=-1))
    else:
        w = mask / torch.clamp(torch.sum(mask, dim=-1, keepdim=True), min=1.0)
        mean = torch.sum(uv * w[..., None], dim=-2)
        rms = torch.sqrt(torch.sum(torch.sum((uv - mean[..., None, :]) ** 2, dim=-1) * w, dim=-1))
    s = math.sqrt(2.0) / torch.clamp(rms, min=1e-12)
    zero, one = torch.zeros_like(s), torch.ones_like(s)
    T = torch.stack(
        [
            torch.stack([s, zero, -s * mean[..., 0]], dim=-1),
            torch.stack([zero, s, -s * mean[..., 1]], dim=-1),
            torch.stack([zero, zero, one], dim=-1),
        ],
        dim=-2,
    )
    return (uv - mean[..., None, :]) * s[..., None, None], T


def _inv_hartley(T: Tensor) -> Tensor:
    """Closed-form inverse of a Hartley normalization matrix."""
    si = 1.0 / T[..., 0, 0]
    zero, one = torch.zeros_like(si), torch.ones_like(si)
    return torch.stack(
        [
            torch.stack([si, zero, -T[..., 0, 2] * si], dim=-1),
            torch.stack([zero, si, -T[..., 1, 2] * si], dim=-1),
            torch.stack([zero, zero, one], dim=-1),
        ],
        dim=-2,
    )


def nullspace_vecs(A: Tensor, k: int) -> Tensor:
    """Last-k right singular vectors of A [..., n, d] as rows [..., k, d],
    most-null first, via eigh of the d x d Gram matrix (inputs are
    Hartley-normalized, so its squared conditioning is benign in f32)."""
    _, V = _eigh(A.mT @ A)  # ascending eigenvalues
    return V[..., :, :k].mT


def _epipolar_rows(n1: Tensor, n2: Tensor) -> Tensor:
    """Rows of x2^T F x1 = 0 with F row-major: [..., n, 9]."""
    x1, y1 = n1[..., 0], n1[..., 1]
    x2, y2 = n2[..., 0], n2[..., 1]
    return torch.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, torch.ones_like(x1)], dim=-1
    )


def _fro_normalize(F: Tensor) -> Tensor:
    nrm = torch.sqrt(torch.sum(F * F, dim=(-2, -1)))
    nrm = torch.where(nrm < 1e-12, torch.full_like(nrm, 1e-12), nrm)
    return F / nrm[..., None, None]


def eight_point(uv1: Tensor, uv2: Tensor, mask: Tensor | None = None, essential: bool = False) -> Tensor:
    """8-point algorithm for F (or E, projected to the essential manifold).

    uv1/uv2 [..., n, 2] (n >= 8); for E pass normalized camera coords.
    Returns [..., 3, 3]. reference: estimators/fundamental_matrix.h:93."""
    m = torch.ones_like(uv1[..., 0]) if mask is None else mask
    n1, T1 = _normalize_points(uv1, m)
    n2, T2 = _normalize_points(uv2, m)
    A = _epipolar_rows(n1, n2) * m[..., None]
    F = nullspace_vecs(A, 1)[..., 0, :].reshape(A.shape[:-2] + (3, 3))
    U, S, Vt = _svd(F)
    if essential:
        S2 = torch.cat([torch.ones_like(S[..., :2]), torch.zeros_like(S[..., 2:])], dim=-1)
    else:
        S2 = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
    F = U @ (S2[..., :, None] * Vt)
    return _fro_normalize(T2.mT @ F @ T1)


def _cbrt(x: Tensor) -> Tensor:
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def seven_point(uv1: Tensor, uv2: Tensor) -> tuple[Tensor, Tensor]:
    """7-point fundamental matrix: up to 3 solutions.

    uv1/uv2 [..., 7, 2] pixel coords. Returns (Fs [..., 3, 3, 3], valid
    [..., 3]). The nullspace of the 7x9 system is span{F1, F2};
    det(F1 + t F2) = 0 is a cubic solved in closed form (trigonometric for
    three real roots, Cardano for one). reference:
    estimators/fundamental_matrix.h:53."""
    n1, T1 = _normalize_points(uv1)
    n2, T2 = _normalize_points(uv2)
    ns = nullspace_vecs(_epipolar_rows(n1, n2), 2)
    shape = ns.shape[:-2] + (3, 3)
    F1 = ns[..., 0, :].reshape(shape)
    F2 = ns[..., 1, :].reshape(shape)

    c0 = det3(F1)
    rhs = torch.stack([det3(F1 + F2) - c0, det3(F1 - F2) - c0, det3(F1 + 2.0 * F2) - c0], dim=-1)
    c3, c2, c1 = (rhs @ _const("seven_point_minv", rhs.device, rhs.dtype).T).unbind(-1)

    a = torch.where(torch.abs(c3) < 1e-12, torch.full_like(c3, 1e-12), c3)
    b, c, d = c2 / a, c1 / a, c0 / a
    p = c - b * b / 3.0
    q = 2.0 * b**3 / 27.0 - b * c / 3.0 + d
    disc = (q / 2.0) ** 2 + (p / 3.0) ** 3
    # three-real-root branch
    pm = torch.clamp(p, max=-1e-12)
    m = 2.0 * torch.sqrt(-pm / 3.0)
    arg = torch.clamp(3.0 * q / (pm * m), -1.0, 1.0)
    theta = torch.arccos(arg) / 3.0
    k = torch.arange(3, dtype=rhs.dtype, device=rhs.device)
    roots3 = m[..., None] * torch.cos(theta[..., None] - 2.0 * math.pi * k / 3.0) - b[..., None] / 3.0
    # single-real-root branch (Cardano)
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    root1 = _cbrt(-q / 2.0 + sq) + _cbrt(-q / 2.0 - sq) - b / 3.0
    three_real = (disc <= 0)[..., None]
    roots = torch.where(three_real, roots3, root1[..., None].expand_as(roots3))
    valid = three_real | _const("first_root", rhs.device, torch.bool)

    Fs = F1[..., None, :, :] + roots[..., None, None] * F2[..., None, :, :]
    Fs = T2.mT[..., None, :, :] @ Fs @ T1[..., None, :, :]
    return _fro_normalize(Fs), valid


def _one_hot(shape, entries) -> Tensor:
    t = torch.zeros(shape, dtype=torch.float32)
    for idx in entries:
        t[idx] += 1.0
    return t


def _five_point_tables():
    """Constant tables of Nister's expansion, built once at import.

    E = x Eb0 + y Eb1 + z Eb2 + Eb3; each E entry is linear in the variables
    v = (x, y, z, 1). The ten cubic constraints (det E = 0 and
    2 E E^T E - tr(E E^T) E = 0) are sums of coef * E_a E_b E_c over entry
    indices a, b, c (table COEF [10, 9, 9, 9]); a product of variables maps
    to a monomial of degree <= 2 (table S2 [4, 4, 10]) and then <= 3 (table
    S3 [10, 4, 20], Nister's order). Evaluating a whole bank is then a
    handful of batched contractions, whatever the number of monomials."""
    var = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]
    mon2 = sorted({tuple(a + b for a, b in zip(var[i], var[j])) for i in range(4) for j in range(4)})
    mon3 = [
        (3, 0, 0), (0, 3, 0), (2, 1, 0), (1, 2, 0), (2, 0, 1),
        (2, 0, 0), (0, 2, 1), (0, 2, 0), (1, 1, 1), (1, 1, 0),
        (1, 0, 2), (1, 0, 1), (1, 0, 0), (0, 1, 2), (0, 1, 1),
        (0, 1, 0), (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0),
    ]

    def add(a, b):
        return tuple(x + y for x, y in zip(a, b))

    S2 = _one_hot((4, 4, 10), [(i, j, mon2.index(add(var[i], var[j]))) for i in range(4) for j in range(4)])
    S3 = _one_hot((10, 4, 20), [(m, k, mon3.index(add(mon2[m], var[k]))) for m in range(10) for k in range(4)])

    def e(i, j):
        return 3 * i + j

    coef = torch.zeros((10, 9, 9, 9), dtype=torch.float32)
    for (i0, j0), (i1, j1), (i2, j2), sign in (
        ((0, 0), (1, 1), (2, 2), 1.0), ((0, 0), (1, 2), (2, 1), -1.0),
        ((0, 1), (1, 0), (2, 2), -1.0), ((0, 1), (1, 2), (2, 0), 1.0),
        ((0, 2), (1, 0), (2, 1), 1.0), ((0, 2), (1, 1), (2, 0), -1.0),
    ):
        coef[0, e(i0, j0), e(i1, j1), e(i2, j2)] += sign
    for i, j in itertools.product(range(3), range(3)):
        eq = 1 + 3 * i + j
        for k, l in itertools.product(range(3), range(3)):
            coef[eq, e(i, l), e(k, l), e(k, j)] += 2.0  # 2 (E E^T)_ik E_kj
            coef[eq, e(k, l), e(k, l), e(i, j)] -= 1.0  # -tr(E E^T) E_ij
    # contraction-ready layouts: S2 [16, 10], COEF [(eq, c), (a, b)],
    # S3 [4, (m2, m3)]
    return (
        S2.reshape(16, 10),
        coef.permute(0, 3, 1, 2).reshape(90, 81),
        S3.permute(1, 0, 2).reshape(4, 200),
    )


def _conv_table(na: int, nb: int) -> Tensor:
    return _one_hot((na * nb, na + nb - 1), [(i * nb + j, i + j) for i in range(na) for j in range(nb)])


def _conv(a: Tensor, b: Tensor) -> Tensor:
    """Batched polynomial product (numpy.convolve) by one constant table."""
    outer = (a[..., :, None] * b[..., None, :]).flatten(-2)
    return outer @ _const(f"conv{a.shape[-1]}x{b.shape[-1]}", a.device, a.dtype)


def _five_point_poly(uv1: Tensor, uv2: Tensor):
    """Nister reduction: (det10 [..., 11] z-polynomial highest-first, the
    B(z) row polynomials (px [..., 3, 4], py [..., 3, 4], pc [..., 3, 5]),
    and the nullspace basis Eb [..., 4, 3, 3])."""
    A = _epipolar_rows(uv1, uv2)  # [..., 5, 9]
    Ebf = nullspace_vecs(A, 4).flip(-2)  # [..., 4, 9]: E = x Eb0 + y Eb1 + z Eb2 + Eb3
    batch = Ebf.shape[:-2]
    dev = Ebf.device
    # Q[a, b, m2]: E_a E_b over degree-2 monomials
    P = (Ebf[..., :, None, :, None] * Ebf[..., None, :, None, :]).reshape(batch + (16, 81))
    Q = P.mT @ _const("five_s2", dev, Ebf.dtype)  # [..., 81 (a,b), 10]
    W = _const("five_coef", dev, Ebf.dtype) @ Q  # [..., 90 (eq,c), 10 (m2)]
    R = Ebf.mT @ _const("five_s3", dev, Ebf.dtype)  # [..., 9 (c), 200 (m2,m3)]
    M = W.reshape(batch + (10, 90)) @ R.reshape(batch + (90, 20))  # [..., 10, 20]

    # Gauss-Jordan: first10 = -C @ last10-monomials
    C = torch.linalg.solve_ex(M[..., :10], M[..., 10:])[0]  # [..., 10, 10]
    # B(z) rows from the row pairs (4,5), (6,7), (8,9): d_j(z) = z C[r2,j] - C[r1,j]
    Cr1 = C[..., [4, 6, 8], :]
    Cr2 = C[..., [5, 7, 9], :]
    pad = torch.nn.functional.pad
    px = pad(Cr2[..., 0:3], (0, 1)) - pad(Cr1[..., 0:3], (1, 0))
    py = pad(Cr2[..., 3:6], (0, 1)) - pad(Cr1[..., 3:6], (1, 0))
    pc = pad(Cr2[..., 6:10], (0, 1)) - pad(Cr1[..., 6:10], (1, 0))
    m12_yc = _conv(py[..., 1, :], pc[..., 2, :]) - _conv(py[..., 2, :], pc[..., 1, :])
    m12_xc = _conv(px[..., 1, :], pc[..., 2, :]) - _conv(px[..., 2, :], pc[..., 1, :])
    m12_xy = _conv(px[..., 1, :], py[..., 2, :]) - _conv(px[..., 2, :], py[..., 1, :])
    det10 = (
        _conv(px[..., 0, :], m12_yc) - _conv(py[..., 0, :], m12_xc) + _conv(pc[..., 0, :], m12_xy)
    )
    return det10, (px, py, pc), Ebf.reshape(batch + (4, 3, 3))


def five_point(uv1: Tensor, uv2: Tensor) -> tuple[Tensor, Tensor]:
    """Nister 5-point essential matrix: up to 10 solutions.

    uv1/uv2 [..., 5, 2] normalized camera coords. Returns (Es [..., 10, 3,
    3], valid [..., 10]). The degree-10 det B(z) polynomial is rooted by
    the batched Durand-Kerner of ops/polynomial. reference:
    estimators/essential_matrix.h (EssentialMatrixFivePointEstimator)."""
    det10, (px, py, pc), Eb = _five_point_poly(uv1, uv2)
    z, ok = poly_ops.real_roots(det10)  # [..., 10]
    zc = z[..., :, None]
    pxv = poly_ops.polyval(px[..., None, :, :], zc)  # [..., 10, 3]
    pyv = poly_ops.polyval(py[..., None, :, :], zc)
    pcv = poly_ops.polyval(pc[..., None, :, :], zc)
    ia = _const("pair_a", z.device, torch.int64)
    ib = _const("pair_b", z.device, torch.int64)
    # solve the best-conditioned 2x2 row pair of B(z) [x, y, 1]^T = 0
    d2 = pxv[..., ia] * pyv[..., ib] - pxv[..., ib] * pyv[..., ia]
    k = torch.argmax(torch.abs(d2), dim=-1, keepdim=True)
    a, b = ia[k], ib[k]
    d2k = torch.gather(d2, -1, k)[..., 0]
    # sign-preserving floor; the root is invalid when even the best pair
    # is degenerate
    sgn = torch.where(d2k < 0.0, -1.0, 1.0)
    det2 = sgn * torch.clamp(torch.abs(d2k), min=1e-12)
    ok = ok & (torch.abs(d2k) >= 1e-12)

    def at(v, i):
        return torch.gather(v, -1, i)[..., 0]

    x = (-at(pcv, a) * at(pyv, b) + at(pcv, b) * at(pyv, a)) / det2
    y = (at(pcv, a) * at(pxv, b) - at(pcv, b) * at(pxv, a)) / det2
    Eb = Eb[..., None, :, :, :]
    Ez = (
        x[..., None, None] * Eb[..., 0, :, :] + y[..., None, None] * Eb[..., 1, :, :]
        + z[..., None, None] * Eb[..., 2, :, :] + Eb[..., 3, :, :]
    )
    Ez = _fro_normalize(Ez)
    ok = ok & torch.isfinite(Ez).all(-1).all(-1)
    eye = torch.eye(3, dtype=Ez.dtype, device=Ez.device)
    return torch.where(ok[..., None, None], Ez, eye), ok


_five_s2, _five_coef, _five_s3 = _five_point_tables()
# constant tables of the two-view solvers, on the host
_CONSTS = {
    "five_s2": _five_s2,
    "five_coef": _five_coef,
    "five_s3": _five_s3,
    **{f"conv{na}x{nb}": _conv_table(na, nb) for na, nb in ((4, 5), (4, 4), (4, 8), (5, 7))},
    # the cubic det(F1 + t F2) = c3 t^3 + c2 t^2 + c1 t + c0 is sampled at
    # t = 1, -1, 2; rows of [t^3, t^2, t] inverted once
    "seven_point_minv": torch.linalg.inv(
        torch.tensor([[1.0, 1.0, 1.0], [-1.0, 1.0, -1.0], [8.0, 4.0, 2.0]], dtype=torch.float64)
    ),
    "first_root": torch.tensor([True, False, False]),
    # the 2x2 row pairs of B(z) five_point solves from
    "pair_a": torch.tensor([0, 0, 1]),
    "pair_b": torch.tensor([1, 2, 2]),
    "w_essential": torch.tensor([[0.0, 1.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]),
}


@functools.lru_cache(maxsize=None)
def _const(name: str, device: torch.device, dtype: torch.dtype) -> Tensor:
    """A constant table on `device`, copied there once: a copy from pageable
    host memory synchronizes the stream. Callers never write to it."""
    return _CONSTS[name].to(device, dtype)


def sampson_error(F: Tensor, uv1: Tensor, uv2: Tensor) -> Tensor:
    """Squared Sampson distance of uv1/uv2 [..., N, 2] under F [..., 3, 3]
    (reference: base/essential_matrix.cc)."""
    x1 = _homog(uv1)
    x2 = _homog(uv2)
    Fx1 = x1 @ F.mT
    Ftx2 = x2 @ F
    num = torch.sum(x2 * Fx1, dim=-1) ** 2
    den = Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2
    return num / torch.clamp(den, min=1e-12)


def decompose_essential(E: Tensor, uv1: Tensor, uv2: Tensor, mask: Tensor) -> tuple[Tensor, Tensor]:
    """The (R, t) of E with the most points in front of both cameras.

    E [..., 3, 3]; uv1/uv2 [..., N, 2] normalized coords of cam1 (at
    identity) and cam2; mask [..., N]. Returns the world-to-cam2 pose
    (q [..., 4], t [..., 3]) with |t| = 1; all four candidates are
    triangulated in one batch. reference: base/pose.cc."""
    U, _, Vt = _svd(E)
    U = U * torch.sign(det3(U))[..., None, None]
    Vt = Vt * torch.sign(det3(Vt))[..., None, None]
    W = _const("w_essential", E.device, E.dtype)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[..., :, 2]
    Rs = torch.stack([R1, R1, R2, R2], dim=-3)  # [..., 4, 3, 3]
    ts = torch.stack([t, -t, t, -t], dim=-2)  # [..., 4, 3]
    qs = se3.rotmat_to_quat(Rs)
    P1 = torch.eye(3, 4, dtype=E.dtype, device=E.device)
    P2 = proj_matrix(qs, ts)[..., :, None, :, :]
    X = triangulate_dlt(P1, P2, uv1[..., None, :, :], uv2[..., None, :, :])  # [..., 4, N, 3]
    z1 = X[..., 2]
    z2 = (X @ Rs.mT + ts[..., None, :])[..., 2]
    good = (z1 > 0) & (z2 > 0) & (torch.abs(z1) < 1e3) & (mask[..., None, :] > 0)
    best = torch.argmax(torch.sum(good, dim=-1), dim=-1)  # first of equal counts
    q = torch.gather(qs, -2, best[..., None, None].expand(best.shape + (1, 4)))[..., 0, :]
    tb = torch.gather(ts, -2, best[..., None, None].expand(best.shape + (1, 3)))[..., 0, :]
    return q, tb


# ---------------------------------------------------------------------------
# homography


def homography_dlt(uv1: Tensor, uv2: Tensor, mask: Tensor | None = None) -> Tensor:
    """4+ point homography via normalized DLT, uv [..., n, 2] ->
    [..., 3, 3] with H[2,2] = 1 (estimators/homography_matrix.h)."""
    m = torch.ones_like(uv1[..., 0]) if mask is None else mask
    n1, T1 = _normalize_points(uv1, m)
    n2, T2 = _normalize_points(uv2, m)
    x1, y1 = n1[..., 0], n1[..., 1]
    x2, y2 = n2[..., 0], n2[..., 1]
    z = torch.zeros_like(x1)
    o = torch.ones_like(x1)
    r1 = torch.stack([-x1, -y1, -o, z, z, z, x2 * x1, x2 * y1, x2], dim=-1)
    r2 = torch.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], dim=-1)
    A = torch.cat([r1 * m[..., None], r2 * m[..., None]], dim=-2)
    H = nullspace_vecs(A, 1)[..., 0, :].reshape(A.shape[:-2] + (3, 3))
    Hn = _inv_hartley(T2) @ H @ T1
    h22 = Hn[..., 2, 2]
    h22 = torch.where(torch.abs(h22) < 1e-12, torch.full_like(h22, 1e-12), h22)
    return Hn / h22[..., None, None]


def homography_transfer_error(H: Tensor, uv1: Tensor, uv2: Tensor) -> Tensor:
    """Squared forward transfer error |H x1 - x2|^2."""
    y = _homog(uv1) @ H.mT
    w = y[..., 2:3]
    w = torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)
    return torch.sum((y[..., :2] / w - uv2) ** 2, dim=-1)


# ---------------------------------------------------------------------------
# generalized (multi-camera) pose


def gp6p_dlt(rays_o: Tensor, rays_d: Tensor, X: Tensor, mask: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """Generalized absolute pose (world -> rig) from >= 6 ray/point matches,
    batched over leading dims: rays_o/rays_d [..., n, 3] ray origins and unit
    directions in the RIG frame, X [..., n, 3] world points, optional weights
    [..., n]. Returns (q [..., 4], t [..., 3]).

    The linear generalized-DLT constraint (R X_i + t - o_i) x d_i = 0 (the
    JAX package's replacement for the reference's GP3P polynomial,
    estimators/generalized_absolute_pose.{h,cc}): a least-squares solve for
    [vec(R); t], the SO(3) projection of R, then t re-solved with R fixed."""
    n = X.shape[-2]
    w = torch.ones(X.shape[:-1], dtype=X.dtype, device=X.device) if mask is None else mask.to(X.dtype)
    dx, dy, dz = rays_d.unbind(-1)
    zero = torch.zeros_like(dx)
    Dx = torch.stack([
        torch.stack([zero, -dz, dy], -1),
        torch.stack([dz, zero, -dx], -1),
        torch.stack([-dy, dx, zero], -1),
    ], dim=-2)  # [..., n, 3, 3] = [d]_x
    batch = X.shape[:-2]
    # unknowns [r row-major (9); t (3)]: rows [d]_x kron(X_i^T) and [d]_x
    kron = torch.einsum("...nab,...nc->...nabc", Dx, X).reshape(batch + (n, 3, 9))
    A = torch.cat([kron, Dx], dim=-1)  # [..., n, 3, 12]
    b = torch.einsum("...nab,...nb->...na", Dx, rays_o)
    ws = torch.sqrt(torch.clamp(w, min=0.0))[..., None, None]
    A = (A * ws).reshape(batch + (3 * n, 12))
    bf = (b * ws[..., 0]).reshape(batch + (3 * n, 1))
    eye12 = torch.eye(12, dtype=X.dtype, device=X.device)
    x = torch.linalg.solve_ex(A.mT @ A + 1e-9 * eye12, A.mT @ bf)[0][..., 0]
    M = x[..., :9].reshape(batch + (3, 3))
    # project to SO(3) (det +1)
    U, _sv, Vt = _svd(M)
    d = torch.sign(det3(U @ Vt))
    d = torch.where(d == 0, torch.ones_like(d), d)
    diag = torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1)
    R = U @ (diag[..., :, None] * Vt)
    # re-solve t linearly with R fixed: [d]_x t = [d]_x (o - R X)
    rhs = torch.einsum("...nab,...nb->...na", Dx, rays_o - X @ R.mT)
    T_A = (Dx * ws).reshape(batch + (3 * n, 3))
    T_b = (rhs * ws[..., 0]).reshape(batch + (3 * n, 1))
    eye3 = torch.eye(3, dtype=X.dtype, device=X.device)
    t = torch.linalg.solve_ex(T_A.mT @ T_A + 1e-9 * eye3, T_A.mT @ T_b)[0][..., 0]
    return se3.rotmat_to_quat(R), t


def _cayley_rotmat(cayley: Tensor) -> Tensor:
    """Cayley parameters [..., 3] -> rotation [..., 3, 3]."""
    cx, cy, cz = cayley.unbind(-1)
    s = 1.0 + cx * cx + cy * cy + cz * cz
    R = torch.stack([
        1 + cx * cx - cy * cy - cz * cz, 2 * (cx * cy - cz), 2 * (cx * cz + cy),
        2 * (cx * cy + cz), 1 - cx * cx + cy * cy - cz * cz, 2 * (cy * cz - cx),
        2 * (cx * cz - cy), 2 * (cy * cz + cx), 1 - cx * cx - cy * cy + cz * cz,
    ], dim=-1)
    return R.reshape(cayley.shape[:-1] + (3, 3)) / s[..., None, None]


def _gr6p_G(cayley: Tensor, f1: Tensor, c1: Tensor, f2: Tensor, c2: Tensor, w: Tensor) -> Tensor:
    """4x4 PSD system [..., 4, 4] of the generalized epipolar constraint at
    rotation `cayley` [..., 3]: each ray pair (f [..., n, 3] bearings, c
    [..., n, 3] origins, weights w [..., n]) contributes g = [a; b] with

        a = (R f1) x f2,   b = (R c1 - c2) . a,

    so that the true (R, t) makes [t; 1] the nullvector of G = sum w g g^T
    (the JAX package's direct O(n) form of estimators/
    generalized_relative_pose.cc:325-478)."""
    R = _cayley_rotmat(cayley)
    Rf1 = torch.einsum("...ij,...nj->...ni", R, f1)
    a = torch.linalg.cross(Rf1, f2.expand_as(Rf1), dim=-1)
    b = torch.sum((torch.einsum("...ij,...nj->...ni", R, c1) - c2) * a, dim=-1)
    g = torch.cat([a, b[..., None]], dim=-1)  # [..., n, 4]
    return torch.einsum("...n,...ni,...nj->...ij", w, g, g)


def cayley_to_quat(cayley: Tensor) -> Tensor:
    """Cayley [..., 3] -> unit quaternion (w, x, y, z): (1, c)/sqrt(1+|c|^2)."""
    q = torch.cat([torch.ones_like(cayley[..., :1]), cayley], dim=-1)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def gr6p(
    f1: Tensor,  # [..., n, 3] unit bearing vectors in rig-1 frame
    c1: Tensor,  # [..., n, 3] ray origins (camera centers) in rig-1 frame
    f2: Tensor,  # [..., n, 3] unit bearings in rig-2 frame
    c2: Tensor,  # [..., n, 3] ray origins in rig-2 frame
    mask: Tensor | None = None,
    generator: torch.Generator | None = None,
    num_restarts: int = 4,
    num_iters: int = 48,
    cayley0: Tensor | None = None,
    perturb: Tensor | None = None,
) -> tuple[Tensor, Tensor, Tensor]:
    """Generalized (multi-camera) relative pose from >= 6 ray
    correspondences, batched over leading dims (Kneip & Li, CVPR'14; the
    reference's GR6P, estimators/generalized_relative_pose.{h,cc}): find
    (R, t) with x_rig2 = R x_rig1 + t by minimizing the smallest eigenvalue
    of G(R) (`_gr6p_G`) over the Cayley rotation manifold, then read the
    translation off G's eigenvectors.

    As in the JAX package: a Kabsch init on the bearing clouds, restarts at
    init + perturbations in [-0.3, 0.3) (row 0 unperturbed), and a
    fixed-length backtracking descent along the normalized gradient, every
    accept/reject a `torch.where` on the device. The gradient of the smallest
    eigenvalue is v^T (dG/dc) v for its unit eigenvector v (what the JAX
    package's `jax.grad` through `eigvalsh` computes), taken by
    `torch.func.grad` with v held fixed; each step costs one batched `_eigh`.
    `perturb` [..., num_restarts, 3] replaces the draw from `generator`
    (tests pass the JAX package's).

    Returns (q [..., 4], ts [..., 4, 3], t_valid [..., 4]): one rotation and
    a translation candidate from each eigenvector of G, for a RANSAC bank to
    score."""
    w = torch.ones(f1.shape[:-1], dtype=f1.dtype, device=f1.device) if mask is None else mask.to(f1.dtype)
    if cayley0 is None:
        # Kabsch on the bearing clouds (ComputeRotationBetweenPoints, :118-146);
        # rotmat -> cayley: C = (R - I)(R + I)^-1, c = (-C12, C02, -C01)
        q0, _, _ = umeyama(f1, f2, with_scale=False, mask=w)
        R0 = se3.quat_to_rotmat(q0)
        eye = torch.eye(3, dtype=f1.dtype, device=f1.device)
        C = (R0 - eye) @ torch.linalg.inv_ex(R0 + eye + 1e-12 * eye)[0]
        cayley0 = torch.stack([-C[..., 1, 2], C[..., 0, 2], -C[..., 0, 1]], dim=-1)
    if perturb is None:
        shape = f1.shape[:-2] + (num_restarts, 3)
        gdev = generator.device if generator is not None else f1.device
        perturb = torch.rand(shape, generator=generator, device=gdev).to(f1) * 0.6 - 0.3
        perturb[..., 0, :] = 0.0
    cay = cayley0[..., None, :] + perturb.to(f1)  # [..., R, 3]
    # the restart axis on the data
    f1r, c1r, f2r, c2r = (x[..., None, :, :] for x in (f1, c1, f2, c2))
    wr = w[..., None, :]

    def smallest(c):  # (eigenvalue, unit eigenvector) of G(c), smallest
        evals, evecs = _eigh(_gr6p_G(c, f1r, c1r, f2r, c2r, wr))
        return evals[..., 0], evecs[..., :, 0]

    cur, v = smallest(cay)
    lam = torch.full(cur.shape, 0.01, dtype=f1.dtype, device=f1.device)
    for _ in range(num_iters):
        vv = v

        def rayleigh(c):
            G = _gr6p_G(c, f1r, c1r, f2r, c2r, wr)
            return torch.sum(vv * (G @ vv[..., None])[..., 0])

        g = torch.func.grad(rayleigh)(cay)
        cand = cay - lam[..., None] * g / torch.clamp(torch.linalg.norm(g, dim=-1, keepdim=True), min=1e-12)
        cnew, vnew = smallest(cand)
        better = cnew < cur
        cay = torch.where(better[..., None], cand, cay)
        cur = torch.where(better, cnew, cur)
        v = torch.where(better[..., None], vnew, v)
        lam = torch.where(better, lam * 1.5, lam * 0.5)
    best = torch.argmin(cur, dim=-1)
    cay = torch.gather(cay, -2, best[..., None, None].expand(best.shape + (1, 3)))[..., 0, :]

    _, evecs = _eigh(_gr6p_G(cay, f1, c1, f2, c2, w))  # ascending
    vh = evecs.mT  # rows = eigenvectors
    denom = vh[..., 3]
    t_valid = torch.abs(denom) > 1e-8
    ts = vh[..., :3] / torch.where(torch.abs(denom) < 1e-8, torch.full_like(denom, 1e-8), denom)[..., None]
    return cayley_to_quat(cay), ts, t_valid


def generalized_sampson_error(q: Tensor, t: Tensor, f1: Tensor, c1: Tensor, f2: Tensor, c2: Tensor) -> Tensor:
    """First-order (Sampson-style) squared error [..., N] of the generalized
    epipolar constraint on Plücker rays, the scoring residual of GR6P banks:
    r = ((R f1) x f2).t + (R c1 - c2).((R f1) x f2), normalized by its
    gradient w.r.t. both bearings (angular units, as the reference's
    normalized-coordinate Sampson error, generalized_relative_pose.cc:596-617).
    q [..., 4], t [..., 3] broadcast against rays [N, 3]."""
    R = se3.quat_to_rotmat(q)
    Rf1 = torch.einsum("...ij,...nj->...ni", R, f1)
    a = torch.linalg.cross(Rf1, f2.expand_as(Rf1), dim=-1)
    base = torch.einsum("...ij,...nj->...ni", R, c1) - c2
    r = torch.sum(a * t[..., None, :], dim=-1) + torch.sum(base * a, dim=-1)
    # r = u . (R f1 x f2) with u = t + base
    u = base + t[..., None, :]
    dr_df1 = torch.einsum("...ni,...ij->...nj", torch.linalg.cross(f2.expand_as(u), u, dim=-1), R)
    dr_df2 = torch.linalg.cross(u, Rf1, dim=-1)
    denom = torch.sum(dr_df1**2, dim=-1) + torch.sum(dr_df2**2, dim=-1)
    return r * r / torch.clamp(denom, min=1e-12)
