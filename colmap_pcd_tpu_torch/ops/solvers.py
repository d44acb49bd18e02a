"""Batched absolute-pose solvers: P3P, EPnP and Umeyama.

Port of the PnP part of colmap_pcd_tpu/ops/solvers.py (`p3p` :125, `epnp`
:259, `umeyama` :302). Every function broadcasts over leading batch dims, so
a RANSAC bank of minimal samples is one batched solve instead of a loop. The
E/F/H solvers of that module belong to the matching slice and are not ported
yet (ROADMAP.md queue 1).
"""

from __future__ import annotations

import torch

from . import polynomial as poly_ops
from . import se3

Tensor = torch.Tensor


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
