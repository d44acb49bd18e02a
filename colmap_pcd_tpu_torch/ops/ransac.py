"""Batched PnP RANSAC: the hypothesis bank as one batched solve, not a loop.

Port of the PnP part of colmap_pcd_tpu/ops/ransac.py (`_draw_samples`
uniform branch :43-54, `_score`, `ransac_pnp` :90-217):

  1. draw H/4 minimal 3-point samples at once (uniform over the valid rows),
  2. solve all of them with the batched P3P (up to 4 poses each),
  3. score all H x N residuals in one pass (inlier count, then truncated
     residual as tie-break),
  4. local optimization: EPnP refits on the best inlier set, a fixed number
     of rounds, then an optional Cauchy-weighted Gauss-Newton pose polish.

Randomness comes from an explicit `torch.Generator`; it cannot reproduce
`jax.random`, so tests hand both implementations the same `sample_idx`.
Nothing here waits for the device: the result stays on it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import se3, solvers

Tensor = torch.Tensor


class RansacOptions(NamedTuple):
    max_error: float = 4.0  # inlier threshold on the residual (units per-fn)
    num_hypotheses: int = 2048
    lo_rounds: int = 3  # local-optimization refit rounds
    min_inlier_ratio: float = 0.0


def _draw_samples(generator: torch.Generator, valid: Tensor, num: int, k: int) -> Tensor:
    """[num, k] indices drawn uniformly, with replacement, from the rows
    where valid > 0."""
    w = (valid > 0).to(torch.float32)
    return torch.multinomial(w, num * k, replacement=True, generator=generator).reshape(num, k)


def _score(err: Tensor, valid: Tensor, thr: float):
    """(num_inliers, score) per hypothesis; score orders by inliers then
    truncated residual sum. err [H,N], valid [N]."""
    ok = (err < thr) & (valid > 0)
    n_in = torch.sum(ok, dim=-1)
    trunc = torch.sum(torch.clamp(err, max=thr) * valid, dim=-1)
    score = n_in.to(torch.float32) - trunc / (thr * torch.clamp(torch.sum(valid), min=1.0))
    return n_in, score


class PnPResult(NamedTuple):
    q: Tensor
    t: Tensor
    inlier_mask: Tensor
    num_inliers: Tensor


def _resid(q: Tensor, t: Tensor, uv: Tensor, X: Tensor) -> Tensor:
    """Squared normalized-plane reprojection error; 1e12 behind the camera.
    q [...,4], t [...,3] broadcast against X [N,3]."""
    xc = se3.se3_apply(q[..., None, :], t[..., None, :], X)
    z = xc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    e = torch.sum((xc[..., :2] / zs[..., None] - uv) ** 2, dim=-1)
    return torch.where(z > 1e-6, e, torch.full_like(e, 1e12))


def ransac_pnp(
    uv: Tensor,  # [N,2] normalized camera coords
    X: Tensor,  # [N,3]
    valid: Tensor,  # [N]
    generator: torch.Generator | None,
    opts: RansacOptions = RansacOptions(),
    refine_iters: int = 0,
    max_error: float | None = None,
    sample_idx: Tensor | None = None,
) -> PnPResult:
    """Absolute pose from 2D-3D matches (EstimateAbsolutePose parity,
    estimators/pose.cc): P3P minimal hypotheses + EPnP local optimization,
    plus an optional Cauchy-GN pose polish (refine_iters > 0, the
    reference's RefineAbsolutePose). max_error is in normalized-coordinate
    units. sample_idx [H/4, 3] replaces the random draw (tests)."""
    H = opts.num_hypotheses
    ns = max(H // 4, 1)
    idx = _draw_samples(generator, valid, ns, 3) if sample_idx is None else sample_idx
    qs, ts, hvalid = solvers.p3p(uv[idx], X[idx])
    qs = qs.reshape(-1, 4)  # [H,4]
    ts = ts.reshape(-1, 3)  # [H,3]
    hvalid = hvalid.reshape(-1)  # [H]

    errs = _resid(qs, ts, uv, X)  # [H,N]
    errs = torch.where(hvalid[:, None], errs, torch.full_like(errs, 1e12))
    thr2 = (opts.max_error if max_error is None else max_error) ** 2
    n_in, score = _score(errs, valid, thr2)
    score = torch.where(hvalid, score, torch.full_like(score, -float("inf")))
    best = torch.argmax(score)
    q_b, t_b, best_in = qs[best], ts[best], n_in[best]

    for _ in range(opts.lo_rounds):
        e = _resid(q_b, t_b, uv, X)
        inl = ((e < thr2) & (valid > 0)).to(torch.float32)
        q_n, t_n = solvers.epnp(uv, X, inl)
        n_n = torch.sum((_resid(q_n, t_n, uv, X) < thr2) & (valid > 0))
        better = n_n >= best_in
        q_b = torch.where(better, q_n, q_b)
        t_b = torch.where(better, t_n, t_b)
        best_in = torch.maximum(n_n, best_in)
    mask = (_resid(q_b, t_b, uv, X) < thr2) & (valid > 0)

    if refine_iters > 0:
        q_b, t_b = _refine_pose(q_b, t_b, uv, X, mask, thr2, refine_iters)
        mask = (_resid(q_b, t_b, uv, X) < thr2) & (valid > 0)
    return PnPResult(q_b, t_b, mask, torch.sum(mask))


def _refine_pose(q, t, uv, X, mask, thr2, iters):
    """Cauchy-weighted Gauss-Newton on (so3, t) over the inlier set
    (RefineAbsolutePose, estimators/pose.cc:220-270); a step is kept only
    if the robust cost drops."""
    c2 = thr2 / 9.0  # Cauchy scale = max_error/3, squared
    maskf = mask.to(torch.float32)
    eye6 = torch.eye(6, dtype=torch.float32, device=X.device)

    def cost(qq, tt):
        xcc = se3.se3_apply(qq, tt, X)
        zz = torch.where(torch.abs(xcc[:, 2]) < 1e-6, torch.full_like(xcc[:, 2], 1e-6), xcc[:, 2])
        rr = xcc[:, :2] / zz[:, None] - uv
        rho = c2 * torch.log1p(torch.sum(rr * rr, dim=-1) / c2)
        rho = torch.where(xcc[:, 2] > 1e-6, rho, torch.full_like(rho, c2 * 20.0))
        return torch.sum(torch.where(mask, rho, torch.zeros_like(rho)))

    for _ in range(iters):
        xc = se3.se3_apply(q, t, X)  # [N,3]
        z = torch.where(torch.abs(xc[:, 2]) < 1e-6, torch.full_like(xc[:, 2], 1e-6), xc[:, 2])
        r = xc[:, :2] / z[:, None] - uv  # [N,2]
        w = maskf / (1.0 + torch.sum(r * r, dim=-1) / c2)  # IRLS Cauchy
        zi = 1.0 / z
        zr = torch.zeros_like(zi)
        # dp/dxc [N,2,3]
        dp = torch.stack(
            [
                torch.stack([zi, zr, -xc[:, 0] * zi * zi], -1),
                torch.stack([zr, zi, -xc[:, 1] * zi * zi], -1),
            ],
            dim=1,
        )
        # left perturbation xc' = exp(dw) xc + dt => dxc/dw = -[xc]x, dxc/dt = I
        px, py, pz = xc[:, 0], xc[:, 1], xc[:, 2]
        skew = torch.stack(
            [
                torch.stack([zr, -pz, py], -1),
                torch.stack([pz, zr, -px], -1),
                torch.stack([-py, px, zr], -1),
            ],
            dim=1,
        )  # [N,3,3] = [xc]x
        J = torch.cat([-torch.einsum("nij,njk->nik", dp, skew), dp], dim=-1)  # [N,2,6]
        JtJ = torch.einsum("nia,nib,n->ab", J, J, w) + 1e-6 * eye6
        Jtr = torch.einsum("nia,ni,n->a", J, r, w)
        delta = -torch.linalg.solve_ex(JtJ, Jtr)[0]
        q_n = se3.quat_mul(se3.so3_exp_quat(delta[:3]), q)
        q_n = q_n / torch.clamp(torch.linalg.norm(q_n), min=1e-12)
        t_n = t + delta[3:]
        better = cost(q_n, t_n) <= cost(q, t)
        q = torch.where(better, q_n, q)
        t = torch.where(better, t_n, t)
    return q, t
