"""Batched RANSAC: the hypothesis bank as one batched solve, not a loop.

Port of colmap_pcd_tpu/ops/ransac.py (`_draw_samples`, `_score`,
`ransac_pnp`, the two-view banks `_ransac_two_view`,
`ransac_{fundamental,essential,homography}`, `ransac_similarity` and the
GR6P bank `ransac_generalized_relative_pose`):

  1. draw the minimal samples at once (uniform over the valid rows, or
     PROSAC-ordered when a per-row quality is given),
  2. solve all of them with the batched minimal solver (P3P, 5-point,
     7-point, 4-point DLT; several models per sample),
  3. score all H x N residuals in one pass (inlier count, then truncated
     residual as tie-break),
  4. local optimization: non-minimal refits on the best inlier set, a
     fixed number of rounds (plus an optional Cauchy-GN polish for PnP).

The two-view banks take leading batch dims [B, ...]: a block of image
pairs is one bank, and only the sample draw loops over the pairs.
Randomness comes from explicit `torch.Generator`s (one per pair); they
cannot reproduce `jax.random`, so tests hand both implementations the same
`sample_idx`. Nothing here waits for the device: the result stays on it.
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


def _draw_samples(
    generator: torch.Generator, valid: Tensor, num: int, k: int, quality: Tensor | None = None
) -> Tensor:
    """[num, k] indices drawn with replacement from the rows where valid > 0.

    With a quality vector [N] (higher = better), sampling is progressive:
    hypothesis i draws uniformly from the top-m_i valid rows by quality,
    m_i ramping geometrically from 2k to all valid rows across the bank
    (PROSAC semantics, optim/progressive_sampler.cc, batched). An item with
    no valid row draws from all rows (its hypotheses are scored out)."""
    ok = valid > 0
    if quality is None:
        w = ok.to(torch.float32)
        w = torch.where(torch.any(ok), w, torch.ones_like(w))
        return torch.multinomial(w, num * k, replacement=True, generator=generator).reshape(num, k)
    # rank rows: best quality first (invalid rows last); stable like argsort
    order = torch.argsort(torch.where(ok, -quality, torch.inf), stable=True)
    rank = torch.argsort(order, stable=True)
    n_valid = torch.clamp(torch.sum(ok).to(torch.float32), min=1.0)
    i = torch.arange(num, dtype=torch.float32, device=valid.device) / max(num - 1, 1)
    m = torch.minimum(torch.ceil(2.0 * k * (n_valid / (2.0 * k)) ** i), n_valid)
    w = ((rank[None, :] < m[:, None]) & ok[None, :]).to(torch.float32)  # [num, N]
    w = torch.where(torch.any(w > 0, dim=-1, keepdim=True), w, torch.ones_like(w))
    return torch.multinomial(w, k, replacement=True, generator=generator)


def _score(err: Tensor, valid: Tensor, thr):
    """(num_inliers, score) per hypothesis; score orders by inliers then
    truncated residual sum. err [..., H, N], valid [..., N]; thr a float or a
    tensor of the batch shape [...]."""
    if torch.is_tensor(thr):
        thr_e, thr_h = thr[..., None, None], thr[..., None]
    else:
        thr_e = thr_h = thr
    v = valid[..., None, :]
    ok = (err < thr_e) & (v > 0)
    n_in = torch.sum(ok, dim=-1)
    trunc = torch.sum(torch.clamp(err, max=thr_e) * v, dim=-1)
    score = n_in.to(torch.float32) - trunc / (thr_h * torch.clamp(torch.sum(v, dim=-1), min=1.0))
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


class TwoViewResult(NamedTuple):
    model: Tensor  # [..., 3, 3] (E, F, or H)
    inlier_mask: Tensor
    num_inliers: Tensor


def _gather_rows(x: Tensor, idx: Tensor) -> Tensor:
    """x [..., N, C], idx [..., S, k] -> [..., S, k, C]. The index goes to
    int64: torch.gather misreads an expanded int32 index."""
    flat = idx.long().flatten(-2)[..., None].expand(idx.shape[:-2] + (idx.shape[-2] * idx.shape[-1], x.shape[-1]))
    return torch.gather(x, -2, flat).reshape(idx.shape + (x.shape[-1],))


def _draw_bank(generators, valid: Tensor, num: int, k: int, quality: Tensor | None) -> Tensor:
    """Minimal-sample indices [..., num, k]: valid [N] draws with one
    generator; valid [B, N] draws item b with generators[b]."""
    if valid.dim() == 1:
        return _draw_samples(generators, valid, num, k, quality)
    return torch.stack([
        _draw_samples(g, valid[b], num, k, None if quality is None else quality[b])
        for b, g in enumerate(generators)
    ])


def _ransac_two_view(uv1, uv2, valid, generators, opts, solver, resid, sample_k,
                     quality=None, max_error=None, minimal_solver=None,
                     models_per_sample=1, sample_idx=None):
    """One LO-RANSAC bank per item of the leading batch dims: uv1/uv2
    [..., N, 2], valid [..., N]. minimal_solver (optional) hypothesizes up
    to m models per minimal sample as ([..., m, 3, 3], [..., m] valid);
    `solver` is the non-minimal LO refit (and the minimal solver when none
    is given). max_error may be a tensor of the batch shape (per-pair
    thresholds). sample_idx [..., S, k] replaces the random draw (tests)."""
    H = opts.num_hypotheses
    n_samples = max(1, H // models_per_sample)
    if sample_idx is None:
        sample_idx = _draw_bank(generators, valid, n_samples, sample_k, quality)
    s1 = _gather_rows(uv1, sample_idx)  # [..., S, k, 2]
    s2 = _gather_rows(uv2, sample_idx)
    if minimal_solver is None:
        models = solver(s1, s2, None)[..., None, :, :]
        model_ok = torch.ones(models.shape[:-2], dtype=torch.bool, device=uv1.device)
    else:
        models, model_ok = minimal_solver(s1, s2)  # [..., S, m, 3, 3], [..., S, m]
    models = models.flatten(-4, -3)
    model_ok = model_ok.flatten(-2)
    errs = resid(models, uv1[..., None, :, :], uv2[..., None, :, :])  # [..., M, N]
    errs = torch.where(model_ok[..., None], errs, torch.full_like(errs, 1e12))
    thr2 = (opts.max_error if max_error is None else max_error) ** 2
    n_in, score = _score(errs, valid, thr2)
    best = torch.argmax(score, dim=-1)
    M_b = torch.gather(models, -3, best[..., None, None, None].expand(best.shape + (1, 3, 3)))[..., 0, :, :]
    best_in = torch.gather(n_in, -1, best[..., None])[..., 0]

    thr_n = thr2[..., None] if torch.is_tensor(thr2) else thr2
    v = valid > 0
    for _ in range(opts.lo_rounds):
        inl = ((resid(M_b, uv1, uv2) < thr_n) & v).to(uv1.dtype)
        M_n = solver(uv1, uv2, inl)
        n_n = torch.sum((resid(M_n, uv1, uv2) < thr_n) & v, dim=-1)
        better = n_n >= best_in
        M_b = torch.where(better[..., None, None], M_n, M_b)
        best_in = torch.maximum(n_n, best_in)
    mask = (resid(M_b, uv1, uv2) < thr_n) & v
    return TwoViewResult(M_b, mask, torch.sum(mask, dim=-1))


def ransac_fundamental(uv1, uv2, valid, generators, opts: RansacOptions = RansacOptions(),
                       quality=None, sample_idx=None):
    """F from pixel coords; max_error in pixels (Sampson). 7-point minimal
    hypotheses (up to 3 per sample), 8-point LO refits: the reference's
    F-LORANSAC (estimators/two_view_geometry.cc:271-273,392)."""
    return _ransac_two_view(
        uv1, uv2, valid, generators, opts,
        lambda a, b, m: solvers.eight_point(a, b, m, essential=False),
        solvers.sampson_error, 7, quality,
        minimal_solver=solvers.seven_point, models_per_sample=3, sample_idx=sample_idx,
    )


def ransac_essential(uv1, uv2, valid, generators, opts: RansacOptions = RansacOptions(),
                     quality=None, max_error=None, sample_idx=None):
    """E from normalized camera coords; max_error in normalized units
    (opts.max_error, or `max_error`, a float or per-item tensor). Nister
    5-point minimal hypotheses (up to 10 per sample), 8-point + manifold
    projection LO refits (estimators/two_view_geometry.cc)."""
    return _ransac_two_view(
        uv1, uv2, valid, generators, opts,
        lambda a, b, m: solvers.eight_point(a, b, m, essential=True),
        solvers.sampson_error, 5, quality, max_error,
        minimal_solver=solvers.five_point, models_per_sample=10, sample_idx=sample_idx,
    )


def ransac_homography(uv1, uv2, valid, generators, opts: RansacOptions = RansacOptions(),
                      quality=None, sample_idx=None):
    """H from pixel coords; max_error in pixels (transfer error)."""
    return _ransac_two_view(
        uv1, uv2, valid, generators, opts,
        solvers.homography_dlt, solvers.homography_transfer_error, 4, quality,
        sample_idx=sample_idx,
    )


class SimilarityResult(NamedTuple):
    q: Tensor
    t: Tensor
    s: Tensor
    inlier_mask: Tensor
    num_inliers: Tensor


def ransac_similarity(
    src: Tensor,  # [N,3]
    dst: Tensor,  # [N,3]
    valid: Tensor,  # [N]
    generator: torch.Generator | None,
    opts: RansacOptions = RansacOptions(),
    sample_idx: Tensor | None = None,
) -> SimilarityResult:
    """Robust 3D similarity (sim3) from point correspondences: minimal-3
    Umeyama hypothesis bank + Umeyama LO refit on inliers. max_error is the
    Euclidean residual in destination units. Mirrors the reference's
    Reconstruction::AlignRobust (RANSAC over SimilarityTransformEstimator<3,
    true> on projection centers, used by RunModelAligner). sample_idx
    [H,3] replaces the random draw (tests)."""
    idx = _draw_samples(generator, valid, opts.num_hypotheses, 3) if sample_idx is None else sample_idx
    qs, ts, ss = solvers.umeyama(src[idx], dst[idx], with_scale=True)  # [H,4], [H,3], [H]
    ok = valid > 0

    def resid(q, t, s):  # squared residual of every row, batched over hypotheses
        pred = s[..., None, None] * se3.quat_rotate(q[..., None, :], src) + t[..., None, :]
        return torch.sum((pred - dst) ** 2, dim=-1)

    thr2 = opts.max_error**2
    n_in, score = _score(resid(qs, ts, ss), valid, thr2)
    best = torch.argmax(score)
    q_b, t_b, s_b, best_in = qs[best], ts[best], ss[best], n_in[best]
    for _ in range(opts.lo_rounds):
        inl = (resid(q_b, t_b, s_b) < thr2) & ok
        q_n, t_n, s_n = solvers.umeyama(src, dst, mask=inl, with_scale=True)
        n_n = torch.sum((resid(q_n, t_n, s_n) < thr2) & ok)
        better = n_n >= best_in
        q_b = torch.where(better, q_n, q_b)
        t_b = torch.where(better, t_n, t_b)
        s_b = torch.where(better, s_n, s_b)
        best_in = torch.maximum(n_n, best_in)
    mask = (resid(q_b, t_b, s_b) < thr2) & ok
    return SimilarityResult(q_b, t_b, s_b, mask, torch.sum(mask))


class GenRelPoseResult(NamedTuple):
    q: Tensor
    t: Tensor
    inlier_mask: Tensor
    num_inliers: Tensor


def ransac_generalized_relative_pose(
    f1: Tensor,  # [N,3] unit bearings in rig-1 frame
    c1: Tensor,  # [N,3] ray origins in rig-1 frame
    f2: Tensor,  # [N,3] unit bearings in rig-2 frame
    c2: Tensor,  # [N,3] ray origins in rig-2 frame
    valid: Tensor,  # [N]
    generator: torch.Generator | None,
    opts: RansacOptions = RansacOptions(num_hypotheses=256),
    sample_idx: Tensor | None = None,
    perturb: Tensor | None = None,
) -> GenRelPoseResult:
    """Rig-vs-rig relative pose: a GR6P hypothesis bank + GR6P LO refits
    (the reference's LORANSAC<GR6PEstimator, GR6PEstimator>,
    estimators/generalized_relative_pose_test.cc:108). H/4 samples of 8 rays
    are solved in one batched `gr6p` (2 restarts, 20 steps), each giving
    four translation candidates, scored by the generalized Sampson error
    (angular units: max_error = pixel threshold / focal); the best is
    refit on its inliers lo_rounds times (1 restart from the incumbent, 32
    steps). Degenerate for pure translation and single-camera samples, as
    upstream documents. sample_idx [H/4, 8] and perturb [H/4, 2, 3] replace
    the draws from `generator` (tests)."""
    ns = max(1, opts.num_hypotheses // 4)
    idx = _draw_samples(generator, valid, ns, 8) if sample_idx is None else sample_idx
    q, ts, t_ok = solvers.gr6p(f1[idx], c1[idx], f2[idx], c2[idx], generator=generator,
                              num_restarts=2, num_iters=20, perturb=perturb)
    qs = q.repeat_interleave(4, dim=0)  # [H,4] one rotation per 4 translations
    ts = ts.reshape(-1, 3)
    t_ok = t_ok.reshape(-1)

    def resid(q, t):
        return solvers.generalized_sampson_error(q, t, f1, c1, f2, c2)

    errs = torch.where(t_ok[:, None], resid(qs, ts), torch.full((1,), 1e12, device=f1.device))
    thr2 = opts.max_error**2
    n_in, score = _score(errs, valid, thr2)
    best = torch.argmax(score)
    q_b, t_b, best_in = qs[best], ts[best], n_in[best]
    ok = valid > 0
    no_perturb = torch.zeros((1, 3), dtype=f1.dtype, device=f1.device)
    for _ in range(opts.lo_rounds):
        inl = ((resid(q_b, t_b) < thr2) & ok).to(f1.dtype)
        # warm-start the non-minimal refit from the incumbent rotation
        w0 = q_b[0]
        cay = q_b[1:] / torch.where(torch.abs(w0) < 1e-8, torch.full_like(w0, 1e-8), w0)
        q_n, ts_n, tok_n = solvers.gr6p(f1, c1, f2, c2, mask=inl, num_restarts=1, num_iters=32,
                                        cayley0=cay, perturb=no_perturb)
        e_n = torch.where(tok_n[:, None], resid(q_n.expand(4, 4), ts_n), torch.full((1,), 1e12, device=f1.device))
        n_n = torch.sum((e_n < thr2) & ok, dim=-1)
        k_best = torch.argmax(n_n)
        better = n_n[k_best] >= best_in
        q_b = torch.where(better, q_n, q_b)
        t_b = torch.where(better, ts_n[k_best], t_b)
        best_in = torch.maximum(n_n[k_best], best_in)
    mask = (resid(q_b, t_b) < thr2) & ok
    return GenRelPoseResult(q_b, t_b, mask, torch.sum(mask))
