"""Polynomial banks and two-view blocks for the root finder's tests and
chip_smoke.py: the coefficients the RANSAC banks root (the five-point
solver's degree-10 polynomials over a 16-pair block of corridor pairs, P3P's
quartics over a PnP bank), hand-made polynomials with hard roots, and a
16-pair verification block. The pairs see the corridor that
tests/render_torch.py renders (walls at x = +-4, ground at y = 2) from
consecutive poses of synthetic_torch.make_trajectory, at the reference
scale's 1280x960 PINHOLE camera, f = 1000. Imports nothing of JAX."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from colmap_pcd_tpu_torch.ops import np_geom, polynomial

W, H, F = 1280, 960, 1000.0
PARAMS = np.asarray([F, F, W / 2, H / 2], np.float32)  # PINHOLE
PINHOLE = 1


def _corridor_points(rng, n: int, z0: float, z1: float) -> np.ndarray:
    """n points on the corridor's walls and ground between depths z0 and z1."""
    side = rng.integers(0, 3, n)
    z = rng.uniform(z0, z1, n)
    a = rng.uniform(-2.0, 2.0, n)
    b = rng.uniform(-4.0, 4.0, n)
    x = np.where(side == 0, -4.0, np.where(side == 1, 4.0, b))
    y = np.where(side == 2, 2.0, a)
    return np.stack([x, y, z], -1)


def corridor_pair(rng, i: int, n: int = 1500, noise: float = 0.5, outliers: float = 0.2):
    """n pixel correspondences (uv1, uv2) of views i and i + 1 of the
    trajectory, with `noise` px of noise and a share of uniform outliers."""
    from synthetic_torch import make_trajectory

    (q1, t1), (q2, t2) = make_trajectory(i + 2)[i:]
    uv1, uv2 = np.zeros((0, 2)), np.zeros((0, 2))
    while uv1.shape[0] < n:
        X = _corridor_points(rng, 4 * n, i * 0.8 + 2.0, i * 0.8 + 40.0)
        p1, z1 = np_geom.project(PINHOLE, PARAMS, q1, t1, X)
        p2, z2 = np_geom.project(PINHOLE, PARAMS, q2, t2, X)
        ok = (z1 > 0.5) & (z2 > 0.5)
        for p in (p1, p2):
            ok &= (p[:, 0] >= 0) & (p[:, 0] < W) & (p[:, 1] >= 0) & (p[:, 1] < H)
        uv1, uv2 = np.concatenate([uv1, p1[ok]]), np.concatenate([uv2, p2[ok]])
    uv1, uv2 = uv1[:n], uv2[:n] + rng.normal(0, noise, (n, 2))
    bad = rng.random(n) < outliers
    uv2[bad] = rng.uniform(0, 1, (bad.sum(), 2)) * [W, H]
    return uv1.astype(np.float32), uv2.astype(np.float32)


def verification_items(seed: int, B: int = 16, n: int = 1500) -> list[dict]:
    """A block of B two-view items (pairs (i, i + 1)) as the sequential
    matcher hands them to models.two_view.two_view_verify_dispatch."""
    rng = np.random.default_rng(seed)
    items = []
    for i in range(B):
        uv1, uv2 = corridor_pair(rng, i, n)
        items.append(dict(
            uv1=uv1, uv2=uv2, params1=np_geom.pad_params(PARAMS, PINHOLE),
            params2=np_geom.pad_params(PARAMS, PINHOLE), model_id1=PINHOLE, model_id2=PINHOLE,
            size1=(W, H), size2=(W, H), quality=rng.random(n).astype(np.float32), seed=seed * 1000 + i,
        ))
    return items


def five_point_bank(seed: int, B: int = 16, S: int = 204, device="cpu") -> torch.Tensor:
    """det10 [B, S, 11]: the five-point solver's polynomials of S minimal
    samples of each of B corridor pairs (normalized coordinates, outliers
    included), the E bank's shape at 2 048 hypotheses (2 048 // 10
    samples)."""
    from colmap_pcd_tpu_torch.ops import solvers

    rng = np.random.default_rng(seed)
    x1s, x2s = [], []
    for i in range(B):
        uv1, uv2 = corridor_pair(rng, i)
        n1 = np_geom.image_to_world(PINHOLE, PARAMS, uv1)
        n2 = np_geom.image_to_world(PINHOLE, PARAMS, uv2)
        idx = np.stack([rng.choice(uv1.shape[0], 5, replace=False) for _ in range(S)])
        x1s.append(n1[idx])
        x2s.append(n2[idx])
    x1 = torch.as_tensor(np.asarray(x1s, np.float32), device=device)
    x2 = torch.as_tensor(np.asarray(x2s, np.float32), device=device)
    return solvers._five_point_poly(x1, x2)[0].contiguous()


@contextlib.contextmanager
def captured_coefficients():
    """Within the block, every bank that reaches polynomial.real_roots is
    kept (a copy) in the yielded list."""
    banks, real_roots = [], polynomial.real_roots

    def capture(coeffs, *a, **kw):
        banks.append(coeffs.detach().clone())
        return real_roots(coeffs, *a, **kw)

    polynomial.real_roots = capture
    try:
        yield banks
    finally:
        polynomial.real_roots = real_roots


def pnp_world(rng, n: int, noise: float = 5e-4, outliers: float = 0.3):
    """n 2D-3D matches (uv normalized [n, 2], X [n, 3]) of one camera."""
    Xc = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n), rng.uniform(4, 12, n)], -1)
    uv = Xc[:, :2] / Xc[:, 2:] + rng.normal(0, noise, (n, 2))
    bad = rng.random(n) < outliers
    uv[bad] = rng.uniform(-0.5, 0.5, (bad.sum(), 2))
    return uv.astype(np.float32), (Xc - np.asarray([0.3, -0.2, 0.5])).astype(np.float32)


def p3p_samples(seed: int, S: int = 512, n: int = 600, device="cpu"):
    """(uv [S, 3, 2], X [S, 3, 3]): S minimal samples of a PnP world."""
    rng = np.random.default_rng(seed)
    uv, X = pnp_world(rng, n)
    idx = np.stack([rng.choice(n, 3, replace=False) for _ in range(S)])
    return (torch.as_tensor(uv[idx], device=device), torch.as_tensor(X[idx], device=device))


def p3p_bank(seed: int, S: int = 512, device="cpu") -> torch.Tensor:
    """The quartics [S, 5] that solvers.p3p roots for S minimal samples."""
    from colmap_pcd_tpu_torch.ops import solvers

    with captured_coefficients() as banks:
        solvers.p3p(*p3p_samples(seed, S, device=device))
    return banks[0].contiguous()


def _poly(roots) -> np.ndarray:
    return np.real(np.poly(roots))


def hard_bank(deg: int) -> np.ndarray:
    """Polynomials of degree `deg` [k, deg + 1] (float32) whose roots are
    hard: a vanishing leading coefficient, a double root, every root
    complex (but one at odd degree; this row is left out at degree 1), and
    coefficients whose balancing hits the clamp at 7 (and at 0)."""
    rows = []
    rng = np.random.default_rng(deg)
    real = list(rng.uniform(-3, 0.5, deg))  # apart from the double root at 1.5
    vanishing = _poly(real)
    vanishing[0] = 1e-35  # below the 1e-30 floor: ok = False
    rows.append(vanishing)
    rows.append(_poly([1.5, 1.5] + real[2:]) if deg >= 2 else _poly([1.5]))
    if deg >= 2:
        cplx = []
        while len(cplx) + 2 <= deg:
            c = complex(rng.uniform(-2, 2), rng.uniform(0.5, 2))
            cplx += [c, c.conjugate()]
        rows.append(_poly(cplx + real[: deg - len(cplx)]))
    big = _poly(np.asarray(real) * 1e4)  # roots ~1e4: log s above 7 (clamped)
    rows.append(big / np.abs(big).max())
    small = _poly(np.asarray(real) * 1e-3)  # roots ~1e-3: log s below 0 (clamped)
    rows.append(small)
    return np.asarray(rows, np.float32)


def random_bank(rng, deg: int, n: int) -> np.ndarray:
    """n polynomials of degree `deg` with a random number of real roots in
    [-3, 3] and the rest complex-conjugate pairs, scaled (float32)."""
    out = []
    for k in rng.integers(0, deg + 1, size=n):
        roots = list(rng.uniform(-3, 3, size=k))
        while len(roots) < deg:
            if deg - len(roots) >= 2:
                c = complex(rng.uniform(-2, 2), rng.uniform(0.5, 2))
                roots += [c, c.conjugate()]
            else:
                roots.append(rng.uniform(-3, 3))
        out.append(_poly(roots) * rng.uniform(0.5, 2))
    return np.asarray(out, np.float32)


# ---------------------------------------------------------------------------
# comparing two routes. Rounding differs in the last bits between the kernel
# and the plain route (torch.prod's reduction order), and an ill-conditioned
# root amplifies that: the plain route alone moves by up to 5e-2 when its
# coefficients move by one ulp. So roots are held to 1e-4 (1 + |re|) where
# every root of the polynomial is well conditioned, and elsewhere a route
# must find the float64 roots as often as the other.

ROOT_TOL = 1e-2  # polynomial.real_roots' rel_imag_tol


def conditioned(c: np.ndarray) -> np.ndarray:
    """[P] True where every root z of the polynomial c [P, n+1] (float64
    companion roots) has a relative condition number kappa = sum |c_k|
    |z|^k / (|z| |p'(z)|) with kappa * 2^-24 <= 1e-4."""
    out = np.zeros(c.shape[0], bool)
    for i, ci in enumerate(c):
        if np.abs(ci[0]) <= 1e-30 * np.abs(ci).max():
            continue
        z = np.roots(ci)
        powers = np.abs(z)[:, None] ** np.arange(len(ci) - 1, -1, -1)
        num = (powers * np.abs(ci)).sum(-1)
        den = np.maximum(np.abs(z), 1e-12) * np.abs(np.polyval(np.polyder(ci), z))
        with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
            out[i] = bool(np.all(num / den * 2.0**-24 <= 1e-4))
    return out


def truth_share(c: np.ndarray, roots: np.ndarray, valid: np.ndarray) -> float:
    """Share of polynomials whose valid real roots are the float64 roots
    that pass the same test, each within 1e-2 (1 + |re|)."""
    hits = 0
    for i, ci in enumerate(c):
        t = np.roots(ci) if np.abs(ci[0]) > 1e-30 * np.abs(ci).max() else np.zeros(0)
        t = np.sort(t.real[np.abs(t.imag) <= ROOT_TOL * (1 + np.abs(t.real))])
        r = np.sort(roots[i][valid[i]])
        hits += len(r) == len(t) and bool(np.all(np.abs(r - t) <= 1e-2 * (1 + np.abs(t))))
    return hits / c.shape[0]


def compare_routes(c, rk, vk, rp, vp, z) -> dict:
    """Kernel (rk, vk) against plain route (rp, vp, its complex roots z),
    all [P, n] on the host, for the coefficients c [P, n+1] (float64):
    the share of well-conditioned polynomials, the indices among them
    whose valid real roots differ (in number, unless a plain root's |im|
    lies within 1e-6 of the test's bound, or by more than 1e-4 (1 + |re|)),
    the largest difference there, and each route's truth_share."""
    good = conditioned(c)
    near = (np.abs(np.abs(z.imag) - ROOT_TOL * (1 + np.abs(z.real))) <= 1e-6).any(-1)
    disagree, worst = [], 0.0
    for i in np.nonzero(good)[0]:
        a, b = np.sort(rk[i][vk[i]]), np.sort(rp[i][vp[i]])
        if len(a) != len(b):
            if not near[i]:
                disagree.append(int(i))
            continue
        if len(a):
            err = float(np.max(np.abs(a - b) / (1 + np.abs(b))))
            worst = max(worst, err)
            if err > 1e-4:
                disagree.append(int(i))
    return {"conditioned": float(good.mean()), "disagree": disagree, "worst": worst,
            "truth_kernel": truth_share(c, rk, vk), "truth_plain": truth_share(c, rp, vp)}
