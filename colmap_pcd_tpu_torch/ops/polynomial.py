"""Batched polynomial root finding (complex64 Durand-Kerner).

Port of colmap_pcd_tpu/ops/polynomial.py. A fixed-length simultaneous
iteration over a whole RANSAC bank of polynomials at once (P3P's quartics),
followed by a short Newton polish; the reference solves these per sample with
a companion matrix (base/polynomial.cc).
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def polyval(coeffs: Tensor, z: Tensor) -> Tensor:
    """Evaluate a polynomial (highest-degree coefficient first) at z.

    coeffs [..., n+1] broadcasts against z [...] (real or complex)."""
    out = torch.zeros_like(z) + coeffs[..., 0]
    for k in range(1, coeffs.shape[-1]):
        out = out * z + coeffs[..., k]
    return out


def polyder(coeffs: Tensor) -> Tensor:
    """Derivative coefficients (highest first)."""
    n = coeffs.shape[-1] - 1
    if n == 0:
        return torch.zeros_like(coeffs[..., :1])
    powers = torch.arange(n, 0, -1, device=coeffs.device).to(coeffs.dtype)
    return coeffs[..., :-1] * powers


def _floor_abs(x: Tensor, eps: float) -> Tensor:
    """x where |x| >= eps, else eps (complex-safe)."""
    return torch.where(torch.abs(x) < eps, torch.full_like(x, eps), x)


def find_roots(coeffs: Tensor, iters: int = 80, newton_iters: int = 3):
    """All complex roots of real polynomials via Durand-Kerner.

    coeffs: [..., n+1] real float32, highest-degree first. Returns (roots
    [..., n] complex64, ok [...] bool — False where the leading coefficient
    vanishes relative to the rest).
    """
    deg = coeffs.shape[-1] - 1
    scale = torch.amax(torch.abs(coeffs), dim=-1, keepdim=True)
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    c = coeffs / scale

    # geometric balancing z = s*u: s = (max|c_k>0| / |lead|)^(1/deg) makes
    # the balanced lead coefficient equal to the largest magnitude, so monic
    # normalization cannot overflow f32; clamp log(s) to 7 (s^deg f32-safe
    # for deg <= 10)
    lead_abs = torch.abs(c[..., 0])
    tail_max = torch.clamp(torch.amax(torch.abs(c[..., 1:]), dim=-1), min=1e-30)
    ok = lead_abs > 1e-30
    s = torch.exp(
        torch.clamp(
            (torch.log(tail_max) - torch.log(torch.clamp(lead_abs, min=1e-30))) / deg,
            0.0,
            7.0,
        )
    )
    exps = torch.arange(deg, -1, -1, device=coeffs.device, dtype=torch.float32)
    cb = c * s[..., None] ** exps
    lead = cb[..., :1]
    monic = cb / torch.where(torch.abs(lead) > 1e-30, lead, torch.ones_like(lead))
    monic_c = monic.to(torch.complex64)

    # classic DK init: powers of (0.4 + 0.9i) — not a root of unity, so
    # conjugate-symmetric configurations cannot lock the iteration
    base = torch.tensor(0.4 + 0.9j, dtype=torch.complex64, device=coeffs.device)
    z = base ** torch.arange(1, deg + 1, device=coeffs.device, dtype=torch.float32)
    z = z.expand(coeffs.shape[:-1] + (deg,)).clone()

    eye = torch.eye(deg, dtype=torch.bool, device=coeffs.device)
    one = torch.ones((), dtype=torch.complex64, device=coeffs.device)
    for _ in range(iters):
        pz = polyval(monic_c[..., None, :], z)
        diff = torch.where(eye, one, z[..., :, None] - z[..., None, :])
        denom = _floor_abs(torch.prod(diff, dim=-1), 1e-20)
        z = z - pz / denom

    dmonic = polyder(monic_c)
    for _ in range(newton_iters):
        pz = polyval(monic_c[..., None, :], z)
        dz = _floor_abs(polyval(dmonic[..., None, :], z), 1e-20)
        z = z - pz / dz
    return z * s[..., None].to(torch.complex64), ok


def real_roots(coeffs: Tensor, rel_imag_tol: float = 1e-2, **kw):
    """Real roots of real polynomials: (roots [..., n] f32, valid [..., n]).

    A root counts as real when |imag| <= tol * (1 + |real|); invalid slots
    carry 0.0 with valid=False (fixed shapes for RANSAC banks)."""
    z, ok = find_roots(coeffs, **kw)
    re, im = z.real, z.imag
    valid = (torch.abs(im) <= rel_imag_tol * (1.0 + torch.abs(re))) & ok[..., None]
    return torch.where(valid, re, torch.zeros_like(re)), valid
