"""Dense multi-view stereo: plane-sweep NCC cost volumes + consistency fusion.

Port of colmap_pcd_tpu/ops/stereo.py (the plane-sweep re-design of the
reference's PatchMatch stereo, src/mvs/patch_match_cuda.cu, and of
StereoFusion, src/mvs/fusion.{h,cc}):

  * a bank of D fronto-parallel depth hypotheses per reference view,
  * every source image homography-warped onto the reference for every
    hypothesis (one flat int64 gather per corner),
  * windowed zero-mean NCC, bilaterally weighted or over box sums,
  * per-pixel cost aggregated over the best K sources,
  * depth = first argmin over the sweep; normals from depth differences,
  * the geometric-consistency mask that fusion keeps points by.

`plane_sweep` is batched natively over a chunk of depths and all S
sources: every intermediate is a [Dc, S, H, W] tensor and each step one
elementwise operation over it, so a chunk costs the same few hundred
launches whatever Dc and S are. The sums keep the JAX package's order
(the 49 taps one by one in offset order, box sums from zero in row-major
order, the best-K mean in rank order); nothing goes through `conv2d`,
whose summation order depends on the batch (ROADMAP queue 3). The small
3x3 products and inverses are written out elementwise; divisions by
constants divide by a tensor (a CUDA division by a host scalar multiplies
by its reciprocal); the bilateral weights' `exp` runs in float64. So the
CPU and the card compute the same floats. (XLA on the CPU contracts a*b+c
into FMAs, so the JAX package's floats differ from these in the last bits:
tests/test_torch_stereo.py states the tolerance.) The result does not
depend on the chunk size: a chunk's first argmin is merged into the
running best by a strict `<`, as the JAX package's scan over depths does.
No function here reads a value back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

# the memory a sweep may take: its chunk of depths ([Dc, S, H, W]
# intermediates) and the reference's bilateral weights beside it
_CHUNK_BYTES = {"cuda": 8 << 30, "cpu": 512 << 20}
# f32 [S, H, W] slices live per depth at a chunk's peak: 64 depths of 4
# sources at 640x480, r = 3, peaked at 7 965.5 MiB on an H100
# (chip_smoke.py), ~25; at 1280x960, r = 5, the geometric pass takes 445
# MiB a depth (23.7 slices) beside 1 203 MiB that no chunk size moves,
# most of it the bilateral weights (8 327.9 MiB at 16 depths, 1.7% over
# the budget): so the weights come off the budget first
_SLICES_PER_DEPTH = 26


class StereoOptions(NamedTuple):
    num_depths: int = 64
    window_radius: int = 3  # NCC window = (2r+1)^2
    top_k: int = 2  # best-K source aggregation
    min_ncc: float = 0.1  # photometric gate (cost = 1 - ncc)
    # depths per batch; 0 chooses it from the device's chunk budget
    depth_chunk: int = 0
    min_consistent: int = 2  # views that must agree in fusion
    max_depth_error: float = 0.01  # relative depth agreement for consistency
    max_normal_error_deg: float = 25.0
    # Bilaterally weighted NCC (patch_match.h:81-83): window pixels weighted
    # by spatial distance and color similarity to the window center.
    # sigma_color <= 0 disables (falls back to box-filter NCC).
    sigma_spatial: float = -1.0  # <=0 -> window_radius
    sigma_color: float = 0.2  # images in [0,1]
    # Geometric-consistency term (patch_match.h:101-111): forward-backward
    # reprojection error against prior source depth maps, capped and added
    # to the photometric cost with this relative weight.
    geom_regularizer: float = 0.3
    geom_max_cost: float = 3.0  # pixels


def _const(x: float, like: Tensor) -> Tensor:
    """A 0-dim f32 tensor on like's device: dividing by it is a true
    division on every device."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _mm3(A: Tensor, B: Tensor) -> Tensor:
    """A @ B for [..., 3, 3] operands, summed k = 0, 1, 2 elementwise."""
    return (
        A[..., :, 0:1] * B[..., 0:1, :]
        + A[..., :, 1:2] * B[..., 1:2, :]
        + A[..., :, 2:3] * B[..., 2:3, :]
    )


def _inv3(M: Tensor) -> Tensor:
    """Closed-form inverse of [..., 3, 3] (adjugate over the determinant)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = f * g - d * i
    C = d * h - e * g
    det = a * A + b * B + c * C
    adj = torch.stack(
        [
            torch.stack([A, c * h - b * i, b * f - c * e], -1),
            torch.stack([B, a * i - c * g, c * d - a * f], -1),
            torch.stack([C, b * g - a * h, a * e - b * d], -1),
        ],
        -2,
    )
    return adj / det[..., None, None]


def _apply3(M: Tensor, x: Tensor, y: Tensor, z: Tensor | None) -> list[Tensor]:
    """Rows of M [..., 3, 3] applied to the vector (x, y, z) of planes
    [..., H, W]; z None stands for ones. Summed k = 0, 1, 2."""
    out = []
    for j in range(3):
        m = [M[..., j, k, None, None] for k in range(3)]
        out.append(m[0] * x + m[1] * y + (m[2] if z is None else m[2] * z))
    return out


def _box_sum(x: Tensor, r: int) -> Tensor:
    """Windowed sum over (2r+1)^2 with zero padding ("SAME"): the taps are
    added to zero one by one in row-major order, as XLA's reduce_window
    adds them."""
    H, W = x.shape[-2:]
    xp = F.pad(x, (r, r, r, r))
    out = torch.zeros_like(x)
    for dy in range(2 * r + 1):
        for dx in range(2 * r + 1):
            out = out + xp[..., dy : dy + H, dx : dx + W]
    return out


def _warp_coords(Hm: Tensor, xx: Tensor, yy: Tensor) -> tuple[Tensor, Tensor]:
    """Per-ref-pixel source coordinates under 3x3 homographies Hm [..., 3, 3];
    xx, yy [H, W] the reference pixel grid."""
    q0, q1, q2 = _apply3(Hm, xx, yy, None)
    w = torch.where(torch.abs(q2) < 1e-8, _const(1e-8, q2), q2)
    return q0 / w, q1 / w


def _sample(src: Tensor, sx: Tensor, sy: Tensor) -> tuple[Tensor, Tensor]:
    """Bilinear sample of src [S, Hs, Ws] at (sx, sy) [..., S, H, W]: the
    corners clipped to the image first, then the fractions clipped to
    [0, 1]; valid from the unclipped coordinates. One flat int64 gather per
    corner. Returns (values, valid as f32)."""
    S, Hs, Ws = src.shape
    x0 = torch.clamp(torch.nan_to_num(torch.floor(sx), nan=0.0), 0, Ws - 1)
    y0 = torch.clamp(torch.nan_to_num(torch.floor(sy), nan=0.0), 0, Hs - 1)
    x1 = torch.clamp(x0 + 1, 0, Ws - 1)
    y1 = torch.clamp(y0 + 1, 0, Hs - 1)
    fx = torch.clamp(sx - x0, 0.0, 1.0)
    fy = torch.clamp(sy - y0, 0.0, 1.0)
    flat = src.reshape(-1)
    base = (torch.arange(S, device=src.device, dtype=torch.int64) * (Hs * Ws))[:, None, None]
    r0, r1 = base + y0.long() * Ws, base + y1.long() * Ws
    c0, c1 = x0.long(), x1.long()
    gx, gy = 1 - fx, 1 - fy
    v = (
        flat[r0 + c0] * gx * gy
        + flat[r0 + c1] * fx * gy
        + flat[r1 + c0] * gx * fy
        + flat[r1 + c1] * fx * fy
    )
    valid = (sx >= 0) & (sx <= Ws - 1) & (sy >= 0) & (sy <= Hs - 1)
    return v, valid.to(torch.float32)


def _plane_homography(K_ref_inv: Tensor, K_src: Tensor, R_rel: Tensor, t_rel: Tensor, depth: Tensor) -> Tensor:
    """Homographies ref->src [D, S, 3, 3] for the fronto-parallel planes at
    `depth` [D] in the reference frame: H = K_src (R + t n^T / d) K_ref^-1
    with n = (0, 0, 1)."""
    n = torch.zeros(3, dtype=depth.dtype, device=depth.device)
    n[2] = 1.0
    n_over_d = n[None, :] / depth[:, None]  # [D, 3]
    M = R_rel[None] + t_rel[None, :, :, None] * n_over_d[:, None, None, :]
    return _mm3(K_src[None], _mm3(M, K_ref_inv))


def _bilateral_ref_terms(ref: Tensor, opts: StereoOptions):
    """The reference-only pieces of bilaterally weighted NCC.

    Weight of window pixel at offset o from the center (patch_match.h:81-83):
        w_o = exp(-|o|^2 / (2 sigma_spatial^2)
                  - (I(p) - I(p+o))^2 / (2 sigma_color^2))
    Returns (offsets, w [K,H,W], w * ref_sh [K,H,W], Wsum, mu_r, var_r); the
    sums over K run in offset order."""
    r = opts.window_radius
    ss = opts.sigma_spatial if opts.sigma_spatial > 0 else float(r)
    sc = opts.sigma_color
    offs = [(dy, dx) for dy in range(-r, r + 1) for dx in range(-r, r + 1)]
    H, W = ref.shape
    rp = F.pad(ref[None, None], (r, r, r, r), mode="replicate")[0, 0]
    ws, rsh = [], []
    for dy, dx in offs:
        sref = rp[r + dy : r + dy + H, r + dx : r + dx + W]
        # in float64, rounded to f32 once: exp differs between the CPU's and
        # the card's f32 libraries, and the weights then equal on both
        diff = (ref - sref).double()
        arg = -(dy * dy + dx * dx) / (2.0 * ss * ss) - diff * diff / (2.0 * sc * sc)
        ws.append(torch.exp(arg).float())
        rsh.append(sref)
    Wsum = mu = mu2 = torch.zeros_like(ref)
    for w, s in zip(ws, rsh):
        Wsum = Wsum + w
        mu = mu + w * s
        mu2 = mu2 + w * s * s
    Wsum = torch.clamp(Wsum, min=1e-8)
    mu_r = mu / Wsum
    var_r = torch.clamp(mu2 / Wsum - mu_r * mu_r, min=1e-8)
    w = torch.stack(ws)
    return offs, w, w * torch.stack(rsh), Wsum, mu_r, var_r


def _bilateral_ncc_cost(warped: Tensor, wvalid: Tensor, bil, r: int) -> Tensor:
    """1 - bilaterally weighted zero-mean NCC over [..., H, W]. Invalid ->
    cost 2. The taps are added one by one in offset order."""
    offs, w, wr, Wsum, mu_r, var_r = bil
    H, W = warped.shape[-2:]
    lead = warped.shape[:-2]
    wp = F.pad(warped.reshape(-1, 1, H, W), (r, r, r, r), mode="replicate").reshape(*lead, H + 2 * r, W + 2 * r)
    vp = F.pad(wvalid.reshape(-1, 1, H, W), (r, r, r, r), mode="replicate").reshape(*lead, H + 2 * r, W + 2 * r)
    Ww = torch.zeros_like(warped)
    Www = torch.zeros_like(warped)
    Wrw = torch.zeros_like(warped)
    Wv = torch.zeros_like(warped)
    for k, (dy, dx) in enumerate(offs):
        sw = wp[..., r + dy : r + dy + H, r + dx : r + dx + W]
        sv = vp[..., r + dy : r + dy + H, r + dx : r + dx + W]
        a = w[k] * sw
        Ww.add_(a)
        Www.add_(a * sw)
        Wrw.add_(wr[k] * sw)
        Wv.add_(w[k] * sv)
    mu_w = Ww / Wsum
    var_w = torch.clamp(Www / Wsum - mu_w * mu_w, min=1e-8)
    cov = Wrw / Wsum - mu_r * mu_w
    ncc = cov / torch.sqrt(var_r * var_w)
    cost = 1.0 - torch.clamp(ncc, -1.0, 1.0)
    ok = Wv > 0.8 * Wsum
    return torch.where(ok, cost, _const(2.0, cost))


def _box_ref_terms(ref: Tensor, r: int):
    """The reference-only box sums of `_ncc_cost`: (s_r, s_rr)."""
    n = _const(float((2 * r + 1) ** 2), ref)
    return _box_sum(ref, r) / n, _box_sum(ref * ref, r) / n


def _ncc_cost(ref: Tensor, warped: Tensor, wvalid: Tensor, box, r: int) -> Tensor:
    """1 - zero-mean NCC over (2r+1)^2 windows. Invalid -> cost 2."""
    s_r, s_rr = box
    n = _const(float((2 * r + 1) ** 2), warped)
    s_w = _box_sum(warped, r) / n
    s_ww = _box_sum(warped * warped, r) / n
    s_rw = _box_sum(ref * warped, r) / n
    var_r = torch.clamp(s_rr - s_r * s_r, min=1e-8)
    var_w = torch.clamp(s_ww - s_w * s_w, min=1e-8)
    ncc = (s_rw - s_r * s_w) / torch.sqrt(var_r * var_w)
    cost = 1.0 - torch.clamp(ncc, -1.0, 1.0)
    ok = _box_sum(wvalid, r) > 0.8 * float((2 * r + 1) ** 2)
    return torch.where(ok, cost, _const(2.0, cost))


def depth_chunk(opts: StereoOptions, S: int, H: int, W: int, D: int, device: torch.device) -> int:
    """Depths per batch: opts.depth_chunk, or as many as the device's chunk
    budget holds beside the bilateral weights (w and w * ref, (2r+1)^2 f32
    [H, W] planes each), spread evenly over the fewest chunks."""
    if opts.depth_chunk > 0:
        return min(opts.depth_chunk, D)
    weights = 2 * (2 * opts.window_radius + 1) ** 2 * H * W * 4 if opts.sigma_color > 0 else 0
    per_depth = _SLICES_PER_DEPTH * S * H * W * 4
    most = max(1, (_CHUNK_BYTES.get(device.type, _CHUNK_BYTES["cpu"]) - weights) // per_depth)
    n_chunks = -(-D // most)
    return -(-D // n_chunks)


def plane_sweep(
    ref: Tensor,  # [H,W] grayscale
    srcs: Tensor,  # [S,Hs,Ws]
    K_ref: Tensor,  # [3,3]
    K_srcs: Tensor,  # [S,3,3]
    R_rel: Tensor,  # [S,3,3] ref-cam -> src-cam rotation
    t_rel: Tensor,  # [S,3]
    depths: Tensor,  # [D] hypothesis bank (e.g. inverse-depth spaced)
    opts: StereoOptions = StereoOptions(),
    src_depths: Tensor | None = None,  # [S,Hs,Ws] prior source depth maps
    use_geom: bool = False,
):
    """Returns (depth_map [H,W], cost_map [H,W], normal_map [H,W,3]) on the
    inputs' device.

    Normals are in the reference camera frame, unit, pointing toward the
    camera (negative z), from central depth differences that wrap around
    at the border (`torch.roll`, as the JAX package's `jnp.roll`).

    With use_geom=True and src_depths given, adds the geometric-consistency
    term (patch_match.h:101-111): the forward-backward reprojection error of
    each depth hypothesis against the source view's own depth map, capped at
    geom_max_cost px, weighted by geom_regularizer.
    """
    H, W = ref.shape
    S = srcs.shape[0]
    D = depths.shape[0]
    dev = ref.device
    K_ref_inv = _inv3(K_ref)
    r = opts.window_radius
    bilateral = opts.sigma_color > 0
    terms = _bilateral_ref_terms(ref, opts) if bilateral else _box_ref_terms(ref, r)
    yy, xx = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=dev),
        torch.arange(W, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    geom = use_geom and src_depths is not None
    K_src_inv = _inv3(K_srcs) if geom else None
    gmax = _const(opts.geom_max_cost, ref)
    k = min(opts.top_k, S)

    def geom_cost(sx, sy):
        """Forward-backward reprojection error vs the source depth maps."""
        d_s, dvalid = _sample(src_depths, sx, sy)
        # back-project the source pixel at its own depth, map to ref frame
        y_src = [c * d_s for c in _apply3(K_src_inv[None], sx, sy, None)]
        t = t_rel[None, :, :, None, None]
        y = [y_src[j] - t[:, :, j] for j in range(3)]
        Rt = R_rel.mT[None]  # R^T (y - t)
        y_ref = _apply3(Rt, *y)
        q = _apply3(K_ref[None, None], *y_ref)
        qz = torch.where(torch.abs(q[2]) < 1e-8, _const(1e-8, q[2]), q[2])
        ex = q[0] / qz - xx
        ey = q[1] / qz - yy
        err = torch.sqrt(ex * ex + ey * ey)
        ok = (dvalid > 0) & (d_s > 0) & (y_ref[2] > 0)
        return torch.where(ok, torch.minimum(err, gmax), gmax)

    def chunk_cost(d):
        """(total, photo) [Dc, H, W] for the depths d [Dc]."""
        Hm = _plane_homography(K_ref_inv, K_srcs, R_rel, t_rel, d)
        sx, sy = _warp_coords(Hm, xx, yy)  # [Dc, S, H, W]
        warped, wv = _sample(srcs, sx, sy)
        if bilateral:
            photo = _bilateral_ncc_cost(warped, wv, terms, r)
        else:
            photo = _ncc_cost(ref, warped, wv, terms, r)
        del warped, wv
        c = photo
        if geom:
            c = c + opts.geom_regularizer * geom_cost(sx, sy)
        # best-k sources by TOTAL cost, ties to the lowest source index (a
        # stable sort, as jax.lax.top_k takes them); the photometric part of
        # the same selection keeps min_ncc gating meaningful downstream
        c_sorted, idx = torch.sort(c, dim=1, stable=True)
        p_sorted = torch.gather(photo, 1, idx[:, :k])
        total, ph = c_sorted[:, 0], p_sorted[:, 0]
        for j in range(1, k):
            total = total + c_sorted[:, j]
            ph = ph + p_sorted[:, j]
        return total / k, ph / k

    geom_slack = opts.geom_regularizer * opts.geom_max_cost
    big = 2.0 + (geom_slack if use_geom else 0.0) + 1e-3
    best_cost = torch.full((H, W), big, dtype=torch.float32, device=dev)
    best_photo = torch.full((H, W), 2.0, dtype=torch.float32, device=dev)
    best_depth = depths[0].expand(H, W).clone()
    Dc = depth_chunk(opts, S, H, W, D, dev)
    for d0 in range(0, D, Dc):
        d = depths[d0 : d0 + Dc]
        c, p = chunk_cost(d)
        # the first depth of the chunk at its least cost, then a strict <
        # against the running best: the scan's rule, first depth among equals
        i = torch.argmin(c, dim=0, keepdim=True)
        ci = torch.gather(c, 0, i)[0]
        upd = ci < best_cost
        best_cost = torch.where(upd, ci, best_cost)
        best_photo = torch.where(upd, torch.gather(p, 0, i)[0], best_photo)
        best_depth = torch.where(upd, d[i[0]], best_depth)
    best_cost = best_photo  # the photometric cost of the chosen depth

    # normals from depth gradients: z(x, y) plane fit in camera coords
    fx = K_ref[0, 0]
    fy = K_ref[1, 1]
    half = _const(0.5, ref)
    dzdx = (torch.roll(best_depth, -1, 1) - torch.roll(best_depth, 1, 1)) * half
    dzdy = (torch.roll(best_depth, -1, 0) - torch.roll(best_depth, 1, 0)) * half
    zc = torch.clamp(best_depth, min=1e-6)
    n0 = -dzdx * fx / zc
    n1 = -dzdy * fy / zc
    n2 = torch.ones_like(best_depth)
    nrm = torch.clamp(torch.sqrt(n0 * n0 + n1 * n1 + n2 * n2), min=1e-12)
    n = -torch.stack([n0 / nrm, n1 / nrm, n2 / nrm], -1)  # toward the camera (-z)
    return best_depth, best_cost, n


def consistency_mask(
    depth_ref: Tensor,  # [H,W]
    cost_ref: Tensor,
    depths_other: Tensor,  # [V,H,W] other views' depth maps
    K: Tensor,  # [3,3] shared intrinsics (undistorted workspace)
    R_to_other: Tensor,  # [V,3,3] ref-cam -> other-cam
    t_to_other: Tensor,  # [V,3]
    opts: StereoOptions = StereoOptions(),
) -> Tensor:
    """Geometric consistency: a ref depth is kept if >= min_consistent other
    views see a compatible depth at the reprojected pixel (fusion semantics,
    mvs/fusion.cc). The depth gate is max_depth_error * 10, as the JAX
    package has it."""
    H, W = depth_ref.shape
    V = depths_other.shape[0]
    dev = depth_ref.device
    yy, xx = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=dev),
        torch.arange(W, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    x_ref = [c * depth_ref for c in _apply3(_inv3(K), xx, yy, None)]  # ref-camera coords
    count = torch.zeros((H, W), dtype=torch.int32, device=dev)
    flat = depths_other.reshape(V, -1)
    gate = opts.max_depth_error * 10
    for v in range(V):
        x_o = _apply3(R_to_other[v], *x_ref)
        x_o = [x_o[j] + t_to_other[v, j] for j in range(3)]
        z_o = x_o[2]
        uv = _apply3(K, *x_o)
        w = torch.where(torch.abs(uv[2]) < 1e-8, _const(1e-8, uv[2]), uv[2])
        u = uv[0] / w
        vv = uv[1] / w
        # torch.round, like jnp.round, rounds half to even
        ui = torch.clamp(torch.nan_to_num(torch.round(u), nan=0.0), 0, W - 1).long()
        vi = torch.clamp(torch.nan_to_num(torch.round(vv), nan=0.0), 0, H - 1).long()
        d_o = flat[v][vi * W + ui]
        rel = torch.abs(d_o - z_o) / torch.clamp(z_o, min=1e-6)
        ok = (z_o > 0) & (u >= 0) & (u <= W - 1) & (vv >= 0) & (vv <= H - 1) & (rel < gate)
        count = count + ok.to(torch.int32)
    photometric = cost_ref < (1.0 - opts.min_ncc)
    return (count >= opts.min_consistent) & photometric
