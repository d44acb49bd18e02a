"""SIFT feature extraction as batched PyTorch ops.

Port of colmap_pcd_tpu/ops/sift.py (which replaces lib/VLFeat's CPU SIFT and
lib/SiftGPU, src/feature/sift.cc ExtractSiftFeaturesCPU/GPU): the classic
pipeline (Gaussian scale space, DoG extrema, edge/peak gates, subpixel
refinement, orientation histogram, 4x4x8 gradient descriptor) with every
stage a dense fixed-shape tensor op over a batch of images [B,H,W]:

  * scale space: separable shift-and-add stencils with a zero boundary
  * extrema: 3x3x3 max/min pooling over the DoG stack, compared to center
  * candidate selection: top-k over the masked |DoG| score map (fixed K per
    octave), in a fixed order among equal scores (lowest index first)
  * subpixel refine: closed-form 3x3 solves from gathered finite differences
  * orientation: 36-bin histograms as a masked sum over gathered patches
  * descriptor: 16x16 sample grid, rotated, trilinearly binned into 4x4x8
    by one matrix product, normalized with the L1_ROOT convention
    (sift.h:108 Normalization)

Nothing here scatters with atomics, so one input gives the same bytes on
every run of one device. float32 throughout (the one matrix product runs
under the package's numerics policy, TF32 off), except the gradient corner
table, which stores
magnitude and angle in bfloat16 as the JAX package does.

Options mirror SiftExtractionOptions (src/feature/sift.h:44-114).
Keypoints are (x, y, scale, orientation) in original-image pixel coords
with array indexing coords (the pixel-center offset of 0.5 is not applied).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .solvers import solve3

Tensor = torch.Tensor


class SiftOptions(NamedTuple):
    max_num_features: int = 8192
    num_octaves: int = 4
    octave_resolution: int = 3  # S: DoG levels per octave used for detection
    first_octave: int = -1  # -1 = 2x upsample (VLFeat/COLMAP default)
    peak_threshold: float = 0.02 / 3.0  # on DoG values (sift.h:73)
    edge_threshold: float = 10.0
    sigma0: float = 1.6
    init_blur: float = 0.5  # assumed camera blur
    max_per_octave: int = 4096
    upright: bool = False
    l1_root: bool = True  # L1_ROOT descriptor normalization (COLMAP default)
    # DSP-SIFT domain-size pooling (sift.h:102-113; default off as in COLMAP)
    domain_size_pooling: bool = False
    dsp_min_scale: float = 1.0 / 6.0
    dsp_max_scale: float = 3.0
    dsp_num_scales: int = 10
    # affine shape adaptation (sift.h:98-100 estimate_affine_shape; VLFeat
    # covariant detector): iterate the gradient second-moment matrix to an
    # isotropic frame, then sample orientation + descriptor through the
    # affine transform. Default off as in COLMAP.
    estimate_affine_shape: bool = False
    affine_iterations: int = 3


def _gauss_kernel(sigma: float) -> np.ndarray:
    r = max(1, int(np.ceil(3.0 * sigma)))
    x = np.arange(-r, r + 1)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _blur(img: Tensor, sigma: float) -> Tensor:
    """Separable Gaussian blur over the last two axes, [...,H,W] -> [...,H,W]
    (zero boundary): the row pass, then the column pass.

    A shift-and-add stencil whose taps are Python floats, summed in tap
    order with one rounding per product and per sum, as the JAX package
    writes it. A convolution call computes the same sums in an order that
    the library picks from the batch's shape (measured on the CPU build: a
    batch of two differs from its images blurred singly by 6e-8), so a
    batch would not equal its single extractions; these elementwise ops do
    not depend on the batch, nor on the device."""
    if sigma < 1e-6:
        return img
    k = [float(v) for v in _gauss_kernel(sigma)]
    r = len(k) // 2
    H, W = img.shape[-2:]
    xp = F.pad(img, (r, r))
    x = k[0] * xp[..., 0:W]
    for t in range(1, len(k)):
        x += k[t] * xp[..., t : t + W]
    xp = F.pad(x, (0, 0, r, r))
    x = k[0] * xp[..., 0:H, :]
    for t in range(1, len(k)):
        x += k[t] * xp[..., t : t + H, :]
    return x


def _downsample2(img: Tensor) -> Tensor:
    return img[..., ::2, ::2]


def _upsample2(img: Tensor) -> Tensor:
    """[...,H,W] -> [...,2H,2W], bilinear with half-pixel centers and the
    edge pixel repeated (as jax.image.resize "bilinear")."""
    H, W = img.shape[-2:]
    x = F.interpolate(
        img.reshape(-1, 1, H, W), size=(2 * H, 2 * W), mode="bilinear",
        align_corners=False, antialias=False,
    )
    return x.reshape(img.shape[:-2] + (2 * H, 2 * W))


def _lay_out(planes: list[Tensor]) -> tuple[Tensor, Tensor, Tensor]:
    """Lay the levels of all octaves end to end.

    planes: per octave [B,L,H_o,W_o] (or [B,L,H_o,W_o,C]). Returns
    (flat [B,R] or [B,R,C], base [sum L] int64, width [sum L] int64): level
    l (counted through the octaves) holds pixel (y, x) at row
    base[l] + y * width[l] + x. The JAX package pads every octave to the
    base plane instead, so that one gather serves all at fixed shapes; the
    rows a keypoint may read are the same, at about a third of the memory."""
    B = planes[0].shape[0]
    base, width, flat, row = [], [], [], 0
    for p in planes:
        L, H, W = p.shape[1:4]
        base += [row + lvl * H * W for lvl in range(L)]
        width += [W] * L
        row += L * H * W
        flat.append(p.reshape((B, L * H * W) + tuple(p.shape[4:])))
    dev = planes[0].device
    return (
        torch.cat(flat, dim=1),
        torch.as_tensor(base, dtype=torch.int64, device=dev),
        torch.as_tensor(width, dtype=torch.int64, device=dev),
    )


def _corner_rows(table: Tensor, xy: Tensor, row0: Tensor, width: Tensor, wh):
    """Shared front half of `_bilinear` and `_bilinear_ma`: the rows of the
    flat table [B,R,...] at each sample's upper-left corner (clamped into
    the keypoint's plane), the fractional offsets and the in-bounds mask.

    xy [B,K,P,2]; row0, width [B,K] (the keypoint's level, from `_lay_out`);
    wh = (wlim, hlim) [B,K], the last valid column and row of that level."""
    B, R = table.shape[:2]
    x, y = xy[..., 0], xy[..., 1]
    wmax, hmax = wh[0][..., None], wh[1][..., None]
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    x0i = torch.minimum(x0.long().clamp(min=0), wmax)
    y0i = torch.minimum(y0.long().clamp(min=0), hmax)
    inb = (x >= 0) & (x <= wmax) & (y >= 0) & (y <= hmax)
    # int64 rows: a 2x-upsampled first octave of a large input passes 2^31
    batch0 = torch.arange(B, device=table.device)[:, None, None] * R
    rows = batch0 + row0[..., None] + y0i * width[..., None] + x0i
    return rows, x0i, y0i, fx, fy, inb


def _bilinear(flat: Tensor, xy: Tensor, row0: Tensor, width: Tensor, wh) -> Tensor:
    """Bilinear sample of the flat level planes [B,R] at xy [B,K,P,2] (x, y)
    on each keypoint's own level; zero outside. The x+1 / y+1 corners are
    clamped into the plane (they carry zero weight there)."""
    B, R = flat.shape
    rows, x0i, y0i, fx, fy, inb = _corner_rows(flat, xy, row0, width, wh)
    wmax, hmax = wh[0][..., None], wh[1][..., None]
    dx = (torch.minimum(x0i + 1, wmax) - x0i)
    dy = (torch.minimum(y0i + 1, hmax) - y0i) * width[..., None]
    src = flat.reshape(B * R)

    def at(r):
        return src[r.reshape(-1)].reshape(r.shape)

    v = (
        at(rows) * (1 - fx) * (1 - fy)
        + at(rows + dx) * fx * (1 - fy)
        + at(rows + dy) * (1 - fx) * fy
        + at(rows + dy + dx) * fx * fy
    )
    return v * inb


def _pack_bilinear_table(mag: Tensor, ang: Tensor) -> Tensor:
    """[...,H,W] mag/ang -> packed [...,H,W,8] corner table with rows
    [m00,a00,m01,a01,m10,a10,m11,a11] (01 = x+1 shift, 10 = y+1 shift,
    zero beyond the edge), so one bilinear sample is one contiguous 16-byte
    row gather instead of 8 scalar gathers.

    bfloat16 storage halves the table, which is 4x the mag/ang planes it
    replaces; descriptor binning tolerates the ~0.4% relative error (8
    orientation bins of width pi/4; weights recompute in f32 at sample
    time). Round-to-nearest-even, as in the JAX package."""
    Fm = torch.stack([mag, ang], -1).to(torch.bfloat16)  # [...,H,W,2]
    Fx = F.pad(Fm, (0, 0, 0, 1))[..., 1:, :]
    F4 = torch.cat([Fm, Fx], -1)  # [...,H,W,4]
    Fy = F.pad(F4, (0, 0, 0, 0, 0, 1))[..., 1:, :, :]
    return torch.cat([F4, Fy], -1)  # [...,H,W,8]


def _bilinear_ma(F8: Tensor, xy: Tensor, row0: Tensor, width: Tensor, wh) -> tuple[Tensor, Tensor]:
    """Bilinear (mag, ang) from the flat packed corner table [B,R,8]; zero
    outside.

    Exactly `_bilinear`'s math: corner x1/y1 reads beyond a keypoint's valid
    extent only ever carry zero weight (fx/fy = 0 at the boundary, inb = 0
    outside), so the packed zero-padded neighbors match clamped re-reads
    wherever the weight is nonzero. The angle is interpolated across the
    +-pi wrap as in the JAX package."""
    B, R = F8.shape[:2]
    rows, _, _, fx, fy, inb = _corner_rows(F8, xy, row0, width, wh)
    g = F8.reshape(B * R, 8).index_select(0, rows.reshape(-1)).float().reshape(rows.shape + (8,))
    w00 = (1 - fx) * (1 - fy)
    w01 = fx * (1 - fy)
    w10 = (1 - fx) * fy
    w11 = fx * fy
    m = g[..., 0] * w00 + g[..., 2] * w01 + g[..., 4] * w10 + g[..., 6] * w11
    a = g[..., 1] * w00 + g[..., 3] * w01 + g[..., 5] * w10 + g[..., 7] * w11
    return m * inb, a * inb


def _shift2d(x: Tensor, dy: int, dx: int) -> Tensor:
    """out[..., y, x] = x[..., y+dy, x+dx], zeros outside."""
    H, W = x.shape[-2:]
    xp = F.pad(x, (1, 1, 1, 1))
    return xp[..., 1 + dy : 1 + dy + H, 1 + dx : 1 + dx + W]


def _extrema_candidates(dog: Tensor, opts: SiftOptions) -> Tensor:
    """dog [B,S+2,H,W] -> per-level extrema score map [B,S,H,W] (0 = not)."""
    H, W = dog.shape[-2:]
    # 3x3x3 max/min pools; max_pool3d pads with -inf
    mx = F.max_pool3d(dog[:, None], 3, stride=1, padding=1)[:, 0]
    mn = -F.max_pool3d(-dog[:, None], 3, stride=1, padding=1)[:, 0]
    center = dog[:, 1:-1]
    is_max = (center >= mx[:, 1:-1]) & (center > opts.peak_threshold)
    is_min = (center <= mn[:, 1:-1]) & (center < -opts.peak_threshold)

    # edge response gate on the spatial Hessian (borders are excluded by the
    # margin below, so the zero boundary of _shift2d is inert)
    dxx = _shift2d(center, 0, 1) + _shift2d(center, 0, -1) - 2 * center
    dyy = _shift2d(center, 1, 0) + _shift2d(center, -1, 0) - 2 * center
    dxy = 0.25 * (
        _shift2d(center, 1, 1)
        + _shift2d(center, -1, -1)
        - _shift2d(center, 1, -1)
        - _shift2d(center, -1, 1)
    )
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    r = opts.edge_threshold
    edge_ok = (det > 0) & (tr * tr * r < (r + 1) ** 2 * det)

    # exclude the image border
    ys = torch.arange(H, device=dog.device)[:, None]
    xs = torch.arange(W, device=dog.device)[None, :]
    b = 5
    inb = (ys >= b) & (ys < H - b) & (xs >= b) & (xs < W - b)

    return torch.abs(center) * ((is_max | is_min) & edge_ok & inb)


def _top_k(score: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """Top k of each row of score [B,N], highest first and, among equal
    scores, lowest index first (the order `jax.lax.top_k` returns;
    `torch.topk` promises none), so that the rows written to a database do
    not depend on the device's scheduling."""
    top, idx = torch.topk(score, k, dim=-1)
    idx, by_index = torch.sort(idx, dim=-1, stable=True)
    top, by_score = torch.sort(top.gather(-1, by_index), dim=-1, descending=True, stable=True)
    return top, idx.gather(-1, by_score)


def _affine_shape(gx, gy, kx, ky, sigma_rel, opts, row0, width, wh):
    """Affine shape adaptation: per-keypoint 2x2 transform A (det 1) that
    isotropizes the local gradient second-moment matrix (VLFeat covariant
    frames backing sift.cc:650 ExtractCovariantSiftFeaturesCPU). Fixed
    iteration count, batched over keypoints. gx, gy are flat planes [B,R]."""
    dev = kx.device
    P = 12
    lin = torch.linspace(-1.0, 1.0, P, device=dev)
    gyg, gxg = torch.meshgrid(lin, lin, indexing="ij")
    offs = torch.stack([gxg.reshape(-1), gyg.reshape(-1)], -1)  # [P*P,2]
    d2 = torch.sum(offs * offs, -1)
    w = torch.exp(-d2 / (2 * 0.5**2)) * (d2 <= 1.0)  # [P*P]
    win_r = 3.0 * 1.5 * sigma_rel  # [B,K]
    A = torch.eye(2, device=dev).expand(kx.shape + (2, 2))
    center = torch.stack([kx, ky], -1)[..., None, :]

    for _ in range(opts.affine_iterations):
        world = torch.einsum("bkij,pj->bkpi", A, offs) * win_r[..., None, None]
        coords = center + world
        gxs = _bilinear(gx, coords, row0, width, wh)  # [B,K,P*P]
        gys = _bilinear(gy, coords, row0, width, wh)
        m00 = torch.sum(w * gxs * gxs, -1)
        m01 = torch.sum(w * gxs * gys, -1)
        m11 = torch.sum(w * gys * gys, -1)
        # inverse square root of M = [[m00,m01],[m01,m11]] (closed form 2x2):
        # sqrtm(M) = (M + s I) / t, inverted through its adjugate
        tr = m00 + m11
        det = torch.clamp(m00 * m11 - m01 * m01, min=1e-18)
        s = torch.sqrt(det)
        t = torch.sqrt(torch.clamp(tr + 2.0 * s, min=1e-18))
        r00 = (m00 + s) / t
        r01 = m01 / t
        r11 = (m11 + s) / t
        dr = torch.clamp(r00 * r11 - r01 * r01, min=1e-18)
        i00 = r11 / dr
        i01 = -r01 / dr
        i11 = r00 / dr
        Minv_sqrt = torch.stack(
            [torch.stack([i00, i01], -1), torch.stack([i01, i11], -1)], -2
        )  # [B,K,2,2]
        # normalize to det 1 so scale stays owned by sigma
        dd = torch.sqrt(torch.clamp(i00 * i11 - i01 * i01, min=1e-18))
        Minv_sqrt = Minv_sqrt / dd[..., None, None]
        A = torch.einsum("bkij,bkjl->bkil", A, Minv_sqrt)
        # guard against degenerate windows (flat texture): keep A bounded
        norm = torch.sqrt(torch.sum(A * A, dim=(-2, -1), keepdim=True))
        A = torch.where(norm > 4.0, A * (4.0 / norm), A)
    return A


def _orientation_and_descriptor(G, kx, ky, sigma_rel, opts, lidx, wh):
    """Dominant orientation and 128-d descriptor for keypoints sampled on
    their own gaussian level (sift.cc:418-650 semantics: VLFeat computes
    gradients on the keypoint's scale level).

    G is the level stack [B,L,H,W], or a list of such stacks, one per
    octave, whose levels count on through the list. kx/ky [B,K] are
    coordinates at the keypoint's octave resolution, sigma_rel [B,K],
    lidx [B,K] the keypoint's level, wh = (wlim, hlim) [B,K] the last valid
    column and row of that level's plane. Returns (ori [B,K], desc
    [B,K,128])."""
    stacks = [G] if isinstance(G, Tensor) else list(G)
    dev = kx.device
    B, K = kx.shape
    # gradient maps per level: central differences, zero at the base
    # plane's borders (detection enforces a border margin)
    tables, gxs, gys = [], [], []
    H0, W0 = stacks[0].shape[-2:]
    for St in stacks:
        H, W = St.shape[-2:]
        # The JAX package pads every octave's plane with zeros to the base
        # plane before it takes the differences, so the last column and row
        # of a smaller plane get the gradient towards that zero, and no
        # zero gradient as the base plane's border does. Carried, so that
        # both packages compute the same descriptors near those edges.
        St = F.pad(St, (0, int(W < W0), 0, int(H < H0)))
        gx = F.pad(0.5 * (St[..., :, 2:] - St[..., :, :-2]), (1, 1))[..., :H, :W]
        gy = F.pad(0.5 * (St[..., 2:, :] - St[..., :-2, :]), (0, 0, 1, 1))[..., :H, :W]
        mag = torch.sqrt(gx * gx + gy * gy)
        ang = torch.atan2(gy, gx)  # [-pi, pi]
        tables.append(_pack_bilinear_table(mag, ang))
        if opts.estimate_affine_shape:
            gxs.append(gx)
            gys.append(gy)
    F8, base, width = _lay_out(tables)
    del tables
    lidx = lidx.long()
    row0, width_k = base[lidx], width[lidx]
    wh = (wh[0].long(), wh[1].long())
    center = torch.stack([kx, ky], -1)[..., None, :]  # [B,K,1,2]

    aff = None
    if opts.estimate_affine_shape:
        aff = _affine_shape(
            _lay_out(gxs)[0], _lay_out(gys)[0], kx, ky, sigma_rel, opts, row0, width_k, wh
        )
        del gxs, gys

    # ---- orientation: 36-bin histogram over a radius 3*1.5*sigma window ----
    P = 16  # patch sample grid (PxP) over [-r, r]
    win_r = 3.0 * 1.5 * sigma_rel  # [B,K]
    lin = torch.linspace(-1.0, 1.0, P, device=dev)
    gyg, gxg = torch.meshgrid(lin, lin, indexing="ij")
    offs = torch.stack([gxg.reshape(-1), gyg.reshape(-1)], -1)  # [P*P,2] in [-1,1]
    offs_k = torch.einsum("bkij,pj->bkpi", aff, offs) if aff is not None else offs
    coords = center + offs_k * win_r[..., None, None]  # [B,K,P*P,2]
    m, a = _bilinear_ma(F8, coords, row0, width_k, wh)
    d2 = torch.sum(offs * offs, dim=-1)  # normalized radius^2
    gw = torch.exp(-d2 / (2 * 0.5**2)) * (d2 <= 1.0)
    w = m * gw
    bins = torch.floor((a + math.pi) / (2 * math.pi) * 36).long() % 36
    # one compare against the bin numbers and one sum over the patch: the
    # order of the sum is fixed, which an atomic scatter's is not
    bin_ids = torch.arange(36, device=dev)[:, None]
    hist = torch.where(bins[..., None, :] == bin_ids, w[..., None, :], 0.0).sum(-1)  # [B,K,36]
    # circular smoothing x2
    for _ in range(2):
        hist = (torch.roll(hist, 1, -1) + hist + torch.roll(hist, -1, -1)) / 3.0
    peak = torch.argmax(hist, dim=-1, keepdim=True)
    # parabolic peak interpolation
    hp = hist.gather(-1, peak)[..., 0]
    hl = hist.gather(-1, (peak - 1) % 36)[..., 0]
    hr = hist.gather(-1, (peak + 1) % 36)[..., 0]
    denom = hl - 2 * hp + hr
    safe = torch.where(denom.abs() > 1e-9, denom, torch.ones_like(denom))
    dbin = torch.where(denom.abs() > 1e-9, 0.5 * (hl - hr) / safe, torch.zeros_like(denom))
    ori = (peak[..., 0].float() + dbin + 0.5) * (2 * math.pi / 36) - math.pi
    if opts.upright:
        ori = torch.zeros_like(ori)

    # ---- descriptor: 16x16 samples over 4x4 bins, rotated by ori -----------
    D = 16
    lin = (torch.arange(D, device=dev) + 0.5) / D * 2.0 - 1.0  # [-1,1]
    sy, sx = torch.meshgrid(lin, lin, indexing="ij")
    soff = torch.stack([sx.reshape(-1), sy.reshape(-1)], -1)  # [D*D,2]
    co, si = torch.cos(ori), torch.sin(ori)
    rot = torch.stack([torch.stack([co, -si], -1), torch.stack([si, co], -1)], -2)  # [B,K,2,2]
    gw = torch.exp(-torch.sum(soff * soff, -1) / (2 * 0.6**2))

    # trilinear binning weights: spatial (4x4) from soff, orientation (8)
    def spatial_weights(c):  # c in [-1,1] -> 4 bins at centers -0.75..0.75
        centers = torch.tensor([-0.75, -0.25, 0.25, 0.75], device=dev)
        return torch.clamp(1.0 - torch.abs(c[..., None] - centers) / 0.5, min=0.0)  # [...,4]

    wxs = spatial_weights(soff[:, 0])  # [DD,4]
    wys = spatial_weights(soff[:, 1])  # [DD,4]
    w_yx = (wys[:, :, None] * wxs[:, None, :]).reshape(D * D, 16)  # [DD, (yb,xb)]
    ori_ids = torch.arange(8, device=dev)[:, None]

    samp = rot if aff is None else torch.einsum("bkij,bkjl->bkil", aff, rot)

    def raw_descriptor(half):
        """Unnormalized 128-d histogram sampled at window half-size `half`
        (spacing 3*sigma -> half = 2*3*sigma at scale 1)."""
        world_off = torch.einsum("bkij,pj->bkpi", samp, soff) * half[..., None, None]
        m, a = _bilinear_ma(F8, center + world_off, row0, width_k, wh)  # [B,K,DD]
        a = a - ori[..., None]
        w = m * gw
        af = (a + math.pi) / (2 * math.pi) * 8.0
        fl = torch.floor(af)
        b0 = (fl.long() % 8)[..., None, :]  # [B,K,1,DD]
        fb = (af - fl)[..., None, :]
        w = w[..., None, :]
        # wo[b,k,o,p]: the sample's weight split between orientation bins b0
        # and b0 + 1
        wo = torch.where(ori_ids == b0, w * (1 - fb), 0.0) + torch.where(
            ori_ids == (b0 + 1) % 8, w * fb, 0.0
        )  # [B,K,8,DD]
        # desc[b,k,yb,xb,o] = sum_p wo[b,k,o,p] * wys[p,yb] * wxs[p,xb]: one
        # [B*K*8, 256] x [256, 16] product
        return torch.matmul(wo, w_yx).transpose(-1, -2).reshape(B, K, 128)

    base_half = 2.0 * 3.0 * sigma_rel  # [B,K]
    if opts.domain_size_pooling:
        # DSP-SIFT (sift.h:102-113 / sift.cc:650): pool raw descriptors over
        # a range of domain sizes before normalization
        scales = np.linspace(opts.dsp_min_scale, opts.dsp_max_scale, opts.dsp_num_scales)
        desc = torch.stack([raw_descriptor(base_half * float(s)) for s in scales]).mean(0)
    else:
        desc = raw_descriptor(base_half)
    # normalize: L2 -> clip 0.2 -> L2; then L1-root if configured
    desc = desc / torch.clamp(torch.linalg.vector_norm(desc, dim=-1, keepdim=True), min=1e-12)
    desc = torch.clamp(desc, max=0.2)
    desc = desc / torch.clamp(torch.linalg.vector_norm(desc, dim=-1, keepdim=True), min=1e-12)
    if opts.l1_root:
        desc = torch.sqrt(desc / torch.clamp(torch.sum(desc, -1, keepdim=True), min=1e-12))
    return ori, desc


def _detect(images: Tensor, opts: SiftOptions):
    """The detection half of `extract_batch`: scale space, extrema, subpixel
    refinement and the selection of the K best candidates over all octaves.

    Returns (Gs, kx, ky, sigma_rel, lev, wh, mul, top, valid): the level
    stacks per octave [B,S+3,H_o,W_o] and, per selected keypoint [B,K'],
    its coordinates and scale at its octave's resolution, its level counted
    through the octaves, the last valid (column, row) of that level, the
    octave's pixel size in image pixels, its score and validity (K' =
    min(K, candidates))."""
    S = opts.octave_resolution
    img = images.float()
    if images.dtype == torch.uint8:
        # the extraction pipeline uploads uint8 and normalizes here
        img = img * (1.0 / 255.0)
    B = img.shape[0]
    dev = img.device

    if opts.first_octave < 0:
        base = _upsample2(img)
        scale0 = 0.5
        extra_blur = np.sqrt(max(opts.sigma0**2 - (2 * opts.init_blur) ** 2, 0.01))
    else:
        base = img
        scale0 = 1.0
        extra_blur = np.sqrt(max(opts.sigma0**2 - opts.init_blur**2, 0.01))
    base = _blur(base, float(extra_blur))

    # Detection runs per octave on max_per_octave candidates, but the
    # expensive part (orientation + descriptor, ~512 bilinear gathers per
    # keypoint) runs ONCE at the end, only for the globally selected
    # max_num_features keypoints, over all octaves' gaussian levels.
    cand = []  # per octave dicts of candidate tensors [B,Ko]
    Gs = []  # per octave level stacks [B,S+3,H,W]
    octave_img = base
    for o in range(opts.num_octaves):
        H, W = octave_img.shape[-2:]
        if H < 16 or W < 16:
            break
        # gaussian levels: sigma_s = sigma0 * 2^(s/S), s = 0..S+2
        levels = [octave_img]
        for s in range(1, S + 3):
            sig_prev = opts.sigma0 * 2 ** ((s - 1) / S)
            sig_cur = opts.sigma0 * 2 ** (s / S)
            levels.append(_blur(levels[-1], float(np.sqrt(sig_cur**2 - sig_prev**2))))
        G = torch.stack(levels, 1)  # [B,S+3,H,W]
        dog = G[:, 1:] - G[:, :-1]  # [B,S+2,H,W]

        score = _extrema_candidates(dog, opts)  # [B,S,H,W]
        flat = score.reshape(B, -1)
        top, idx = _top_k(flat, min(opts.max_per_octave, flat.shape[1]))
        valid = top > 0
        s_idx = idx // (H * W)
        rem = idx % (H * W)
        yi = rem // W
        xi = rem % W

        # subpixel refinement via gathered 3D finite differences
        si = s_idx + 1  # index into dog
        dog_flat = dog.reshape(B, -1)

        def at(ds, dy, dx):
            return dog_flat.gather(1, (
                (si + ds).clamp(0, S + 1) * H + (yi + dy).clamp(0, H - 1)
            ) * W + (xi + dx).clamp(0, W - 1))

        v = at(0, 0, 0)
        sp, sm = at(1, 0, 0), at(-1, 0, 0)
        yp, ym = at(0, 1, 0), at(0, -1, 0)
        xp, xm = at(0, 0, 1), at(0, 0, -1)
        gs = 0.5 * (sp - sm)
        gy = 0.5 * (yp - ym)
        gx = 0.5 * (xp - xm)
        hss = sp + sm - 2 * v
        hyy = yp + ym - 2 * v
        hxx = xp + xm - 2 * v
        hsy = 0.25 * (at(1, 1, 0) - at(1, -1, 0) - at(-1, 1, 0) + at(-1, -1, 0))
        hsx = 0.25 * (at(1, 0, 1) - at(1, 0, -1) - at(-1, 0, 1) + at(-1, 0, -1))
        hyx = 0.25 * (at(0, 1, 1) - at(0, 1, -1) - at(0, -1, 1) + at(0, -1, -1))
        Hm = torch.stack(
            [
                torch.stack([hss + 1e-6, hsy, hsx], -1),
                torch.stack([hsy, hyy + 1e-6, hyx], -1),
                torch.stack([hsx, hyx, hxx + 1e-6], -1),
            ],
            -2,
        )  # [B,Ko,3,3]
        g = torch.stack([gs, gy, gx], -1)
        # closed form instead of a batched LU: no library call, no host sync
        off = torch.clamp(-solve3(Hm, g), -1.0, 1.0)  # [B,Ko,3] (ds, dy, dx)
        ds, dy, dx = off[..., 0], off[..., 1], off[..., 2]

        kx = xi.float() + dx
        ky = yi.float() + dy
        sfrac = s_idx.float() + 1.0 + ds  # dog level
        sigma_rel = opts.sigma0 * 2 ** (sfrac / S)  # at octave resolution

        # each keypoint's own gaussian level: sigma(G[s]) = sigma0 * 2^(s/S)
        # so the nearest level is round(sfrac)
        lidx = torch.round(sfrac).long().clamp(0, S + 2)

        cand.append(dict(
            score=torch.where(valid, top, torch.zeros_like(top)),
            kx=kx, ky=ky, sigma_rel=sigma_rel,
            lev=o * (S + 3) + lidx,
            mul=torch.full_like(kx, scale0 * (2.0**o)),
            wlim=torch.full_like(lidx, W - 1),
            hlim=torch.full_like(lidx, H - 1),
            valid=valid,
        ))
        Gs.append(G)

        octave_img = _downsample2(G[:, S])  # next octave base: level S (2x sigma0)

    def cat(key):
        return torch.cat([c[key] for c in cand], dim=1)

    score = cat("score")
    K = opts.max_num_features
    top, idx = _top_k(score, min(K, score.shape[1]))

    def pick(key):
        return cat(key).gather(1, idx)

    sel_valid = pick("valid") & (top > 0)
    return (
        Gs, pick("kx"), pick("ky"), pick("sigma_rel"), pick("lev"),
        (pick("wlim"), pick("hlim")), pick("mul"), top, sel_valid,
    )


def extract_batch(images: Tensor, opts: SiftOptions = SiftOptions()):
    """images [B,H,W], float32 in [0,1] or uint8 -> (keypoints [B,K,4],
    descriptors [B,K,128], scores [B,K], valid [B,K] bool), K =
    opts.max_num_features, on the device of `images`. Every image of the
    batch is computed for itself: the result equals B calls of `extract`."""
    Gs, kx, ky, sigma_rel, lev, wh, mul, top, sel_valid = _detect(images, opts)
    ori, desc = _orientation_and_descriptor(Gs, kx, ky, sigma_rel, opts, lidx=lev, wh=wh)
    sel_kp = torch.stack([kx * mul, ky * mul, sigma_rel * mul, ori], -1)

    K = opts.max_num_features
    if sel_kp.shape[1] < K:
        pad = K - sel_kp.shape[1]
        sel_kp = F.pad(sel_kp, (0, 0, 0, pad))
        desc = F.pad(desc, (0, 0, 0, pad))
        top = F.pad(top, (0, pad))
        sel_valid = F.pad(sel_valid, (0, pad))
    return sel_kp, desc, top, sel_valid


def extract(image: Tensor, opts: SiftOptions = SiftOptions()):
    """image [H,W] float32 in [0,1] or uint8 -> (keypoints [K,4], descriptors
    [K,128], scores [K], valid [K] bool): `extract_batch` of one image."""
    kp, desc, score, valid = extract_batch(image[None], opts)
    return kp[0], desc[0], score[0], valid[0]


def descriptors_to_uint8(desc: Tensor) -> Tensor:
    """COLMAP convention: float descriptor * 512, clipped to [0,255]
    (`torch.round` rounds half to even, as `jnp.round` does)."""
    return torch.clamp(torch.round(desc * 512.0), 0, 255).to(torch.uint8)
