"""Two-view geometry estimation + configuration classification.

Port of colmap_pcd_tpu/models/two_view.py (parity with
src/estimators/two_view_geometry.{h,cc}): estimate E, F and H with
LO-RANSAC, classify the pair configuration from relative inlier support,
and recover the relative pose of calibrated pairs.

A block of image pairs is verified as one batched bank over [B, cap]
(`_ransac_efh_batch`): the three RANSAC banks, pose recovery, the median
triangulation angle and the classification all run on the device for the
whole block, and only the sample draws loop over the pairs, each with its
own `torch.Generator` seeded from the item's seed. `detect_watermark` and
the host half of classification are numpy.

Configurations (two_view_geometry.h:48-66): DEGENERATE, CALIBRATED,
UNCALIBRATED, PLANAR, PANORAMIC, PLANAR_OR_PANORAMIC, WATERMARK, MULTIPLE.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .. import device as device_mod
from ..ops import camera_models as cm
from ..ops import np_geom
from ..ops import ransac as ransac_ops
from ..ops import se3, solvers

Tensor = torch.Tensor

DEGENERATE = 0
CALIBRATED = 1
UNCALIBRATED = 2
PLANAR = 3
PANORAMIC = 4
PLANAR_OR_PANORAMIC = 5
WATERMARK = 6
MULTIPLE = 7


@dataclass
class TwoViewOptions:
    min_num_inliers: int = 15
    max_error: float = 4.0  # px
    num_hypotheses: int = 2048
    # H inlier ratio above which the pair is planar/panoramic
    max_H_inlier_ratio: float = 0.8
    # E must explain nearly as many inliers as F to call it calibrated
    min_E_F_inlier_ratio: float = 0.95
    compute_relative_pose: bool = True
    # watermark detection (two_view_geometry.h:93-102): a pure 2D translation
    # among border inliers marks a watermark-induced degenerate pair
    detect_watermark: bool = True
    watermark_min_inlier_ratio: float = 0.7
    watermark_border_size: float = 0.1
    # iterative multi-model extraction (EstimateMultiple)
    multiple_models: bool = False


@dataclass
class TwoViewGeometry:
    config: int = DEGENERATE
    E: Optional[np.ndarray] = None
    F: Optional[np.ndarray] = None
    H: Optional[np.ndarray] = None
    inlier_matches: np.ndarray = field(default_factory=lambda: np.zeros((0, 2), np.int32))
    # relative pose (world = cam1 frame), |t| = 1
    qvec: Optional[np.ndarray] = None
    tvec: Optional[np.ndarray] = None
    tri_angle: float = 0.0


def detect_watermark(
    uv1: np.ndarray,
    uv2: np.ndarray,
    inlier_mask: np.ndarray,
    size1: tuple[int, int],
    size2: tuple[int, int],
    opts: TwoViewOptions = TwoViewOptions(),
) -> bool:
    """Watermark heuristic (two_view_geometry.cc DetectWatermark): if most
    inliers sit in the image borders of BOTH images and are explained by a
    pure 2D translation, the geometry is a watermark artifact. The
    translation-RANSAC is one vectorized all-pairs count (every inlier's
    displacement is a hypothesis) instead of a sequential sampler."""
    sel = np.nonzero(inlier_mask)[0]
    m = sel.size
    if m == 0:
        return False
    w1, h1 = size1
    w2, h2 = size2
    b1 = opts.watermark_border_size * float(np.hypot(w1, h1))
    b2 = opts.watermark_border_size * float(np.hypot(w2, h2))
    p1, p2 = uv1[sel], uv2[sel]

    def outside(p, b, w, h):
        return (p[:, 0] < b) | (p[:, 0] > w - b) | (p[:, 1] < b) | (p[:, 1] > h - b)

    in_border = outside(p1, b1, w1, h1) & outside(p2, b2, w2, h2)
    if in_border.sum() / m < opts.watermark_min_inlier_ratio:
        return False
    t = p2 - p1  # [m,2] candidate translations
    # all-pairs translation consensus (bounded to 512 hypotheses)
    hyp = t if m <= 512 else t[np.linspace(0, m - 1, 512).astype(int)]
    d2 = np.sum((t[None, :, :] - hyp[:, None, :]) ** 2, axis=-1)  # [H,m]
    counts = (d2 <= opts.max_error**2).sum(axis=1)
    return counts.max() / m >= opts.watermark_min_inlier_ratio


def estimate_two_view_geometry_multiple(
    uv1, uv2, params1, params2, model_id1, model_id2,
    opts: TwoViewOptions = TwoViewOptions(), seed: int = 0, device=None,
) -> TwoViewGeometry:
    """EstimateMultiple (two_view_geometry.cc): iteratively estimate a
    geometry, carve out its inliers, repeat; >1 sufficiently supported
    geometries -> config MULTIPLE with the union of inliers."""
    remaining = np.arange(uv1.shape[0])
    geometries: list[TwoViewGeometry] = []
    sub_opts = TwoViewOptions(**{**opts.__dict__, "multiple_models": False, "detect_watermark": False})
    while remaining.size >= 8:
        g = estimate_two_view_geometry(
            uv1[remaining], uv2[remaining], params1, params2,
            model_id1, model_id2, sub_opts, seed=seed + len(geometries), device=device,
        )
        if g.config == DEGENERATE or len(g.inlier_matches) < opts.min_num_inliers:
            break
        g.inlier_matches = np.stack(
            [remaining[g.inlier_matches[:, 0]]] * 2, axis=-1
        ).astype(np.int32)
        geometries.append(g)
        keep = np.ones(remaining.size, bool)
        keep[np.isin(remaining, g.inlier_matches[:, 0])] = False
        remaining = remaining[keep]
    if not geometries:
        return TwoViewGeometry()
    if len(geometries) == 1:
        return geometries[0]
    out = geometries[0]
    out.config = MULTIPLE
    out.inlier_matches = np.concatenate([g.inlier_matches for g in geometries])
    return out


def _match_cap(n: int) -> int:
    """Power-of-two bucket (128, 256, ...) the matches of a pair pad to,
    as in the JAX package (there: one compiled program per bucket)."""
    return 128 * 2 ** max(0, math.ceil(math.log2(max(n, 1) / 128)))


def _e_threshold(opts: TwoViewOptions, params1, params2, model_id1, model_id2) -> float:
    """The E bank's normalized-unit threshold: max_error / mean focal."""
    fi1 = cm._FOCAL_IDX[model_id1]
    fi2 = cm._FOCAL_IDX[model_id2]
    p1, p2 = np.asarray(params1), np.asarray(params2)
    return opts.max_error / float(np.mean([p1[fi1[0]], p1[fi1[1]], p2[fi2[0]], p2[fi2[1]]]))


def _upload_items(items: list[dict], opts: TwoViewOptions, device):
    """Pad a block of items to one cap and move it to the device: (n1, n2,
    uv1, uv2, valid, quals [B,cap], e_errs [B], generators, ns). Rows
    without a quality get -inf: the block's banks always sample
    progressively, as the JAX package's batched bank does."""
    cap = _match_cap(max(it["uv1"].shape[0] for it in items))
    B = len(items)
    uv1 = np.zeros((B, cap, 2), np.float32)
    uv2 = np.zeros((B, cap, 2), np.float32)
    n1 = np.zeros((B, cap, 2), np.float32)
    n2 = np.zeros((B, cap, 2), np.float32)
    valid = np.zeros((B, cap), np.float32)
    quals = np.full((B, cap), -np.inf, np.float32)
    e_errs = np.zeros(B, np.float32)
    gens, ns = [], []
    for b, it in enumerate(items):
        N = it["uv1"].shape[0]
        ns.append(N)
        uv1[b, :N] = it["uv1"]
        uv2[b, :N] = it["uv2"]
        # normalized coords for E (host-side undistortion)
        n1[b, :N] = np_geom.image_to_world(it["model_id1"], it["params1"], it["uv1"])
        n2[b, :N] = np_geom.image_to_world(it["model_id2"], it["params2"], it["uv2"])
        valid[b, :N] = 1.0
        if it.get("quality") is not None:
            quals[b, :N] = it["quality"]
        e_errs[b] = _e_threshold(opts, it["params1"], it["params2"], it["model_id1"], it["model_id2"])
        gens.append(torch.Generator(device=device).manual_seed(int(it.get("seed", 0)) & 0xFFFFFFFF))
    arrays = (n1, n2, uv1, uv2, valid, quals, e_errs)
    return (*(torch.as_tensor(a, device=device) for a in arrays), gens, ns)


def _efh_banks(n1, n2, uv1, uv2, valid, gens, ro, e_errs, quals):
    """E, F and H banks over a block [B, cap]; each pair's generator draws
    the E, then the F, then the H samples."""
    resE = ransac_ops.ransac_essential(n1, n2, valid, gens, ro, quals, e_errs)
    resF = ransac_ops.ransac_fundamental(uv1, uv2, valid, gens, ro, quals)
    resH = ransac_ops.ransac_homography(uv1, uv2, valid, gens, ro, quals)
    return resE, resF, resH


def _pose_recovery(E: Tensor, n1: Tensor, n2: Tensor, mask: Tensor):
    """Pose from E + per-match triangulation angles and depths, batched:
    E [..., 3, 3], n1/n2 [..., N, 2], mask [..., N]. Returns (q, t, angle,
    z1, z2) (two_view_geometry.cc tail)."""
    q, t = solvers.decompose_essential(E, n1, n2, mask)
    P1 = torch.eye(3, 4, dtype=E.dtype, device=E.device)
    P2 = solvers.proj_matrix(q, t)[..., None, :, :]
    X = solvers.triangulate_dlt(P1, P2, n1, n2)  # [..., N, 3]
    c2 = se3.projection_center(q, t)
    ang = solvers.triangulation_angle(torch.zeros_like(c2)[..., None, :], c2[..., None, :], X)
    z2 = se3.se3_apply(q[..., None, :], t[..., None, :], X)[..., 2]
    return q, t, ang, X[..., 2], z2


def estimate_two_view_geometry(
    uv1: np.ndarray,  # [N,2] pixel coords of matched features in image 1
    uv2: np.ndarray,  # [N,2] matched coords in image 2 (row-aligned with uv1)
    params1: np.ndarray,
    params2: np.ndarray,
    model_id1: int,
    model_id2: int,
    opts: TwoViewOptions = TwoViewOptions(),
    seed: int = 0,
    size1: tuple[int, int] | None = None,  # (width, height) for watermark test
    size2: tuple[int, int] | None = None,
    quality: np.ndarray | None = None,  # [N] match quality for PROSAC sampling
    device=None,
) -> TwoViewGeometry:
    """uv1[i] <-> uv2[i] are matched pairs (from ops/matching). One pair
    through the batched banks (a block of one) and the JAX package's host
    classification."""
    if opts.multiple_models:
        return estimate_two_view_geometry_multiple(
            uv1, uv2, params1, params2, model_id1, model_id2, opts, seed, device
        )
    N = uv1.shape[0]
    out = TwoViewGeometry()
    if N < 8:
        return out
    dev = device_mod.resolve(device)
    item = dict(uv1=uv1, uv2=uv2, params1=params1, params2=params2, model_id1=model_id1,
                model_id2=model_id2, seed=seed, quality=quality)
    n1, n2, uv1d, uv2d, valid, quals, e_errs, gens, _ = _upload_items([item], opts, dev)
    if quality is None:
        quals = None  # uniform sampling, as the JAX package's scalar path
    ro = ransac_ops.RansacOptions(max_error=opts.max_error, num_hypotheses=opts.num_hypotheses)
    resE, resF, resH = _efh_banks(n1, n2, uv1d, uv2d, valid, gens, ro, e_errs, quals)
    nE, nF, nH = (int(r.num_inliers[0]) for r in (resE, resF, resH))
    out.E, out.F, out.H = (r.model[0].cpu().numpy() for r in (resE, resF, resH))

    if max(nE, nF) < opts.min_num_inliers:
        out.config = DEGENERATE
        return out
    if nE >= opts.min_E_F_inlier_ratio * nF and nE >= opts.min_num_inliers:
        config = CALIBRATED
        best_mask = resE.inlier_mask[0, :N].cpu().numpy()
        n_best = nE
    else:
        config = UNCALIBRATED
        best_mask = resF.inlier_mask[0, :N].cpu().numpy()
        n_best = nF
    if nH > opts.max_H_inlier_ratio * n_best:
        config = PLANAR_OR_PANORAMIC

    rows = np.nonzero(best_mask)[0]
    out.inlier_matches = np.stack([rows, rows], axis=-1).astype(np.int32)
    out.config = config
    if (
        opts.detect_watermark
        and size1 is not None
        and size2 is not None
        and detect_watermark(np.asarray(uv1), np.asarray(uv2), best_mask, size1, size2, opts)
    ):
        out.config = WATERMARK
        return out

    if opts.compute_relative_pose and config == CALIBRATED:
        mask_p = torch.zeros_like(valid)
        mask_p[0, :N] = torch.as_tensor(best_mask, device=dev)
        q, t, ang, z1, z2 = _pose_recovery(resE.model, n1, n2, mask_p)
        out.qvec = q[0].cpu().numpy()
        out.tvec = t[0].cpu().numpy()
        ang, z1, z2 = (x[0, :N].cpu().numpy() for x in (ang, z1, z2))
        ok = best_mask & (z1 > 0) & (z2 > 0)
        if ok.sum() > 0:
            out.tri_angle = float(np.median(ang[ok]))
    return out


def _ransac_efh_batch(n1, n2, uv1, uv2, valid, gens, ro, e_errs, quals, cls=(15, 0.95, 0.8)):
    """Fused E/F/H + pose recovery + classification over a block of pairs
    [B, cap]: verifying an image-pair block is one batched bank, and the
    output is the per-pair verdict (config code, models, best inlier mask,
    pose, median triangulation angle). cls = (min_num_inliers,
    min_E_F_inlier_ratio, max_H_inlier_ratio)."""
    min_inl, ef_ratio, h_ratio = cls
    resE, resF, resH = _efh_banks(n1, n2, uv1, uv2, valid, gens, ro, e_errs, quals)
    q, t, ang, z1, z2 = _pose_recovery(resE.model, n1, n2, resE.inlier_mask.to(n1.dtype))
    nE, nF, nH = resE.num_inliers, resF.num_inliers, resH.num_inliers
    calibrated = (nE >= ef_ratio * nF) & (nE >= min_inl)
    degenerate = torch.maximum(nE, nF) < min_inl
    best_mask = torch.where(calibrated[:, None], resE.inlier_mask, resF.inlier_mask)
    n_best = torch.where(calibrated, nE, nF)
    planar = nH > h_ratio * n_best
    config = torch.where(
        degenerate, DEGENERATE,
        torch.where(planar, PLANAR_OR_PANORAMIC, torch.where(calibrated, CALIBRATED, UNCALIBRATED)),
    ).to(torch.int32)
    # median triangulation angle (lower middle) over cheirality-positive
    # best inliers
    ok = best_mask & (z1 > 0) & (z2 > 0)
    n_ok = torch.sum(ok, dim=-1)
    srt = torch.sort(torch.where(ok, ang, torch.full_like(ang, torch.inf)), dim=-1).values
    mid = torch.clamp(n_ok - 1, min=0) // 2
    tri = torch.where(n_ok > 0, torch.gather(srt, -1, mid[:, None])[:, 0], torch.zeros_like(srt[:, 0]))
    return dict(
        config=config, E=resE.model, F=resF.model, H=resH.model,
        best_mask=best_mask, n_best=n_best, q=q, t=t, tri_angle=tri,
    )


def two_view_verify_dispatch(items: list[dict], opts: TwoViewOptions = TwoViewOptions(), device=None):
    """Device half of batched two-view verification: pad the item block,
    upload it, and run the fused EFH + pose bank without fetching.

    Returns (outputs, ctx): the bank's dict of device tensors and the host
    metadata `two_view_verify_classify` needs. Each item: dict(uv1 [N,2],
    uv2 [N,2], params1, params2, model_id1, model_id2, seed, size1, size2,
    quality); N may differ per item, all pad to the largest item's cap."""
    idxs = [k for k, it in enumerate(items) if it["uv1"].shape[0] >= 8]
    if not idxs:
        return None, {"idxs": [], "n_items": len(items)}
    dev = device_mod.resolve(device)
    n1, n2, uv1, uv2, valid, quals, e_errs, gens, ns = _upload_items([items[k] for k in idxs], opts, dev)
    ro = ransac_ops.RansacOptions(max_error=opts.max_error, num_hypotheses=opts.num_hypotheses)
    cls = (opts.min_num_inliers, opts.min_E_F_inlier_ratio, opts.max_H_inlier_ratio)
    out = _ransac_efh_batch(n1, n2, uv1, uv2, valid, gens, ro, e_errs, quals, cls)
    return out, {"idxs": idxs, "ns": ns, "n_items": len(items)}


def fetch(outputs: dict | None) -> dict | None:
    """One device->host copy of a bank's outputs (numpy arrays)."""
    if outputs is None:
        return None
    return {k: v.cpu().numpy() for k, v in outputs.items()}


def two_view_verify_classify(
    fetched, ctx: dict, items: list[dict], opts: TwoViewOptions = TwoViewOptions(),
) -> list[TwoViewGeometry]:
    """Host half of batched two-view verification: classify each pair's
    configuration from the fetched EFH + pose arrays (pure numpy)."""
    out = [TwoViewGeometry() for _ in range(ctx["n_items"])]
    for b, k in enumerate(ctx["idxs"]):
        g = out[k]
        N = ctx["ns"][b]
        g.E, g.F, g.H = fetched["E"][b], fetched["F"][b], fetched["H"][b]
        g.config = int(fetched["config"][b])
        if g.config == DEGENERATE:
            continue
        best_mask = fetched["best_mask"][b, :N]
        rows = np.nonzero(best_mask)[0]
        g.inlier_matches = np.stack([rows, rows], axis=-1).astype(np.int32)
        it = items[k]
        if (
            opts.detect_watermark
            and it.get("size1") is not None
            and it.get("size2") is not None
            and detect_watermark(
                np.asarray(it["uv1"]), np.asarray(it["uv2"]), best_mask,
                it["size1"], it["size2"], opts,
            )
        ):
            g.config = WATERMARK
            continue
        if opts.compute_relative_pose and g.config == CALIBRATED:
            g.qvec = fetched["q"][b]
            g.tvec = fetched["t"][b]
            g.tri_angle = float(fetched["tri_angle"][b])
    return out


def estimate_two_view_geometry_batch(
    items: list[dict], opts: TwoViewOptions = TwoViewOptions(), device=None,
) -> list[TwoViewGeometry]:
    """Batched estimate_two_view_geometry: one fused EFH + pose bank for a
    whole image-pair block (the matcher calls the two halves separately).
    Multiple-model extraction takes the scalar path per item."""
    if opts.multiple_models:
        return [
            estimate_two_view_geometry(
                it["uv1"], it["uv2"], it["params1"], it["params2"],
                it["model_id1"], it["model_id2"], opts, seed=it.get("seed", 0),
                size1=it.get("size1"), size2=it.get("size2"),
                quality=it.get("quality"), device=device,
            )
            if it["uv1"].shape[0] >= 8 else TwoViewGeometry()
            for it in items
        ]
    outputs, ctx = two_view_verify_dispatch(items, opts, device)
    return two_view_verify_classify(fetch(outputs), ctx, items, opts)
