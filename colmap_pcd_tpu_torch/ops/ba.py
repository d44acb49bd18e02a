"""Bundle adjustment: Levenberg-Marquardt with a dense Schur complement.

Port of colmap_pcd_tpu/ops/ba.py (the reference's Ceres problems,
src/optim/bundle_adjustment.cc:443-1131, and cost functors,
src/base/cost_functions.h):

  residuals  : 2D reprojection per observation (any of the 11 camera models)
               + 1D weighted point-to-plane distance per 3D point against its
               associated lidar plane (cost_functions.h:150-241).
  robust loss: trivial / soft-L1 / Cauchy via IRLS sqrt-weighting.
  Jacobians  : forward mode (`torch.func.jvp`, one batched pass per tangent
               direction); no backward pass anywhere.
  structure  : point blocks (3x3) eliminated per point in closed form; the
               reduced camera system (6 per pose block [+ two 6-blocks of
               intrinsics per camera]) is assembled densely and solved by
               Cholesky in full f32 (DENSE_SCHUR, bundle_adjustment.cc:499-512),
               or solved by block-Jacobi PCG without forming it.
  damping    : LM with multiplicative lambda updates. The JAX version runs the
               loop on the device (lax.while_loop); here it is a Python loop
               with ONE host sync per iteration, for the stall/convergence
               test (BAResult.host_syncs counts them).

Shapes are padded and masked exactly as in the JAX package, so one problem
built by `make_problem` feeds both implementations. Above
`dense_max_pose_blocks` 6-blocks (or with `camera_solver="pcg"`) the camera
side is solved matrix-free by preconditioned CG (ITERATIVE_SCHUR +
SCHUR_JACOBI) instead of the dense Cholesky.

Every GN step has a per-shard half (point blocks, the camera-side sums,
back-substitution) and a reduced half (damping, the camera solve, the
accept test). `solve` runs one shard; parallel/dist_ba.py runs the same
loop (`solve_shards`) over the point blocks of a mesh, reducing the sums
where the JAX package psums them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import device as device_mod
from ..utils.logging_utils import PHASES
from . import camera_models as cm
from . import se3

Tensor = torch.Tensor

LOSS_TRIVIAL = 0
LOSS_SOFT_L1 = 1
LOSS_CAUCHY = 2


class BAConfig(NamedTuple):
    """Solve configuration (same fields and defaults as the JAX BAConfig)."""

    model_id: int = 1
    # distinct camera models present in the problem; empty = model_id only.
    # problem.cam_model[k] indexes into this tuple per intrinsics slot.
    model_ids: tuple = ()
    loss_type: int = LOSS_TRIVIAL
    loss_scale: float = 1.0
    max_iterations: int = 25
    refine_intrinsics: bool = False  # adds two 6-blocks per camera
    refine_focal: bool = True
    refine_principal: bool = False
    refine_extra: bool = True
    point_chunk: int = 512  # points per Schur reduction chunk
    lidar_loss_robust: bool = False  # robust loss on lidar terms too
    initial_lambda: float = 1e-4
    min_lambda: float = 1e-10
    max_lambda: float = 1e8
    track_len: int = 16
    # Ceres function_tolerance: stop on the first accepted step whose
    # relative cost change is below this; rejected steps get
    # max_consecutive_rejects tries
    function_tolerance: float = 1e-6
    max_consecutive_rejects: int = 4
    # pose 6-blocks in the reduced camera system (0 -> one per camera slot);
    # fixed cameras may all map to block 0
    num_pose_blocks: int = 0
    camera_solver: str = "auto"
    dense_max_pose_blocks: int = 1024
    pcg_max_iterations: int = 100
    pcg_rtol: float = 1e-6


class BAProblem(NamedTuple):
    """Padded, fixed-shape bundle adjustment problem (tensors on one device).

    Shapes: C = image slots, K = camera (intrinsics) slots, P = point slots,
    N = observation slots, T = track_len.
    """

    cam_q: Tensor  # [C,4] world-to-camera quaternion (w,x,y,z)
    cam_t: Tensor  # [C,3]
    cam_k: Tensor  # [C] int64 intrinsics slot per image
    intr: Tensor  # [K,12] padded camera params
    cam_model: Tensor  # [K] int64 index into cfg.model_ids
    points: Tensor  # [P,3]
    obs_cam: Tensor  # [N] int64 image slot (0 for padding)
    obs_pt: Tensor  # [N] int64 point slot (0 for padding)
    obs_uv: Tensor  # [N,2] pixel measurements
    obs_valid: Tensor  # [N] f32 {0,1}
    # [P,T] int64 indices into obs arrays, -1 padded; the valid entries are
    # injective and complete over the valid observations (make_problem)
    pt_obs: Tensor
    lidar_plane: Tensor  # [P,4] (a,b,c,d), |n|=1
    lidar_w: Tensor  # [P] f32 constraint weight, 0 = none
    cam_blk: Tensor  # [C] int64 pose block slot per camera
    pose_fixed: Tensor  # [C] f32 {0,1}
    tvec_fixed: Tensor  # [C,3] f32 {0,1}
    point_fixed: Tensor  # [P] f32 {0,1}
    intr_fixed: Tensor  # [K] f32 {0,1}
    num_cams: Tensor  # [] live image slots
    num_points: Tensor  # []


class BAResult(NamedTuple):
    cam_q: Tensor
    cam_t: Tensor
    intr: Tensor
    points: Tensor
    initial_cost: Tensor
    final_cost: Tensor
    iterations: int
    host_syncs: int  # device->host waits taken by the LM loop


# ---------------------------------------------------------------------------
# residuals & robust loss


def _models(cfg: BAConfig) -> tuple:
    return cfg.model_ids if cfg.model_ids else (cfg.model_id,)


def _intr_refine_mask_for(model_id: int, cfg: BAConfig) -> list:
    fi, fj, ci, cj = cm._FOCAL_IDX[model_id]
    m = [0.0] * cm.MAX_PARAMS
    for i in range(cm.NUM_PARAMS[model_id]):
        if i in (fi, fj):
            m[i] = 1.0 if cfg.refine_focal else 0.0
        elif i in (ci, cj):
            m[i] = 1.0 if cfg.refine_principal else 0.0
        else:
            m[i] = 1.0 if cfg.refine_extra else 0.0
    return m


def _intr_refine_mask(cfg: BAConfig, device) -> Tensor:
    """[M,12] per-model mask of intrinsic params allowed to move."""
    return torch.tensor(
        [_intr_refine_mask_for(m, cfg) for m in _models(cfg)], dtype=torch.float32, device=device
    )


def _project_dispatch(cfg: BAConfig, kparams, q, t, X, midx):
    """cm.project over the set of camera models; midx selects per row."""
    models = _models(cfg)
    if len(models) == 1:
        return cm.project(models[0], kparams, q, t, X)
    outs = [cm.project(m, kparams, q, t, X) for m in models]
    sel = [(midx == i).to(outs[0][1].dtype) for i in range(len(models))]
    xy = sum(sel[i][..., None] * outs[i][0] for i in range(len(models)))
    z = sum(sel[i] * outs[i][1] for i in range(len(models)))
    return xy, z


def _sqrt_rho_deriv(sq_norm: Tensor, cfg: BAConfig) -> Tensor:
    """IRLS weight sqrt(rho'(s)) for robust losses; s = squared residual norm."""
    s = sq_norm / (cfg.loss_scale**2)
    if cfg.loss_type == LOSS_TRIVIAL:
        return torch.ones_like(sq_norm)
    if cfg.loss_type == LOSS_SOFT_L1:
        return (1.0 + s) ** (-0.25)
    if cfg.loss_type == LOSS_CAUCHY:
        return (1.0 + s) ** (-0.5)
    raise ValueError(f"unknown loss {cfg.loss_type}")


def _rho(sq_norm: Tensor, cfg: BAConfig) -> Tensor:
    """Robust loss value rho(s)."""
    s = sq_norm / (cfg.loss_scale**2)
    c2 = cfg.loss_scale**2
    if cfg.loss_type == LOSS_TRIVIAL:
        return sq_norm
    if cfg.loss_type == LOSS_SOFT_L1:
        return 2.0 * c2 * (torch.sqrt(1.0 + s) - 1.0)
    if cfg.loss_type == LOSS_CAUCHY:
        return c2 * torch.log1p(s)
    raise ValueError(f"unknown loss {cfg.loss_type}")


def _reproj_residual(cfg, q, t, kparams, X, uv, midx):
    """2-vector reprojection residual; masked to 0 behind the camera and
    clamped so wild outliers cannot produce inf/nan in f32."""
    xy, z = _project_dispatch(cfg, kparams, q, t, X, midx)
    r = torch.clamp(xy - uv, -1e4, 1e4)
    return r * (z > 1e-3).to(r.dtype)[..., None]


def _obs_midx(problem: BAProblem) -> Tensor:
    return problem.cam_model[problem.cam_k[problem.obs_cam]]


def reprojection_errors(problem: BAProblem, cfg: BAConfig) -> Tensor:
    """Per-observation reprojection error norms (pixels), padded entries 0."""
    q = problem.cam_q[problem.obs_cam]
    t = problem.cam_t[problem.obs_cam]
    k = problem.intr[problem.cam_k[problem.obs_cam]]
    X = problem.points[problem.obs_pt]
    r = _reproj_residual(cfg, q, t, k, X, problem.obs_uv, _obs_midx(problem))
    return torch.linalg.norm(r, dim=-1) * problem.obs_valid


def total_cost(cam_q, cam_t, intr, points, problem: BAProblem, cfg: BAConfig) -> Tensor:
    q = cam_q[problem.obs_cam]
    t = cam_t[problem.obs_cam]
    k = intr[problem.cam_k[problem.obs_cam]]
    X = points[problem.obs_pt]
    r = _reproj_residual(cfg, q, t, k, X, problem.obs_uv, _obs_midx(problem))
    sq = torch.sum(r * r, dim=-1) * problem.obs_valid
    cost = torch.sum(_rho(sq, cfg) * problem.obs_valid)
    # lidar point-to-plane: w * (n . X + d)
    rl = problem.lidar_w * (
        torch.sum(points * problem.lidar_plane[:, :3], dim=-1) + problem.lidar_plane[:, 3]
    )
    if cfg.lidar_loss_robust:
        return cost + torch.sum(_rho(rl * rl, cfg))
    return cost + torch.sum(rl * rl)


# ---------------------------------------------------------------------------
# jacobians


def _obs_jacobians(problem: BAProblem, cfg: BAConfig, cam_q, cam_t, intr, points):
    """Per-observation residuals and Jacobians at delta = 0.

    Returns r [N,2], Jc [N,2,6] (pose tangent), Jp [N,2,3] (point),
    Jk [N,2,12] (intrinsics, refine-masked; None unless refined), all
    robust-weighted, with frozen-parameter columns and invalid observations
    zeroed.
    """
    q = cam_q[problem.obs_cam]
    t = cam_t[problem.obs_cam]
    kcam = problem.cam_k[problem.obs_cam]
    k = intr[kcam]
    X = points[problem.obs_pt]
    uv = problem.obs_uv
    midx = problem.cam_model[kcam]
    kmask = _intr_refine_mask(cfg, q.device)[midx]  # [N,12]
    N = q.shape[0]

    def f(dc, dx, *dk):
        # rotation: left-multiplicative quaternion update; translation:
        # additive (the reference's quaternion manifold + subset-manifold
        # tvec, bundle_adjustment.cc:794-803 — tvec freezing is exact)
        q2 = se3.quat_mul(se3.so3_exp_quat(dc[:, :3]), q)
        kk = k + dk[0] * kmask if dk else k
        return _reproj_residual(cfg, q2, t + dc[:, 3:], kk, X + dx, uv, midx)

    # intrinsics frozen (every incremental-mapper solve): skip their 12
    # tangent directions entirely
    widths = (6, 3, 12) if cfg.refine_intrinsics else (6, 3)
    primals = tuple(torch.zeros((N, w), dtype=q.dtype, device=q.device) for w in widths)
    basis = torch.eye(sum(widths), dtype=q.dtype, device=q.device)

    def push(e):  # one tangent direction, shared by every observation
        tangents = tuple(x.expand(N, -1) for x in torch.split(e, widths))
        return torch.func.jvp(f, primals, tangents)
    r, J = torch.func.vmap(push, out_dims=(None, 0))(basis)  # J [D,N,2]
    J = J.permute(1, 2, 0)  # [N,2,D]
    Jc, Jp = J[..., :6], J[..., 6:9]
    Jk = J[..., 9:] if cfg.refine_intrinsics else None

    # robust IRLS sqrt-weighting
    sq = torch.sum(r * r, dim=-1)
    w = torch.sqrt(torch.clamp(_sqrt_rho_deriv(sq, cfg), min=1e-12)) * problem.obs_valid
    r = r * w[:, None]
    # freeze poses / tvec components / points / intrinsics
    pf = 1.0 - problem.pose_fixed[problem.obs_cam]  # [N]
    tv = 1.0 - problem.tvec_fixed[problem.obs_cam]  # [N,3]
    cmask = torch.cat([pf[:, None].expand(N, 3), tv], dim=-1) * pf[:, None]
    Jc = Jc * w[:, None, None] * cmask[:, None, :]
    Jp = Jp * w[:, None, None] * (1.0 - problem.point_fixed[problem.obs_pt])[:, None, None]
    if Jk is not None:
        Jk = Jk * w[:, None, None] * (1.0 - problem.intr_fixed[kcam])[:, None, None]
    return r, Jc, Jp, Jk


# ---------------------------------------------------------------------------
# normal equations + Schur elimination


def _inv3(A: Tensor) -> Tensor:
    """Closed-form batched 3x3 inverse (adjugate / det), f32-safe."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    det = torch.where(torch.abs(det) < 1e-20, torch.full_like(det, 1e-20), det)
    adj = torch.stack(
        [
            torch.stack([A11, A12, A13], -1),
            torch.stack([A21, A22, A23], -1),
            torch.stack([A31, A32, A33], -1),
        ],
        dim=-2,
    )
    return adj / det[..., None, None]


class _Layout(NamedTuple):
    """Loop-invariant Schur bookkeeping of one problem (the JAX version
    relies on XLA hoisting these out of the LM loop)."""

    nbp: int  # pose blocks
    nb: int  # all 6-blocks
    roles: int  # camera-side entries per observation (1, or 3 with intrinsics)
    csize: int  # points per reduction chunk
    blk: Tensor  # [M] 6-block of each camera-side entry
    pt3: Tensor  # [M] point of each camera-side entry
    slot_all: Tensor  # [M] slot of each entry in the packed [Ppad*Tn] table
    blk_slots: Tensor  # [Ppad, Tn] 6-block per slot (padding -> 0)
    pcg: bool  # the camera solve is the PCG tier (`uses_pcg`)


def _layout(problem: BAProblem, cfg: BAConfig) -> _Layout:
    C = problem.cam_q.shape[0]
    K = problem.intr.shape[0]
    N = problem.obs_cam.shape[0]
    nbp = cfg.num_pose_blocks if cfg.num_pose_blocks > 0 else C
    roles = 3 if cfg.refine_intrinsics else 1
    nb = nbp + (2 * K if cfg.refine_intrinsics else 0)
    blk = problem.cam_blk[problem.obs_cam]
    pt3 = problem.obs_pt
    if cfg.refine_intrinsics:
        kid = problem.cam_k[problem.obs_cam]
        blk = torch.cat([blk, nbp + 2 * kid, nbp + 2 * kid + 1])
        pt3 = torch.cat([pt3] * 3)
    csize, slot_all, blk_slots = _slot_tables(problem.pt_obs, N, roles, blk, cfg.point_chunk)
    return _Layout(nbp, nb, roles, csize, blk, pt3, slot_all, blk_slots, uses_pcg(problem, cfg))


def _slot_tables(pt_obs: Tensor, N: int, roles: int, blk: Tensor, point_chunk: int):
    """(csize, slot_all [roles*N], blk_slots [Ppad, roles*T]): pt_obs [P, T]
    inverted once into a slot per camera-side entry. Entry (p, t) of role r
    lives at p*Tn + r*T + t; observations the table does not reference
    (padding) go to the sentinel slot Ppad*Tn, which is dropped. blk [roles*N]
    is each entry's 6-block."""
    P, T = pt_obs.shape
    dev = pt_obs.device
    csize = min(point_chunk, P)
    Ppad = -(-P // csize) * csize
    Tn = roles * T
    flat = pt_obs.reshape(-1)
    fidx = torch.arange(P * T, device=dev)
    base = (fidx // T) * Tn + fidx % T
    sent = Ppad * Tn
    slot_of_obs = torch.full((N + 1,), sent, dtype=torch.int64, device=dev)
    slot_of_obs.scatter_(0, torch.where(flat >= 0, flat, N), base)
    slot_of_obs = slot_of_obs[:N]
    slot_all = torch.cat([slot_of_obs + r * T for r in range(roles)])
    slot_all = torch.where(slot_all < sent, slot_all, sent)
    blk_slots = torch.zeros(sent + 1, dtype=torch.int64, device=dev)
    blk_slots[slot_all] = blk
    return csize, slot_all, blk_slots[:sent].view(Ppad, Tn)


def _point_blocks(problem: BAProblem, cfg: BAConfig, cam_q, cam_t, intr, points, lam):
    """One shard's residuals, Jacobians and damped point blocks: (Jcam
    [M,2,6], rc [M,2], Jpc [M,2,3], Hpp_inv [P,3,3], b_p [P,3]) for the
    M = roles * N camera-side entries.

    Camera-side blocks 0..nbp-1 are pose tangents; with refine_intrinsics,
    blocks nbp + 2k and nbp + 2k + 1 hold camera k's 12 intrinsics.
    """
    P = points.shape[0]
    dev = points.device
    f32 = dict(dtype=torch.float32, device=dev)

    r, Jc, Jp, Jk = _obs_jacobians(problem, cfg, cam_q, cam_t, intr, points)

    # ---- point blocks: H_pp and b_p, including lidar terms -----------------
    Hpp = torch.zeros((P, 3, 3), **f32).index_add_(
        0, problem.obs_pt, torch.einsum("nri,nrj->nij", Jp, Jp)
    )
    b_p = torch.zeros((P, 3), **f32).index_add_(
        0, problem.obs_pt, -torch.einsum("nri,nr->ni", Jp, r)
    )
    nvec = problem.lidar_plane[:, :3]
    rl = problem.lidar_w * (torch.sum(points * nvec, dim=-1) + problem.lidar_plane[:, 3])
    if cfg.lidar_loss_robust:
        wl = torch.sqrt(torch.clamp(_sqrt_rho_deriv(rl * rl, cfg), min=1e-12))
    else:
        wl = torch.ones_like(rl)
    Jl = (wl * problem.lidar_w)[:, None] * nvec * (1.0 - problem.point_fixed)[:, None]
    Hpp = Hpp + Jl[:, :, None] * Jl[:, None, :]
    b_p = b_p - Jl * (wl * rl)[:, None]
    # LM damping on point blocks + a floor so untouched points invert
    diagH = torch.diagonal(Hpp, dim1=-2, dim2=-1)
    Hpp_inv = _inv3(Hpp + torch.diag_embed(lam * diagH + 1e-8 + 1e-6))

    # ---- camera-side entries ----------------------------------------------
    if cfg.refine_intrinsics:
        Jcam = torch.cat([Jc, Jk[:, :, :6], Jk[:, :, 6:]])  # [3N,2,6]
        r3 = torch.cat([r, r, r])
        Jp3 = torch.cat([Jp, Jp, Jp])
    else:
        Jcam, r3, Jp3 = Jc, r, Jp
    return Jcam, r3, Jp3, Hpp_inv, b_p


class _Side(NamedTuple):
    """One shard's half of a GN step: its camera-side entries, their point
    couplings (per entry and packed by point slot) and its damped point
    blocks. Everything the reduced half needs from a shard is a sum over
    these (`_dense_sums`, `_pcg_sums`, `_pcg_matvec`)."""

    Jcam: Tensor  # [M,2,6]
    rc: Tensor  # [M,2]
    W: Tensor  # [M,6,3] coupling per entry
    Wslots: Tensor  # [Ppad,Tn,6,3], padding slots zero
    Hpp_inv: Tensor  # [P,3,3]
    b_p: Tensor  # [P,3]
    Hinv_c: Tensor  # [Ppad,3,3], Hpp_inv padded to whole chunks
    bp_c: Tensor  # [Ppad,3]


def _side(lay: _Layout, Jcam, rc, Jpc, Hpp_inv, b_p) -> _Side:
    """The entries packed by point: slot (p, t) of a [Ppad, Tn] table."""
    P = Hpp_inv.shape[0]
    f32 = dict(dtype=torch.float32, device=Hpp_inv.device)
    W = torch.einsum("mri,mrj->mij", Jcam, Jpc)
    Ppad, Tn = lay.blk_slots.shape
    Wslots = torch.zeros((Ppad * Tn + 1, 6, 3), **f32)
    Wslots[lay.slot_all] = W
    Wslots = Wslots[:-1].view(Ppad, Tn, 6, 3)
    pad = Ppad - P
    Hinv_c = torch.nn.functional.pad(Hpp_inv, (0, 0, 0, 0, 0, pad))
    bp_c = torch.nn.functional.pad(b_p, (0, 0, 0, pad))
    return _Side(Jcam, rc, W, Wslots, Hpp_inv, b_p, Hinv_c, bp_c)


def _reduce(mesh, parts: list) -> tuple:
    """The shards' parts (one tuple of tensors each) summed on the root
    device. One shard: its part as it is. A mesh: one reduction of the parts
    packed flat, summed in shard order (`mesh.reduce_sum`), counted in the
    PHASES counters `ba_reductions` and `ba_reduced_bytes`."""
    if mesh is None:
        (part,) = parts
        return part
    flat = mesh.reduce_sum([torch.cat([x.reshape(-1) for x in p]) for p in parts])
    PHASES.count("ba_reductions", 1)
    PHASES.count("ba_reduced_bytes", flat.numel() * flat.element_size())
    out, o = [], 0
    for x in parts[0]:
        out.append(flat[o : o + x.numel()].view(x.shape))
        o += x.numel()
    return tuple(out)


def _replicate(mesh, x: Tensor) -> list:
    """x on every shard's device (one shard: x itself)."""
    return [x] if mesh is None else mesh.broadcast(x)


def _camera_step(cfg, lays: list, sides: list, lam, mesh=None, damp_reduced: bool = False):
    """The reduced half of a GN step: the shards' camera-side sums reduced
    onto the root device, damped and solved there once. Returns (dx_cam
    [nb,6] zeroed on failure, ok, host syncs taken by the camera solve)."""
    if lays[0].pcg:
        return _pcg_camera_step(cfg, lays, sides, lam, mesh)
    S, b, diagB = _reduce(mesh, [_dense_sums(lay, s) for lay, s in zip(lays, sides)])
    dx_cam, ok = _dense_solve(S, b, diagB, lam, damp_reduced)
    return dx_cam, ok, 0


def _back_substitute(lay: _Layout, side: _Side, dx_cam, ok) -> Tensor:
    """A shard's point steps: dx_p = Hinv (b_p - sum_e W_e^T dx[blk_e]),
    zero where the camera solve failed."""
    u = torch.einsum("mij,mi->mj", side.W, dx_cam[lay.blk])
    wtd = torch.zeros_like(side.b_p).index_add_(0, lay.pt3, u)
    dx_p = torch.einsum("pij,pj->pi", side.Hpp_inv, side.b_p - wtd)
    return torch.where(ok, dx_p, torch.zeros_like(dx_p))


def _reduced_step(cfg, lay: _Layout, Jcam, rc, Jpc, Hpp_inv, b_p, lam, damp_reduced: bool = False):
    """The camera step of the point-eliminated system and the points'
    back-substitution of one shard, given the camera-side entries (Jcam
    [M,2,6], their residuals rc [M,2] and point Jacobians Jpc [M,2,3],
    M = roles * N) and the damped point blocks' inverses. Returns (dx_cam
    [nb,6], dx_points [P,3], host syncs taken by the camera solve)."""
    side = _side(lay, Jcam, rc, Jpc, Hpp_inv, b_p)
    dx_cam, ok, syncs = _camera_step(cfg, [lay], [side], lam, None, damp_reduced)
    return dx_cam, _back_substitute(lay, side, dx_cam, ok), syncs


def _dense_sums(lay: _Layout, side: _Side):
    """DENSE_SCHUR, a shard's share: (S [D,D], b [D], diag B [D]) of its
    observations and points, D = 6 nb: the camera-side JtJ (diag B is its
    diagonal before point elimination, Ceres' damping convention) minus the
    Schur reduction over the shard's point chunks."""
    nb, roles, csize = lay.nb, lay.roles, lay.csize
    D = 6 * nb
    Jcam, Wslots = side.Jcam, side.Wslots
    dev = Jcam.device
    f32 = dict(dtype=torch.float32, device=dev)
    N = Jcam.shape[0] // roles
    # camera-side JtJ: per observation, the role x role outer products at
    # block pairs (blk_a, blk_b)
    Jroles = Jcam.view(roles, N, 2, 6)
    blks = lay.blk.view(roles, N)
    JtJ = torch.einsum("anri,bnrj->abnij", Jroles, Jroles).reshape(-1, 6, 6)
    pair = (blks[:, None, :] * nb + blks[None, :, :]).reshape(-1)
    S4 = torch.zeros((nb * nb, 6, 6), **f32).index_add_(0, pair, JtJ)
    S = S4.view(nb, nb, 6, 6).permute(0, 2, 1, 3).reshape(D, D)
    b = torch.zeros((nb, 6), **f32).index_add_(
        0, lay.blk, -torch.einsum("mri,mr->mi", Jcam, side.rc)
    ).view(D)
    diagB = torch.diagonal(S).clone()

    # ---- Schur reduction over point chunks ----------------------------------
    row = torch.arange(csize, device=dev)[:, None] * nb
    for p0 in range(0, Wslots.shape[0], csize):
        Wg = Wslots[p0 : p0 + csize]  # [c,Tn,6,3]
        blkg = lay.blk_slots[p0 : p0 + csize]  # [c,Tn]
        Y = torch.einsum("ctij,cjk->ctik", Wg, side.Hinv_c[p0 : p0 + csize])
        # the reduction sum_a sum_b Y_a W_b^T at (blk_a, blk_b) factorizes
        # per point: with A_n = sum_{a: blk=n} Y_a and B_m = sum_{b: blk=m}
        # W_b, block (n, m) receives A_n B_m^T
        flat = (row + blkg).reshape(-1)
        A = torch.zeros((csize * nb, 6, 3), **f32).index_add_(0, flat, Y.reshape(-1, 6, 3))
        Bw = torch.zeros((csize * nb, 6, 3), **f32).index_add_(0, flat, Wg.reshape(-1, 6, 3))
        S = S - torch.einsum(
            "cnik,cmjk->nimj", A.view(csize, nb, 6, 3), Bw.view(csize, nb, 6, 3)
        ).reshape(D, D)
        yb = torch.einsum("ctik,ck->cti", Y, side.bp_c[p0 : p0 + csize])
        b = b - torch.zeros((nb, 6), **f32).index_add_(
            0, blkg.reshape(-1), yb.reshape(-1, 6)
        ).view(D)
    return S, b, diagB


def _dense_solve(S, b, diagB, lam, damp_reduced: bool = False):
    """The reduced camera system S x = b, damped and Cholesky-factored. LM
    damps diag(B) before point elimination (Ceres), or with damp_reduced
    the diagonal of the reduced S (the JAX package's rig BA). Returns
    (dx_cam [nb,6] zeroed on failure, ok)."""
    if damp_reduced:
        diagB = torch.diagonal(S).clone()
    # damping + unit diagonal for blocks without residuals
    dead = (torch.abs(diagB) < 1e-10).to(torch.float32)
    S = S + torch.diag(lam * diagB + 1e-8 + dead)
    # Jacobi scaling for f32 conditioning, then Cholesky
    dscale = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(S), min=1e-12))
    L, info = torch.linalg.cholesky_ex(S * dscale[:, None] * dscale[None, :])
    dxs = torch.cholesky_solve((b * dscale)[:, None], L)[:, 0]
    dx_cam = (dxs * dscale).view(-1, 6)
    # a failed factorization (non-SPD) gives no step
    ok = (info == 0) & torch.isfinite(dx_cam).all()
    return torch.where(ok, dx_cam, torch.zeros_like(dx_cam)), ok


# CG steps run between two reads of the stop test on the host
_CG_BLOCK = 8


def _pcg_sums(lay: _Layout, side: _Side):
    """ITERATIVE_SCHUR, a shard's share: (grad [nb,6], Bblk [nb,6,6], Sblk
    [nb,6,6]), the reduced right-hand side and the block diagonals of B and
    of the Schur term for the SCHUR_JACOBI preconditioner (same-entry terms
    only; cross-entry couplings of one block stay exact in the matvec,
    merely absent here)."""
    nb = lay.nb
    Jcam, Wslots = side.Jcam, side.Wslots
    f32 = dict(dtype=torch.float32, device=Jcam.device)
    grad = torch.zeros((nb, 6), **f32).index_add_(0, lay.blk, -torch.einsum("mri,mr->mi", Jcam, side.rc))
    Bblk = torch.zeros((nb, 6, 6), **f32).index_add_(0, lay.blk, torch.einsum("mri,mrj->mij", Jcam, Jcam))
    Sblk = torch.zeros((nb, 6, 6), **f32)
    for p0 in range(0, Wslots.shape[0], lay.csize):
        Wg = Wslots[p0 : p0 + lay.csize]
        blkg = lay.blk_slots[p0 : p0 + lay.csize].reshape(-1)
        Y = torch.einsum("ctij,cjk->ctik", Wg, side.Hinv_c[p0 : p0 + lay.csize])
        yb = torch.einsum("ctik,ck->cti", Y, side.bp_c[p0 : p0 + lay.csize])
        grad.index_add_(0, blkg, -yb.reshape(-1, 6))
        # per-entry Schur diagonal contribution Y_e W_e^T
        Sblk.index_add_(0, blkg, torch.einsum("ctik,ctjk->ctij", Y, Wg).reshape(-1, 6, 6))
    return grad, Bblk, Sblk


def _pcg_matvec(lay: _Layout, side: _Side, x):
    """A shard's share of the undamped Schur operator applied to x [nb,6]:
    B (the camera-side JtJ, cross-role couplings included) per observation
    minus the W Hpp^-1 W^T term per point slot."""
    roles, Jcam, Wslots = lay.roles, side.Jcam, side.Wslots
    N = Jcam.shape[0] // roles
    s = torch.einsum("mri,mi->mr", Jcam, x[lay.blk])  # [M,2]
    # cross-role coupling: sum the residual-space contributions per obs
    s_obs = s.view(roles, N, 2).sum(dim=0).repeat(roles, 1)
    out = torch.zeros_like(x).index_add_(0, lay.blk, torch.einsum("mri,mr->mi", Jcam, s_obs))
    u = torch.einsum("ctij,cti->cj", Wslots, x[lay.blk_slots])  # [Ppad,3]
    v = torch.einsum("cij,cj->ci", side.Hinv_c, u)
    ye = torch.einsum("ctij,cj->cti", Wslots, v)
    return out.index_add_(0, lay.blk_slots.reshape(-1), -ye.reshape(-1, 6))


def _pcg_camera_step(cfg, lays: list, sides: list, lam, mesh=None):
    """ITERATIVE_SCHUR: preconditioned CG on S x = b without forming S (the
    reference's ITERATIVE_SCHUR + SCHUR_JACOBI, bundle_adjustment.cc:499-512);
    memory is O(blocks + observations), never O(blocks^2). The CG vectors
    live on the root device; each matvec sends x to the shards and reduces
    their shares (one reduction per CG step, as the JAX package's psum).

    The JAX loop stops on data (lax.while_loop). Here CG runs in blocks of
    _CG_BLOCK steps: once the stop test holds, the remaining steps of the
    block leave x, r, p frozen (masked updates), so the result equals the
    exact-stop loop's while the host reads the test once per block.
    Returns (dx_cam [nb,6] zeroed if not finite, ok, host syncs)."""
    grad, Bblk, Sblk = _reduce(mesh, [_pcg_sums(lay, s) for lay, s in zip(lays, sides)])
    dev = grad.device
    diagB = torch.diagonal(Bblk, dim1=-2, dim2=-1)  # [nb,6]
    dead = (torch.abs(diagB) < 1e-10).to(torch.float32)
    # LM damping on diag(B) (Ceres damps H before elimination)
    lamdiag = lam * diagB + 1e-8 + dead
    # eigen-floor: the approximated block diagonal can lose SPD-ness
    evals, evecs = torch.linalg.eigh(Bblk - Sblk + torch.diag_embed(lamdiag))
    floor = torch.clamp(evals[..., -1:] * 1e-7, min=1e-10)
    Pinv = torch.einsum("bik,bk,bjk->bij", evecs, 1.0 / torch.maximum(evals, floor), evecs)

    def matvec(x):  # x [nb,6]
        xs = _replicate(mesh, x)
        return _reduce(mesh, [(_pcg_matvec(lay, s, xi),) for lay, s, xi in zip(lays, sides, xs)])[0] \
            + lamdiag * x

    def precond(r):
        return torch.einsum("bij,bj->bi", Pinv, r)

    tol2 = cfg.pcg_rtol**2 * torch.sum(grad * grad)
    x = torch.zeros_like(grad)
    r = grad
    p = precond(grad)
    rz = torch.sum(grad * p)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    syncs = 0
    for it in range(cfg.pcg_max_iterations):
        active = ~done & (torch.sum(r * r) > tol2)
        if it % _CG_BLOCK == 0:
            syncs += 1
            if not bool(active):
                break
        Ap = matvec(p)
        pAp = torch.sum(p * Ap)
        # negative-curvature / rounding guard (truncated CG): the damped
        # Schur operator and the SPD preconditioner make pAp, rz >= 0 in
        # exact arithmetic, but f32 rounding near convergence can flip them
        # tiny-negative, and a clamp would then produce an enormous (finite)
        # step. Stop with the current iterate instead.
        bad = (pAp <= 0.0) | (rz <= 0.0)
        one = torch.ones_like(pAp)
        alpha = torch.where(bad, 0.0, rz / torch.where(bad, one, pAp))
        x_n = x + alpha * p
        r_n = r - alpha * Ap
        z = precond(r_n)
        rz_n = torch.sum(r_n * z)
        beta = torch.where(bad, 0.0, rz_n / torch.where(bad, one, rz))
        x = torch.where(active, x_n, x)
        r = torch.where(active, r_n, r)
        p = torch.where(active, z + beta * p, p)
        rz = torch.where(active, rz_n, rz)
        done = done | (active & bad)
    ok = torch.isfinite(x).all()
    return torch.where(ok, x, torch.zeros_like(x)), ok, syncs


def _apply_step(cfg, problem, lay: _Layout, cam_q, cam_t, intr, points, dx_cam, dx_p):
    # fixed cameras may share block 0, so mask
    pose_dx = dx_cam[problem.cam_blk] * (1.0 - problem.pose_fixed)[:, None]
    q2 = se3.quat_normalize(se3.quat_mul(se3.so3_exp_quat(pose_dx[:, :3]), cam_q))
    t2 = cam_t + pose_dx[:, 3:]
    if cfg.refine_intrinsics:
        K = intr.shape[0]
        dintr = dx_cam[lay.nbp : lay.nbp + 2 * K].reshape(K, 12)
        intr = intr + dintr * _intr_refine_mask(cfg, intr.device)[problem.cam_model]
    return q2, t2, intr, points + dx_p


def uses_pcg(problem: BAProblem, cfg: BAConfig) -> bool:
    """The camera-side solver tier: PCG when asked for, or ("auto") above
    dense_max_pose_blocks 6-blocks (the reference's DENSE_SCHUR ->
    ITERATIVE_SCHUR ladder); else the dense Cholesky."""
    C, K = problem.cam_q.shape[0], problem.intr.shape[0]
    nb = (cfg.num_pose_blocks or C) + (2 * K if cfg.refine_intrinsics else 0)
    return cfg.camera_solver == "pcg" or (
        cfg.camera_solver == "auto" and nb > cfg.dense_max_pose_blocks
    )


def solve(problem: BAProblem, cfg: BAConfig) -> BAResult:
    """Run LM on the problem: at most cfg.max_iterations GN steps, stopping
    after max_consecutive_rejects rejected steps or on an accepted step with
    relative cost change below function_tolerance. host_syncs counts the
    LM loop's reads (one per iteration) and the PCG tier's (one per block
    of CG steps). The one-shard case of `solve_shards`."""
    q, t, k, (X,), init_cost, cost, it, syncs = solve_shards([problem], cfg)
    return BAResult(q, t, k, X, init_cost, cost, it, syncs)


def solve_shards(shards: list, cfg: BAConfig, mesh=None):
    """The LM loop over the shards of one problem (parallel/dist_ba.py's
    `shard_problem`; one shard and no mesh: `solve`). Each shard holds the
    cameras (replicated) and its own points with their observations; its
    half of every GN step (point blocks, camera-side sums, back-substitution)
    runs on its device, and the sums meet on `mesh.root` at exactly the JAX
    package's psum points: the cost, the dense tier's S, b and diag B, the
    PCG tier's gradient and preconditioner blocks and each CG matvec. The
    reduced system is solved there once and its step copied to every shard;
    the accept test reads the reduced cost, so the shards stay in lockstep.

    Returns (cam_q, cam_t, intr, [points of each shard], initial_cost,
    final_cost, iterations, host syncs); the cameras are shard 0's."""
    lays = [_layout(p, cfg) for p in shards]
    cams = [(p.cam_q, p.cam_t, p.intr) for p in shards]
    Xs = [p.points for p in shards]

    def cost_of(cams, Xs):
        return _reduce(mesh, [(total_cost(*c, X, p, cfg),) for c, X, p in zip(cams, Xs, shards)])[0]

    cost = init_cost = cost_of(cams, Xs)
    lam = torch.tensor(cfg.initial_lambda, dtype=torch.float32, device=cost.device)
    stall = torch.zeros((), dtype=torch.int64, device=cost.device)
    it = syncs = 0
    while it < cfg.max_iterations:
        sides = [
            _side(lay, *_point_blocks(p, cfg, *c, X, lm))
            for p, lay, c, X, lm in zip(shards, lays, cams, Xs, _replicate(mesh, lam))
        ]
        dx_cam, ok, cg_syncs = _camera_step(cfg, lays, sides, lam, mesh)
        cands = [
            _apply_step(cfg, p, lay, *c, X, dx, _back_substitute(lay, sd, dx, o))
            for p, lay, sd, c, X, dx, o in zip(
                shards, lays, sides, cams, Xs, _replicate(mesh, dx_cam), _replicate(mesh, ok)
            )
        ]
        del sides
        new_cost = cost_of([cd[:3] for cd in cands], [cd[3] for cd in cands])
        accept = new_cost < cost
        accs = _replicate(mesh, accept)
        cams = [tuple(torch.where(a, n, o) for n, o in zip(cd[:3], c)) for a, cd, c in zip(accs, cands, cams)]
        Xs = [torch.where(a, cd[3], X) for a, cd, X in zip(accs, cands, Xs)]
        cost_next = torch.where(accept, new_cost, cost)
        lam = torch.clamp(
            torch.where(accept, lam * 0.33, lam * 8.0), cfg.min_lambda, cfg.max_lambda
        )
        rel = torch.abs(cost - cost_next) / torch.clamp(cost, min=1e-12)
        # accepted tiny step -> converged; rejected step -> one more lambda
        stall = torch.where(
            accept,
            torch.where(rel < cfg.function_tolerance, cfg.max_consecutive_rejects, 0),
            stall + 1,
        )
        cost = cost_next
        it += 1
        syncs += 1 + cg_syncs
        if int(stall) >= cfg.max_consecutive_rejects:
            break
    return (*cams[0], Xs, init_cost, cost, it, syncs)


# ---------------------------------------------------------------------------
# helpers for building problems


def make_problem(
    cam_q,
    cam_t,
    intr,
    points,
    obs_cam,
    obs_pt,
    obs_uv,
    *,
    device=None,
    **kw,
) -> BAProblem:
    """Assemble a BAProblem on `device` (None: CUDA; the CPU only by name)
    from unpadded numpy arrays: `host_problem`'s fields, uploaded."""
    device = device_mod.resolve(device)
    return to_device(host_problem(cam_q, cam_t, intr, points, obs_cam, obs_pt, obs_uv, **kw), device)


def to_device(problem: BAProblem, device) -> BAProblem:
    """Every field of a BAProblem (numpy arrays or tensors) on `device`."""
    return BAProblem(*(torch.as_tensor(v, device=device) for v in problem))


def host_problem(
    cam_q,
    cam_t,
    intr,
    points,
    obs_cam,
    obs_pt,
    obs_uv,
    *,
    cam_k=None,
    cam_model=None,
    cam_blk=None,
    obs_valid=None,
    track_len: int = 16,
    lidar_plane=None,
    lidar_w=None,
    pose_fixed=None,
    tvec_fixed=None,
    point_fixed=None,
    intr_fixed=None,
) -> BAProblem:
    """A BAProblem of numpy arrays (float32 and int64) from unpadded numpy
    arrays; `make_problem` uploads it, parallel/dist_ba.py shards it first.

    Builds the per-point observation table pt_obs [P, track_len]; track_len
    must cover the longest track (checked).
    """
    cam_q = np.asarray(cam_q, np.float32)
    C = cam_q.shape[0]
    points = np.asarray(points, np.float32)
    P = points.shape[0]
    obs_cam = np.asarray(obs_cam, np.int64)
    obs_pt = np.asarray(obs_pt, np.int64)
    N = obs_cam.shape[0]
    intr = np.asarray(intr, np.float32)
    if intr.ndim == 1:
        intr = intr[None, :]
    K = intr.shape[0]
    if intr.shape[1] < 12:
        intr = np.pad(intr, ((0, 0), (0, 12 - intr.shape[1])))
    obs_valid = np.ones((N,), np.float32) if obs_valid is None else np.asarray(obs_valid, np.float32)

    # per-point observation table over the valid observations: stable-sort
    # observations by point, rank within each group
    pt_obs = -np.ones((P, track_len), np.int64)
    vidx = np.nonzero(obs_valid > 0)[0]
    if vidx.size:
        pv = obs_pt[vidx]
        order = np.argsort(pv, kind="stable")
        ps, io = pv[order], vidx[order]
        _, starts, counts = np.unique(ps, return_index=True, return_counts=True)
        if counts.max() > track_len:
            raise ValueError(f"a point has {counts.max()} > track_len={track_len} observations")
        rank = np.arange(ps.size) - np.repeat(starts, counts)
        pt_obs[ps, rank] = io

    def f32(x, shape, val=0.0):
        return np.full(shape, val, np.float32) if x is None else np.asarray(x, np.float32)

    def i64(x, default):
        return default if x is None else np.asarray(x, np.int64)

    return BAProblem(
        cam_q=cam_q,
        cam_t=f32(cam_t, (C, 3)),
        cam_k=i64(cam_k, np.zeros((C,), np.int64)),
        intr=intr,
        cam_model=i64(cam_model, np.zeros((K,), np.int64)),
        points=points,
        obs_cam=obs_cam,
        obs_pt=obs_pt,
        obs_uv=f32(obs_uv, (N, 2)),
        obs_valid=obs_valid,
        pt_obs=pt_obs,
        lidar_plane=f32(lidar_plane, (P, 4)),
        lidar_w=f32(lidar_w, (P,)),
        cam_blk=i64(cam_blk, np.arange(C, dtype=np.int64)),
        pose_fixed=f32(pose_fixed, (C,)),
        tvec_fixed=f32(tvec_fixed, (C, 3)),
        point_fixed=f32(point_fixed, (P,)),
        intr_fixed=f32(intr_fixed, (K,)),
        num_cams=np.asarray(C, np.int64),
        num_points=np.asarray(P, np.int64),
    )
