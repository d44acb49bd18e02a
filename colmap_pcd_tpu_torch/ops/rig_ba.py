"""Camera-rig bundle adjustment.

Port of colmap_pcd_tpu/ops/rig_ba.py (the reference's RigBundleAdjuster +
RigBundleAdjustmentCostFunction, src/optim/bundle_adjustment.h:322-379,
bundle_adjustment.cc:700-900, base/cost_functions.h:501-561): every image
pose is the composition of a per-snapshot rig pose and a per-rig-camera
relative pose,

    x_cam = R_rel (R_rig x_world + t_rig) + t_rel,

and both factors are optimized jointly with the 3D points. The machinery is
ops/ba.py's: per-observation Jacobians for the two camera-side 6-blocks (rig
tangent, rel tangent) and the point by forward mode (`torch.func.jvp` over
the 15 tangent directions), point blocks eliminated per 3x3 (Schur) over
chunks of points, the reduced camera system (6 * (S + R) unknowns) solved
densely by Cholesky. As in the JAX package, LM damps the reduced system's
diagonal. The LM loop is a Python loop with one host read per iteration
(RigBAResult.host_syncs counts them).

Images that are not part of any rig get their own snapshot slot and share a
frozen identity relative pose (slot 0), so one problem holds mixed rig and
non-rig reconstructions. Shapes are padded and masked exactly as in the JAX
package, so one problem feeds both implementations.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import device as device_mod
from . import ba as ba_ops
from . import se3

Tensor = torch.Tensor


class RigBAConfig(NamedTuple):
    """Solve configuration (same fields and defaults as the JAX RigBAConfig)."""

    model_id: int = 1
    model_ids: tuple = ()
    loss_type: int = ba_ops.LOSS_TRIVIAL
    loss_scale: float = 1.0
    max_iterations: int = 50
    refine_relative_poses: bool = True  # RigBundleAdjuster::Options
    point_chunk: int = 512
    initial_lambda: float = 1e-4
    min_lambda: float = 1e-10
    max_lambda: float = 1e8


class RigBAProblem(NamedTuple):
    """Padded rig BA problem (tensors on one device).

    Shapes: S = snapshot (rig pose) slots, R = relative-pose slots,
    K = intrinsics slots, P = point slots, N = observation slots,
    T = max observations per point.
    """

    rig_q: Tensor  # [S,4] world-to-rig quaternion
    rig_t: Tensor  # [S,3]
    rel_q: Tensor  # [R,4] rig-to-camera quaternion
    rel_t: Tensor  # [R,3]
    intr: Tensor  # [K,12]
    cam_model: Tensor  # [K] int64 index into cfg.model_ids
    points: Tensor  # [P,3]
    obs_rig: Tensor  # [N] int64 snapshot slot
    obs_rel: Tensor  # [N] int64 relative-pose slot
    obs_k: Tensor  # [N] int64 intrinsics slot
    obs_pt: Tensor  # [N] int64 point slot
    obs_uv: Tensor  # [N,2]
    obs_valid: Tensor  # [N] f32 {0,1}
    pt_obs: Tensor  # [P,T] int64 obs index, -1 padded
    rig_fixed: Tensor  # [S] f32 {0,1}
    rel_fixed: Tensor  # [R] f32 {0,1}
    point_fixed: Tensor  # [P] f32 {0,1}


class RigBAResult(NamedTuple):
    rig_q: Tensor
    rig_t: Tensor
    rel_q: Tensor
    rel_t: Tensor
    points: Tensor
    initial_cost: Tensor
    final_cost: Tensor
    iterations: int
    host_syncs: int  # device->host waits taken by the LM loop


def _residual(cfg, q_rig, t_rig, q_rel, t_rel, kparams, X, uv, midx):
    """Reprojection residual through the composed pose (masked behind the
    camera and clamped, as ba._reproj_residual)."""
    q, t = se3.se3_compose(q_rel, t_rel, q_rig, t_rig)
    return ba_ops._reproj_residual(cfg, q, t, kparams, X, uv, midx)


def _gathered(problem: RigBAProblem, rig_q, rig_t, rel_q, rel_t, points):
    """Per-observation parameters (q_rig, t_rig, q_rel, t_rel, k, X, uv, midx)."""
    return (rig_q[problem.obs_rig], rig_t[problem.obs_rig], rel_q[problem.obs_rel],
            rel_t[problem.obs_rel], problem.intr[problem.obs_k], points[problem.obs_pt],
            problem.obs_uv, problem.cam_model[problem.obs_k])


def total_cost(rig_q, rig_t, rel_q, rel_t, points, problem: RigBAProblem, cfg: RigBAConfig) -> Tensor:
    r = _residual(cfg, *_gathered(problem, rig_q, rig_t, rel_q, rel_t, points))
    sq = torch.sum(r * r, dim=-1) * problem.obs_valid
    return torch.sum(ba_ops._rho(sq, cfg) * problem.obs_valid)


def _obs_jacobians(problem: RigBAProblem, cfg: RigBAConfig, rig_q, rig_t, rel_q, rel_t, points):
    """Residuals r [N,2] and Jacobians wrt the rig tangent Jg [N,2,6], the
    rel tangent Jr [N,2,6] and the point Jp [N,2,3] at delta = 0, robust
    weighted, with frozen parameters and invalid observations zeroed."""
    q_rig, t_rig, q_rel, t_rel, k, X, uv, midx = _gathered(problem, rig_q, rig_t, rel_q, rel_t, points)
    N = q_rig.shape[0]

    def f(dg, dr, dx):
        qg = se3.quat_mul(se3.so3_exp_quat(dg[:, :3]), q_rig)
        qr = se3.quat_mul(se3.so3_exp_quat(dr[:, :3]), q_rel)
        return _residual(cfg, qg, t_rig + dg[:, 3:], qr, t_rel + dr[:, 3:], k, X + dx, uv, midx)

    widths = (6, 6, 3)
    primals = tuple(torch.zeros((N, w), dtype=X.dtype, device=X.device) for w in widths)
    basis = torch.eye(sum(widths), dtype=X.dtype, device=X.device)

    def push(e):  # one tangent direction, shared by every observation
        return torch.func.jvp(f, primals, tuple(x.expand(N, -1) for x in torch.split(e, widths)))
    r, J = torch.func.vmap(push, out_dims=(None, 0))(basis)  # J [15,N,2]
    J = J.permute(1, 2, 0)  # [N,2,15]

    sq = torch.sum(r * r, dim=-1)
    w = torch.sqrt(torch.clamp(ba_ops._sqrt_rho_deriv(sq, cfg), min=1e-12)) * problem.obs_valid
    rel_live = (1.0 - problem.rel_fixed[problem.obs_rel]) * (1.0 if cfg.refine_relative_poses else 0.0)
    Jg = J[..., :6] * (w * (1.0 - problem.rig_fixed[problem.obs_rig]))[:, None, None]
    Jr = J[..., 6:12] * (w * rel_live)[:, None, None]
    Jp = J[..., 12:] * (w * (1.0 - problem.point_fixed[problem.obs_pt]))[:, None, None]
    return r * w[:, None], Jg, Jr, Jp


def _layout(problem: RigBAProblem, cfg: RigBAConfig) -> ba_ops._Layout:
    """Schur bookkeeping: two camera-side roles per observation, the
    snapshot's rig block and (after the S rig blocks) its relative-pose
    block."""
    S, R = problem.rig_q.shape[0], problem.rel_q.shape[0]
    N = problem.obs_rig.shape[0]
    blk = torch.cat([problem.obs_rig, S + problem.obs_rel])
    csize, slot_all, blk_slots = ba_ops._slot_tables(problem.pt_obs, N, 2, blk, cfg.point_chunk)
    return ba_ops._Layout(S + R, S + R, 2, csize, blk, torch.cat([problem.obs_pt] * 2), slot_all,
                          blk_slots, False)


def _gn_system(problem: RigBAProblem, cfg: RigBAConfig, lay, rig_q, rig_t, rel_q, rel_t, points, lam):
    """One damped GN step: (dx_blocks [S+R,6], dx_points [P,3])."""
    P = points.shape[0]
    f32 = dict(dtype=torch.float32, device=points.device)
    r, Jg, Jr, Jp = _obs_jacobians(problem, cfg, rig_q, rig_t, rel_q, rel_t, points)
    Hpp = torch.zeros((P, 3, 3), **f32).index_add_(0, problem.obs_pt, torch.einsum("nri,nrj->nij", Jp, Jp))
    b_p = torch.zeros((P, 3), **f32).index_add_(0, problem.obs_pt, -torch.einsum("nri,nr->ni", Jp, r))
    diagH = torch.diagonal(Hpp, dim1=-2, dim2=-1)
    Hpp_inv = ba_ops._inv3(Hpp + torch.diag_embed(lam * diagH + 1e-8 + 1e-6))
    dx_cam, dx_p, _ = ba_ops._reduced_step(
        cfg, lay, torch.cat([Jg, Jr]), torch.cat([r, r]), torch.cat([Jp, Jp]), Hpp_inv, b_p, lam,
        damp_reduced=True,
    )
    return dx_cam, dx_p


def _apply_step(problem: RigBAProblem, rig_q, rig_t, rel_q, rel_t, points, dx_cam, dx_p):
    S = problem.rig_q.shape[0]
    dg, dr = dx_cam[:S], dx_cam[S:]
    rig_q2 = se3.quat_normalize(se3.quat_mul(se3.so3_exp_quat(dg[:, :3]), rig_q))
    rel_q2 = se3.quat_normalize(se3.quat_mul(se3.so3_exp_quat(dr[:, :3]), rel_q))
    return rig_q2, rig_t + dg[:, 3:], rel_q2, rel_t + dr[:, 3:], points + dx_p


def solve(problem: RigBAProblem, cfg: RigBAConfig) -> RigBAResult:
    """LM on the problem: at most cfg.max_iterations GN steps, stopping once
    four steps in a row were rejected or accepted with a relative cost change
    below 1e-6 (the JAX package's stall rule). One host read per iteration."""
    lay = _layout(problem, cfg)
    state = (problem.rig_q, problem.rig_t, problem.rel_q, problem.rel_t, problem.points)
    cost = init_cost = total_cost(*state, problem, cfg)
    lam = torch.tensor(cfg.initial_lambda, dtype=torch.float32, device=problem.points.device)
    stall = torch.zeros((), dtype=torch.int64, device=lam.device)
    it = 0
    while it < cfg.max_iterations:
        dx_cam, dx_p = _gn_system(problem, cfg, lay, *state, lam)
        cand = _apply_step(problem, *state, dx_cam, dx_p)
        new_cost = total_cost(*cand, problem, cfg)
        accept = new_cost < cost
        state = tuple(torch.where(accept, b, a) for a, b in zip(state, cand))
        cost_next = torch.where(accept, new_cost, cost)
        lam = torch.clamp(torch.where(accept, lam * 0.33, lam * 8.0), cfg.min_lambda, cfg.max_lambda)
        rel = torch.abs(cost - cost_next) / torch.clamp(cost, min=1e-12)
        stall = torch.where(accept & (rel >= 1e-6), torch.zeros_like(stall), stall + 1)
        cost = cost_next
        it += 1
        if int(stall) >= 4:
            break
    return RigBAResult(*state, init_cost, cost, it, it)


def make_problem(
    rig_q,
    rig_t,
    rel_q,
    rel_t,
    intr,
    points,
    obs_rig,
    obs_rel,
    obs_k,
    obs_pt,
    obs_uv,
    *,
    device=None,
    cam_model=None,
    obs_valid=None,
    track_len: int = 16,
    rig_fixed=None,
    rel_fixed=None,
    point_fixed=None,
) -> RigBAProblem:
    """Assemble a RigBAProblem on `device` (None: CUDA; the CPU only by name)
    from numpy arrays, with the per-point observation table pt_obs
    [P, track_len] (track_len must cover the longest track; checked)."""
    device = device_mod.resolve(device)
    points = np.asarray(points, np.float32)
    obs_pt = np.asarray(obs_pt, np.int64)
    N, P = obs_pt.shape[0], points.shape[0]
    intr = np.asarray(intr, np.float32)
    if intr.ndim == 1:
        intr = intr[None, :]
    K = intr.shape[0]
    if intr.shape[1] < 12:
        intr = np.pad(intr, ((0, 0), (0, 12 - intr.shape[1])))
    obs_valid = np.ones((N,), np.float32) if obs_valid is None else np.asarray(obs_valid, np.float32)

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

    def f32(x, shape=None):
        a = np.zeros(shape, np.float32) if x is None else np.asarray(x, np.float32)
        return torch.as_tensor(a, device=device)

    def i64(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=device)

    rig_q, rel_q = f32(rig_q), f32(rel_q)
    return RigBAProblem(
        rig_q=rig_q, rig_t=f32(rig_t), rel_q=rel_q, rel_t=f32(rel_t), intr=f32(intr),
        cam_model=i64(np.zeros((K,)) if cam_model is None else cam_model),
        points=f32(points), obs_rig=i64(obs_rig), obs_rel=i64(obs_rel), obs_k=i64(obs_k),
        obs_pt=i64(obs_pt), obs_uv=f32(obs_uv), obs_valid=f32(obs_valid), pt_obs=i64(pt_obs),
        rig_fixed=f32(rig_fixed, (rig_q.shape[0],)), rel_fixed=f32(rel_fixed, (rel_q.shape[0],)),
        point_fixed=f32(point_fixed, (P,)),
    )
