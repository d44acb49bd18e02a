"""Surface meshing from oriented point clouds: the spectral Poisson mesher.

Port of colmap_pcd_tpu/ops/meshing.py, the re-design of the reference's
octree PoissonRecon (src/mvs/meshing.h:106-125 PoissonMeshing,
lib/PoissonRecon/*):

  1. splat oriented normals into a regular vector grid (trilinear weights),
  2. solve the screened Poisson equation (div V = Laplacian chi) spectrally
     with 3D FFTs (`torch.fft.fftn` / `ifftn` on complex64), the Gaussian
     smoothing of PoissonRecon's B-spline basis a spectral multiply in the
     same pass,
  3. pick the isovalue as the mean indicator value at the input samples
     (PoissonRecon's GetIsoValue), and
  4. extract the isosurface with vectorized marching tetrahedra plus a
     density trim mirroring PoissonRecon's SurfaceTrimmer.

Steps 1-3 run on the device. The splat adds in 32.32 fixed point in int64
(`index_add_`), which is exact in any order, so the card's atomics give
the same bytes on every run; the sums are rounded to f32 once. Step 4 is
the JAX package's host code, carried unchanged; the grid, the density and
the isovalue come back to the host in one fetch (PHASES `poisson_fetch`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import device as device_mod
from ..utils.logging_utils import PHASES

Tensor = torch.Tensor

# the splat's fixed point: contributions of magnitude <= 1 in units of
# 2^-32, so a voxel may sum 2^31 of them in int64
_FIXED_ONE = float(1 << 32)


@dataclass
class PoissonOptions:
    """Mirrors PoissonMeshingOptions (src/mvs/meshing.h:40-60): depth/trim
    have the same meaning; point_weight maps to the screening strength."""

    depth: int = 7  # grid resolution 2^depth per axis
    point_weight: float = 1.0  # screening (interpolation) weight
    trim: float = 7.0  # density-based trimming threshold (0 = keep all)
    smooth_sigma_vox: float = 1.5  # Gaussian smoothing of the splat field
    padding: float = 0.125  # bbox padding fraction (guards FFT periodic wrap)


# ----------------------------------------------------------------- device part
def _corners(pts01: Tensor, n: int, clip_hi: int | None):
    """(i0 [P,3] int64, f [P,3]) of the trilinear stencil at pts01 * n - 0.5;
    i0 clipped to [0, clip_hi] when clip_hi is given."""
    x = pts01 * n - 0.5
    i0 = torch.floor(x)
    if clip_hi is not None:
        i0 = torch.clamp(i0, 0, clip_hi)
    return i0.long(), x - i0


def _corner_weight(f: Tensor, dx: int, dy: int, dz: int) -> Tensor:
    return (
        (f[:, 0] if dx else 1 - f[:, 0])
        * (f[:, 1] if dy else 1 - f[:, 1])
        * (f[:, 2] if dz else 1 - f[:, 2])
    )


def _indicator_grid(pts01: Tensor, normals: Tensor, weights: Tensor, n: int, sigma_vox: float, screen: float):
    """Splat -> smooth -> screened spectral Poisson solve.

    pts01: [P,3] points scaled to [0,1)^3; normals: [P,3] unit normals;
    returns (chi [n,n,n] indicator field, density [n,n,n] splat mass), f32
    on the inputs' device.
    """
    dev = pts01.device
    i0, f = _corners(pts01, n, None)
    acc = torch.zeros((n * n * n, 4), dtype=torch.int64, device=dev)
    # trilinear splat over the 8 corners, each contribution rounded to 32.32
    # fixed point: integer sums do not depend on the order the atomics land in
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = _corner_weight(f, dx, dy, dz) * weights
                idx = torch.clamp(i0 + torch.tensor([dx, dy, dz], device=dev), 0, n - 1)
                lin = (idx[:, 0] * n + idx[:, 1]) * n + idx[:, 2]
                vals = torch.cat([w[:, None] * normals, w[:, None]], 1)
                acc.index_add_(0, lin, torch.round(vals.double() * _FIXED_ONE).long())
    sums = (acc.double() / _FIXED_ONE).float().reshape(n, n, n, 4)
    vec, den = sums[..., :3], sums[..., 3].contiguous()

    # spectral pipeline: F(div V) with smoothing, divided by Laplacian symbol
    k = torch.fft.fftfreq(n, device=dev, dtype=torch.float32)  # cycles per voxel
    kx, ky, kz = torch.meshgrid(k, k, k, indexing="ij")
    # Gaussian smoothing in voxel units
    sig = torch.tensor(sigma_vox, dtype=torch.float32, device=dev)
    g = torch.exp(-2.0 * (math.pi * sig) ** 2 * (kx * kx + ky * ky + kz * kz))

    def dsym(kk):
        """spectral central-difference derivative symbol i*sin(2 pi k), h = 1 voxel"""
        return torch.complex(torch.zeros_like(kk), torch.sin(2 * math.pi * kk))

    def sin2(kk):
        s = torch.sin(math.pi * kk)
        return s * s

    # discrete 7-point Laplacian symbol: -4 sum sin^2(pi k)
    lap = -4.0 * (sin2(kx) + sin2(ky) + sin2(kz))
    Vx = torch.fft.fftn(vec[..., 0].contiguous())
    Vy = torch.fft.fftn(vec[..., 1].contiguous())
    Vz = torch.fft.fftn(vec[..., 2].contiguous())
    divF = dsym(kx) * Vx + dsym(ky) * Vy + dsym(kz) * Vz
    denom = lap - screen
    chiF = torch.where(denom == 0, torch.zeros_like(divF), g * divF / denom)
    chi = torch.fft.ifftn(chiF).real.to(torch.float32)
    return chi, den


def _sample_trilinear(grid: Tensor, pts01: Tensor, n: int) -> Tensor:
    i0, f = _corners(pts01, n, n - 2)
    flat = grid.reshape(-1)
    out = torch.zeros_like(f[:, 0])
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = _corner_weight(f, dx, dy, dz)
                lin = ((i0[:, 0] + dx) * n + (i0[:, 1] + dy)) * n + (i0[:, 2] + dz)
                out = out + w * flat[lin]
    return out


# ------------------------------------------------------- marching tetrahedra
# 6-tetrahedra decomposition of the unit cube (corners indexed by (x,y,z) bits
# -> corner id x*4+y*2+z). Every tet contains the main diagonal 0-7, so faces
# between adjacent cubes match up and the extracted surface is watertight on
# interior cells.
_TETS = np.array(
    [
        [0, 5, 1, 7],
        [0, 1, 3, 7],
        [0, 3, 2, 7],
        [0, 2, 6, 7],
        [0, 6, 4, 7],
        [0, 4, 5, 7],
    ],
    np.int32,
)
_CORNER = np.array(
    [[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)], np.int32
)
# tet edges (pairs of local tet-vertex ids 0..3)
_TET_EDGES = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], np.int32)
_EDGE_ID = {(int(a), int(b)): i for i, (a, b) in enumerate(_TET_EDGES)}
_EDGE_ID.update({(b, a): i for (a, b), i in list(_EDGE_ID.items())})


def _build_tet_table() -> np.ndarray:
    """case -> up to 2 triangles of tet-edge ids (-1 padded). Case bit i set
    <=> tet vertex i is inside (value < iso). Generated, not hand-written:
    |S|=1/3 -> one triangle on the 3 crossing edges, |S|=2 -> the crossing
    quad split along a diagonal. Winding is normalized by the gradient check
    in marching_tetrahedra."""
    table = -np.ones((16, 6), np.int32)
    for case in range(1, 15):
        inside = [v for v in range(4) if case >> v & 1]
        outside = [v for v in range(4) if not case >> v & 1]
        if len(inside) == 1:
            (v,) = inside
            table[case, :3] = [_EDGE_ID[(v, o)] for o in outside]
        elif len(inside) == 3:
            (v,) = outside
            table[case, :3] = [_EDGE_ID[(v, o)] for o in inside]
        else:
            a, b = inside
            c, d = outside
            # quad in cyclic order: (a,c) (b,c) (b,d) (a,d)
            q = [_EDGE_ID[(a, c)], _EDGE_ID[(b, c)], _EDGE_ID[(b, d)], _EDGE_ID[(a, d)]]
            table[case] = [q[0], q[1], q[2], q[0], q[2], q[3]]
    return table


_TET_TRIS = _build_tet_table()


def marching_tetrahedra(grid: np.ndarray, iso: float = 0.0):
    """Extract the iso-surface of a [n,n,n] scalar grid as a triangle soup,
    vectorized over all cells x 6 tets. Returns (verts [V,3] in voxel coords,
    faces [F,3] int32) with deduplicated vertices."""
    n = grid.shape[0]
    # candidate cells: sign change within the cell's 8 corners
    c = grid < iso
    occ = np.zeros((n - 1, n - 1, n - 1), bool)
    anyin = np.zeros_like(occ)
    allin = np.ones_like(occ)
    for dx, dy, dz in _CORNER:
        v = c[dx : n - 1 + dx, dy : n - 1 + dy, dz : n - 1 + dz]
        anyin |= v
        allin &= v
    occ = anyin & ~allin
    cidx = np.argwhere(occ)  # [C,3]
    if cidx.size == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    corner_pos = cidx[:, None, :] + _CORNER[None, :, :]  # [C,8,3]
    corner_val = grid[corner_pos[..., 0], corner_pos[..., 1], corner_pos[..., 2]]

    vals = corner_val[:, _TETS]  # [C,6,4]
    pos = corner_pos[:, _TETS, :]  # [C,6,4,3]

    inside = vals < iso
    case = (
        inside[..., 0] * 1 + inside[..., 1] * 2 + inside[..., 2] * 4 + inside[..., 3] * 8
    )  # [C,6]

    # edge interpolation points for all 6 tet edges: [C,6,6,3]
    a = _TET_EDGES[:, 0]
    b = _TET_EDGES[:, 1]
    va = vals[..., a]
    vb = vals[..., b]
    denom = va - vb
    t = np.where(np.abs(denom) < 1e-12, 0.5, (va - iso) / np.where(denom == 0, 1, denom))
    t = np.clip(t, 0.0, 1.0)
    pa = pos[:, :, a, :]
    pb = pos[:, :, b, :]
    epts = pa + t[..., None] * (pb - pa)  # [C,6,6edges,3]

    tris = _TET_TRIS[case]  # [C,6,6]
    valid = tris >= 0
    # first triangle
    out = []
    for k in (0, 1):
        sl = tris[:, :, 3 * k : 3 * k + 3]  # [C,6,3]
        ok = (sl >= 0).all(axis=-1)
        if not ok.any():
            continue
        ci, ti = np.nonzero(ok)
        e = sl[ci, ti]  # [M,3]
        tri = epts[ci[:, None], ti[:, None], e]  # [M,3,3]
        out.append(tri)
    if not out:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    soup = np.concatenate(out, axis=0).astype(np.float32)  # [F,3,3]

    # orient consistently: flip triangles whose normal points against the
    # field gradient (outward = increasing chi)
    g = np.stack(np.gradient(grid), axis=-1)
    ctr = soup.mean(axis=1)
    ci = np.clip(ctr.astype(np.int32), 0, n - 1)
    gc = g[ci[:, 0], ci[:, 1], ci[:, 2]]
    nrm = np.cross(soup[:, 1] - soup[:, 0], soup[:, 2] - soup[:, 0])
    flip = (nrm * gc).sum(-1) < 0
    soup[flip] = soup[flip][:, ::-1]

    # dedup vertices (quantize to 1e-4 voxel)
    flat = soup.reshape(-1, 3)
    key = np.round(flat * 1e4).astype(np.int64)
    _, uniq_idx, inv = np.unique(
        key.view([("x", np.int64), ("y", np.int64), ("z", np.int64)]).reshape(-1),
        return_index=True,
        return_inverse=True,
    )
    verts = flat[uniq_idx]
    faces = inv.reshape(-1, 3).astype(np.int32)
    # drop degenerate faces
    good = (
        (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) & (faces[:, 0] != faces[:, 2])
    )
    return verts, faces[good]


# ---------------------------------------------------------------- entry point
def poisson_mesh(
    points: np.ndarray,
    normals: np.ndarray,
    opts: PoissonOptions = PoissonOptions(),
    device=None,
):
    """Oriented point cloud -> triangle mesh (verts [V,3] world, faces [F,3]).

    Parity: mvs::PoissonMeshing (src/mvs/meshing.cc) — same inputs (fused
    cloud with normals), same knobs (depth/trim), a spectral solve on
    `device` (None: CUDA) instead of the vendored octree multigrid.
    """
    points = np.asarray(points, np.float32)
    normals = np.asarray(normals, np.float32)
    assert points.shape == normals.shape and points.shape[1] == 3
    nlen = np.linalg.norm(normals, axis=1)
    keep = nlen > 1e-6
    points, normals, nlen = points[keep], normals[keep], nlen[keep]
    normals = normals / nlen[:, None]
    if points.shape[0] < 16:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    dev = device_mod.resolve(device)
    n = 1 << opts.depth
    lo = points.min(axis=0)
    hi = points.max(axis=0)
    span = float((hi - lo).max()) or 1.0
    pad = span * opts.padding
    origin = lo - pad
    scale = span + 2 * pad
    pts01 = (points - origin) / scale

    p = torch.as_tensor(np.ascontiguousarray(pts01, np.float32), device=dev)
    chi, den = _indicator_grid(
        p,
        torch.as_tensor(np.ascontiguousarray(normals, np.float32), device=dev),
        torch.ones(points.shape[0], dtype=torch.float32, device=dev),
        n,
        opts.smooth_sigma_vox,
        opts.point_weight * 1e-3,
    )
    iso = torch.mean(_sample_trilinear(chi, p, n))
    with PHASES.phase("poisson_fetch"):
        host = torch.cat([chi.reshape(-1), den.reshape(-1), iso.reshape(1)]).cpu().numpy()
    chi_np = host[: n**3].reshape(n, n, n)
    den_np = host[n**3 : 2 * n**3].reshape(n, n, n)
    verts_vox, faces = marching_tetrahedra(chi_np, float(host[-1]))
    if len(verts_vox) == 0:
        return verts_vox, faces

    if opts.trim > 0:
        # SurfaceTrimmer analog: drop faces in low-sample-density space.
        # smooth density a little so trim is stable across splat quantization
        thresh = opts.trim * float(den_np[den_np > 0].mean()) * 0.01
        ci = np.clip(verts_vox.astype(np.int32), 0, n - 1)
        vd = den_np[ci[:, 0], ci[:, 1], ci[:, 2]]
        # a face survives if any vertex sits in supported space
        fd = vd[faces].max(axis=1)
        faces = faces[fd >= thresh]
        used = np.unique(faces)
        remap = -np.ones(len(verts_vox), np.int64)
        remap[used] = np.arange(used.size)
        verts_vox = verts_vox[used]
        faces = remap[faces].astype(np.int32)

    verts = verts_vox / n * scale + origin
    return verts.astype(np.float32), faces
