"""The port's meshing against the JAX package: the spectral Poisson solve
(`_indicator_grid`, `_sample_trilinear`, `poisson_mesh`) on
tests/test_meshing.py's sphere, `marching_tetrahedra` and both Delaunay
meshers on the same inputs, and the behaviours of tests/test_meshing.py on
the port at their own bars."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from colmap_pcd_tpu.models import reconstruction as rec_j
from colmap_pcd_tpu.ops import delaunay as delaunay_j
from colmap_pcd_tpu.ops import meshing as meshing_j
from colmap_pcd_tpu_torch import cli
from colmap_pcd_tpu_torch.io import ply as ply_io
from colmap_pcd_tpu_torch.models import reconstruction as rec_t
from colmap_pcd_tpu_torch.ops import delaunay as delaunay_t
from colmap_pcd_tpu_torch.ops import meshing as meshing_t

from test_meshing import _sphere_cloud

torch.set_num_threads(1)  # tier-1 runs several workers on few cores

# The splat: the JAX package adds f32 contributions one by one, the port
# sums them exactly (32.32 fixed point) and rounds once, so the density
# agrees within DEN_RTOL of its largest value; torch.fft and XLA's FFT
# round differently, so chi agrees within CHI_RTOL of its largest
# magnitude. Trilinear samples of one grid agree within SAMPLE_ATOL. Meshes
# are compared by face count (within FACES_RTOL) and by the distance of
# every vertex to the other mesh's nearest vertex (within VERT_ATOL of the
# unit sphere's scale), not face by face.
DEN_RTOL, CHI_RTOL, SAMPLE_ATOL = 1e-6, 1e-5, 1e-6
FACES_RTOL, VERT_ATOL = 0.01, 1e-3


def _pts01(n=4000, seed=0):
    pts, nrm = _sphere_cloud(np.random.default_rng(seed), n=n)
    lo, hi = pts.min(0), pts.max(0)
    span = float((hi - lo).max())
    return ((pts - (lo - 0.125 * span)) / (1.25 * span)).astype(np.float32), nrm


def test_indicator_grid_matches_jax():
    p01, nrm = _pts01()
    w = np.ones(len(p01), np.float32)
    n = 32
    chi_t, den_t = meshing_t._indicator_grid(torch.as_tensor(p01), torch.as_tensor(nrm), torch.as_tensor(w),
                                             n, 1.5, 1e-3)
    chi_j, den_j = meshing_j._indicator_grid(jnp.asarray(p01), jnp.asarray(nrm), jnp.asarray(w), n,
                                             jnp.float32(1.5), jnp.float32(1e-3))
    chi_j, den_j = np.asarray(chi_j), np.asarray(den_j)
    np.testing.assert_allclose(den_t.numpy(), den_j, atol=DEN_RTOL * np.abs(den_j).max())
    np.testing.assert_allclose(chi_t.numpy(), chi_j, atol=CHI_RTOL * np.abs(chi_j).max())


def test_splat_does_not_depend_on_the_points_order():
    """Fixed-point sums: any order of the same points gives the same bytes
    (on the card, any order the atomics land in)."""
    p01, nrm = _pts01()
    w = torch.ones(len(p01))
    perm = np.random.default_rng(1).permutation(len(p01))
    a = meshing_t._indicator_grid(torch.as_tensor(p01), torch.as_tensor(nrm), w, 32, 1.5, 1e-3)
    b = meshing_t._indicator_grid(torch.as_tensor(p01[perm]), torch.as_tensor(nrm[perm]), w, 32, 1.5, 1e-3)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_sample_trilinear_matches_jax():
    rng = np.random.default_rng(2)
    grid = rng.normal(size=(16, 16, 16)).astype(np.float32)
    pts = rng.uniform(-0.05, 1.05, (500, 3)).astype(np.float32)  # past the edges too
    s_t = meshing_t._sample_trilinear(torch.as_tensor(grid), torch.as_tensor(pts), 16).numpy()
    s_j = np.asarray(meshing_j._sample_trilinear(jnp.asarray(grid), jnp.asarray(pts), 16))
    np.testing.assert_allclose(s_t, s_j, atol=SAMPLE_ATOL)


def _same_mesh(vf_t, vf_j):
    (v_t, f_t), (v_j, f_j) = vf_t, vf_j
    assert abs(len(f_t) - len(f_j)) <= FACES_RTOL * len(f_j), (len(f_t), len(f_j))
    assert cKDTree(v_j).query(v_t)[0].max() < VERT_ATOL
    assert cKDTree(v_t).query(v_j)[0].max() < VERT_ATOL


@pytest.mark.parametrize("trim", [0.0, 9.0])
def test_poisson_mesh_matches_jax(trim):
    pts, nrm = _sphere_cloud(np.random.default_rng(0))
    keep = pts[:, 2] < 0.6  # a missing cap, so the trim has work to do
    opts = dict(depth=6, trim=trim)
    _same_mesh(
        meshing_t.poisson_mesh(pts[keep], nrm[keep], meshing_t.PoissonOptions(**opts), device="cpu"),
        meshing_j.poisson_mesh(pts[keep], nrm[keep], meshing_j.PoissonOptions(**opts)),
    )


def test_marching_tetrahedra_identical_to_jax():
    n = 24
    ax = np.arange(n) - n / 2 + 0.5
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    grid = (np.sqrt(X**2 + Y**2 + Z**2) - 7.0 + 0.3 * np.sin(X)).astype(np.float32)
    for iso in (0.0, 0.7):
        v_t, f_t = meshing_t.marching_tetrahedra(grid, iso)
        v_j, f_j = meshing_j.marching_tetrahedra(grid, iso)
        np.testing.assert_array_equal(v_t, v_j)
        np.testing.assert_array_equal(f_t, f_j)


def _ring_scene(pkg, rng, n_cams=8, npts=220):
    """test_delaunay_sparse_mesh's scene: 8 cameras on a ring of radius 5,
    points on the unit sphere seen by the 3 nearest."""
    rec = pkg.Reconstruction()
    rec.add_camera(pkg.Camera(1, 1, 640, 480, np.asarray([500.0, 500, 320, 240])))
    centers = []
    for i in range(1, n_cams + 1):
        a = 2 * np.pi * i / n_cams
        img = pkg.Image(i, f"v{i}.png", 1, xys=np.zeros((0, 2)))
        img.qvec = np.asarray([1.0, 0, 0, 0])
        img.tvec = -np.asarray([5 * np.cos(a), 0.2, 5 * np.sin(a)])
        rec.add_image(img)
        rec.register_image(i)
        centers.append((i, np.asarray([5 * np.cos(a), 0.2, 5 * np.sin(a)])))
    u = rng.normal(size=(npts, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    for k in range(npts):
        p = pkg.Point3D(xyz=u[k])
        for _, i in sorted((np.linalg.norm(c - u[k]), i) for i, c in centers)[:3]:
            p.track.append((i, 0))
        rec.points3D[k + 1] = p
    return rec


def test_delaunay_meshers_identical_to_jax():
    rec_t_, rec_j_ = (_ring_scene(pkg, np.random.default_rng(5)) for pkg in (rec_t, rec_j))
    for a, b in zip(delaunay_t.sparse_delaunay_mesh(rec_t_), delaunay_j.sparse_delaunay_mesh(rec_j_)):
        np.testing.assert_array_equal(a, b)
    cloud = np.random.default_rng(6).normal(size=(600, 3))
    cloud /= np.linalg.norm(cloud, axis=1, keepdims=True)
    opts_t = delaunay_t.DelaunayMeshingOptions(quality_regularization=0.5, visibility_sigma=2.0)
    opts_j = delaunay_j.DelaunayMeshingOptions(quality_regularization=0.5, visibility_sigma=2.0)
    dense_t = delaunay_t.dense_delaunay_mesh(cloud, rec_t_, opts_t)
    dense_j = delaunay_j.dense_delaunay_mesh(cloud, rec_j_, opts_j)
    assert len(dense_t[1]) > 0
    for a, b in zip(dense_t, dense_j):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------ tests/test_meshing.py on the port
def test_marching_tetrahedra_sphere_sdf():
    n = 48
    ax = np.arange(n) - n / 2 + 0.5
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    r0 = 15.0
    verts, faces = meshing_t.marching_tetrahedra((np.sqrt(X**2 + Y**2 + Z**2) - r0).astype(np.float32), 0.0)
    assert len(faces) > 500
    rad = np.linalg.norm(verts - (n / 2 - 0.5), axis=1)
    assert abs(rad.mean() - r0) < 0.2 and rad.std() < 0.2
    e = np.sort(np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]]), axis=1)
    _, counts = np.unique(e, axis=0, return_counts=True)
    assert (counts == 2).mean() > 0.99


def test_marching_tetrahedra_empty():
    verts, faces = meshing_t.marching_tetrahedra(np.ones((8, 8, 8), np.float32), 0.0)
    assert len(verts) == 0 and len(faces) == 0


def test_poisson_mesh_sphere():
    pts, nrm = _sphere_cloud(np.random.default_rng(0))
    verts, faces = meshing_t.poisson_mesh(pts, nrm, meshing_t.PoissonOptions(depth=6, trim=0.0), device="cpu")
    assert len(faces) > 1000
    rad = np.linalg.norm(verts - verts.mean(axis=0), axis=1)
    assert abs(np.median(rad) - 1.0) < 0.1
    assert np.percentile(np.abs(rad - 1.0), 90) < 0.15


def test_poisson_mesh_trim_removes_unsupported():
    pts, nrm = _sphere_cloud(np.random.default_rng(1))
    keep = pts[:, 2] < 0.6
    v_all, f_all = meshing_t.poisson_mesh(pts[keep], nrm[keep], meshing_t.PoissonOptions(depth=6, trim=0.0),
                                          device="cpu")
    v_tr, f_tr = meshing_t.poisson_mesh(pts[keep], nrm[keep], meshing_t.PoissonOptions(depth=6, trim=9.0),
                                        device="cpu")
    assert len(f_tr) < len(f_all)
    if len(v_tr):
        assert (v_tr[:, 2] > 0.8).mean() < 0.02


def test_poisson_mesh_needs_a_device_by_name():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    pts, nrm = _sphere_cloud(np.random.default_rng(0), n=100)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        meshing_t.poisson_mesh(pts, nrm)


def test_ply_mesh_roundtrip(tmp_path):
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
    faces = np.array([[0, 1, 2], [0, 1, 3], [1, 2, 3]], np.int32)
    p = str(tmp_path / "mesh.ply")
    ply_io.write_ply_mesh(p, verts, faces)
    v2, f2 = ply_io.read_ply_mesh(p)
    np.testing.assert_allclose(v2, verts)
    np.testing.assert_array_equal(f2, faces)


def test_delaunay_sparse_mesh():
    verts, faces = delaunay_t.sparse_delaunay_mesh(_ring_scene(rec_t, np.random.default_rng(0)))
    assert len(faces) > 100, len(faces)
    r = np.linalg.norm(verts[faces.ravel()], axis=1)
    assert np.median(np.abs(r - 1.0)) < 0.15


def test_delaunay_cli(tmp_path):
    rng = np.random.default_rng(0)
    rec = rec_t.Reconstruction()
    rec.add_camera(rec_t.Camera(1, 1, 64, 48, np.asarray([50.0, 50, 32, 24])))
    for i in range(1, 7):
        a = 2 * np.pi * i / 6
        img = rec_t.Image(i, f"v{i}.png", 1, xys=np.zeros((0, 2)))
        img.qvec = np.asarray([1.0, 0, 0, 0])
        img.tvec = -np.asarray([4 * np.cos(a), 0.0, 4 * np.sin(a)])
        rec.add_image(img)
        rec.register_image(i)
    u = rng.normal(size=(120, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    for k in range(120):
        p = rec_t.Point3D(xyz=u[k])
        p.track = [(1 + k % 6, 0), (1 + (k + 1) % 6, 0)]
        rec.points3D[k + 1] = p
    sp = tmp_path / "sparse"
    rec.write(str(sp))
    out = tmp_path / "mesh.ply"
    assert cli.main(["delaunay_mesher", "--input_path", str(sp), "--output_path", str(out),
                     "--input_type", "sparse", "--device", "cpu"]) == 0
    assert out.exists()
