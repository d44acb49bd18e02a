"""The port's `mapper` command end to end on files, its isolation from JAX,
and the synthetic world it is tested on."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import synthetic
import synthetic_torch
from colmap_pcd_tpu_torch import cli
from colmap_pcd_tpu_torch.models.reconstruction import Reconstruction

torch.set_num_threads(1)  # tier-1 runs several workers on few cores

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "colmap_pcd_tpu_torch"


def _world_files(tmp_path, n_images, n_points, seed=7):
    rec, graph, lmap, gt = synthetic_torch.make_world(
        np.random.default_rng(seed), n_images=n_images, n_points=n_points, noise_px=0.3
    )
    return synthetic_torch.write_world(rec, graph, lmap, gt, str(tmp_path)), gt


_SMALL_WORLD_FLAGS = (
    "--Mapper.abs_pose_min_num_inliers", "15",
    "--Mapper.init_min_num_inliers", "50",
    "--Mapper.multiple_models", "0",
    "--device", "cpu",
)


def test_cli_mapper_lidar_world(tmp_path):
    """`mapper` on test_e2e_lidar_mapping's world written to a database, a
    lidar PLY and a pose-prior file; the model read back meets its bars."""
    paths, gt = _world_files(tmp_path, 8, 600)
    out = tmp_path / "out"
    rc = cli.main(synthetic_torch.mapper_argv(paths, str(out), *_SMALL_WORLD_FLAGS))
    assert rc == 0
    rec = Reconstruction.read(str(out / "0"))
    assert rec.num_reg_images >= 7, rec.num_reg_images
    assert synthetic_torch.ate_rmse(rec, gt) < 0.10
    assert synthetic_torch.scale_error(rec, gt) < 0.02


def test_cli_reports_unported_commands(capsys):
    """Every command of the JAX CLI is ported (the dense four since step
    10), so none answers "not yet ported"; a name neither CLI has is
    reported as unknown."""
    from colmap_pcd_tpu import cli as cli_j

    assert sorted(cli.COMMANDS) == sorted(cli_j.COMMANDS)
    assert cli.main(["frobnicate", "--workspace_path", "x"]) == 1
    out = capsys.readouterr().out
    assert "unknown command" in out and "not yet ported" not in out
    assert cli.main(["--help"]) == 0


def test_port_path_never_imports_jax(tmp_path):
    """The CLI slice in a fresh interpreter where `import jax` fails loudly
    (sys.modules["jax"] = None): any JAX import on the port's path raises."""
    paths, gt = _world_files(tmp_path, 5, 400, seed=3)
    out = tmp_path / "out"
    argv = synthetic_torch.mapper_argv(paths, str(out), *_SMALL_WORLD_FLAGS)
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import torch; torch.set_num_threads(1)\n"
        "from colmap_pcd_tpu_torch import cli\n"
        f"rc = cli.main({argv!r})\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'colmap_pcd_tpu.'))"
        " for m in sys.modules if sys.modules[m] is not None), 'jax imported'\n"
        "sys.exit(rc)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert Reconstruction.read(str(out / "0")).num_reg_images >= 4


def test_port_matcher_and_classic_mapper_never_import_jax(tmp_path):
    """`sequential_matcher`, then `mapper` without a lidar map, in a fresh
    interpreter where `import jax` fails loudly."""
    rec, graph, lmap, gt, desc, _ = synthetic_torch.make_descriptor_world(
        np.random.default_rng(11), n_images=5, n_points=400, noise_px=0.2
    )
    paths = synthetic_torch.write_world(rec, graph, lmap, gt, str(tmp_path), descriptors=desc)
    out = tmp_path / "out"
    match_argv = ["sequential_matcher", "--database_path", paths["database"], "--device", "cpu"]
    map_argv = synthetic_torch.classic_mapper_argv(
        paths, str(out), (1, 3), "--Mapper.init_min_tri_angle", "2",
        "--Mapper.init_min_num_inliers", "30", "--Mapper.abs_pose_min_num_inliers", "15",
        "--Mapper.multiple_models", "0", "--device", "cpu",
    )
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import torch; torch.set_num_threads(1)\n"
        "from colmap_pcd_tpu_torch import cli\n"
        f"assert cli.main({match_argv!r}) == 0\n"
        f"rc = cli.main({map_argv!r})\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'colmap_pcd_tpu.'))"
        " for m in sys.modules if sys.modules[m] is not None), 'jax imported'\n"
        "sys.exit(rc)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert Reconstruction.read(str(out / "0")).num_reg_images >= 4


def test_port_sources_have_no_jax_import():
    offenders = [
        str(p.relative_to(REPO))
        for p in PORT.rglob("*.py")
        for line in p.read_text().splitlines()
        if line.strip().startswith(("import jax", "from jax"))
    ]
    assert not offenders, offenders


@pytest.mark.parametrize("seed", [7, 11])
def test_synthetic_torch_builds_the_jax_world(seed):
    """tests/synthetic_torch.py builds the same world as tests/synthetic.py
    for a seed: map, ground truth, keypoints and matches."""
    rec_j, graph_j, lmap_j, gt_j = synthetic.make_world(np.random.default_rng(seed), n_images=6, n_points=400)
    rec_t, graph_t, lmap_t, gt_t = synthetic_torch.make_world(np.random.default_rng(seed), n_images=6, n_points=400)
    np.testing.assert_array_equal(lmap_t.points, lmap_j.points)
    np.testing.assert_array_equal(lmap_t.normals, lmap_j.normals)
    for (qj, tj), (qt, tt) in zip(gt_j, gt_t):
        np.testing.assert_array_equal(qt, qj)
        np.testing.assert_array_equal(tt, tj)
    assert sorted(rec_t.images) == sorted(rec_j.images)
    for iid in rec_j.images:
        np.testing.assert_array_equal(rec_t.images[iid].xys, rec_j.images[iid].xys)
    assert sorted(graph_t.image_pairs()) == sorted(graph_j.image_pairs())
    for i, j in graph_j.image_pairs():
        np.testing.assert_array_equal(graph_t.matches_between(i, j), graph_j.matches_between(i, j))
