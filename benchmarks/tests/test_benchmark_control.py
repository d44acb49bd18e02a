"""The comparison that decides `correct` fails where it must, at a size the
CPU runs (benchmarks/tests/tiny.py).

- The controls: each of the cell's own `controls` (a guarantee of the
  configuration broken: the lidar constraints weighed at 0, the two-view
  verification accepting every match) comes out not correct.
- The faults, planted underneath the harness in the program while the rest
  of a run goes on as usual: an answer altered where it is produced (two
  registered images' poses swapped as the controller returns them; every
  inlier match of a pair pointing at its neighbouring keypoint as the
  matcher writes it), half of the batch left out (half of a capture's
  images never extracted; every other pair of the matcher's list never
  matched), and a step that returns its state unchanged (the mapper's
  registration loop returning the model as the initial pair left it). The
  exchange between chips does not exist on one chip.
Each sound run beside them comes out correct.
"""

import numpy as np
import pytest

from benchmarks import harness
from benchmarks.tests import tiny

PIPELINE, FRONT = "ref.capture8.seq", "ref.front25.default"
CONTROLS = [(name, control) for name in (PIPELINE, FRONT) for control in harness.load_cell(name).workload["controls"]]


def _patch_poses_swapped(monkeypatch):
    from colmap_pcd_tpu_torch.models import controllers

    orig = controllers.IncrementalMapperController.reconstruct

    def reconstruct(self):
        ok = orig(self)
        ids = sorted(self.rec.registered_ids)
        a, b = self.rec.images[ids[1]], self.rec.images[ids[-1]]
        a.qvec, b.qvec, a.tvec, b.tvec = b.qvec, a.qvec, b.tvec, a.tvec
        return ok

    monkeypatch.setattr(controllers.IncrementalMapperController, "reconstruct", reconstruct)


def _patch_half_the_images(monkeypatch):
    from colmap_pcd_tpu_torch.models import feature_pipeline

    orig = feature_pipeline.list_images
    monkeypatch.setattr(feature_pipeline, "list_images", lambda path: orig(path)[::2])


def _patch_state_unchanged(monkeypatch):
    from colmap_pcd_tpu_torch.models import controllers

    monkeypatch.setattr(controllers.IncrementalMapperController, "_incremental_loop", lambda self: None)


def _patch_matches_shifted(monkeypatch):
    from colmap_pcd_tpu_torch.models import database

    orig = database.Database.write_two_view_geometry

    def write(self, i, j, inliers, *args, **kwargs):
        m = np.asarray(inliers).copy()
        if len(m):
            m[:, 1] = np.roll(m[:, 1], 1)
        return orig(self, i, j, m, *args, **kwargs)

    monkeypatch.setattr(database.Database, "write_two_view_geometry", write)


def _patch_half_the_pairs(monkeypatch):
    from colmap_pcd_tpu_torch.models import feature_pipeline

    orig = feature_pipeline.sequential_pair_list
    monkeypatch.setattr(feature_pipeline, "sequential_pair_list", lambda *a: orig(*a)[::2])


@pytest.mark.parametrize("name", [PIPELINE, FRONT])
def test_sound(name):
    sound = tiny.execute(name)
    assert sound["correct"], sound["check"]


@pytest.mark.parametrize("name,control", CONTROLS)
def test_control(name, control):
    line = tiny.execute(name, control=control)
    assert not line["correct"], line["check"]


@pytest.mark.parametrize("name,fault", [
    (PIPELINE, _patch_poses_swapped),
    (PIPELINE, _patch_half_the_images),
    (PIPELINE, _patch_state_unchanged),
    (FRONT, _patch_matches_shifted),
    (FRONT, _patch_half_the_pairs),
])
def test_fault_is_not_correct(monkeypatch, name, fault):
    fault(monkeypatch)
    line = tiny.execute(name)
    assert not line["correct"], line["check"]
