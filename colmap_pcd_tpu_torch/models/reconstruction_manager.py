"""Multi-model reconstruction management.

Parity with src/base/reconstruction_manager.{h,cc}: owns the set of models
produced from one database (incremental SfM can split a weakly connected
scene into several components), supports add/get/delete and writes models
to <path>/0, <path>/1, ... like the reference CLI.
"""

from __future__ import annotations

import os

import numpy as np

from .reconstruction import Camera, Image, Reconstruction


def clone_skeleton(rec: Reconstruction) -> Reconstruction:
    """A fresh Reconstruction sharing the dataset (cameras copied, images
    re-created with no registrations/points) — the per-trial model the
    controller hands to a new IncrementalMapper (BeginReconstruction)."""
    out = Reconstruction()
    for cid, c in rec.cameras.items():
        out.add_camera(
            Camera(cid, c.model_id, c.width, c.height, np.array(c.params), c.prior_focal)
        )
    for iid, im in rec.images.items():
        out.add_image(Image(iid, im.name, im.camera_id, xys=im.xys.copy()))
    out.image_pair_corrs = dict(rec.image_pair_corrs)
    return out


class ReconstructionManager:
    def __init__(self):
        self._recs: list[Reconstruction] = []

    def add(self, rec: Reconstruction | None = None) -> int:
        self._recs.append(rec if rec is not None else Reconstruction())
        return len(self._recs) - 1

    def get(self, idx: int) -> Reconstruction:
        return self._recs[idx]

    def delete(self, idx: int):
        del self._recs[idx]

    def size(self) -> int:
        return len(self._recs)

    def __iter__(self):
        return iter(self._recs)

    def best_index(self) -> int:
        """Largest model by registered images (-1 if empty)."""
        if not self._recs:
            return -1
        return int(np.argmax([r.num_reg_images for r in self._recs]))

    def write(self, path: str):
        """Write all models to <path>/<idx> (RunMapper export layout)."""
        for i, rec in enumerate(self._recs):
            rec.write(os.path.join(path, str(i)))
