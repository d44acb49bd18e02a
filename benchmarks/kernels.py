"""Shapes of the hand kernels' launches, recorded by wrappers that a traced
run installs around the names the program calls:

- K2: `ops.nn_kernel.nn_argmin` (models/lidar_map.py calls it through the
  module), its queries and map points per call;
- K1 uint8: `ops.matching.match_top2_u8`, the name the matcher imported
  (wrapping it in ops/match_kernel.py alone would see no launch), the batch,
  both caps and the valid rows' and columns' counts per call. The counts
  are summed on the device and fetched once, after the window.

The wrappers keep the originals' launch counters (the kernels' bodies
update them through the module's name). Calls on the CPU are not launches
and are not recorded.
"""

from __future__ import annotations

import functools


class KernelShapes:
    def __init__(self):
        self.k2: list[tuple[int, int]] = []
        self.k1u8: list[tuple] = []  # (B, N1, N2, device [sum n1 + n2, sum n1 * n2])
        self._restore = []

    def install(self):
        import torch

        from colmap_pcd_tpu_torch.ops import matching, nn_kernel

        nn_orig, k1_orig = nn_kernel.nn_argmin, matching.match_top2_u8

        @functools.wraps(nn_orig)
        def nn_argmin(queries, points):
            if queries.device.type == "cuda" and queries.shape[0] and points.shape[0]:
                self.k2.append((int(queries.shape[0]), int(points.shape[0])))
            return nn_orig(queries, points)

        @functools.wraps(k1_orig)
        def match_top2_u8(d1, d2, inv1, inv2, valid2, valid1=None):
            if d1.device.type == "cuda" and d1.numel() and d2.numel():
                batched = d1.dim() == 3
                B = d1.shape[0] if batched else 1
                N1, N2 = d1.shape[-2], d2.shape[-2]
                n2 = (valid2 > 0).reshape(B, N2).sum(-1)
                n1 = ((valid1 > 0).reshape(B, N1).sum(-1) if valid1 is not None
                      else torch.full_like(n2, N1))
                self.k1u8.append((B, N1, N2, torch.stack([(n1 + n2).sum(), (n1 * n2).sum()])))
            return k1_orig(d1, d2, inv1, inv2, valid2, valid1)

        for wrapper, orig in ((nn_argmin, nn_orig), (match_top2_u8, k1_orig)):
            for attr in ("launches", "max_queries", "max_cap"):
                if hasattr(orig, attr):
                    setattr(wrapper, attr, getattr(orig, attr))
        nn_kernel.nn_argmin = nn_argmin
        matching.match_top2_u8 = match_top2_u8
        self._restore = [(nn_kernel, "nn_argmin", nn_orig), (matching, "match_top2_u8", k1_orig)]
        return self

    def restore(self):
        for module, name, orig in self._restore:
            setattr(module, name, orig)
        self._restore = []

    def fetched(self) -> dict:
        """The recorded launches as plain numbers (one fetch of the K1 counts)."""
        import torch

        k1 = []
        if self.k1u8:
            sums = torch.stack([s for *_, s in self.k1u8]).double().cpu().numpy()
            k1 = [(B, N1, N2, float(a), float(b)) for (B, N1, N2, _), (a, b) in zip(self.k1u8, sums)]
        return {"k2": list(self.k2), "k1u8": k1}
