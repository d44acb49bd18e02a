"""The corridor, version 2: the same trajectory, map and ray-caster as
`corridor.py`, with textures fine enough that SIFT finds the source's
feature count.

`corridor.py`'s five octaves of value noise (0.7 to 16 cycles a metre)
leave 740-1100 keypoints in a 1280x960 view at COLMAP's default scale
space, a tenth of COLMAP's 8192 cap. Here seven octaves (up to 67 cycles
a metre, about the pixel pitch at the wall's distance), with an amplitude
that falls by 0.8 an octave and a contrast of 1.2 around mid-grey, leave
8000-8192 keypoints in such a view at those defaults (the port's SIFT,
`first_octave` -1), so the cap binds as it does on real photographs.

A world is fixed by a seed and a job index as in `corridor.py`. Imports
nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmarks.world import corridor
from benchmarks.world.corridor import MAP_MARGIN, build_corridor_map, trajectory, world_key  # noqa: F401

OCTAVES = (0.7, 1.6, 3.4, 7.9, 16.0, 33.0, 67.0)
PERSISTENCE = 0.8
CONTRAST = 1.2
_WEIGHTS = [PERSISTENCE ** o for o in range(len(OCTAVES))]
_AMPLITUDES = [CONTRAST * w / sum(_WEIGHTS) for w in _WEIGHTS]


def _texture(u: torch.Tensor, v: torch.Tensor, seed: int) -> torch.Tensor:
    out = 0.5
    for o, (scale, amp) in enumerate(zip(OCTAVES, _AMPLITUDES)):
        out = out + amp * (corridor._value_noise(u, v, scale, seed + o * 977) - 0.5)
    return out


def render_u8(poses, width: int, height: int, focal: float, texture_offset: int = 0,
              device="cpu") -> np.ndarray:
    """Every view of `poses` as uint8 grayscale [n,H,W], as `corridor.render_u8`."""
    return corridor.render_u8(poses, width, height, focal, texture_offset, device, texture=_texture)
