"""Image reading for per-registration point coloring (replaces FreeImage
Bitmap, src/util/bitmap.{h,cc})."""

from __future__ import annotations

import numpy as np


def imread_rgb(path: str) -> np.ndarray:
    from PIL import Image as PILImage

    with PILImage.open(path) as im:
        return np.asarray(im.convert("RGB"), np.uint8)
