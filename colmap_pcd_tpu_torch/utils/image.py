"""Image reading/resizing for the feature pipeline and for per-registration
point coloring (replaces FreeImage Bitmap, src/util/bitmap.{h,cc}, and
ImageReader resizing, src/feature/extraction.cc)."""

from __future__ import annotations

import numpy as np


def imread_gray(path: str) -> np.ndarray:
    """Read an image as float32 grayscale in [0, 1]."""
    from PIL import Image as PILImage

    with PILImage.open(path) as im:
        g = im.convert("L")
        return np.asarray(g, np.float32) / 255.0


def imread_gray_u8(path: str) -> np.ndarray:
    """Read an image as uint8 grayscale: the extraction pipeline uploads
    uint8 (a quarter of the f32 bytes) and normalizes on the device."""
    from PIL import Image as PILImage

    with PILImage.open(path) as im:
        return np.asarray(im.convert("L"), np.uint8)


def imread_rgb(path: str) -> np.ndarray:
    from PIL import Image as PILImage

    with PILImage.open(path) as im:
        return np.asarray(im.convert("RGB"), np.uint8)


def resize_max(img: np.ndarray, max_size: int) -> tuple[np.ndarray, float]:
    """Downscale so max(H, W) <= max_size. Returns (image, scale_factor)
    (SiftExtractionOptions.max_image_size handling, feature/extraction.cc).
    A max_size <= 0 keeps the image whole (COLMAP's -1: no limit)."""
    H, W = img.shape[:2]
    m = max(H, W)
    if max_size <= 0 or m <= max_size:
        return img, 1.0
    scale = max_size / m
    from PIL import Image as PILImage

    arr = (img * 255).astype(np.uint8) if img.dtype != np.uint8 else img
    pil = PILImage.fromarray(arr)
    out = pil.resize((int(W * scale), int(H * scale)), PILImage.LANCZOS)
    if img.dtype == np.uint8:
        out = np.asarray(out, np.uint8)  # uint8 in -> uint8 out
    else:
        out = np.asarray(out, np.float32) / 255.0
    return out, scale
