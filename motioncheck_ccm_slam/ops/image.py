"""Image-level ops for the ORB front-end: pyramid, Gaussian blur.

Replaces the OpenCV image path of the reference extractor
(reference: src/ORBextractor.cpp:1280 ComputePyramid, GaussianBlur call in
ComputeDescriptors). Everything is static-shape jnp so the whole 8-level
front-end compiles into one XLA program.
"""
from __future__ import annotations

import functools
import math
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def pyramid_shapes(height: int, width: int, n_levels: int, scale: float) -> List[Tuple[int, int]]:
    """Static (H, W) per pyramid level, matching the reference's rounding
    (cvRound(w / scale^l))."""
    shapes = []
    for l in range(n_levels):
        inv = 1.0 / (scale ** l)
        shapes.append((int(round(height * inv)), int(round(width * inv))))
    return shapes


def build_pyramid(img, n_levels: int, scale: float):
    """Grayscale (H, W) f32 -> list of per-level images (static shapes).

    Bilinear resize from the previous level like the reference (iterative
    resize accumulates the same blur cascade OpenCV produces).
    """
    h, w = img.shape
    shapes = pyramid_shapes(h, w, n_levels, scale)
    levels = [img]
    for l in range(1, n_levels):
        prev = levels[-1]
        levels.append(
            jax.image.resize(prev, shapes[l], method="bilinear", antialias=False)
        )
    return levels


@functools.lru_cache(maxsize=None)
def _gaussian_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    half = ksize // 2
    x = np.arange(-half, half + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img, ksize: int = 7, sigma: float = 2.0):
    """Separable Gaussian blur of (H, W) f32, SAME border (edge replicate).

    Implemented as shift-and-add (static slices of one padded buffer),
    which XLA fuses into one elementwise pass per direction."""
    k = _gaussian_kernel_1d(ksize, sigma)
    half = ksize // 2
    h, w = img.shape
    x = jnp.pad(img, ((half, half), (half, half)), mode="edge")
    mid = float(k[0]) * x[:, 0:w]
    for i in range(1, ksize):
        mid = mid + float(k[i]) * x[:, i:i + w]
    out = float(k[0]) * mid[0:h, :]
    for i in range(1, ksize):
        out = out + float(k[i]) * mid[i:i + h, :]
    return out


def nearest_sample(img, xy):
    """Sample (H, W) image at rounded coords xy (..., 2) = (x, y)."""
    h, w = img.shape
    x = jnp.clip(jnp.round(xy[..., 0]), 0, w - 1).astype(jnp.int32)
    y = jnp.clip(jnp.round(xy[..., 1]), 0, h - 1).astype(jnp.int32)
    return img[y, x]
