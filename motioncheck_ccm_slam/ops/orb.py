"""ORB feature extraction as batched, static-shape XLA programs.

Functional equivalent of the reference extractor (reference:
src/ORBextractor.cpp — ComputePyramid :1280, ComputeKeyPointsOctTree :933,
computeOrientation :641, computeOrbDescriptor :100, operator() :1216),
re-designed for XLA instead of per-pixel C++ loops:

- FAST-9/16 is evaluated densely for the whole level as 16 shifted image
  views + boolean ring-run reductions (pure elementwise work, no
  branches).
- The two-threshold retry (iniThFAST=20 then minThFAST=7, per 30px cell) is a
  cell-level ``where``: cells that found no high-threshold corner fall back to
  the low-threshold response map.
- The quadtree keypoint distribution becomes per-cell top-k followed by a
  global per-level top-K_l — same spatial-uniformity goal, fully batched.
- Orientation (IC angle, circular patch r=15) and steered BRIEF (256 pairs,
  Gaussian-blurred image) are batched gathers over all keypoints at once.

The BRIEF sampling pattern is generated from a fixed-seed Gaussian like the
original BRIEF paper (we do NOT reuse OpenCV's learned table; extractor and
matcher are both ours, so only internal consistency matters).

Descriptors are bit-packed to (K, 8) uint32 for popcount matching
(see ops/matching.py).
"""
from __future__ import annotations

import functools
import math
from typing import List, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ExtractorParams
from . import image as image_ops

# ---------------------------------------------------------------------------
# Static tables
# ---------------------------------------------------------------------------

# FAST ring: 16 contiguous (dx, dy) offsets of the radius-3 Bresenham circle
FAST_RING = np.array(
    [
        (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
        (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2),
        (-1, -3),
    ],
    dtype=np.int32,
)
FAST_ARC = 9  # FAST-9: >= 9 contiguous ring pixels all brighter/darker


@functools.lru_cache(maxsize=None)
def _ic_angle_mask(half_patch: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Circular patch mask + coordinate grids for the intensity-centroid
    angle (reference IC_Angle with the umax row table)."""
    r = half_patch
    dy, dx = np.mgrid[-r : r + 1, -r : r + 1]
    mask = (dx * dx + dy * dy) <= r * r
    return mask.astype(np.float32), dx.astype(np.float32), dy.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _brief_pattern(n_bits: int = 256, patch: int = 31, seed: int = 1234) -> np.ndarray:
    """(n_bits, 4) int table of (x1, y1, x2, y2) BRIEF test offsets.

    Gaussian sampling (sigma = patch/5, clamped) per the BRIEF paper's G-II
    variant; deterministic via fixed seed.
    """
    rng = np.random.default_rng(seed)
    sigma = patch / 5.0
    lim = patch // 2 - 2  # keep rotated samples inside the 31x31 disc
    pts = np.clip(np.round(rng.normal(0.0, sigma, size=(n_bits, 4))), -lim, lim)
    return pts.astype(np.float32)


def level_feature_budgets(max_features: int, n_levels: int, scale: float) -> List[int]:
    """Per-level feature counts, geometric in 1/scale like the reference
    (ORBextractor ctor: mnFeaturesPerLevel)."""
    f = 1.0 / scale
    total = (1.0 - f) / (1.0 - f ** n_levels)
    budgets = [int(round(max_features * total * (f ** l))) for l in range(n_levels)]
    budgets[-1] += max_features - sum(budgets)
    return budgets


# ---------------------------------------------------------------------------
# FAST corner response (dense, per level)
# ---------------------------------------------------------------------------

def _fast_ring_diff(img):
    """(16, H, W) ring-minus-center differences shared by both thresholds."""
    h, w = img.shape
    p = jnp.pad(img, 3, mode="edge")
    ring = []
    for dx, dy in FAST_RING:
        ring.append(jax.lax.dynamic_slice(p, (3 + int(dy), 3 + int(dx)), (h, w)))
    return jnp.stack(ring) - img[None]


def _has_arc(mask):
    """Wrap-around contiguous run of >= FAST_ARC over the ring axis.

    Bit-packed: the 16 ring booleans per pixel become one int32 map (bit i =
    ring position i), duplicated into the high half for wraparound; the
    AND-of-9-consecutive reduction is then 8 shift-ANDs on a single int map
    instead of 16x8 boolean map ANDs (16x less elementwise work).
    """
    bits = mask.astype(jnp.int32)
    m = bits[0]
    for i in range(1, 16):
        m = m | (bits[i] << i)
    dup = m | (m << 16)
    run = dup
    for k in range(1, FAST_ARC):
        run = run & (dup >> k)
    return (run & jnp.int32(0xFFFF)) != 0


def _interior_mask(h, w, border=3):
    yy = jnp.arange(h)[:, None]
    xx = jnp.arange(w)[None, :]
    return (yy >= border) & (yy < h - border) & (xx >= border) & (xx < w - border)


def fast_response(img, threshold: float):
    """Dense FAST-9/16 response map for a (H, W) f32 image.

    Returns (is_corner, score): boolean map and a response map
    (sum of thresholded ring residuals — a smooth, NMS-friendly proxy for
    OpenCV's arc-min score).
    """
    h, w = img.shape
    diff = _fast_ring_diff(img)
    corner = _has_arc(diff > threshold) | _has_arc(diff < -threshold)
    score_b = jnp.sum(jnp.maximum(diff - threshold, 0.0), axis=0)
    score_d = jnp.sum(jnp.maximum(-diff - threshold, 0.0), axis=0)
    score = jnp.maximum(score_b, score_d)
    return corner & _interior_mask(h, w), score


def fast_response_two_thresholds(img, th_hi: float, th_lo: float):
    """Both threshold maps from ONE shared ring computation (the reference's
    ini/min two-threshold retry re-runs cv::FAST; here the 16 shifted views
    and diffs are computed once)."""
    h, w = img.shape
    diff = _fast_ring_diff(img)
    interior = _interior_mask(h, w)

    def at(threshold):
        corner = _has_arc(diff > threshold) | _has_arc(diff < -threshold)
        score_b = jnp.sum(jnp.maximum(diff - threshold, 0.0), axis=0)
        score_d = jnp.sum(jnp.maximum(-diff - threshold, 0.0), axis=0)
        return corner & interior, jnp.maximum(score_b, score_d)

    return at(th_hi), at(th_lo)


def _nms3(score):
    """3x3 non-max suppression: True where score is the local max."""
    p = jnp.pad(score, 1, mode="constant", constant_values=-jnp.inf)
    h, w = score.shape
    neigh = []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            neigh.append(jax.lax.dynamic_slice(p, (1 + dy, 1 + dx), (h, w)))
    m = jnp.max(jnp.stack(neigh), axis=0)
    return score > m  # strict > breaks plateaus deterministically


# ---------------------------------------------------------------------------
# Per-level keypoint selection
# ---------------------------------------------------------------------------

def _select_level_keypoints(img, params: ExtractorParams, k_level: int,
                            cell: int = 32, k_cell: int = 8):
    """Detect + spatially distribute up to k_level keypoints on one level.

    Returns xy (k_level, 2) f32 (level coords), score (k_level,), valid mask.
    """
    h, w = img.shape
    b = params.edge_threshold
    (corner_hi, score_hi), (corner_lo, score_lo) = (
        fast_response_two_thresholds(
            img, float(params.ini_th_fast), float(params.min_th_fast)
        )
    )

    # border exclusion for orientation/descriptor sampling
    yy = jnp.arange(h)[:, None]
    xx = jnp.arange(w)[None, :]
    ok_border = (yy >= b) & (yy < h - b) & (xx >= b) & (xx < w - b)
    corner_hi = corner_hi & ok_border
    corner_lo = corner_lo & ok_border

    # pad to cell multiples
    hp = (h + cell - 1) // cell * cell
    wp = (w + cell - 1) // cell * cell
    def to_cells(x, fill):
        xp = jnp.pad(x, ((0, hp - h), (0, wp - w)), constant_values=fill)
        return xp.reshape(
            hp // cell, cell, wp // cell, cell).transpose(0, 2, 1, 3)

    hi_in_cell = jnp.any(to_cells(corner_hi, False), axis=(2, 3))

    # two-threshold retry: cells without any high-threshold corner use
    # the low-threshold detection (ComputeKeyPointsOctTree retry loop)
    use_hi = hi_in_cell[:, :, None, None]
    corner = jnp.where(
        use_hi, to_cells(corner_hi, False), to_cells(corner_lo, False))
    score = jnp.where(
        use_hi, to_cells(score_hi, 0.0), to_cells(score_lo, 0.0))
    corner_map = corner.transpose(0, 2, 1, 3).reshape(hp, wp)
    score_map = score.transpose(0, 2, 1, 3).reshape(hp, wp)
    masked_score = jnp.where(corner_map, score_map, 0.0)

    keep = _nms3(masked_score) & corner_map
    final_score = jnp.where(keep, masked_score, 0.0)

    # per-cell top-k (final_score is already (hp, wp))
    cells = (
        final_score.reshape(hp // cell, cell, wp // cell, cell)
        .transpose(0, 2, 1, 3)
        .reshape(-1, cell * cell)
    )  # (ncells, c*c)
    vals, idx = jax.lax.top_k(cells, k_cell)  # (ncells, k_cell)
    ncells_y, ncells_x = hp // cell, wp // cell
    cy = jnp.arange(ncells_y * ncells_x) // ncells_x
    cx = jnp.arange(ncells_y * ncells_x) % ncells_x
    py = cy[:, None] * cell + idx // cell
    px = cx[:, None] * cell + idx % cell

    # global top-k_level over cell winners
    flat_vals = vals.reshape(-1)
    flat_y = py.reshape(-1)
    flat_x = px.reshape(-1)
    top_vals, top_i = jax.lax.top_k(flat_vals, k_level)
    sel_y = flat_y[top_i].astype(jnp.float32)
    sel_x = flat_x[top_i].astype(jnp.float32)
    valid = top_vals > 0.0
    xy = jnp.stack([sel_x, sel_y], -1)
    return xy, top_vals, valid


# ---------------------------------------------------------------------------
# Orientation + descriptors (batched over keypoints)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ic_moment_factors(half_patch: int, rel_err: float = 0.01):
    """Low-rank separable factorization of the m10 moment kernel.

    The 31x31 kernel kx(dy, dx) = dx * disc(dy, dx) is nearly low-rank; its
    truncated SVD (rank r with Frobenius error < rel_err) turns the dense
    single-channel 31x31 2D conv into r separable 1-D conv pairs. The m01
    kernel is exactly kx^T, so it shares the same factors with the roles of
    the 1-D filters swapped.
    Returns (uy, vx): uy (31, r) vertical factors scaled by singular values,
    vx (r, 31) horizontal factors.
    """
    mask, dxg, dyg = _ic_angle_mask(half_patch)
    k = (dxg * mask).astype(np.float64)
    U, S, Vt = np.linalg.svd(k)
    tail = np.sqrt(np.cumsum((S ** 2)[::-1])[::-1])  # tail[r] = err of rank r
    ok = tail / tail[0] < rel_err
    r = int(np.argmax(ok)) if ok.any() else len(S)
    r = max(r, 1)
    uy = (U[:, :r] * S[:r]).astype(np.float32)
    vx = Vt[:r].astype(np.float32)
    return uy, vx


def ic_moment_maps(img, half_patch: int):
    """Dense IC moment maps: m10(x, y) = sum_patch dx * I, m01 likewise.

    Two separable low-rank conv passes (see _ic_moment_factors) replace the
    reference's per-keypoint circular-patch loop AND the gather-heavy patch
    extraction — per keypoint the angle is then just two map lookups. XLA's
    conv primitive is cross-correlation (no kernel flip), which is exactly
    the patch sum we want: m10(x,y) = sum dx * I(y+dy, x+dx), and separable
    cross-correlation composes without flips.
    """
    uy, vx = _ic_moment_factors(half_patch)
    r = vx.shape[0]
    p = half_patch
    ksz = 2 * p + 1
    h, w = img.shape
    x = jnp.pad(img, ((p, p), (p, p)), mode="edge")
    # Both passes as shift-and-add over static slices of the padded buffer,
    # which XLA fuses into elementwise passes. Horizontal: 2r channels = [v_i] (m10) ++ [u_i s_i]
    # (m01 = kx^T shares factors with roles swapped).
    kh = np.concatenate([vx, uy.T], 0)          # (2r, ksz)
    mid = []
    for c in range(2 * r):
        acc = float(kh[c, 0]) * x[:, 0:w]
        for i in range(1, ksz):
            acc = acc + float(kh[c, i]) * x[:, i:i + w]
        mid.append(acc)                          # (Hp, w)
    # vertical pass combines channels into the two moment maps
    kv = np.concatenate([uy.T, vx], 0)           # (2r, ksz): uy for m10 rows
    m10 = jnp.zeros((h, w), img.dtype)
    m01 = jnp.zeros((h, w), img.dtype)
    for c in range(r):
        for j in range(ksz):
            m10 = m10 + float(kv[c, j]) * mid[c][j:j + h, :]
    for c in range(r):
        for j in range(ksz):
            m01 = m01 + float(kv[r + c, j]) * mid[r + c][j:j + h, :]
    return m10, m01


def ic_angles(img, xy, half_patch: int, moment_maps=None):
    """Intensity-centroid angles (radians) for keypoints xy (K, 2) on img."""
    if moment_maps is None:
        moment_maps = ic_moment_maps(img, half_patch)
    m10_map, m01_map = moment_maps
    h, w = img.shape
    x0 = jnp.clip(jnp.round(xy[:, 0]), 0, w - 1).astype(jnp.int32)
    y0 = jnp.clip(jnp.round(xy[:, 1]), 0, h - 1).astype(jnp.int32)
    return jnp.arctan2(m01_map[y0, x0], m10_map[y0, x0])


def brief_descriptors(img_blur, xy, angles):
    """Steered BRIEF-256 for keypoints (K, 2) with orientations (K,).

    Returns (K, 8) uint32 bit-packed descriptors.
    """
    pat = jnp.asarray(_brief_pattern())  # (256, 4) x1 y1 x2 y2
    c = jnp.cos(angles)[:, None]
    s = jnp.sin(angles)[:, None]

    def rotate(px, py):
        rx = px[None, :] * c - py[None, :] * s
        ry = px[None, :] * s + py[None, :] * c
        return rx, ry

    r1x, r1y = rotate(pat[:, 0], pat[:, 1])  # (K, 256)
    r2x, r2y = rotate(pat[:, 2], pat[:, 3])
    p1 = jnp.stack([xy[:, 0:1] + r1x, xy[:, 1:2] + r1y], -1)
    p2 = jnp.stack([xy[:, 0:1] + r2x, xy[:, 1:2] + r2y], -1)
    v1 = image_ops.nearest_sample(img_blur, p1)
    v2 = image_ops.nearest_sample(img_blur, p2)
    bits = (v1 < v2).astype(jnp.uint32)  # (K, 256)
    # pack 256 bits -> 8 uint32 words
    k = bits.shape[0]
    words = bits.reshape(k, 8, 32)
    weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))[None, None, :]
    return jnp.sum(words * weights, axis=-1, dtype=jnp.uint32)


# ---------------------------------------------------------------------------
# Full extractor
# ---------------------------------------------------------------------------

class OrbFeatures(NamedTuple):
    """SoA feature block for one frame, fixed capacity K = max_features.

    xy is in level-0 (full-resolution) pixel coordinates; octave is the
    pyramid level; response the FAST score; angle radians; desc bit-packed
    (K, 8) uint32; valid marks live slots.
    """

    xy: jax.Array        # (K, 2) f32
    response: jax.Array  # (K,) f32
    angle: jax.Array     # (K,) f32
    octave: jax.Array    # (K,) i32
    desc: jax.Array      # (K, 8) u32
    valid: jax.Array     # (K,) bool


def extract_orb(img, params: ExtractorParams) -> OrbFeatures:
    """Extract ORB features from a grayscale (H, W) f32 image in [0, 255].

    Jit-compatible; all shapes static given ``params``.
    """
    levels = image_ops.build_pyramid(img, params.n_levels, params.scale_factor)
    budgets = level_feature_budgets(
        params.max_features, params.n_levels, params.scale_factor
    )
    out_xy, out_resp, out_ang, out_oct, out_desc, out_valid = [], [], [], [], [], []
    for l, (lvl_img, k_level) in enumerate(zip(levels, budgets)):
        xy, score, valid = _select_level_keypoints(lvl_img, params, k_level)
        ang = ic_angles(lvl_img, xy, params.half_patch_size)
        blur = image_ops.gaussian_blur(lvl_img, 7, 2.0)
        desc = brief_descriptors(blur, xy, ang)
        scale_l = params.scale_factor ** l
        out_xy.append(xy * scale_l)
        out_resp.append(score)
        out_ang.append(ang)
        out_oct.append(jnp.full((k_level,), l, jnp.int32))
        out_desc.append(desc)
        out_valid.append(valid)
    return OrbFeatures(
        xy=jnp.concatenate(out_xy),
        response=jnp.concatenate(out_resp),
        angle=jnp.concatenate(out_ang),
        octave=jnp.concatenate(out_oct),
        desc=jnp.concatenate(out_desc),
        valid=jnp.concatenate(out_valid),
    )


def scale_factors(params: ExtractorParams) -> np.ndarray:
    return np.array(
        [params.scale_factor ** l for l in range(params.n_levels)], np.float32
    )


def inv_level_sigma2(params: ExtractorParams) -> np.ndarray:
    """Per-octave information weights 1/sigma^2 (reference Frame
    mvInvLevelSigma2)."""
    s = scale_factors(params)
    return (1.0 / (s * s)).astype(np.float32)
