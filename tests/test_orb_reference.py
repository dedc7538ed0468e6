"""The dense ORB front-end maps against independent numpy/scipy references:
FAST-9/16 corners and scores, the Gaussian blur, the IC moment maps, and
the int8-matmul Hamming matrix."""
import numpy as np
import jax.numpy as jnp
import pytest
from scipy import ndimage

from motioncheck_ccm_slam.ops import image as image_ops, matching, orb


@pytest.fixture(scope="module")
def img():
    rng = np.random.default_rng(42)
    base = rng.uniform(0, 64, (137, 201)).astype(np.float32)
    # strong corners so both thresholds fire
    for y, x in rng.integers(25, 110, (30, 2)):
        base[y:y + 3, x:x + 3] += 150.0
    return base


def _fast_reference(img, threshold):
    """Plain FAST-9/16: a pixel is a corner when >= 9 contiguous ring pixels
    (with wraparound) are all brighter than center+t or all darker than
    center-t; score = max(sum of (d - t)+, sum of (-d - t)+) over the ring.
    The 3-pixel border never qualifies."""
    h, w = img.shape
    p = np.pad(img, 3, mode="edge")
    diff = np.stack([p[3 + dy:3 + dy + h, 3 + dx:3 + dx + w]
                     for dx, dy in orb.FAST_RING]) - img[None]

    def arc(mask):
        ring = np.concatenate([mask, mask[:orb.FAST_ARC - 1]], 0)
        run = np.zeros(mask.shape[1:], np.int32)
        best = np.zeros(mask.shape[1:], np.int32)
        for k in range(ring.shape[0]):
            run = np.where(ring[k], run + 1, 0)
            best = np.maximum(best, run)
        return best >= orb.FAST_ARC

    corner = arc(diff > threshold) | arc(diff < -threshold)
    corner[:3] = corner[-3:] = False
    corner[:, :3] = corner[:, -3:] = False
    score = np.maximum(np.maximum(diff - threshold, 0).sum(0),
                       np.maximum(-diff - threshold, 0).sum(0))
    return corner, score


@pytest.mark.parametrize("threshold", [7.0, 20.0])
def test_fast_response_matches_reference(img, threshold):
    corner, score = orb.fast_response(jnp.asarray(img), threshold)
    corner_ref, score_ref = _fast_reference(img, threshold)
    assert corner_ref.sum() > 50, "fixture produced too few corners"
    np.testing.assert_array_equal(np.asarray(corner), corner_ref)
    np.testing.assert_allclose(np.asarray(score), score_ref,
                               rtol=1e-6, atol=1e-3)


def test_blur_and_moments_match_scipy(img):
    """Separable shift-and-add maps vs scipy's correlate1d (edge
    replicate == mode 'nearest'), the moments through the same low-rank
    factors, and within the factorization's 1% of the exact disc kernel."""
    x = jnp.asarray(img)
    k = image_ops._gaussian_kernel_1d(7, 2.0).astype(np.float64)
    blur_ref = ndimage.correlate1d(
        ndimage.correlate1d(img.astype(np.float64), k, axis=1,
                            mode="nearest"), k, axis=0, mode="nearest")
    np.testing.assert_allclose(np.asarray(image_ops.gaussian_blur(x, 7, 2.0)),
                               blur_ref, rtol=0, atol=1e-3)

    m10, m01 = orb.ic_moment_maps(x, 15)
    uy, vx = orb._ic_moment_factors(15)
    f64 = img.astype(np.float64)
    m10_ref = sum(
        ndimage.correlate1d(ndimage.correlate1d(f64, vx[i], axis=1,
                                                mode="nearest"),
                            uy[:, i], axis=0, mode="nearest")
        for i in range(vx.shape[0]))
    m01_ref = sum(
        ndimage.correlate1d(ndimage.correlate1d(f64, uy[:, i], axis=1,
                                                mode="nearest"),
                            vx[i], axis=0, mode="nearest")
        for i in range(vx.shape[0]))
    scale = np.abs(m10_ref).max()
    assert np.abs(np.asarray(m10) - m10_ref).max() < 1e-5 * scale
    assert np.abs(np.asarray(m01) - m01_ref).max() < 1e-5 * scale
    mask, dxg, dyg = orb._ic_angle_mask(15)
    exact = ndimage.correlate(f64, dxg * mask, mode="nearest")
    assert np.abs(np.asarray(m10) - exact).max() < 0.02 * np.abs(exact).max()


def test_hamming_matrix_matches_xor_popcount():
    """The int8-matmul Hamming matrix is exact against XOR + popcount."""
    rng = np.random.default_rng(0)
    d1 = rng.integers(0, 2 ** 32, (300, 8), dtype=np.uint32)
    d2 = rng.integers(0, 2 ** 32, (500, 8), dtype=np.uint32)
    d2[:50] = d1[:50]          # include exact matches (distance 0)
    ham = np.asarray(matching.hamming_matrix(jnp.asarray(d1),
                                             jnp.asarray(d2)))
    x = d1[:, None, :] ^ d2[None, :, :]
    ref = np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)
    np.testing.assert_array_equal(ham, ref)
