import numpy as np
import jax.numpy as jnp

from motioncheck_ccm_slam.ops import matching


def rand_desc(rng, n):
    return jnp.asarray(rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32))


def flip_bits(rng, desc, n_bits):
    """Flip n_bits random bits in each descriptor."""
    d = np.asarray(desc).copy()
    for i in range(d.shape[0]):
        for _ in range(n_bits):
            w = rng.integers(0, 8)
            b = rng.integers(0, 32)
            d[i, w] ^= np.uint32(1) << np.uint32(b)
    return jnp.asarray(d)


def test_popcount():
    x = jnp.array([0, 1, 3, 0xFFFFFFFF, 0x80000000], dtype=jnp.uint32)
    np.testing.assert_array_equal(
        np.asarray(matching.popcount_u32(x)), [0, 1, 2, 32, 1]
    )


def test_hamming_matrix_identity():
    rng = np.random.default_rng(0)
    d = rand_desc(rng, 16)
    D = matching.hamming_matrix(d, d)
    assert np.all(np.diag(np.asarray(D)) == 0)
    # random descriptors differ by ~128 bits on average
    off = np.asarray(D)[~np.eye(16, dtype=bool)]
    assert 80 < off.mean() < 176


def test_hamming_known_distance():
    rng = np.random.default_rng(1)
    d1 = rand_desc(rng, 8)
    d2 = flip_bits(np.random.default_rng(2), d1, 5)
    d = np.asarray(matching.hamming_rows(d1, d2))
    assert np.all(d <= 5)  # <= because random flips can collide
    assert np.all(d >= 1)


def test_masked_best_match_and_ratio():
    dist = jnp.array([[5, 40, 100], [60, 61, 200]], jnp.int32)
    mask = jnp.ones((2, 3), bool)
    m = matching.masked_best_match(dist, mask, max_dist=100, nn_ratio=0.9)
    assert bool(m.ok[0]) and int(m.idx[0]) == 0
    # row 1: best 60 vs second 61 fails 0.9 ratio
    assert not bool(m.ok[1])


def test_mask_blocks_matches():
    dist = jnp.zeros((1, 4), jnp.int32)
    mask = jnp.array([[False, False, True, False]])
    m = matching.masked_best_match(dist, mask, max_dist=50)
    assert int(m.idx[0]) == 2


def test_resolve_duplicates():
    # queries 0 and 1 both match target 3; query 1 is closer
    m = matching.MatchResult(
        idx=jnp.array([3, 3, 2], jnp.int32),
        dist=jnp.array([20, 10, 5], jnp.int32),
        ok=jnp.array([True, True, True]),
    )
    r = matching.resolve_duplicates(m, 4)
    assert not bool(r.ok[0])
    assert bool(r.ok[1])
    assert bool(r.ok[2])


def test_mutual_match_recovers_permutation():
    rng = np.random.default_rng(3)
    d1 = rand_desc(rng, 32)
    perm = np.random.default_rng(4).permutation(32)
    d2 = np.asarray(flip_bits(np.random.default_rng(5), d1, 3))[perm]
    m = matching.mutual_match(
        d1, jnp.ones(32, bool), jnp.asarray(d2), jnp.ones(32, bool), max_dist=50
    )
    ok = np.asarray(m.ok)
    assert ok.sum() >= 30
    inv = np.argsort(perm)
    np.testing.assert_array_equal(np.asarray(m.idx)[ok], inv[ok])


def test_rotation_consistency():
    rng = np.random.default_rng(6)
    n = 100
    # 90 consistent matches at offset 0.5 rad, 10 outliers scattered
    a_q = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
    a_t = a_q - 0.5
    a_t[:10] = rng.uniform(0, 2 * np.pi, 10)
    ok = jnp.ones(n, bool)
    keep = np.asarray(
        matching.rotation_consistency(jnp.asarray(a_q), jnp.asarray(a_t), ok)
    )
    assert keep[10:].mean() > 0.95
    assert keep[:10].mean() < 0.5


def test_search_by_projection_radius():
    rng = np.random.default_rng(7)
    n = 64
    desc = rand_desc(rng, n)
    uv = jnp.asarray(rng.uniform(0, 600, size=(n, 2)).astype(np.float32))
    octv = jnp.zeros(n, jnp.int32)
    valid = jnp.ones(n, bool)
    # queries = same points jittered by 2px, same descriptors
    uv_q = uv + jnp.asarray(rng.uniform(-2, 2, size=(n, 2)).astype(np.float32))
    m = matching.search_by_projection(
        desc, uv_q, octv, valid, desc, uv, octv, valid, radius=5.0, max_dist=10
    )
    ok = np.asarray(m.ok)
    assert ok.sum() >= n - 2
    np.testing.assert_array_equal(np.asarray(m.idx)[ok], np.arange(n)[ok])


def test_search_for_triangulation_epipolar_gate():
    # cameras displaced in x: epipolar lines are horizontal (y2 == y1)
    rng = np.random.default_rng(8)
    n = 32
    desc = rand_desc(rng, n)
    uv1 = jnp.asarray(rng.uniform(50, 400, size=(n, 2)).astype(np.float32))
    # same y = on epipolar line for F = [ex] skew with baseline along x
    # F for pure x-translation: l2 = F x1 ~ (0, -1, y1) -> y2 = y1
    F = jnp.array([[0, 0, 0], [0, 0, -1], [0, 1, 0]], jnp.float32)
    uv2_good = uv1 + jnp.asarray(
        np.stack([rng.uniform(-30, 30, n), rng.uniform(-0.5, 0.5, n)], -1).astype(np.float32)
    )
    inv_sigma2 = jnp.ones(8, jnp.float32)
    octv = jnp.zeros(n, jnp.int32)
    valid = jnp.ones(n, bool)
    m = matching.search_for_triangulation(
        desc, uv1, valid, desc, uv2_good, valid, F, inv_sigma2, octv, max_dist=10
    )
    assert np.asarray(m.ok).sum() >= n - 2
    # move points far off the epipolar line -> rejected
    uv2_bad = uv2_good + jnp.array([0.0, 50.0])
    m2 = matching.search_for_triangulation(
        desc, uv1, valid, desc, uv2_bad, valid, F, inv_sigma2, octv, max_dist=10
    )
    assert np.asarray(m2.ok).sum() == 0
