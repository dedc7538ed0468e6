import numpy as np
import jax.numpy as jnp

from motioncheck_ccm_slam.models import vocabulary as voc
from motioncheck_ccm_slam.models.database import KeyFrameDatabase


def rand_desc(rng, n):
    return rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32)


def perturb(rng, d, n_bits):
    out = d.copy()
    for i in range(len(out)):
        for _ in range(n_bits):
            w = rng.integers(0, 8)
            out[i, w] ^= np.uint32(1) << np.uint32(rng.integers(0, 32))
    return out


def test_vocab_structure():
    v = voc.default_vocabulary(k=4, levels=3, n_train=4000)
    assert v.n_words == 64
    assert len(v.centroids) == 3
    assert v.centroids[-1].shape == (64, 8)


def test_transform_deterministic_and_stable():
    rng = np.random.default_rng(0)
    v = voc.default_vocabulary(k=4, levels=3, n_train=4000)
    tf = voc.make_transform(v)
    d = rand_desc(rng, 128)
    valid = jnp.ones(128, bool)
    w1, b1 = tf(jnp.asarray(d), valid)
    w2, b2 = tf(jnp.asarray(d), valid)
    np.testing.assert_array_equal(np.asarray(w1), np.asarray(w2))
    assert abs(float(jnp.sum(jnp.abs(b1))) - 1.0) < 1e-5  # L1 normalized
    # slightly perturbed descriptors mostly map to the same words
    d2 = perturb(rng, d, 3)
    w3, _ = tf(jnp.asarray(d2), valid)
    same = (np.asarray(w1) == np.asarray(w3)).mean()
    assert same > 0.5


def test_bow_similarity_discriminates():
    """Same scene (perturbed descs) scores higher than a different scene.
    Needs a realistically sized vocabulary — with only ~64 words every
    histogram looks alike (DBoW2 uses 1e6 words for the same reason)."""
    rng = np.random.default_rng(1)
    v = voc.default_vocabulary(k=8, levels=4, n_train=8000)
    tf = voc.make_transform(v)
    valid = jnp.ones(256, bool)
    dA = rand_desc(rng, 256)
    dA2 = perturb(rng, dA, 8)       # same place, revisited
    dB = rand_desc(rng, 256)        # different place
    _, bA = tf(jnp.asarray(dA), valid)
    _, bA2 = tf(jnp.asarray(dA2), valid)
    _, bB = tf(jnp.asarray(dB), valid)
    s_same = float(voc.bow_score(bA, bA2))
    s_diff = float(voc.bow_score(bA, bB))
    assert s_same > s_diff * 1.5
    assert s_same > 0.2


def test_database_loop_candidates():
    rng = np.random.default_rng(2)
    v = voc.default_vocabulary(k=4, levels=3, n_train=4000)
    db = KeyFrameDatabase(vocab=v, capacity=16)
    valid = jnp.ones(256, bool)
    descs = [rand_desc(rng, 256) for _ in range(8)]
    for i, d in enumerate(descs):
        db.add(i, jnp.asarray(d), valid, map_id=0)
    # query resembles KF 2 (revisit)
    q = perturb(rng, descs[2], 6)
    _, qbow = voc.make_transform(v)(jnp.asarray(q), valid)
    covis = np.zeros(16, bool)
    covis[6] = covis[7] = True   # pretend 6,7 are covis neighbors
    cands, scores = db.detect_loop_candidates(9, qbow, covis)
    assert 2 in cands[:2]
    assert 6 not in cands and 7 not in cands


def test_database_map_match_excludes_own_map():
    rng = np.random.default_rng(3)
    v = voc.default_vocabulary(k=4, levels=3, n_train=4000)
    db = KeyFrameDatabase(vocab=v, capacity=8)
    valid = jnp.ones(128, bool)
    d_own = rand_desc(rng, 128)
    db.add(0, jnp.asarray(d_own), valid, map_id=1)
    db.add(1, jnp.asarray(perturb(rng, d_own, 4)), valid, map_id=1)
    db.add(2, jnp.asarray(perturb(rng, d_own, 4)), valid, map_id=2)
    _, qbow = voc.make_transform(v)(jnp.asarray(d_own), valid)
    cands, _ = db.detect_map_match_candidates(qbow, own_map_id=1)
    assert 0 not in cands and 1 not in cands
    assert 2 in cands
