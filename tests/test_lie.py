import numpy as np
import jax.numpy as jnp
import pytest

from motioncheck_ccm_slam.ops import lie


def rand_rot(rng, n=()):
    w = rng.normal(size=n + (3,)).astype(np.float32)
    return np.asarray(lie.so3_exp(jnp.asarray(w)))


def test_so3_exp_log_roundtrip():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(64, 3)).astype(np.float32)
    # keep |w| < pi for unique log
    w = w / np.linalg.norm(w, axis=-1, keepdims=True) * rng.uniform(0, 3.0, (64, 1))
    R = lie.so3_exp(jnp.asarray(w))
    w2 = lie.so3_log(R)
    np.testing.assert_allclose(np.asarray(w2), w, atol=2e-4)


def test_so3_small_angle():
    w = jnp.array([[1e-9, -1e-9, 1e-10], [0.0, 0.0, 0.0]], jnp.float32)
    R = lie.so3_exp(w)
    np.testing.assert_allclose(np.asarray(R[1]), np.eye(3), atol=1e-7)
    np.testing.assert_allclose(np.asarray(lie.so3_log(R)), np.asarray(w), atol=1e-6)


def test_so3_near_pi():
    axis = np.array([1.0, 2.0, -0.5], np.float32)
    axis /= np.linalg.norm(axis)
    for theta in [np.pi - 1e-4, np.pi - 1e-2]:
        w = (axis * theta).astype(np.float32)
        R = lie.so3_exp(jnp.asarray(w))
        w2 = np.asarray(lie.so3_log(R))
        # log may return +-axis*theta; both are valid near pi
        err = min(np.linalg.norm(w2 - w), np.linalg.norm(w2 + w))
        assert err < 5e-3


def test_se3_exp_log_roundtrip():
    rng = np.random.default_rng(1)
    xi = rng.normal(size=(32, 6)).astype(np.float32)
    T = lie.se3_exp(jnp.asarray(xi))
    xi2 = lie.se3_log(T)
    T2 = lie.se3_exp(xi2)
    np.testing.assert_allclose(np.asarray(T2), np.asarray(T), atol=1e-4)


def test_se3_inverse():
    rng = np.random.default_rng(2)
    xi = rng.normal(size=(8, 6)).astype(np.float32)
    T = lie.se3_exp(jnp.asarray(xi))
    I = np.asarray(T @ lie.inv_T(T))
    np.testing.assert_allclose(I, np.broadcast_to(np.eye(4), (8, 4, 4)), atol=1e-5)


def test_quat_roundtrip():
    rng = np.random.default_rng(3)
    R = rand_rot(rng, (100,))
    q = lie.rot_to_quat(jnp.asarray(R))
    R2 = lie.quat_to_rot(q)
    np.testing.assert_allclose(np.asarray(R2), R, atol=1e-5)
    # near-pi rotations exercise the non-trace pivots
    R_pi = np.asarray(lie.so3_exp(jnp.array([[np.pi - 1e-5, 0, 0],
                                             [0, np.pi - 1e-5, 0],
                                             [0, 0, np.pi - 1e-5]], jnp.float32)))
    q2 = lie.rot_to_quat(jnp.asarray(R_pi))
    np.testing.assert_allclose(np.asarray(lie.quat_to_rot(q2)), R_pi, atol=1e-5)


def test_sim3_exp_log_roundtrip():
    rng = np.random.default_rng(4)
    xi = rng.normal(size=(32, 7)).astype(np.float32) * 0.8
    S = lie.sim3_exp(jnp.asarray(xi))
    xi2 = lie.sim3_log(S)
    S2 = lie.sim3_exp(xi2)
    np.testing.assert_allclose(np.asarray(S2), np.asarray(S), atol=2e-4, rtol=2e-4)


def test_sim3_zero_is_identity():
    S = lie.sim3_exp(jnp.zeros((7,), jnp.float32))
    np.testing.assert_allclose(np.asarray(S), np.eye(4), atol=1e-6)


def test_sim3_inverse_apply():
    rng = np.random.default_rng(5)
    xi = rng.normal(size=(7,)).astype(np.float32) * 0.5
    S = lie.sim3_exp(jnp.asarray(xi))
    pts = jnp.asarray(rng.normal(size=(1, 10, 3)).astype(np.float32))
    out = lie.sim3_apply(lie.sim3_inv(S), lie.sim3_apply(S, pts))
    np.testing.assert_allclose(np.asarray(out), np.asarray(pts), atol=1e-4)


def test_sim3_scale_recovery():
    R = rand_rot(np.random.default_rng(6))
    t = jnp.array([1.0, -2.0, 0.5], jnp.float32)
    s = jnp.float32(2.5)
    S = lie.make_sim3(jnp.asarray(R), t, s)
    R2, t2, s2 = lie.split_sim3(S)
    np.testing.assert_allclose(float(s2), 2.5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(R2), R, atol=1e-5)


def test_horn_alignment_similarity():
    rng = np.random.default_rng(7)
    R_true = rand_rot(rng)
    t_true = np.array([0.3, -1.0, 2.0], np.float32)
    s_true = 1.7
    p1 = rng.normal(size=(50, 3)).astype(np.float32)
    p2 = (s_true * p1 @ R_true.T + t_true).astype(np.float32)
    R, t, s = lie.horn_align(jnp.asarray(p1), jnp.asarray(p2))
    np.testing.assert_allclose(float(s), s_true, atol=1e-4)
    np.testing.assert_allclose(np.asarray(R), R_true, atol=1e-4)
    np.testing.assert_allclose(np.asarray(t), t_true, atol=1e-3)


def test_horn_alignment_fixed_scale():
    rng = np.random.default_rng(8)
    R_true = rand_rot(rng)
    t_true = np.array([0.1, 0.2, -0.3], np.float32)
    p1 = rng.normal(size=(30, 3)).astype(np.float32)
    p2 = (p1 @ R_true.T + t_true).astype(np.float32)
    R, t, s = lie.horn_align(jnp.asarray(p1), jnp.asarray(p2), fix_scale=True)
    np.testing.assert_allclose(float(s), 1.0)
    np.testing.assert_allclose(np.asarray(R), R_true, atol=1e-4)


def test_horn_batched():
    rng = np.random.default_rng(9)
    B = 16
    R_true = rand_rot(rng, (B,))
    p1 = rng.normal(size=(B, 20, 3)).astype(np.float32)
    p2 = np.einsum("bij,bnj->bni", R_true, p1)
    R, t, s = lie.horn_align(jnp.asarray(p1), jnp.asarray(p2))
    np.testing.assert_allclose(np.asarray(R), R_true, atol=1e-4)
    np.testing.assert_allclose(np.asarray(t), np.zeros((B, 3)), atol=1e-4)
