import numpy as np
import jax
import jax.numpy as jnp

from motioncheck_ccm_slam.ops import lie, ransac, geometry
from motioncheck_ccm_slam.config import CameraParams

CAM = CameraParams()
K = jnp.asarray(CAM.K())


def make_two_view(rng, n=200, planar=False, noise=0.3, outlier_frac=0.1):
    pts = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    if planar:
        pts[:, 2] = 0.0
    pts[:, 2] += 6.0
    T2 = lie.se3_exp(
        jnp.asarray(np.array([0.02, -0.05, 0.01, 0.8, 0.05, -0.1], np.float32))
    )
    pts_j = jnp.asarray(pts)
    uv1 = np.asarray(geometry.project(pts_j[None], K)[0]).copy()
    pc2 = lie.transform_points(T2, pts_j[None])[0]
    uv2 = np.asarray(geometry.project(pc2[None], K)[0]).copy()
    uv1 += rng.normal(0, noise, uv1.shape)
    uv2 += rng.normal(0, noise, uv2.shape)
    n_out = int(n * outlier_frac)
    uv2[:n_out] += rng.uniform(20, 60, (n_out, 2))
    return pts, np.asarray(T2), jnp.asarray(uv1.astype(np.float32)), jnp.asarray(uv2.astype(np.float32)), n_out


def test_two_view_init_general_scene():
    rng = np.random.default_rng(0)
    pts, T2, uv1, uv2, n_out = make_two_view(rng)
    res = ransac.initialize_two_view(
        jax.random.PRNGKey(0), uv1, uv2, jnp.ones(len(uv1), bool), K
    )
    assert bool(res.success)
    assert not bool(res.used_homography)
    # direction of translation matches (scale is free in mono)
    t_est = np.asarray(res.Tcw2[:3, 3])
    t_true = T2[:3, 3]
    cos = t_est @ t_true / (np.linalg.norm(t_est) * np.linalg.norm(t_true))
    assert cos > 0.995
    R_err = np.abs(np.asarray(res.Tcw2[:3, :3]) - T2[:3, :3]).max()
    assert R_err < 0.02
    # outlier correspondences not marked good
    good = np.asarray(res.good)
    assert good[:n_out].mean() < 0.4
    assert good[n_out:].mean() > 0.7


def test_two_view_init_planar_uses_homography():
    rng = np.random.default_rng(1)
    pts, T2, uv1, uv2, _ = make_two_view(rng, planar=True, outlier_frac=0.05)
    res = ransac.initialize_two_view(
        jax.random.PRNGKey(1), uv1, uv2, jnp.ones(len(uv1), bool), K
    )
    assert bool(res.used_homography)
    assert bool(res.success)
    t_est = np.asarray(res.Tcw2[:3, 3])
    t_true = T2[:3, 3]
    cos = t_est @ t_true / (np.linalg.norm(t_est) * np.linalg.norm(t_true))
    assert cos > 0.99


def test_two_view_insufficient_baseline_fails():
    """Nearly-zero baseline -> no parallax -> init must refuse."""
    rng = np.random.default_rng(2)
    pts = rng.uniform(-2, 2, size=(150, 3)).astype(np.float32)
    pts[:, 2] += 6.0
    pts_j = jnp.asarray(pts)
    T2 = lie.se3_exp(jnp.asarray(np.array([0, 0, 0, 1e-4, 0, 0], np.float32)))
    uv1 = geometry.project(pts_j[None], K)[0]
    pc2 = lie.transform_points(T2, pts_j[None])[0]
    uv2 = geometry.project(pc2[None], K)[0]
    res = ransac.initialize_two_view(
        jax.random.PRNGKey(2), uv1, uv2, jnp.ones(150, bool), K
    )
    assert not bool(res.success)


def test_pnp_ransac():
    rng = np.random.default_rng(3)
    n = 120
    pts = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    pts[:, 2] += 6.0
    Tcw = lie.se3_exp(jnp.asarray(np.array([0.1, -0.2, 0.05, 0.3, 0.1, -0.2], np.float32)))
    pc = lie.transform_points(Tcw, jnp.asarray(pts)[None])[0]
    uv = np.asarray(geometry.project(pc[None], K)[0]).copy()
    uv += rng.normal(0, 0.3, uv.shape)
    n_out = 30
    uv[:n_out] += rng.uniform(30, 80, (n_out, 2))
    res = ransac.pnp_ransac(
        jax.random.PRNGKey(3), jnp.asarray(pts), jnp.asarray(uv.astype(np.float32)),
        jnp.ones(n, bool), K,
    )
    assert bool(res.success)
    err = np.abs(np.asarray(res.Tcw) - np.asarray(Tcw)).max()
    assert err < 5e-3
    inl = np.asarray(res.inliers)
    assert inl[:n_out].sum() <= 2
    assert inl[n_out:].mean() > 0.95


def test_sim3_ransac():
    rng = np.random.default_rng(4)
    n = 80
    # landmarks in map1's frame
    p1 = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    p1[:, 2] += 6.0
    # true similarity map1 -> map2
    R_true = np.asarray(lie.so3_exp(jnp.asarray(np.array([0.1, -0.2, 0.3], np.float32))))
    s_true = 1.6
    t_true = np.array([0.5, -0.3, 1.0], np.float32)
    p2 = (s_true * p1 @ R_true.T + t_true).astype(np.float32)
    # corrupt 25% of the correspondences
    n_out = 20
    p2_n = p2.copy()
    p2_n[:n_out] += rng.uniform(1.0, 3.0, (n_out, 3)).astype(np.float32)
    # keyframes observing each set
    Tcw1 = jnp.eye(4, dtype=jnp.float32)
    Tcw2 = jnp.eye(4, dtype=jnp.float32)
    uv1 = geometry.project(lie.transform_points(Tcw1, jnp.asarray(p1)[None])[0][None], K)[0]
    uv2 = geometry.project(lie.transform_points(Tcw2, jnp.asarray(p2)[None])[0][None], K)[0]
    res = ransac.sim3_ransac(
        jax.random.PRNGKey(4), jnp.asarray(p1), jnp.asarray(p2_n),
        uv1, uv2, Tcw1, Tcw2, K, jnp.ones(n, bool),
    )
    assert bool(res.success)
    np.testing.assert_allclose(float(res.s), s_true, atol=0.02)
    np.testing.assert_allclose(np.asarray(res.R), R_true, atol=0.02)
    np.testing.assert_allclose(np.asarray(res.t), t_true, atol=0.05)
    inl = np.asarray(res.inliers)
    assert inl[:n_out].sum() <= 2
