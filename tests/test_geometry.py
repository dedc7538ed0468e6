import numpy as np
import jax.numpy as jnp

from motioncheck_ccm_slam.ops import geometry, lie
from motioncheck_ccm_slam.config import CameraParams


def test_project_backproject():
    cam = CameraParams()
    K = jnp.asarray(cam.K())
    pts = jnp.array([[[0.1, -0.2, 2.0], [0.0, 0.0, 1.0], [1.0, 1.0, 5.0]]], jnp.float32)
    uv = geometry.project(pts, K)
    rays = geometry.backproject(uv[0], K)
    # rays scaled by depth should recover the points
    np.testing.assert_allclose(
        np.asarray(rays * pts[0, :, 2:3]), np.asarray(pts[0]), atol=1e-4
    )


def test_undistort_roundtrip():
    cam = CameraParams()
    K = jnp.asarray(cam.K())
    dist = jnp.asarray(cam.dist_coeffs())
    rng = np.random.default_rng(0)
    # normalized points within FOV
    xy = rng.uniform(-0.5, 0.5, size=(200, 2)).astype(np.float32)
    xyd = geometry.distort_normalized(jnp.asarray(xy), dist)
    uv_dist = jnp.stack(
        [xyd[:, 0] * cam.fx + cam.cx, xyd[:, 1] * cam.fy + cam.cy], -1
    )
    uv_undist = geometry.undistort_points(uv_dist, K, dist, iters=10)
    uv_true = jnp.stack(
        [xy[:, 0] * cam.fx + cam.cx, xy[:, 1] * cam.fy + cam.cy], -1
    )
    np.testing.assert_allclose(np.asarray(uv_undist), np.asarray(uv_true), atol=0.05)


def test_triangulate_dlt_exact():
    rng = np.random.default_rng(1)
    cam = CameraParams()
    K = jnp.asarray(cam.K())
    # two cameras with baseline
    T1 = jnp.eye(4, dtype=jnp.float32)
    T2 = lie.se3_exp(jnp.array([0.02, -0.01, 0.03, 0.5, 0.0, 0.0], jnp.float32))
    pts_w = rng.uniform(-1, 1, size=(64, 3)).astype(np.float32)
    pts_w[:, 2] += 5.0
    pts_w = jnp.asarray(pts_w)
    P1 = geometry.projection_matrix(K, T1)
    P2 = geometry.projection_matrix(K, T2)
    uv1 = geometry.project(lie.transform_points(T1, pts_w[None])[0][None], K)[0]
    uv2 = geometry.project(lie.transform_points(T2, pts_w[None])[0][None], K)[0]
    tri, _ = geometry.triangulate_dlt(P1, P2, uv1[None], uv2[None])
    np.testing.assert_allclose(np.asarray(tri[0]), np.asarray(pts_w), atol=1e-2)


def test_reprojection_chi2_zero_for_exact():
    rng = np.random.default_rng(2)
    cam = CameraParams()
    K = jnp.asarray(cam.K())
    Tcw = lie.se3_exp(jnp.array([0.1, 0.0, -0.1, 0.2, 0.1, 0.0], jnp.float32))
    pts_w = jnp.asarray(rng.uniform(-1, 1, size=(32, 3)).astype(np.float32))
    pts_w = pts_w.at[:, 2].add(4.0)
    pc = lie.transform_points(Tcw, pts_w[None])[0]
    uv = geometry.project(pc[None], K)[0]
    chi2, depth = geometry.reprojection_chi2(
        pts_w[None], Tcw, K, uv[None], jnp.ones((1, 32), jnp.float32)
    )
    assert float(jnp.max(chi2)) < 1e-4
    assert bool(jnp.all(depth > 0))


def test_camera_center():
    Tcw = lie.se3_exp(jnp.array([0.0, 0.3, 0.0, 1.0, 2.0, 3.0], jnp.float32))
    Ow = geometry.camera_center(Tcw)
    # transforming Ow to camera frame should give origin
    pc = lie.transform_points(Tcw, Ow[None, None])[0, 0]
    np.testing.assert_allclose(np.asarray(pc), np.zeros(3), atol=1e-5)


def test_parallax():
    C1 = jnp.array([0.0, 0.0, 0.0], jnp.float32)
    C2 = jnp.array([1.0, 0.0, 0.0], jnp.float32)
    pts = jnp.array([[[0.5, 0.0, 100.0], [0.5, 0.0, 0.5]]], jnp.float32)
    cosp = geometry.parallax_cos(C1[None], C2[None], pts)
    assert float(cosp[0, 0]) > 0.999        # far point: tiny parallax
    assert float(cosp[0, 1]) < 0.5          # near point: large parallax
