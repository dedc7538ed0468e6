import numpy as np
import jax
import jax.numpy as jnp

from motioncheck_ccm_slam.ops import lie
from motioncheck_ccm_slam.solvers import ba_core, pose_opt, local_ba
from motioncheck_ccm_slam.config import CameraParams

CAM = CameraParams()
K = jnp.asarray(CAM.K())


def synth_scene(rng, n_cams=6, n_pts=200, obs_noise=0.3):
    """Cameras on an arc looking at a point cloud; full visibility."""
    pts = rng.uniform(-2, 2, size=(n_pts, 3)).astype(np.float32)
    pts[:, 2] += 8.0
    Tcw = []
    for i in range(n_cams):
        xi = np.zeros(6, np.float32)
        xi[:3] = rng.normal(0, 0.03, 3)  # small rotations
        xi[3] = i * 0.4                   # baseline along x
        xi[4:] = rng.normal(0, 0.05, 2)
        Tcw.append(np.asarray(lie.se3_exp(jnp.asarray(xi))))
    Tcw = np.stack(Tcw)
    # observations: every camera sees every point
    cam_idx, lm_idx, uvs = [], [], []
    for c in range(n_cams):
        R, t = Tcw[c, :3, :3], Tcw[c, :3, 3]
        pc = pts @ R.T + t
        uv = np.stack(
            [
                CAM.fx * pc[:, 0] / pc[:, 2] + CAM.cx,
                CAM.fy * pc[:, 1] / pc[:, 2] + CAM.cy,
            ],
            -1,
        )
        uv += rng.normal(0, obs_noise, uv.shape)
        cam_idx.append(np.full(n_pts, c))
        lm_idx.append(np.arange(n_pts))
        uvs.append(uv)
    obs = ba_core.BAObservations(
        cam_idx=jnp.asarray(np.concatenate(cam_idx), jnp.int32),
        lm_idx=jnp.asarray(np.concatenate(lm_idx), jnp.int32),
        uv=jnp.asarray(np.concatenate(uvs), jnp.float32),
        inv_sigma2=jnp.ones(n_cams * n_pts, jnp.float32),
        valid=jnp.ones(n_cams * n_pts, bool),
    )
    return jnp.asarray(Tcw), jnp.asarray(pts), obs


def test_pose_opt_converges():
    rng = np.random.default_rng(0)
    Tcw_all, pts, _ = synth_scene(rng, n_cams=1, n_pts=150)
    Tcw_true = Tcw_all[0]
    # observations from the true pose
    pc = lie.transform_points(Tcw_true, pts[None])[0]
    from motioncheck_ccm_slam.ops import geometry
    uv = geometry.project(pc[None], K)[0]
    # perturb the pose
    noise = jnp.asarray(
        np.array([0.02, -0.03, 0.01, 0.1, -0.15, 0.1], np.float32)
    )
    Tcw_init = lie.se3_exp(noise) @ Tcw_true
    res = pose_opt.optimize_pose(
        Tcw_init, pts, uv, jnp.ones(150, jnp.float32), jnp.ones(150, bool), K
    )
    err = np.asarray(res.Tcw) - np.asarray(Tcw_true)
    assert np.abs(err).max() < 1e-3
    assert int(res.n_inliers) == 150


def test_pose_opt_rejects_outliers():
    rng = np.random.default_rng(1)
    Tcw_all, pts, _ = synth_scene(rng, n_cams=1, n_pts=200)
    Tcw_true = Tcw_all[0]
    pc = lie.transform_points(Tcw_true, pts[None])[0]
    from motioncheck_ccm_slam.ops import geometry
    uv = np.asarray(geometry.project(pc[None], K)[0]).copy()
    # corrupt 20% of observations
    n_out = 40
    uv[:n_out] += rng.uniform(30, 80, size=(n_out, 2)) * rng.choice([-1, 1], (n_out, 2))
    noise = jnp.asarray(np.array([0.01, 0.01, -0.01, 0.05, 0.05, -0.05], np.float32))
    Tcw_init = lie.se3_exp(noise) @ Tcw_true
    res = pose_opt.optimize_pose(
        Tcw_init, pts, jnp.asarray(uv), jnp.ones(200, jnp.float32),
        jnp.ones(200, bool), K,
    )
    err = np.abs(np.asarray(res.Tcw) - np.asarray(Tcw_true)).max()
    assert err < 2e-3
    inl = np.asarray(res.inliers)
    assert inl[:n_out].sum() <= 2       # outliers rejected
    assert inl[n_out:].mean() > 0.97    # inliers kept


def test_local_ba_reduces_error():
    rng = np.random.default_rng(2)
    Tcw_true, pts_true, obs = synth_scene(rng, n_cams=6, n_pts=150, obs_noise=0.05)
    # perturb everything except camera 0 (gauge)
    Tcw_init = np.asarray(Tcw_true).copy()
    for c in range(1, 6):
        xi = rng.normal(0, 0.01, 6).astype(np.float32)
        xi[3:] = rng.normal(0, 0.05, 3)
        Tcw_init[c] = np.asarray(lie.se3_exp(jnp.asarray(xi))) @ Tcw_init[c]
    pts_init = pts_true + jnp.asarray(rng.normal(0, 0.05, pts_true.shape).astype(np.float32))
    fixed = jnp.zeros(6, bool).at[0].set(True)
    res = local_ba.bundle_adjust(
        jnp.asarray(Tcw_init), pts_init, obs, K, fixed, iterations=12
    )
    err_before = np.abs(Tcw_init[1:] - np.asarray(Tcw_true)[1:]).max()
    err_after = np.abs(np.asarray(res.Tcw)[1:] - np.asarray(Tcw_true)[1:]).max()
    # monocular BA with one fixed camera leaves a scale gauge mode, so pose
    # recovery is approximate; expect a solid (not perfect) reduction
    assert err_after < err_before * 0.25
    # camera 0 untouched
    np.testing.assert_allclose(np.asarray(res.Tcw)[0], Tcw_init[0], atol=1e-7)
    # landmarks recovered
    lm_err = np.linalg.norm(np.asarray(res.Xw) - np.asarray(pts_true), axis=-1)
    assert np.median(lm_err) < 0.06  # scale-gauge mode bounds absolute accuracy


def test_local_ba_two_pass_outlier_gate():
    rng = np.random.default_rng(3)
    Tcw_true, pts_true, obs = synth_scene(rng, n_cams=5, n_pts=120, obs_noise=0.2)
    uv = np.asarray(obs.uv).copy()
    n_bad = 60
    bad_idx = rng.choice(len(uv), n_bad, replace=False)
    uv[bad_idx] += rng.uniform(40, 90, size=(n_bad, 2))
    obs = obs._replace(uv=jnp.asarray(uv))
    Tcw_init = np.asarray(Tcw_true).copy()
    for c in range(1, 5):
        xi = np.zeros(6, np.float32)
        xi[3:] = rng.normal(0, 0.03, 3)
        Tcw_init[c] = np.asarray(lie.se3_exp(jnp.asarray(xi))) @ Tcw_init[c]
    fixed = jnp.zeros(5, bool).at[0].set(True)
    res = local_ba.bundle_adjust(
        jnp.asarray(Tcw_init), pts_true, obs, K, fixed,
        iterations=15, outlier_pass_at=5,
    )
    inl = np.asarray(res.obs_inlier)
    assert inl[bad_idx].mean() < 0.1
    err_after = np.abs(np.asarray(res.Tcw)[1:] - np.asarray(Tcw_true)[1:]).max()
    err_before = np.abs(Tcw_init[1:] - np.asarray(Tcw_true)[1:]).max()
    # 0.2px noise + mono scale gauge bound the absolute accuracy here; what
    # matters is that outliers were rejected and the estimate improved
    assert err_after < err_before


def test_ba_jacobians_match_autodiff():
    """Analytic reprojection Jacobians == jax.jacobian of the residual."""
    rng = np.random.default_rng(4)
    Tcw = lie.se3_exp(jnp.asarray(rng.normal(0, 0.1, 6).astype(np.float32)))
    X = jnp.asarray(np.array([[0.3, -0.2, 5.0]], np.float32))
    obs = ba_core.BAObservations(
        cam_idx=jnp.zeros(1, jnp.int32),
        lm_idx=jnp.zeros(1, jnp.int32),
        uv=jnp.zeros((1, 2), jnp.float32),
        inv_sigma2=jnp.ones(1, jnp.float32),
        valid=jnp.ones(1, bool),
    )

    def res_of_xi(xi):
        T = lie.se3_exp(xi[None])[0] @ Tcw
        r, _, _ = ba_core.reproject_residuals(T[None], X, obs, K)
        return r[0]

    def res_of_X(x):
        r, _, _ = ba_core.reproject_residuals(Tcw[None], x[None], obs, K)
        return r[0]

    Jc_auto = jax.jacobian(res_of_xi)(jnp.zeros(6, jnp.float32))
    Jl_auto = jax.jacobian(res_of_X)(X[0])
    r, pc, _ = ba_core.reproject_residuals(Tcw[None], X, obs, K)
    Jc, Jl = ba_core.reproject_jacobians(pc, Tcw[None][:, :3, :3], K)
    np.testing.assert_allclose(np.asarray(Jc[0]), np.asarray(Jc_auto), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(np.asarray(Jl[0]), np.asarray(Jl_auto), rtol=1e-3, atol=1e-3)
