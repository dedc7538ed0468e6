"""Distributed GBA on the virtual 8-device CPU mesh."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh

from motioncheck_ccm_slam.parallel import sharded_ba
from motioncheck_ccm_slam.solvers import ba_core, local_ba
from motioncheck_ccm_slam.ops import lie
from test_ba import synth_scene, K


@pytest.fixture(scope="module", params=[1, 8])
def mesh(request):
    n = request.param
    devs = np.array(jax.devices()[:n])
    return Mesh(devs, ("obs",))


def test_matrix_free_cm_matches_dense():
    """The component-major single-chip solver lands in the dense solver's
    basin (same scene as the sharded test)."""
    rng = np.random.default_rng(0)
    Tcw_true, pts_true, obs = synth_scene(rng, n_cams=8, n_pts=200,
                                          obs_noise=0.2)
    Tcw_init = np.asarray(Tcw_true).copy()
    for c in range(1, 8):
        xi = np.zeros(6, np.float32)
        xi[:3] = rng.normal(0, 0.005, 3)
        xi[3:] = rng.normal(0, 0.04, 3)
        Tcw_init[c] = np.asarray(lie.se3_exp(jnp.asarray(xi))) @ Tcw_init[c]
    pts_init = pts_true + jnp.asarray(
        rng.normal(0, 0.05, pts_true.shape).astype(np.float32)
    )
    fixed_cam = jnp.zeros(8, bool).at[0].set(True)
    fixed_lm = jnp.zeros(200, bool)

    gba = sharded_ba.make_matrix_free_gba(iterations=12, pcg_iters=30)
    res = gba(jnp.asarray(Tcw_init), pts_init, obs, K, fixed_cam, fixed_lm)

    err_before = np.abs(Tcw_init[1:] - np.asarray(Tcw_true)[1:]).max()
    err_after = np.abs(np.asarray(res.Tcw)[1:] - np.asarray(Tcw_true)[1:]).max()
    assert err_after < err_before * 0.3, (err_before, err_after)

    dense = local_ba.bundle_adjust(
        jnp.asarray(Tcw_init), pts_init, obs, K, fixed_cam,
        fixed_lm=fixed_lm, iterations=12,
    )
    err_dense = np.abs(np.asarray(dense.Tcw)[1:] - np.asarray(Tcw_true)[1:]).max()
    assert err_after < max(2.5 * err_dense, 5e-3)
    # inlier classification agrees with the dense solver on >99% of obs
    agree = (np.asarray(res.obs_inlier) == np.asarray(dense.obs_inlier)).mean()
    assert agree > 0.99


def test_sharded_gba_matches_dense(mesh):
    rng = np.random.default_rng(0)
    Tcw_true, pts_true, obs = synth_scene(rng, n_cams=8, n_pts=200,
                                          obs_noise=0.2)
    Tcw_init = np.asarray(Tcw_true).copy()
    for c in range(1, 8):
        xi = np.zeros(6, np.float32)
        xi[:3] = rng.normal(0, 0.005, 3)
        xi[3:] = rng.normal(0, 0.04, 3)
        Tcw_init[c] = np.asarray(lie.se3_exp(jnp.asarray(xi))) @ Tcw_init[c]
    pts_init = pts_true + jnp.asarray(
        rng.normal(0, 0.05, pts_true.shape).astype(np.float32)
    )
    fixed_cam = jnp.zeros(8, bool).at[0].set(True)
    fixed_lm = jnp.zeros(200, bool)

    gba = sharded_ba.make_sharded_gba(mesh, iterations=12, pcg_iters=30)
    res = gba(jnp.asarray(Tcw_init), pts_init, obs, K, fixed_cam, fixed_lm)

    err_before = np.abs(Tcw_init[1:] - np.asarray(Tcw_true)[1:]).max()
    err_after = np.abs(np.asarray(res.Tcw)[1:] - np.asarray(Tcw_true)[1:]).max()
    assert err_after < err_before * 0.3, (err_before, err_after)

    # agreement with the dense single-chip solver
    dense = local_ba.bundle_adjust(
        jnp.asarray(Tcw_init), pts_init, obs, K, fixed_cam,
        fixed_lm=fixed_lm, iterations=12,
    )
    err_dense = np.abs(np.asarray(dense.Tcw)[1:] - np.asarray(Tcw_true)[1:]).max()
    # both should land in the same basin within noise
    assert err_after < max(2.5 * err_dense, 5e-3)


def test_sharded_gba_obs_padding(mesh):
    """Observation counts that don't divide the mesh still work."""
    rng = np.random.default_rng(1)
    Tcw_true, pts_true, obs = synth_scene(rng, n_cams=3, n_pts=67,
                                          obs_noise=0.1)
    assert obs.cam_idx.shape[0] % 8 != 0
    gba = sharded_ba.make_sharded_gba(mesh, iterations=4, pcg_iters=15)
    res = gba(
        Tcw_true, pts_true, obs, K,
        jnp.zeros(3, bool).at[0].set(True), jnp.zeros(67, bool),
    )
    assert np.isfinite(float(res.cost))
    assert res.obs_inlier.shape[0] == obs.cam_idx.shape[0]
