"""The server GBA solvers (parallel/sharded_ba): the single-device
matrix-free solver and the mesh-sharded one, against the dense-W optimizer,
against each other, and the Schur operator against a dense S."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh

from motioncheck_ccm_slam.ops import lie
from motioncheck_ccm_slam.parallel import sharded_ba
from motioncheck_ccm_slam.solvers import ba_core, local_ba

from test_ba import synth_scene, K


def _perturbed(rng, n_cams=8, n_pts=200):
    """A camera-major scene (every camera sees every point) with perturbed
    poses and landmarks; camera 0 is the gauge."""
    Tcw_true, pts_true, obs = synth_scene(rng, n_cams=n_cams, n_pts=n_pts,
                                          obs_noise=0.2)
    Tcw_init = np.asarray(Tcw_true).copy()
    for c in range(1, n_cams):
        xi = np.zeros(6, np.float32)
        xi[:3] = rng.normal(0, 0.005, 3)
        xi[3:] = rng.normal(0, 0.04, 3)
        Tcw_init[c] = np.asarray(lie.se3_exp(jnp.asarray(xi))) @ Tcw_init[c]
    pts_init = pts_true + jnp.asarray(
        rng.normal(0, 0.05, pts_true.shape).astype(np.float32))
    fixed_cam = jnp.zeros(n_cams, bool).at[0].set(True)
    fixed_lm = jnp.zeros(n_pts, bool)
    return (jnp.asarray(Tcw_init), pts_init, obs, fixed_cam, fixed_lm,
            Tcw_true, pts_true)


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), (sharded_ba.AXIS,))


@pytest.mark.parametrize("n_shards", [1, 8])
def test_gba_converges(n_shards):
    """The product server solver for ``n_shards`` devices (matrix-free on
    one, mesh-sharded on eight) reaches the dense-W optimizer's optimum."""
    rng = np.random.default_rng(0)
    (Tcw_i, pts_i, obs, fixed_cam, fixed_lm, Tcw_true,
     pts_true) = _perturbed(rng)
    if n_shards == 1:
        gba = sharded_ba.make_matrix_free_gba(iterations=8, pcg_iters=30)
    else:
        gba = sharded_ba.make_sharded_gba(_mesh(n_shards), iterations=8,
                                          pcg_iters=30)
    res = gba(Tcw_i, pts_i, obs, K, fixed_cam, fixed_lm)
    dense = local_ba.bundle_adjust(Tcw_i, pts_i, obs, K, fixed_cam,
                                   fixed_lm=fixed_lm, iterations=8)
    assert float(res.cost) < float(dense.cost) * 1.10
    pose_err = float(jnp.abs(res.Tcw - Tcw_true).max())
    assert pose_err < 0.01, pose_err
    agree = float(jnp.mean(res.obs_inlier == dense.obs_inlier))
    assert agree > 0.99, agree


def test_gba_mesh_matches_single_device():
    """The 8-device sharded solve and the single-device matrix-free solve
    land on the same optimum (same arithmetic up to summation order)."""
    rng = np.random.default_rng(5)
    Tcw_i, pts_i, obs, fixed_cam, fixed_lm, _, _ = _perturbed(
        rng, n_cams=6, n_pts=150)
    g1 = sharded_ba.make_matrix_free_gba(iterations=5, pcg_iters=20)
    g8 = sharded_ba.make_sharded_gba(_mesh(8), iterations=5, pcg_iters=20)
    r1 = g1(Tcw_i, pts_i, obs, K, fixed_cam, fixed_lm)
    r8 = g8(Tcw_i, pts_i, obs, K, fixed_cam, fixed_lm)
    assert abs(float(r1.cost) - float(r8.cost)) <= (
        1e-3 * max(float(r1.cost), 1.0))
    assert float(jnp.abs(r1.Tcw - r8.Tcw).max()) < 1e-3
    # landmark coords are O(10): allow float-ordering divergence amplified
    # over 5 LM iterations
    assert float(jnp.abs(r1.Xw - r8.Xw).max()) < 5e-3
    assert bool(jnp.all(r1.obs_inlier == r8.obs_inlier))


def test_gba_dynamic_iterations_no_retrace(monkeypatch):
    """n_iterations is a traced scalar: chunked callers reuse the compiled
    body, so a second chunk size traces the LM iteration no further."""
    rng = np.random.default_rng(1)
    Tcw_i, pts_i, obs, fixed_cam, fixed_lm, _, _ = _perturbed(
        rng, n_cams=4, n_pts=80)
    traces = []
    real = sharded_ba._gba_iteration_cm

    def counting(*a, **kw):
        traces.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(sharded_ba, "_gba_iteration_cm", counting)
    gba = sharded_ba.make_matrix_free_gba(pcg_iters=10)
    c1 = float(gba(Tcw_i, pts_i, obs, K, fixed_cam, fixed_lm,
                   n_iterations=2).cost)
    n_first = len(traces)
    c2 = float(gba(Tcw_i, pts_i, obs, K, fixed_cam, fixed_lm,
                   n_iterations=6).cost)
    assert n_first >= 1
    assert len(traces) == n_first
    assert c2 <= c1 * 1.05


def test_gba_reject_branch_monotone():
    """Starting AT a converged optimum, LM steps keep getting rejected: the
    state must stay put, the cost must never increase, and the inlier
    classification must match a fresh zero-iteration pass."""
    rng = np.random.default_rng(9)
    Tcw_i, pts_i, obs, fixed_cam, fixed_lm, _, _ = _perturbed(
        rng, n_cams=5, n_pts=100)
    gba = sharded_ba.make_matrix_free_gba(pcg_iters=15)
    r0 = gba(Tcw_i, pts_i, obs, K, fixed_cam, fixed_lm, n_iterations=8)
    r1 = gba(r0.Tcw, r0.Xw, obs, K, fixed_cam, fixed_lm, n_iterations=4)
    assert float(r1.cost) <= float(r0.cost) * (1.0 + 1e-5)
    assert float(jnp.abs(r1.Tcw - r0.Tcw).max()) < 5e-3
    r2 = gba(r1.Tcw, r1.Xw, obs, K, fixed_cam, fixed_lm, n_iterations=0)
    assert bool(jnp.all(r1.obs_inlier == r2.obs_inlier))


@pytest.mark.parametrize("C,L,O", [(256, 256, 3000), (130, 384, 5000)])
def test_schur_matvec_matches_dense(C, L, O):
    """``_schur_matvec`` (gather + segment-sum sweeps) equals the dense
    reduced camera matrix S = blockdiag(Hcc) - W Hll^-1 W^T applied to v."""
    rng = np.random.default_rng(0)
    cam_idx = rng.integers(0, C, O).astype(np.int32)
    lm_idx = rng.integers(0, L, O).astype(np.int32)
    Wcl = rng.normal(0, 0.3, (O, 6, 3)).astype(np.float32)
    A = rng.normal(0, 0.2, (C, 6, 6)).astype(np.float32)
    Hcc = A @ np.transpose(A, (0, 2, 1)) + 2.0 * np.eye(6, dtype=np.float32)
    Q = rng.normal(0, 0.05, (L, 3, 3)).astype(np.float32)
    Hll_inv = (rng.uniform(0.2, 2.0, L)[:, None, None] * np.eye(3)
               + Q @ np.transpose(Q, (0, 2, 1))).astype(np.float32)
    v = rng.normal(0, 1.0, (C, 6)).astype(np.float32)

    Sv = sharded_ba._schur_matvec(
        jnp.asarray(v), jnp.asarray(Hcc), jnp.asarray(Hll_inv),
        jnp.asarray(Wcl), jnp.asarray(cam_idx), jnp.asarray(lm_idx), C, L,
        reduce=lambda x: x)

    W = np.zeros((6 * C, 3 * L), np.float64)
    for o in range(O):
        c, l = cam_idx[o], lm_idx[o]
        W[6 * c:6 * c + 6, 3 * l:3 * l + 3] += Wcl[o]
    Hinv = np.zeros((3 * L, 3 * L), np.float64)
    Hd = np.zeros((6 * C, 6 * C), np.float64)
    for l in range(L):
        Hinv[3 * l:3 * l + 3, 3 * l:3 * l + 3] = Hll_inv[l]
    for c in range(C):
        Hd[6 * c:6 * c + 6, 6 * c:6 * c + 6] = Hcc[c]
    ref = ((Hd - W @ Hinv @ W.T) @ v.reshape(-1)).reshape(C, 6)
    err = np.abs(np.asarray(Sv) - ref).max() / (np.abs(ref).max() + 1e-6)
    assert err < 1e-5, err


def test_invalid_obs_excluded():
    """Masked observations weigh exactly nothing: a matrix-free solve with
    some observations masked (and, like the product stream's empty slots,
    parked at landmark 0 with junk pixels) matches a sharded solve on the
    stream with those observations dropped."""
    rng = np.random.default_rng(2)
    Tcw_i, pts_i, obs, fixed_cam, fixed_lm, _, _ = _perturbed(
        rng, n_cams=6, n_pts=120)
    O = obs.cam_idx.shape[0]
    keep = rng.uniform(size=O) > 0.3
    masked = obs._replace(
        lm_idx=jnp.where(jnp.asarray(keep), obs.lm_idx, 0),
        uv=jnp.where(jnp.asarray(keep)[:, None], obs.uv, 1e4),
        valid=jnp.asarray(keep),
    )
    sel = jnp.asarray(np.flatnonzero(keep))
    dropped = ba_core.BAObservations(*(a[sel] for a in obs))
    r_m = sharded_ba.make_matrix_free_gba(iterations=5, pcg_iters=20)(
        Tcw_i, pts_i, masked, K, fixed_cam, fixed_lm)
    r_d = sharded_ba.make_sharded_gba(_mesh(1), iterations=5, pcg_iters=20)(
        Tcw_i, pts_i, dropped, K, fixed_cam, fixed_lm)
    assert abs(float(r_m.cost) - float(r_d.cost)) <= (
        1e-3 * max(float(r_d.cost), 1.0))
    assert float(jnp.abs(r_m.Tcw - r_d.Tcw).max()) < 1e-3
    assert float(jnp.abs(r_m.Xw - r_d.Xw).max()) < 5e-3
    assert not bool(jnp.any(r_m.obs_inlier[~keep]))
    assert bool(jnp.all(r_m.obs_inlier[sel] == r_d.obs_inlier))


def test_lm_segment_sums_exact_deep_in_stream():
    """Per-landmark sums over a long landmark-sorted stream keep full f32
    precision for the LAST landmark too (a cumsum + boundary difference
    loses ~eps * O / segment length there)."""
    O, seg = 1 << 20, 4
    L = O // seg
    rng = np.random.default_rng(0)
    x = rng.uniform(1.0, 2.0, (3, O)).astype(np.float32)
    lm_sorted = np.repeat(np.arange(L, dtype=np.int32), seg)
    got = np.asarray(sharded_ba._lm_sum_t(jnp.asarray(x),
                                          jnp.asarray(lm_sorted), L))
    ref = x.astype(np.float64).reshape(3, L, seg).sum(-1)
    assert np.abs(got - ref).max() / ref.min() < 1e-6
