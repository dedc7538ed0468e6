"""Essential-graph pose-graph optimization: solver-level recovery and
map-level propagation of a loop correction BEYOND the covisibility group
(the reference's core loop-closing behavior — Optimizer.cpp:1064-1337 seeds
corrected vertices with non-corrected edge measurements so the correction
distributes over the whole graph)."""
import numpy as np
import jax.numpy as jnp
import pytest

from motioncheck_ccm_slam.config import (
    CameraParams, CapacityParams, Config, ExtractorParams, OptParams,
    PlaceRecParams,
)
from motioncheck_ccm_slam.models import database as db_mod
from motioncheck_ccm_slam.models import loop_closing
from motioncheck_ccm_slam.models import map_state as ms
from motioncheck_ccm_slam.models import vocabulary as vocab_mod
from motioncheck_ccm_slam.ops import lie
from motioncheck_ccm_slam.solvers import pose_graph

from synth_map import ring_poses, ring_world, add_pass


# ---------------------------------------------------------------------------
# Solver level: drifted chain + loop edge, dense and matrix-free CG paths
# ---------------------------------------------------------------------------

def _chain_problem(V=40, drift_t=0.5):
    """Straight chain of V poses; estimates carry linear drift; one loop edge
    ties the last vertex to its TRUE pose relative to vertex 0."""
    true_T = []
    for k in range(V):
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = -0.3 * k          # world->cam: camera at x=0.3k
        true_T.append(T)
    true_T = np.stack(true_T)
    est_T = true_T.copy()
    for k in range(V):
        D = np.eye(4, dtype=np.float32)
        D[1, 3] = drift_t * k / (V - 1)   # growing y offset
        est_T[k] = true_T[k] @ D
    S_true = lie.make_sim3(jnp.asarray(true_T[:, :3, :3]),
                           jnp.asarray(true_T[:, :3, 3]),
                           jnp.ones(V, jnp.float32))
    S_est = lie.make_sim3(jnp.asarray(est_T[:, :3, :3]),
                          jnp.asarray(est_T[:, :3, 3]),
                          jnp.ones(V, jnp.float32))
    # chain edges measured from the DRIFTED estimates (consecutive drift is
    # nearly consistent — like real odometry), loop edge from TRUTH
    ei = list(range(1, V)) + [V - 1]
    ej = list(range(0, V - 1)) + [0]
    ei_j = jnp.asarray(np.array(ei, np.int32))
    ej_j = jnp.asarray(np.array(ej, np.int32))
    meas_chain = pose_graph.make_edge_measurements(
        S_est, ei_j[:-1], ej_j[:-1]
    )
    meas_loop = pose_graph.make_edge_measurements(
        S_true, ei_j[-1:], ej_j[-1:]
    )
    meas = jnp.concatenate([meas_chain, meas_loop], 0)
    edges = pose_graph.PoseGraphEdges(
        i=ei_j, j=ej_j, S_ji_meas=meas,
        weight=jnp.ones(V, jnp.float32), valid=jnp.ones(V, bool),
    )
    fixed = jnp.zeros(V, bool).at[0].set(True)
    return S_true, S_est, edges, fixed


def _cam_centers(S):
    T = np.asarray(pose_graph.se3_from_sim3(S))
    return -np.einsum("kji,kj->ki", T[:, :3, :3], T[:, :3, 3])


@pytest.mark.parametrize("method", ["dense", "cg"])
def test_chain_loop_recovery(method):
    S_true, S_est, edges, fixed = _chain_problem()
    err_before = np.linalg.norm(
        _cam_centers(S_est) - _cam_centers(S_true), axis=-1
    )
    res = pose_graph.optimize_pose_graph(
        S_est, edges, fixed, iterations=25, method=method
    )
    err_after = np.linalg.norm(
        _cam_centers(res.S_iw) - _cam_centers(S_true), axis=-1
    )
    # the tail had the full drift; the loop edge + redistribution shrinks it
    assert err_before[-1] > 0.4
    assert err_after[-1] < 0.1, (err_before[-1], err_after[-1])
    assert err_after.mean() < 0.35 * err_before.mean()


def test_dense_and_cg_agree():
    S_true, S_est, edges, fixed = _chain_problem(V=24)
    r1 = pose_graph.optimize_pose_graph(
        S_est, edges, fixed, iterations=20, method="dense"
    )
    r2 = pose_graph.optimize_pose_graph(
        S_est, edges, fixed, iterations=20, method="cg", pcg_iters=80
    )
    c1 = _cam_centers(r1.S_iw)
    c2 = _cam_centers(r2.S_iw)
    assert np.abs(c1 - c2).max() < 0.02, np.abs(c1 - c2).max()


# ---------------------------------------------------------------------------
# Map level: loop correction must reach KFs OUTSIDE the covis group
# ---------------------------------------------------------------------------

CONFIG = Config().replace(
    extractor=ExtractorParams(max_features=256, n_levels=4, n_features=256),
    capacity=CapacityParams(client_max_kfs=32, client_max_mps=8192),
    camera=CameraParams(k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0),
    placerec=PlaceRecParams(new_loop_thres=10, covisibility_consistency_th=2),
    opt=OptParams(gba_iterations=4, solver_iterations=5),
)

N_PASS1 = 16      # 0..270 deg, 18-deg steps: tail view does NOT overlap head
DRIFT_XI = np.array([0.0, 0.05, 0.0, 0.10, 0.28, 0.0], np.float32)


@pytest.fixture(scope="module")
def drifted_ring():
    """Three-quarter ring traverse with progressive drift, then a revisit of
    the start viewpoints carrying the FULL drift. The drifted tail (last
    pass-1 KFs, ~270 deg away) shares no landmarks with the revisit KFs, so
    only a functional essential graph can correct it."""
    world = ring_world(CONFIG, n_points=1600, seed=3)
    m = ms.MapState.create(CONFIG, server=False)
    angles1 = [18.0 * k for k in range(N_PASS1)]
    poses1, ts1 = ring_poses(angles1)
    drifts = [
        np.asarray(lie.se3_exp(jnp.asarray(DRIFT_XI * (k / (N_PASS1 - 1)))))
        for k in range(N_PASS1)
    ]
    slots1 = add_pass(m, world, poses1, ts1, kf_id_start=0, seed=1,
                      lm_pose_error=drifts)
    # revisit: same viewpoints as KFs 0 and 1, full drift, fresh landmarks
    poses2, ts2 = ring_poses([0.0, 18.0], t0=10.0)
    D_full = np.asarray(lie.se3_exp(jnp.asarray(DRIFT_XI)))
    slots2 = add_pass(m, world, poses2, ts2, kf_id_start=50, seed=2,
                      lm_pose_error=D_full, chain_from=slots1[-1])
    return world, m, slots1, slots2, poses1, poses2


def _center_errors(m, slots, true_poses):
    errs = []
    for k, slot in enumerate(slots):
        T_est = np.asarray(m.kf.Tcw[slot])
        C_est = np.linalg.inv(T_est)[:3, 3]
        C_true = np.linalg.inv(true_poses[k])[:3, 3]
        errs.append(float(np.linalg.norm(C_est - C_true)))
    return np.array(errs)


def test_loop_correction_propagates_past_covis_group(drifted_ring):
    world, m, slots1, slots2, poses1, poses2 = drifted_ring
    vocab = vocab_mod.default_vocabulary()
    closer = loop_closing.LoopCloser(
        config=CONFIG, map=m,
        database=db_mod.KeyFrameDatabase(vocab=vocab, capacity=m.nk),
        run_gba_after_loop=False,
    )
    err_before = _center_errors(m, slots1, poses1)
    # precondition: the drifted tail is OUTSIDE the covis group of the
    # revisit KFs (no shared landmarks) — otherwise this test shows nothing
    W = np.asarray(ms.covisibility(m.kf, m.nm))
    tail = slots1[-1]
    assert all(W[tail, s2] < 15 for s2 in slots2), \
        "fixture invalid: tail covisible with revisit"
    closed = False
    for slot in slots1 + slots2:
        closed = closer.process_keyframe(slot) or closed
    assert closed, "revisit with drift must close a loop"
    err_after = _center_errors(m, slots1, poses1)
    # the tail carried (nearly) the full drift; after the essential graph it
    # must have recovered most of it even though it is outside the covis
    # group of the loop-closing KF
    assert err_before[-1] > 0.25, err_before
    assert err_after[-1] < 0.5 * err_before[-1], (
        err_before[-1], err_after[-1]
    )
    assert err_after[N_PASS1 // 2:].mean() < 0.6 * \
        err_before[N_PASS1 // 2:].mean()
