"""Server-side loop closing on a synthetic revisit with simulated drift."""
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

from synth_map import SynthWorld, add_pass, arc_poses

CONFIG = Config().replace(
    extractor=ExtractorParams(max_features=256, n_levels=4, n_features=256),
    capacity=CapacityParams(client_max_kfs=48, client_max_mps=6144),
    camera=CameraParams(k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0),
    placerec=PlaceRecParams(new_loop_thres=10, covisibility_consistency_th=2),
    opt=OptParams(gba_iterations=4, solver_iterations=5),
)


@pytest.fixture(scope="module")
def drifted_revisit():
    """Pass 1 along a path; pass 2 revisits the SAME viewpoints but its
    poses/landmarks carry a rigid drift D (the accumulated error loop
    closing must undo)."""
    world = SynthWorld(CONFIG, n_points=400, seed=0)
    m = ms.MapState.create(CONFIG, server=False)
    poses, ts = arc_poses(6, step=0.25)
    slots1 = add_pass(m, world, poses, ts, kf_id_start=0, seed=1)
    # drift: 0.15 m translation + 1.5 deg yaw
    D = np.asarray(lie.se3_exp(jnp.asarray(
        np.array([0.0, 0.026, 0.0, 0.15, 0.05, 0.0], np.float32))))
    ts2 = [t + 10.0 for t in ts]
    slots2 = add_pass(m, world, poses, ts2, kf_id_start=50,
                      lm_pose_error=D, seed=2)
    return world, m, slots1, slots2, D


def make_closer(m):
    vocab = vocab_mod.default_vocabulary()
    return loop_closing.LoopCloser(
        config=CONFIG, map=m,
        database=db_mod.KeyFrameDatabase(vocab=vocab, capacity=m.nk),
        run_gba_after_loop=False,   # keep CPU time bounded; GBA tested via gba tests
    )


def test_loop_detected_and_closed(drifted_revisit):
    world, m, slots1, slots2, D = drifted_revisit
    closer = make_closer(m)
    closed = False
    for slot in slots1 + slots2:
        closed = closer.process_keyframe(slot) or closed
    assert closed, "revisit with drift must close a loop"
    assert closer.n_loops_closed >= 1


def test_drift_removed(drifted_revisit):
    world, m, slots1, slots2, D = drifted_revisit
    # after the loop closure in the fixture-shared map, the revisit pass's
    # poses should align with the first pass's (drift undone)
    poses, ts = arc_poses(6, step=0.25)
    errs = []
    for k, slot in enumerate(slots2):
        T_est = np.asarray(m.kf.Tcw[slot])
        C_est = np.linalg.inv(T_est)[:3, 3]
        C_true = np.linalg.inv(poses[k])[:3, 3]
        errs.append(np.linalg.norm(C_est - C_true))
    # drift was |t|~0.16; after closure the tail KFs should be much closer
    assert min(errs) < 0.08, errs
    assert np.mean(errs) < 0.16, errs


def test_loop_edges_recorded(drifted_revisit):
    world, m, slots1, slots2, D = drifted_revisit
    loop_edges = np.asarray(m.kf.loop_edge)
    assert (loop_edges >= 0).sum() >= 2  # both endpoints recorded


def test_organic_chain_with_gba():
    """The FULL organic chain in one run — BoW detect -> Sim3 RANSAC ->
    correction -> essential graph -> Motion-Check-gated GBA — with
    run_gba_after_loop ON (the other tests disable it for CPU budget; this
    one mirrors the reference's actual loop path LoopFinder::CorrectLoop ->
    RunGBA, src/LoopFinder.cpp:746)."""
    world = SynthWorld(CONFIG, n_points=400, seed=0)
    m = ms.MapState.create(CONFIG, server=False)
    poses, ts = arc_poses(6, step=0.25)
    slots1 = add_pass(m, world, poses, ts, kf_id_start=0, seed=1)
    D = np.asarray(lie.se3_exp(jnp.asarray(
        np.array([0.0, 0.026, 0.0, 0.15, 0.05, 0.0], np.float32))))
    slots2 = add_pass(m, world, poses, [t + 10.0 for t in ts],
                      kf_id_start=50, lm_pose_error=D, seed=2)
    vocab = vocab_mod.default_vocabulary()
    closer = loop_closing.LoopCloser(
        config=CONFIG, map=m,
        database=db_mod.KeyFrameDatabase(vocab=vocab, capacity=m.nk),
        run_gba_after_loop=True,
    )
    closed = False
    for slot in slots1 + slots2:
        closed = closer.process_keyframe(slot) or closed
    assert closed and closer.n_loops_closed >= 1
    # GBA polished the closed map: revisit poses match pass 1's within
    # tight tolerance (loop-only correction leaves more residual)
    errs = []
    for k, slot in enumerate(slots2):
        C_est = np.linalg.inv(np.asarray(m.kf.Tcw[slot]))[:3, 3]
        C_true = np.linalg.inv(poses[k])[:3, 3]
        errs.append(np.linalg.norm(C_est - C_true))
    assert np.mean(errs) < 0.08, errs
