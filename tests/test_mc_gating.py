"""Motion Check as a system-level GBA safeguard: a deliberately corrupted
GBA is caught and rolled back (the fork's headline claim, readme.md:12),
and after a loop-closure GBA the gating mode (isGBA=false) latches
CorrectKF_switch off and triggers the follow-up re-GBA
(reference src/Map.cpp:3784-3799, src/LoopFinder.cpp:754-762)."""
import numpy as np
import jax.numpy as jnp
import pytest

from motioncheck_ccm_slam.config import (
    CameraParams, CapacityParams, Config, ExtractorParams, MotionCheckParams,
    OptParams, PlaceRecParams,
)
from motioncheck_ccm_slam.models import database as db_mod
from motioncheck_ccm_slam.models import gba as gba_mod
from motioncheck_ccm_slam.models import loop_closing
from motioncheck_ccm_slam.models import map_state as ms
from motioncheck_ccm_slam.models import vocabulary as vocab_mod
from motioncheck_ccm_slam.solvers import local_ba

from synth_map import add_pass, ring_poses, ring_world

N_KFS = 18
CORRUPT_SLOTS = [6, 7, 8, 9, 10]

CONFIG = Config().replace(
    extractor=ExtractorParams(max_features=256, n_levels=4, n_features=256),
    capacity=CapacityParams(client_max_kfs=24, client_max_mps=8192),
    camera=CameraParams(k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0),
    motion_check=MotionCheckParams(skip_edge_kfs=2),
    opt=OptParams(gba_iterations=8, solver_iterations=5),
)


def corrupting_solver(Tcw, Xw, obs, K, fixed_cam, fixed_lm, n_it=None):
    """An 'optimizer' that diverges: honest BA, then a violent alternating
    sideways kick on a band of keyframes — the failure mode Motion Check
    exists to catch."""
    res = local_ba.bundle_adjust(
        Tcw, Xw, obs, K, fixed_cam, fixed_lm=fixed_lm,
        iterations=int(n_it or 5),
    )
    T = np.array(res.Tcw)
    for i, s in enumerate(CORRUPT_SLOTS):
        T[s, 1, 3] += 1.0 if i % 2 == 0 else -1.0
    return res._replace(Tcw=jnp.asarray(T))


def _make_map(seed=0):
    # a CURVED trajectory: Motion Check's direction limits scale with the
    # tracking curvature (min(2*tdeg, 30deg)) — a straight line has tdeg~0
    # and would flag mm-level honest-GBA refinements as violations
    world = ring_world(CONFIG, n_points=1600, seed=seed)
    m = ms.MapState.create(CONFIG, server=False)
    poses, ts = ring_poses([15.0 * k for k in range(N_KFS)], y_amp=0.5)
    slots = add_pass(m, world, poses, ts, kf_id_start=0, seed=seed + 1)
    return world, m, slots, poses


def _ate(m, slots, poses):
    errs = [
        np.linalg.norm(
            np.linalg.inv(np.asarray(m.kf.Tcw[s]))[:3, 3]
            - np.linalg.inv(poses[k])[:3, 3]
        )
        for k, s in enumerate(slots)
        if bool(np.asarray(m.kf.valid[s]))
    ]
    return float(np.sqrt(np.mean(np.square(errs))))


def test_mc_rescues_corrupted_final_gba():
    """The headline behavior: with MC the corrupted GBA is reverted and the
    trajectory survives; without MC it is destroyed. (ATE with/without MC.)"""
    world, m1, slots, poses = _make_map()
    res = gba_mod.run_gba(m1, CONFIG, sharded_solver=corrupting_solver,
                          mc_mode="full")
    ate_with_mc = _ate(m1, slots, poses)

    world, m2, slots2, _ = _make_map()
    gba_mod.run_gba(m2, CONFIG, sharded_solver=corrupting_solver,
                    enable_motion_check=False)
    ate_without_mc = _ate(m2, slots2, poses)

    assert res.reverted or res.n_deleted_kfs >= 3, res
    assert ate_without_mc > 0.3, ate_without_mc   # corruption really bites
    assert ate_with_mc < 0.1 * ate_without_mc, (ate_with_mc, ate_without_mc)


def test_honest_gba_passes_mc():
    world, m, slots, poses = _make_map(seed=3)
    res = gba_mod.run_gba(m, CONFIG, mc_mode="full")
    assert not res.reverted
    assert res.n_deleted_kfs == 0


def test_mc_gating_latches_and_requests_regba():
    """Gating mode (after a loop-closure GBA): flags only — the map keeps
    the optimized poses, but CorrectKF_switch latches off and request_gba
    arms the follow-up GBA."""
    world, m, slots, poses = _make_map(seed=5)
    res = gba_mod.run_gba(m, CONFIG, sharded_solver=corrupting_solver,
                          mc_mode="gating")
    assert res.mc_gated
    assert m.request_gba
    assert not m.correct_kf_switch
    assert not res.reverted and res.n_deleted_kfs == 0
    # gating does NOT undo the damage itself
    assert _ate(m, slots, poses) > 0.3
    # with the latch off, a later full-mode MC run is disabled (reference
    # CorrectKF_V3 :3801 requires CorrectKF_switch)
    res2 = gba_mod.run_gba(m, CONFIG, sharded_solver=corrupting_solver,
                           mc_mode="full")
    assert not res2.reverted and res2.n_deleted_kfs == 0


def test_loop_closure_triggers_regba():
    """End-to-end through the loop closer: a corrupted loop-closure GBA is
    flagged by the gating MC and the follow-up (honest) re-GBA runs."""
    world, m, slots, poses = _make_map(seed=7)
    vocab = vocab_mod.default_vocabulary()
    closer = loop_closing.LoopCloser(
        config=CONFIG, map=m,
        database=db_mod.KeyFrameDatabase(vocab=vocab, capacity=m.nk),
        gba_solver=corrupting_solver,
    )
    cur, cand = slots[-1], slots[0]
    # drift-free loop: S12 (cand-cam -> cur-cam) is the true relative pose,
    # so the Sim3 propagation is a no-op and only the GBA path is exercised
    S12 = jnp.asarray(
        np.asarray(m.kf.Tcw[cur]) @ np.linalg.inv(np.asarray(m.kf.Tcw[cand]))
    )
    assert closer.correct_loop(cur, cand, S12, None)
    assert closer.n_regba == 1
    assert not m.correct_kf_switch
    assert not m.request_gba
    # the re-GBA was honest: trajectory survives end-to-end
    assert _ate(m, slots, poses) < 0.15
