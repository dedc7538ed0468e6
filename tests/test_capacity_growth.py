"""Capacity growth: blocks double when full instead of raising (the
reference server map is unbounded — std::map; our fixed-capacity SoA blocks
grow append-only so slot indices survive)."""
import numpy as np
import jax.numpy as jnp

from motioncheck_ccm_slam.config import (
    CameraParams, CapacityParams, Config, ExtractorParams, MotionCheckParams,
)
from motioncheck_ccm_slam.models import gba as gba_mod
from motioncheck_ccm_slam.models import map_state as ms

from synth_map import SynthWorld, add_pass, arc_poses

CONFIG = Config().replace(
    extractor=ExtractorParams(max_features=128, n_levels=4, n_features=128),
    capacity=CapacityParams(client_max_kfs=4, client_max_mps=128),
    camera=CameraParams(k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0),
    motion_check=MotionCheckParams(enabled=False),
)


def test_blocks_grow_past_initial_capacity():
    world = SynthWorld(CONFIG, n_points=300, seed=0)
    m = ms.MapState.create(CONFIG, server=False)
    assert m.nk == 4 and m.nm == 128
    poses, ts = arc_poses(10, step=0.2)
    slots = add_pass(m, world, poses, ts, kf_id_start=0, seed=1)
    assert len(slots) == 10
    assert m.nk >= 10 and m.n_kf_growths >= 1
    assert m.n_mp_growths >= 1
    # every KF intact and indexable by id
    for k, s in enumerate(slots):
        assert m.kf_slot_by_id[(k, 0)] == s
        assert bool(np.asarray(m.kf.valid[s]))
    # all observations point at valid landmarks
    idx = np.asarray(m.kf.mp_idx)
    valid = np.asarray(m.mp.valid)
    assert valid[idx[idx >= 0]].all()


def test_gba_survives_mid_job_growth():
    """A GBA job started before a growth must finalize correctly after the
    blocks doubled under it (new slots are out-of-problem)."""
    world = SynthWorld(CONFIG, n_points=200, seed=2)
    m = ms.MapState.create(CONFIG, server=False)
    poses, ts = arc_poses(4, step=0.2)
    slots = add_pass(m, world, poses, ts, kf_id_start=0, seed=3)
    nk0 = m.nk
    job = gba_mod.GBAJob(m=m, config=CONFIG, iterations=8,
                         enable_motion_check=False, chunk=4)
    job.step()
    # growth mid-job: a new pass forces both blocks to double
    add_pass(m, world, poses, [t + 10 for t in ts], kf_id_start=50, seed=4,
             chain_from=slots[-1])
    assert m.nk > nk0
    while not job.step():
        pass
    res = job.finalize()
    assert not res.interrupted
    # in-problem poses were optimized; out-of-problem ones propagated or kept
    assert np.isfinite(np.asarray(m.kf.Tcw)).all()
    assert np.isfinite(np.asarray(m.mp.Xw)).all()
