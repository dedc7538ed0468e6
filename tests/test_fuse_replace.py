"""Fuse-with-Replace and the server mapping pipeline: duplicate landmarks
collapse onto the survivor (reference ORBmatcher::Fuse :977 +
MapPoint::Replace), landmark probation culls weak server landmarks
(MapPointCullingServer src/Mapping.cpp:756), and redundancy culling applies
the same-or-finer-scale condition (KeyFrameCullingV3 :816)."""
import numpy as np
import jax.numpy as jnp

from motioncheck_ccm_slam.config import (
    CameraParams, CapacityParams, Config, ExtractorParams,
)
from motioncheck_ccm_slam.models import map_state as ms
from motioncheck_ccm_slam.models import mapping

from synth_map import SynthWorld, add_pass, arc_poses

CONFIG = Config().replace(
    extractor=ExtractorParams(max_features=256, n_levels=4, n_features=256),
    capacity=CapacityParams(client_max_kfs=24, client_max_mps=4096),
    camera=CameraParams(k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0),
)


def test_replace_map_points_rewires_and_dedupes():
    m = ms.MapState.create(CONFIG, server=False)
    world = SynthWorld(CONFIG, n_points=60, seed=1)
    poses, ts = arc_poses(3, step=0.2)
    slots = add_pass(m, world, poses, ts, kf_id_start=0, seed=2)
    mp_idx = np.asarray(m.kf.mp_idx)
    # pick two distinct landmarks observed by the same KF
    row = mp_idx[slots[0]]
    obs = row[row >= 0]
    a, b = int(obs[0]), int(obs[1])
    n_valid_before = int(np.asarray(m.mp.valid).sum())
    n = mapping.replace_map_points(m, [(a, b)])
    assert n == 1
    # exactly one of the two died
    valid = np.asarray(m.mp.valid)
    assert valid[a] != valid[b]
    assert int(valid.sum()) == n_valid_before - 1
    winner, loser = (a, b) if valid[a] else (b, a)
    new_idx = np.asarray(m.kf.mp_idx)
    # no association points at the loser anywhere
    assert not (new_idx == loser).any()
    # each row holds the winner at most once
    for r in range(new_idx.shape[0]):
        assert int((new_idx[r] == winner).sum()) <= 1


def test_fuse_collapses_loop_duplicates():
    """Two passes over the same world create duplicate landmark copies (as a
    closed loop does). Fuse over the revisit KFs must collapse them."""
    world = SynthWorld(CONFIG, n_points=300, seed=0)
    m = ms.MapState.create(CONFIG, server=False)
    poses, ts = arc_poses(4, step=0.2)
    s1 = add_pass(m, world, poses, ts, kf_id_start=0, seed=1)
    s2 = add_pass(m, world, poses, [t + 10 for t in ts], kf_id_start=50,
                  seed=2, chain_from=s1[-1])
    n_before = int(np.asarray(m.mp.valid).sum())
    n_claim, n_repl = mapping.fuse_neighbors(m, s2, CONFIG)
    n_after = int(np.asarray(m.mp.valid).sum())
    assert n_repl >= 50, (n_claim, n_repl)
    assert n_after <= n_before - n_repl + 5
    # surviving associations are consistent: every mp_idx points at a valid MP
    idx = np.asarray(m.kf.mp_idx)
    valid = np.asarray(m.mp.valid)
    held = idx[idx >= 0]
    assert valid[held].all()


def test_server_probation_culls_weak_landmarks():
    world = SynthWorld(CONFIG, n_points=200, seed=3)
    m = ms.MapState.create(CONFIG, server=False)
    poses, ts = arc_poses(5, step=0.2)
    slots = add_pass(m, world, poses, ts, kf_id_start=0, seed=4)
    nm = m.nm
    n_obs = np.asarray(ms.mp_observation_counts(m.kf, nm))
    valid = np.asarray(m.mp.valid)
    weak = valid & (n_obs <= 3)
    strong = valid & (n_obs > 3)
    assert weak.any() and strong.any()
    # all landmarks entered at tick 1; probation ends at tick 4
    mp_tick = np.where(valid, 1, -1).astype(np.int32)
    n = mapping.cull_recent_mps_server(m, mp_tick, tick=4, client_id=0)
    assert n == int(weak.sum())
    valid_after = np.asarray(m.mp.valid)
    assert not valid_after[weak].any()
    assert valid_after[strong].all()
    # exempt landmarks (tick=-2) survive regardless
    m2 = ms.MapState.create(CONFIG, server=False)
    add_pass(m2, world, poses, ts, kf_id_start=0, seed=4)
    mp_tick2 = np.where(np.asarray(m2.mp.valid), -2, -1).astype(np.int32)
    assert mapping.cull_recent_mps_server(m2, mp_tick2, 4, 0) == 0


def test_redundancy_scale_condition():
    """A KF observing at a COARSER octave than all other observers counts as
    redundant; one observing at the FINEST octave does not (reference
    KeyFrameCullingV3: redundancy requires >=3 others at octave <= o+1)."""
    world = SynthWorld(CONFIG, n_points=150, seed=5)
    m = ms.MapState.create(CONFIG, server=False)
    poses, ts = arc_poses(5, step=0.05)   # near-identical views: all co-observe
    slots = add_pass(m, world, poses, ts, kf_id_start=0, seed=6)
    octv = np.asarray(m.kf.octave).copy()
    # KF 0 sees everything at octave 3 (coarse), others at octave 0
    octv[slots[0]] = 3
    for s in slots[1:]:
        octv[s] = 0
    m.kf = m.kf._replace(octave=jnp.asarray(octv))
    frac = np.asarray(mapping._redundancy_kernel(
        m.kf, nm=m.nm, n_levels=CONFIG.extractor.n_levels))
    # KF0's observations: >=3 others at octave 0 <= 3+1 -> redundant
    assert frac[slots[0]] > 0.9
    # KF1 at octave 0: others at octave 0 (<= 1) count. Flip the others to
    # octave 3 (coarser than 0+1): KF1 must stop being redundant
    octv2 = octv.copy()
    for s in slots[2:]:
        octv2[s] = 3
    octv2[slots[0]] = 3
    m.kf = m.kf._replace(octave=jnp.asarray(octv2))
    frac2 = np.asarray(mapping._redundancy_kernel(
        m.kf, nm=m.nm, n_levels=CONFIG.extractor.n_levels))
    assert frac2[slots[1]] < 0.1
