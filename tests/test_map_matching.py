"""MapMatcher covisibility-consistency gate: a single aliased BoW hit must
NOT fuse two maps; a genuine sustained overlap must (reference
MapMatcher::DetectLoop src/MapMatcher.cpp:104 reuses the consecutive-
consistent-group machinery of LoopFinder::DetectLoop)."""
import numpy as np
import jax.numpy as jnp

from motioncheck_ccm_slam.config import (
    CameraParams, CapacityParams, Config, ExtractorParams, OptParams,
    PlaceRecParams,
)
from motioncheck_ccm_slam.models import map_matching
from motioncheck_ccm_slam.models import map_state as ms

from synth_map import SynthWorld, add_pass, arc_poses

CONFIG = Config().replace(
    extractor=ExtractorParams(max_features=256, n_levels=4, n_features=256),
    capacity=CapacityParams(client_max_kfs=48, client_max_mps=6144),
    camera=CameraParams(k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0),
    placerec=PlaceRecParams(start_map_matching_after_kf=0,
                            covisibility_consistency_th=3),
    opt=OptParams(gba_iterations=4),
)


def _build_map(world, poses, ts, client_id, kf_id_start=0, seed=1):
    m = ms.MapState.create(CONFIG, server=False)
    slots = add_pass(m, world, poses, ts, client_id=client_id,
                     kf_id_start=kf_id_start, seed=seed)
    return m, slots


def test_single_aliased_hit_does_not_merge():
    """Map B traverses world W2 but ONE of its keyframes observes W1 (a
    perceptually aliased place). The matcher must never emit a hit: one
    detection cannot build the required 3-long consistency chain."""
    w1 = SynthWorld(CONFIG, n_points=400, seed=0)
    w2 = SynthWorld(CONFIG, n_points=400, seed=99)   # distinct descriptors
    poses, ts = arc_poses(6, step=0.25)
    mA, slotsA = _build_map(w1, poses, ts, client_id=0, seed=1)

    mB = ms.MapState.create(CONFIG, server=False)
    slotsB = add_pass(mB, w2, poses[:3], ts[:3], client_id=1,
                      kf_id_start=0, seed=2)
    # the aliased keyframe: same viewpoint as A's pass, observing W1
    alias = add_pass(mB, w1, poses[3:4], [ts[3] + 5.0], client_id=1,
                     kf_id_start=10, seed=3, chain_from=slotsB[-1])
    tail = add_pass(mB, w2, poses[4:], [t + 6.0 for t in ts[4:]],
                    client_id=1, kf_id_start=20, seed=4,
                    chain_from=alias[-1])
    matcher = map_matching.MapMatcher(config=CONFIG, maps={0: mA, 1: mB})
    for s in slotsA:
        matcher.add_keyframe(0, s)
    hits = [matcher.check(1, s) for s in slotsB + alias + tail]
    assert all(h is None for h in hits), \
        "a single aliased detection must not trigger a merge"


def test_sustained_overlap_merges():
    """Positive control: when map B genuinely re-observes W1 for several
    consecutive keyframes, the consistency chain completes and a Sim3-
    verified hit is produced."""
    w1 = SynthWorld(CONFIG, n_points=400, seed=0)
    poses, ts = arc_poses(6, step=0.25)
    mA, slotsA = _build_map(w1, poses, ts, client_id=0, seed=1)
    mB, slotsB = _build_map(w1, poses, [t + 30.0 for t in ts], client_id=1,
                            kf_id_start=0, seed=5)
    matcher = map_matching.MapMatcher(config=CONFIG, maps={0: mA, 1: mB})
    for s in slotsA:
        matcher.add_keyframe(0, s)
    hits = [matcher.check(1, s) for s in slotsB]
    got = [h for h in hits if h is not None]
    assert got, "sustained genuine overlap must produce a confirmed hit"
    hit = got[0]
    assert hit.map_id_match == 0 and hit.map_id_cur == 1
    # both maps live in the same (undrifted) frame: the Sim3 is ~identity
    S = np.asarray(hit.S_match_from_cur)
    assert np.allclose(S[:3, :3], np.eye(3), atol=0.05)
    assert np.linalg.norm(S[:3, 3]) < 0.1
    assert hit.mp_pairs is not None and len(hit.mp_pairs) >= 15
