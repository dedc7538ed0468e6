"""Merge-time probation bookkeeping (VERDICT r2 weak #9): a map merge must
not blanket-exempt every landmark from probation culling. The handler whose
map was merged away keeps its own mid-probation entries (remapped through
the landmark slot map), and the match-side handler treats merged-in
landmarks as mature — the reference keeps mlpRecentAddedMapPoints per
server LocalMapping across ClientHandler::ChangeMap
(/root/reference/src/Mapping.cpp:737-775, src/ClientHandler.cpp:221)."""
import numpy as np

from motioncheck_ccm_slam.config import (
    CameraParams, CapacityParams, Config, ExtractorParams, OptParams,
    PlaceRecParams,
)
from motioncheck_ccm_slam.models import map_matching
from motioncheck_ccm_slam.models import map_state as ms
from motioncheck_ccm_slam.system.server import ServerSystem

from synth_map import SynthWorld, add_pass, arc_poses

CONFIG = Config().replace(
    extractor=ExtractorParams(max_features=256, n_levels=4, n_features=256),
    capacity=CapacityParams(
        client_max_kfs=48, client_max_mps=6144,
        server_max_kfs=48, server_max_mps=6144,
    ),
    camera=CameraParams(k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0),
    placerec=PlaceRecParams(start_map_matching_after_kf=0,
                            covisibility_consistency_th=3),
    opt=OptParams(gba_iterations=2),
)


def test_probation_ticks_survive_merge():
    w1 = SynthWorld(CONFIG, n_points=400, seed=0)
    poses, ts = arc_poses(6, step=0.25)

    server = ServerSystem(config=CONFIG, n_agents=2)
    for h in server.handlers.values():
        h.loop_closer.run_gba_after_loop = False
    h0, h1 = server.handlers[0], server.handlers[1]

    mA = h0.map
    slotsA = add_pass(mA, w1, poses, ts, client_id=0, kf_id_start=0, seed=1)
    mB = h1.map
    slotsB = add_pass(mB, w1, poses, [t + 30.0 for t in ts], client_id=1,
                      kf_id_start=0, seed=5)
    h0.mp_tick = np.full(mA.nm, -1, np.int32)
    h1.mp_tick = np.full(mB.nm, -1, np.int32)

    # handler 1 (the "cur" side, merged away) has some landmarks
    # mid-probation; remember their ids so we can find them post-remap
    b_valid = np.flatnonzero(np.asarray(mB.mp.valid))
    prob_slots = b_valid[:60]
    h1.mp_tick[prob_slots] = 7
    h1.n_kfs_processed = 8
    prob_ids = np.asarray(mB.mp.mp_id)[prob_slots].copy()

    # handler 0 (match side) has its own mid-probation entries
    a_valid = np.flatnonzero(np.asarray(mA.mp.valid))
    a_prob = a_valid[:5]
    h0.mp_tick[a_prob] = 3
    a_prob_ids = np.asarray(mA.mp.mp_id)[a_prob].copy()

    matcher = server.matcher
    matcher.maps[0], matcher.maps[1] = mA, mB
    for s in slotsA:
        matcher.add_keyframe(0, s)
    hit = None
    for s in slotsB:
        hit = matcher.check(1, s)
        if hit is not None:
            break
    assert hit is not None, "sustained overlap must produce a hit"

    server._merge(hit)
    fused = h0.map
    assert h1.map is fused

    # cur-side mid-probation ticks carried through the remap by
    # (mp_id, client_id) — both maps reuse the same mp_id numbering
    fused_ids = np.asarray(fused.mp.mp_id)
    fused_cids = np.asarray(fused.mp.client_id)
    fused_valid = np.asarray(fused.mp.valid)
    carried = 0
    for mid in prob_ids:
        slots = np.flatnonzero(fused_valid & (fused_ids == mid)
                               & (fused_cids == 1))
        if len(slots) == 0:
            continue  # fused into an existing match-map landmark
        assert h1.mp_tick[slots[0]] == 7, \
            "mid-probation tick must survive the merge remap"
        carried += 1
    # most duplicates fuse into match-map landmarks; the unfused remainder
    # must keep its mid-probation tick rather than reset to exempt
    assert carried >= 2, "expected surviving probation entries to carry"

    # cur-side sees the match map's landmarks as mature (exempt, -2),
    # never as fresh (-1) arrivals to re-probate
    for mid in a_prob_ids:
        slots = np.flatnonzero(fused_valid & (fused_ids == mid)
                               & (fused_cids == 0))
        assert len(slots) == 1
        assert h1.mp_tick[slots[0]] == -2

    # match-side handler: its own probation entries untouched, merged-in
    # landmarks exempt rather than queued as fresh
    for mid in a_prob_ids:
        slots = np.flatnonzero(fused_valid & (fused_ids == mid)
                               & (fused_cids == 0))
        assert h0.mp_tick[slots[0]] == 3, \
            "match-side handler keeps its own probation books"
    for mid in prob_ids:
        slots = np.flatnonzero(fused_valid & (fused_ids == mid)
                               & (fused_cids == 1))
        if len(slots) == 0:
            continue
        assert h0.mp_tick[slots[0]] == -2, \
            "merged-in landmarks must be exempt on the match side"
