"""INTERRUPTBA / FINALBA semantics: a running GBA aborts on fresh agent
data leaving the map untouched, keyframes inserted mid-GBA receive the
correction through the spanning tree, and the server re-arms the final GBA
after an interruption (reference Communicator.cpp:453-496,
Map::isGBAinterrupted, Map.cpp:1536-1584)."""
import numpy as np
import jax.numpy as jnp
import pytest

from motioncheck_ccm_slam.config import (
    CameraParams, CapacityParams, CommParams, Config, ExtractorParams,
    MotionCheckParams,
)
from motioncheck_ccm_slam.models import gba as gba_mod
from motioncheck_ccm_slam.models import map_state as ms
from motioncheck_ccm_slam.parallel import comm as comm_mod
from motioncheck_ccm_slam.system.server import ServerSystem

from synth_map import SynthWorld, add_pass, arc_poses

CONFIG = Config().replace(
    extractor=ExtractorParams(max_features=256, n_levels=4, n_features=256),
    capacity=CapacityParams(client_max_kfs=24, client_max_mps=4096,
                            server_max_kfs=24, server_max_mps=4096),
    camera=CameraParams(k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0),
    motion_check=MotionCheckParams(enabled=False),
)


def _make_map(n_kfs=6, noise=0.02, seed=0):
    world = SynthWorld(CONFIG, n_points=500, seed=seed)
    m = ms.MapState.create(CONFIG, server=False)
    poses, ts = arc_poses(n_kfs, step=0.25)
    slots = add_pass(m, world, poses, ts, kf_id_start=0, seed=seed + 1)
    if noise:
        rng = np.random.default_rng(seed + 2)
        T = np.array(m.kf.Tcw)
        T[np.asarray(slots), :3, 3] += rng.normal(
            0, noise, (len(slots), 3)
        ).astype(np.float32)
        m.kf = m.kf._replace(Tcw=jnp.asarray(T))
    return world, m, slots


def test_interrupted_gba_leaves_map_untouched():
    world, m, slots = _make_map()
    Tcw_before = np.asarray(m.kf.Tcw).copy()
    Xw_before = np.asarray(m.mp.Xw).copy()
    res = gba_mod.run_gba(m, CONFIG, interrupt_check=lambda: True,
                          iterations=12, chunk=4)
    assert res.interrupted
    # the job works on copies: an abort costs nothing
    assert np.array_equal(np.asarray(m.kf.Tcw), Tcw_before)
    assert np.array_equal(np.asarray(m.mp.Xw), Xw_before)


def test_gba_converges_when_not_interrupted():
    world, m, slots = _make_map()
    res = gba_mod.run_gba(m, CONFIG, iterations=12, chunk=4)
    assert not res.interrupted
    # the injected pose noise must shrink
    poses, _ = arc_poses(len(slots), step=0.25)
    errs = [
        np.linalg.norm(
            np.linalg.inv(np.asarray(m.kf.Tcw[s]))[:3, 3]
            - np.linalg.inv(poses[k])[:3, 3]
        )
        for k, s in enumerate(slots)
    ]
    assert np.mean(errs) < 0.02, errs


def test_mid_gba_keyframe_gets_spanning_tree_propagation():
    """A KF inserted while the job runs is not part of the problem; on
    finalize its pose must move WITH its spanning-tree ancestor (reference
    src/Map.cpp:1536-1584)."""
    world, m, slots = _make_map(noise=0.04)
    job = gba_mod.GBAJob(m=m, config=CONFIG, iterations=12,
                         enable_motion_check=False, chunk=4)
    job.step()
    # mid-job: a new KF chained to the last one arrives (simulating comm)
    anchor = slots[-1]
    T_anchor_live = np.asarray(m.kf.Tcw[anchor])
    T_rel = np.eye(4, dtype=np.float32)
    T_rel[0, 3] = 0.25
    T_new = T_rel @ T_anchor_live
    new_slot = m.alloc_kf_slot(99, 0)
    m.kf = m.kf._replace(
        kf_id=m.kf.kf_id.at[new_slot].set(99),
        client_id=m.kf.client_id.at[new_slot].set(0),
        timestamp=m.kf.timestamp.at[new_slot].set(99.0),
        Tcw=m.kf.Tcw.at[new_slot].set(jnp.asarray(T_new)),
        valid=m.kf.valid.at[new_slot].set(True),
        parent=m.kf.parent.at[new_slot].set(anchor),
        pred=m.kf.pred.at[new_slot].set(anchor),
    )
    while not job.step():
        pass
    job.finalize()
    # relative transform to the ancestor must be preserved exactly
    T_anchor_opt = np.asarray(m.kf.Tcw[anchor])
    T_new_opt = np.asarray(m.kf.Tcw[new_slot])
    T_rel_after = T_new_opt @ np.linalg.inv(T_anchor_opt)
    assert np.abs(T_rel_after - T_rel).max() < 1e-4
    # and the ancestor itself moved (the GBA did something)
    assert np.abs(T_anchor_opt - T_anchor_live).max() > 1e-5


def test_mid_gba_keyframe_chain_propagates_through_midjob_ancestor():
    """Two KFs inserted mid-job where the second one's only ancestor is the
    FIRST mid-job KF: its correction must chain off the first one's
    propagated pose, not a stale pre-propagation copy (the first KF's slot
    held no meaningful pose when the job snapshotted)."""
    world, m, slots = _make_map(noise=0.04)
    job = gba_mod.GBAJob(m=m, config=CONFIG, iterations=12,
                         enable_motion_check=False, chunk=4)
    job.step()
    anchor = slots[-1]
    T_anchor_live = np.asarray(m.kf.Tcw[anchor])
    rels, new_slots = [], []
    prev, T_prev = anchor, T_anchor_live
    for k in range(2):
        T_rel = np.eye(4, dtype=np.float32)
        T_rel[0, 3] = 0.2 + 0.1 * k
        T_new = T_rel @ T_prev
        s = m.alloc_kf_slot(90 + k, 0)
        m.kf = m.kf._replace(
            kf_id=m.kf.kf_id.at[s].set(90 + k),
            client_id=m.kf.client_id.at[s].set(0),
            timestamp=m.kf.timestamp.at[s].set(90.0 + k),
            Tcw=m.kf.Tcw.at[s].set(jnp.asarray(T_new)),
            valid=m.kf.valid.at[s].set(True),
            parent=m.kf.parent.at[s].set(prev),
            pred=m.kf.pred.at[s].set(prev),
        )
        rels.append(T_rel)
        new_slots.append(s)
        prev, T_prev = s, T_new
    while not job.step():
        pass
    job.finalize()
    # every link of the chain preserves its relative transform exactly
    T_anchor_opt = np.asarray(m.kf.Tcw[anchor])
    prev_T = T_anchor_opt
    for T_rel, s in zip(rels, new_slots):
        T_opt = np.asarray(m.kf.Tcw[s])
        assert np.abs(T_opt @ np.linalg.inv(prev_T) - T_rel).max() < 1e-4
        prev_T = T_opt
    assert np.abs(T_anchor_opt - T_anchor_live).max() > 1e-5


def _kf_msg_for(m, slot, kf_id, client_id=0):
    """Minimal full-KF message chained to an existing server KF."""
    F = m.kf.xy.shape[1]
    pred_id = int(np.asarray(m.kf.kf_id[slot]))
    Tcp = np.eye(4, dtype=np.float32)
    Tcp[0, 3] = 0.1
    rng = np.random.default_rng(kf_id)
    return comm_mod.KfMsg(
        kf_id=kf_id, client_id=client_id, timestamp=float(kf_id),
        Tcp=Tcp, pred_id=pred_id, parent_id=pred_id,
        xy=np.zeros((F, 2), np.float32),
        angle=np.zeros(F, np.float32),
        octave=np.zeros(F, np.int32),
        desc=rng.integers(0, 2 ** 32, (F, 8), dtype=np.uint32),
        feat_valid=np.zeros(F, bool),
        mp_ids=np.full(F, -1, np.int64),
    )


def test_final_gba_interrupts_and_rearms():
    """FINALBA: fresh agent data queued during the final GBA aborts it and
    re-arms; after the data is ingested and the agent goes quiet again the
    GBA completes."""
    cfg = CONFIG.replace(comm=CommParams(final_ba_idle_s=0.2))
    server = ServerSystem(config=cfg, n_agents=1)
    h = server.handlers[0]
    # seed the server map directly (comm-path tested elsewhere)
    world = SynthWorld(cfg, n_points=500, seed=5)
    poses, ts = arc_poses(6, step=0.25)
    slots = add_pass(h.map, world, poses, ts, kf_id_start=0, seed=6)
    # agent goes quiet
    h.comm.got_data = False
    h.comm.idle_cycles = 10 ** 6
    Tcw_before = np.asarray(h.map.kf.Tcw).copy()
    # fresh data arrives just as the final GBA would run
    h.channel.client_send(comm_mod.MapMsg(
        sender_client_id=0, keyframes=[_kf_msg_for(h.map, slots[-1], 50)],
    ))
    assert not server.maybe_final_gba()
    assert server.n_gba_interrupts == 1
    assert not server.final_gba_done
    # abort left the map untouched
    assert np.array_equal(np.asarray(h.map.kf.Tcw), Tcw_before)
    # ingest the message, go quiet again, retry
    server.spin_once()
    assert (50, 0) in h.map.kf_slot_by_id
    h.comm.got_data = False
    h.comm.idle_cycles = 10 ** 6
    assert server.maybe_final_gba()
    assert server.final_gba_done
