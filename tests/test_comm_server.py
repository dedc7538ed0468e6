"""Client<->server communication + server-side map mirroring tests."""
import numpy as np
import jax.numpy as jnp
import pytest

from motioncheck_ccm_slam.config import (
    CameraParams, CapacityParams, Config, ExtractorParams,
)
from motioncheck_ccm_slam.parallel import comm as comm_mod
from motioncheck_ccm_slam.system.client import ClientSystem
from motioncheck_ccm_slam.system.server import ServerSystem

from synth_scene import SynthScene

TEST_CONFIG = Config().replace(
    extractor=ExtractorParams(max_features=512, n_levels=4, n_features=512),
    capacity=CapacityParams(
        client_max_kfs=24, client_max_mps=2048,
        server_max_kfs=64, server_max_mps=8192,
    ),
    camera=CameraParams(k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0),
)


@pytest.fixture(scope="module")
def client_server_run():
    server = ServerSystem(config=TEST_CONFIG, n_agents=1)
    client = ClientSystem(config=TEST_CONFIG)
    client.comm = comm_mod.ClientComm(
        config=TEST_CONFIG, channel=server.channel_for(0), client_id=0
    )
    # loop closing needs long loops; keep it off for the mirror test
    server.handlers[0].loop_closer.run_gba_after_loop = False
    scene = SynthScene(TEST_CONFIG, n_points=500, seed=3, speed=0.9)
    for t, Tcw_gt, img in scene.sequence(14):
        client.process_image(img, t)
        server.spin_once()
    # drain any retransmits
    for _ in range(4):
        client.comm.tick(client.map)
        server.spin_once()
    return client, server


def test_server_mirrors_keyframes(client_server_run):
    client, server = client_server_run
    smap = server.handlers[0].map
    # every client KF (alive or trimmed later) that was shipped is on server
    assert smap.n_kfs >= client.map.n_kfs
    assert smap.n_kfs >= 3


def test_server_mirrors_landmarks(client_server_run):
    client, server = client_server_run
    smap = server.handlers[0].map
    assert smap.n_mps > 100


def test_relative_pose_reconstruction(client_server_run):
    """Server-side world poses must agree with the client's (they were
    shipped relative to predecessors)."""
    client, server = client_server_run
    smap = server.handlers[0].map
    cmap = client.map
    matched = 0
    for (kf_id, cid), cslot in cmap.kf_slot_by_id.items():
        sslot = smap.kf_slot_by_id.get((kf_id, cid))
        if sslot is None:
            continue
        Tc = np.asarray(cmap.kf.Tcw[cslot])
        Ts = np.asarray(smap.kf.Tcw[sslot])
        # poses agree up to the client's own post-send refinements; the
        # reduced-update stream keeps them close
        assert np.abs(Tc - Ts).max() < 0.05
        matched += 1
    assert matched >= 3


def test_acks_clear_retransmit_queue(client_server_run):
    client, server = client_server_run
    assert len(client.comm.sent_unacked_kf) == 0
    assert len(client.comm.sent_unacked_mp) == 0
    assert len(client.comm.acked_kf) >= 3


def test_message_loss_tolerance():
    """Dropping a message must not lose keyframes: unacked entities are
    retransmitted (the Disturber-style robustness of the reference)."""
    server = ServerSystem(config=TEST_CONFIG, n_agents=1)
    client = ClientSystem(config=TEST_CONFIG)
    ch = server.channel_for(0)
    client.comm = comm_mod.ClientComm(config=TEST_CONFIG, channel=ch, client_id=0)
    server.handlers[0].loop_closer.run_gba_after_loop = False
    scene = SynthScene(TEST_CONFIG, n_points=500, seed=3, speed=0.9)
    drop_next = [True]
    for i, (t, Tcw_gt, img) in enumerate(scene.sequence(12)):
        client.process_image(img, t)
        # adversarially drop every other client->server message
        if drop_next[0]:
            try:
                ch.to_server.get_nowait()
            except Exception:
                pass
        drop_next[0] = not drop_next[0]
        server.spin_once()
    for _ in range(6):
        client.comm.tick(client.map)
        server.spin_once()
    smap = server.handlers[0].map
    assert smap.n_kfs >= client.map.n_kfs  # everything arrived eventually


def test_reduced_stream_is_budgeted_and_changed_only(client_server_run):
    """KfRedMsg/MpRedMsg are emitted only for entities whose pose/position
    changed since the last publish, within the configured budgets (the
    reference budgets all traffic, conf/config.yaml:88-100)."""
    client, server = client_server_run
    cfg = TEST_CONFIG.comm
    # steady state: nothing changed since the last tick -> empty reds
    client.comm.tick(client.map)
    msg = server.channel_for(0).server_recv()
    assert msg is not None
    assert len(msg.keyframes_red) == 0
    assert len(msg.map_points_red) == 0
    assert msg.closest_kf_id >= 0
    # perturb one acked KF pose and one acked landmark -> exactly those flow
    m = client.map
    kf_id = max(client.comm.acked_kf)
    slot = m.kf_slot_by_id[(kf_id, 0)]
    m.kf = m.kf._replace(Tcw=m.kf.Tcw.at[slot, 0, 3].add(0.05))
    mp_id = max(client.comm.acked_mp)
    mslot = m.mp_slot_by_id[(mp_id, 0)]
    m.mp = m.mp._replace(Xw=m.mp.Xw.at[mslot, 1].add(0.05))
    client.comm.tick(m)
    msg = server.channel_for(0).server_recv()
    red_ids = [r.kf_id for r in msg.keyframes_red]
    assert red_ids == [kf_id]
    assert [r.mp_id for r in msg.map_points_red] == [mp_id]
    assert len(msg.keyframes_red) <= cfg.client_kf_it_bound
    assert len(msg.map_points_red) <= cfg.client_mp_it_bound
    # server applies both updates
    server.channel_for(0).client_send(msg)
    smap = server.handlers[0].map
    server.handlers[0].comm.tick()
    sslot = smap.kf_slot_by_id[(kf_id, 0)]
    smslot = smap.mp_slot_by_id[(mp_id, 0)]
    assert np.allclose(np.asarray(smap.kf.Tcw[sslot]),
                       np.asarray(m.kf.Tcw[slot]), atol=1e-4)
    assert np.allclose(np.asarray(smap.mp.Xw[smslot]),
                       np.asarray(m.mp.Xw[mslot]), atol=1e-4)


def test_server_assigns_unique_ids(client_server_run):
    """Every mirrored KF gets a server-global uid (reference
    UniqueIdDispenser estd.h:83-108; 0 = unset)."""
    client, server = client_server_run
    smap = server.handlers[0].map
    valid = np.asarray(smap.kf.valid)
    uids = np.asarray(smap.kf.unique_id)[valid]
    assert (uids > 0).all()
    assert len(set(uids.tolist())) == len(uids)


def test_watchdog_beats(client_server_run):
    client, server = client_server_run
    assert not server.watchdog.silent_modules()
    assert "comm0" in server.watchdog.report()
    assert not client.watchdog.silent_modules()


def _mk_kf_msg(kf_id, pred_id, parent_id, Tcp, Tcpar=None, F=512):
    return comm_mod.KfMsg(
        kf_id=kf_id, client_id=0, timestamp=float(kf_id),
        Tcp=np.asarray(Tcp, np.float32), pred_id=pred_id,
        parent_id=parent_id,
        xy=np.zeros((F, 2), np.float32), angle=np.zeros(F, np.float32),
        octave=np.zeros(F, np.int32), desc=np.zeros((F, 8), np.uint32),
        feat_valid=np.zeros(F, bool), mp_ids=np.full(F, -1, np.int64),
        Tcpar=(None if Tcpar is None else np.asarray(Tcpar, np.float32)),
    )


def test_lost_predecessor_parent_fallback():
    """A KF whose predecessor was trimmed client-side before ever shipping
    must still integrate through the mTcpar parent-relative fallback
    (reference cslam_msgs/msg/KF.msg:31-32, src/KeyFrame.cpp:1420-1458);
    without any resolvable reference it stays deferred, not lost."""
    server = ServerSystem(config=TEST_CONFIG, n_agents=1)
    ch = server.channel_for(0)
    h = server.handlers[0]

    T0 = np.eye(4, dtype=np.float32)
    msg = comm_mod.MapMsg(sender_client_id=0)
    msg.keyframes.append(_mk_kf_msg(0, -1, -1, T0))
    ch.client_send(msg)
    server.spin_once()
    assert (0, 0) in h.map.kf_slot_by_id

    # kf 5: predecessor 3 NEVER shipped (client-trimmed); parent 0 known.
    # Tcpar moves 0.3 along x relative to kf 0.
    Tcpar = np.eye(4, dtype=np.float32)
    Tcpar[0, 3] = 0.3
    bogus_Tcp = np.eye(4, dtype=np.float32)
    bogus_Tcp[0, 3] = 99.0   # must NOT be used
    msg = comm_mod.MapMsg(sender_client_id=0)
    msg.keyframes.append(_mk_kf_msg(5, 3, 0, bogus_Tcp, Tcpar=Tcpar))
    # kf 9: neither predecessor 7 nor parent 8 exists -> defer, don't drop
    msg.keyframes.append(_mk_kf_msg(9, 7, 8, bogus_Tcp, Tcpar=Tcpar))
    ch.client_send(msg)
    server.spin_once()

    slot5 = h.map.kf_slot_by_id.get((5, 0))
    assert slot5 is not None, "parent fallback did not integrate the KF"
    Tcw5 = np.asarray(h.map.kf.Tcw[slot5])
    slot0 = h.map.kf_slot_by_id[(0, 0)]
    expect = Tcpar @ np.asarray(h.map.kf.Tcw[slot0])
    assert np.abs(Tcw5 - expect).max() < 1e-4
    assert (9, 0) not in h.map.kf_slot_by_id
    assert any(k.kf_id == 9 for k in h.comm.deferred_kfs)
    # when parent 8 finally arrives, kf 9 integrates on the next cycle
    msg = comm_mod.MapMsg(sender_client_id=0)
    msg.keyframes.append(_mk_kf_msg(8, -1, -1, T0))
    ch.client_send(msg)
    server.spin_once()
    server.spin_once()
    assert (9, 0) in h.map.kf_slot_by_id
