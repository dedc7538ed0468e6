"""Wire codec + native framing + TCP transport tests."""
import numpy as np
import pytest

from motioncheck_ccm_slam.parallel import codec, comm as comm_mod, transport
from motioncheck_ccm_slam.utils import native


def make_msg(seed=0, n_kf=2, n_mp=3):
    rng = np.random.default_rng(seed)
    msg = comm_mod.MapMsg(sender_client_id=1, weak_ack_kf=7, weak_ack_mp=42,
                          acks_kf=[1, 2, 3], acks_mp=[9])
    F = 16
    for i in range(n_kf):
        msg.keyframes.append(comm_mod.KfMsg(
            kf_id=10 + i, client_id=1, timestamp=1.5 + i,
            Tcp=rng.normal(size=(4, 4)).astype(np.float32),
            pred_id=9 + i, parent_id=8,
            xy=rng.uniform(0, 700, (F, 2)).astype(np.float32),
            angle=rng.uniform(-3, 3, F).astype(np.float32),
            octave=rng.integers(0, 8, F).astype(np.int32),
            desc=rng.integers(0, 2**32, (F, 8), dtype=np.uint32),
            feat_valid=rng.random(F) > 0.3,
            mp_ids=rng.integers(-1, 100, F).astype(np.int64),
        ))
        msg.keyframes_red.append(comm_mod.KfRedMsg(
            kf_id=i, client_id=1,
            Tcp=rng.normal(size=(4, 4)).astype(np.float32), pred_id=i - 1,
        ))
    for i in range(n_mp):
        msg.map_points.append(comm_mod.MpMsg(
            mp_id=100 + i, client_id=1,
            pos_ref=rng.normal(size=3).astype(np.float32), ref_kf_id=10,
            desc=rng.integers(0, 2**32, 8, dtype=np.uint32),
            normal=rng.normal(size=3).astype(np.float32),
            min_dist=0.5, max_dist=5.0,
        ))
        msg.map_points_red.append(comm_mod.MpRedMsg(
            mp_id=i, client_id=1,
            pos_ref=rng.normal(size=3).astype(np.float32), ref_kf_id=3,
        ))
    return msg


def assert_msgs_equal(a, b):
    assert a.sender_client_id == b.sender_client_id
    assert a.acks_kf == b.acks_kf and a.acks_mp == b.acks_mp
    assert a.weak_ack_kf == b.weak_ack_kf
    assert len(a.keyframes) == len(b.keyframes)
    for ka, kb in zip(a.keyframes, b.keyframes):
        assert ka.kf_id == kb.kf_id and ka.pred_id == kb.pred_id
        np.testing.assert_array_equal(ka.Tcp, kb.Tcp)
        np.testing.assert_array_equal(ka.desc, kb.desc)
        np.testing.assert_array_equal(ka.mp_ids, kb.mp_ids)
        np.testing.assert_array_equal(ka.feat_valid, kb.feat_valid)
    for pa, pb in zip(a.map_points, b.map_points):
        assert pa.mp_id == pb.mp_id
        np.testing.assert_array_equal(pa.pos_ref, pb.pos_ref)
        np.testing.assert_array_equal(pa.desc, pb.desc)


def test_codec_roundtrip():
    msg = make_msg()
    assert_msgs_equal(codec.decode(codec.encode(msg)), msg)


def test_native_lib_builds():
    """g++ is in the image; the native wire runtime must build and load."""
    lib = native.get_lib()
    assert lib is not None, "native/wire.cpp failed to build"


def test_native_crc_matches_zlib():
    import zlib

    data = b"the quick brown fox" * 100
    assert native.crc32(data) == (zlib.crc32(data) & 0xFFFFFFFF)


def test_framed_roundtrip_and_corruption():
    msg = make_msg(seed=1)
    framed = codec.encode_framed(msg)
    assert_msgs_equal(codec.decode_framed(framed), msg)
    # flip a payload byte -> CRC must catch it
    corrupted = bytearray(framed)
    corrupted[native.HEADER_SIZE + 5] ^= 0xFF
    with pytest.raises(ValueError):
        codec.decode_framed(bytes(corrupted))


def test_tcp_transport_roundtrip():
    server = transport.ServerTransport(host="127.0.0.1")
    client = transport.ClientTransport("127.0.0.1", server.port, client_id=3)
    ep = server.wait_for(3)
    # client -> server
    msg = make_msg(seed=2)
    client.client_send(msg)
    import time

    got = None
    for _ in range(200):
        got = ep.server_recv()
        if got is not None:
            break
        time.sleep(0.01)
    assert got is not None
    assert_msgs_equal(got, msg)
    # server -> client
    reply = comm_mod.MapMsg(sender_client_id=-1, acks_kf=[10, 11],
                            weak_ack_kf=11)
    ep.server_send(reply)
    got2 = None
    for _ in range(200):
        got2 = client.client_recv()
        if got2 is not None:
            break
        time.sleep(0.01)
    assert got2 is not None
    assert got2.acks_kf == [10, 11]
    client.close()
    server.close()


def test_agent_done_roundtrip_and_finalba_arming():
    """The explicit end-of-stream flag survives the wire and arms FINALBA
    immediately (the multi-process replacement for the 30s idle heuristic)."""
    from motioncheck_ccm_slam.config import Config

    msg = comm_mod.MapMsg(sender_client_id=0, agent_done=True)
    out = codec.decode(codec.encode(msg))
    assert out.agent_done is True
    assert codec.decode(codec.encode(make_msg())).agent_done is False

    # channel-level: goodbye marks the server comm finished without idling
    from motioncheck_ccm_slam.models import map_state as ms
    from motioncheck_ccm_slam.system.server import ServerClientHandler

    cfg = Config()
    ch = comm_mod.Channel()
    h = ServerClientHandler(
        config=cfg, client_id=0,
        map=ms.MapState.create(cfg.replace(), server=False), channel=ch,
    )
    assert not h.comm.agent_finished
    client = comm_mod.ClientComm(config=cfg, channel=ch, client_id=0)
    client.send_goodbye()
    h.comm.tick()
    assert h.comm.agent_said_done
    assert h.comm.agent_finished
