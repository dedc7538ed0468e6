"""2-agent collaborative run: both agents map overlapping parts of one
scene; the server must detect the cross-map overlap and merge the maps
(Config 5 of BASELINE.json)."""
import numpy as np
import jax.numpy as jnp
import pytest

from motioncheck_ccm_slam.config import (
    CameraParams, CapacityParams, Config, ExtractorParams, PlaceRecParams,
    SystemParams,
)
from motioncheck_ccm_slam.parallel import comm as comm_mod
from motioncheck_ccm_slam.system.client import ClientSystem
from motioncheck_ccm_slam.system.server import ServerSystem

from synth_scene import SynthScene

from motioncheck_ccm_slam.config import OptParams

BASE = Config().replace(
    extractor=ExtractorParams(max_features=512, n_levels=4, n_features=512),
    capacity=CapacityParams(
        client_max_kfs=24, client_max_mps=2048,
        server_max_kfs=48, server_max_mps=6144,
    ),
    camera=CameraParams(k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0),
    placerec=PlaceRecParams(start_map_matching_after_kf=2,
                            covisibility_consistency_th=3),
    # small GBA budget keeps CPU-CI compile+run time bounded
    opt=OptParams(gba_iterations=4),
)


class OffsetScene(SynthScene):
    """Same world, trajectory shifted — agent 2 revisits agent 1's area."""

    def __init__(self, config, offset_y=0.15, **kw):
        super().__init__(config, **kw)
        self.offset_y = offset_y

    def pose(self, t):
        T = super().pose(t)
        T = T.copy()
        T[1, 3] += self.offset_y  # camera shifted in y
        return T


@pytest.fixture(scope="module")
def two_agent_run():
    server = ServerSystem(config=BASE, n_agents=2)
    # keep runtime bounded: loop-closure GBA off during streaming (final GBA
    # still exercised through maybe_final_gba)
    for h in server.handlers.values():
        h.loop_closer.run_gba_after_loop = False

    clients = []
    scenes = []
    for cid in range(2):
        cfg = BASE.replace(sys=SystemParams(client_id=cid, n_agents=2))
        c = ClientSystem(config=cfg)
        c.comm = comm_mod.ClientComm(
            config=cfg, channel=server.channel_for(cid), client_id=cid
        )
        clients.append(c)
        scenes.append(
            SynthScene(cfg, n_points=500, seed=3, speed=0.9) if cid == 0
            else OffsetScene(cfg, offset_y=0.15, n_points=500, seed=3,
                             speed=0.9)
        )
    # 32 frames: the MapMatcher's covisibility-consistency gate needs 3
    # consecutive cross-map detections (kf 2,3,4) before it will merge,
    # and the median-parallax init gate defers bootstrap to ~frame 4
    seqs = [list(s.sequence(32)) for s in scenes]
    for i in range(32):
        for cid, c in enumerate(clients):
            t, _, img = seqs[cid][i]
            c.process_image(img, t)
        server.spin_once()
    for _ in range(3):
        for c in clients:
            c.comm.tick(c.map)
        server.spin_once()
    return server, clients


def test_both_agents_mapped(two_agent_run):
    server, clients = two_agent_run
    for cid in range(2):
        assert clients[cid].tracker.state.name == "OK"
    # all keyframes arrived somewhere on the server
    total_kfs = len({
        k for h in {id(h.map): h for h in server.handlers.values()}.values()
        for k in h.map.kf_slot_by_id
    })
    assert total_kfs >= clients[0].map.n_kfs + clients[1].map.n_kfs - 2


def test_maps_merged(two_agent_run):
    server, clients = two_agent_run
    assert server.n_merges >= 1
    # after the merge both handlers share one map containing both agents' KFs
    m0 = server.handlers[0].map
    m1 = server.handlers[1].map
    assert m0 is m1
    cids = {cid for (_, cid) in m0.kf_slot_by_id}
    assert cids == {0, 1}


def test_final_gba_runs(two_agent_run):
    server, clients = two_agent_run
    # agents go idle -> FINALBA fires exactly once
    for h in server.handlers.values():
        h.comm.idle_cycles = 10**9
        h.comm.got_data = False
    assert server.maybe_final_gba()
    assert server.final_gba_done
    assert not server.maybe_final_gba()


def test_fused_trajectories_consistent(two_agent_run):
    """After merging, the two agents' keyframe trajectories live in ONE
    frame: their y-offset must match the ground-truth 0.15 m offset (up to
    map scale)."""
    server, clients = two_agent_run
    m = server.handlers[0].map
    kf = m.kf
    valid = np.asarray(kf.valid)
    cid_arr = np.asarray(kf.client_id)
    centers = {}
    for cid in (0, 1):
        sel = valid & (cid_arr == cid)
        if not sel.any():
            continue
        T = np.asarray(kf.Tcw)[sel]
        C = np.stack([np.linalg.inv(t)[:3, 3] for t in T])
        centers[cid] = C
    assert set(centers) == {0, 1}
    # both trajectories move dominantly along -x in the fused frame
    for cid, C in centers.items():
        span = C.max(0) - C.min(0)
        assert span[0] > 2 * span[1]
