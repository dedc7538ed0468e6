"""4-agent topology with cascaded merges (reference MAXAGENTS=4,
src/server/ServerSystem.cpp:30): four agents map overlapping parts of one
world; the server must cascade the merges (A+B -> AB, AB+C, ABC+D) until
every handler points at ONE fused map, and FINALBA must cover that map
exactly once."""
import numpy as np
import pytest

from motioncheck_ccm_slam.config import SystemParams
from motioncheck_ccm_slam.parallel import comm as comm_mod
from motioncheck_ccm_slam.system.client import ClientSystem
from motioncheck_ccm_slam.system.server import ServerSystem

from synth_scene import SynthScene
from test_multi_agent import BASE, OffsetScene

N_AGENTS = 4


@pytest.fixture(scope="module")
def four_agent_run():
    server = ServerSystem(config=BASE, n_agents=N_AGENTS)
    for h in server.handlers.values():
        h.loop_closer.run_gba_after_loop = False

    clients, scenes = [], []
    for cid in range(N_AGENTS):
        cfg = BASE.replace(sys=SystemParams(client_id=cid,
                                            n_agents=N_AGENTS))
        c = ClientSystem(config=cfg)
        c.comm = comm_mod.ClientComm(
            config=cfg, channel=server.channel_for(cid), client_id=cid
        )
        clients.append(c)
        scenes.append(
            SynthScene(cfg, n_points=500, seed=3, speed=0.9) if cid == 0
            else OffsetScene(cfg, offset_y=0.12 * cid, n_points=500,
                             seed=3, speed=0.9)
        )
    # 32 frames: the median-parallax init gate defers bootstrap to ~frame 4
    seqs = [list(s.sequence(32)) for s in scenes]
    for i in range(32):
        for cid, c in enumerate(clients):
            t, _, img = seqs[cid][i]
            c.process_image(img, t)
        server.spin_once()
    for _ in range(4):
        for c in clients:
            c.comm.tick(c.map)
        server.spin_once()
    return server, clients


def test_cascaded_merges_to_one_map(four_agent_run):
    server, clients = four_agent_run
    for cid in range(N_AGENTS):
        assert clients[cid].tracker.state.name == "OK"
    # N maps fuse pairwise: N-1 merges, all onto one surviving map
    assert server.n_merges == N_AGENTS - 1
    maps = {id(h.map) for h in server.handlers.values()}
    assert len(maps) == 1
    m = server.handlers[0].map
    cids = {cid for (_, cid) in m.kf_slot_by_id}
    assert cids == set(range(N_AGENTS))


def test_final_gba_covers_fused_map_once(four_agent_run):
    server, clients = four_agent_run
    for h in server.handlers.values():
        h.comm.idle_cycles = 10**9
        h.comm.got_data = False
    n_before = [h.loop_closer.n_regba for h in server.handlers.values()]
    assert server.maybe_final_gba()
    assert server.final_gba_done
    # a second call is a no-op: the one distinct map was already covered
    assert not server.maybe_final_gba()
    assert n_before == [h.loop_closer.n_regba
                       for h in server.handlers.values()]


def test_fused_frame_is_shared(four_agent_run):
    """All four trajectories land in one consistent frame: every agent's
    camera path spans dominantly the same (x) axis of the fused world."""
    server, _ = four_agent_run
    kf = server.handlers[0].map.kf
    valid = np.asarray(kf.valid)
    cid_arr = np.asarray(kf.client_id)
    for cid in range(N_AGENTS):
        sel = valid & (cid_arr == cid)
        assert sel.any(), f"agent {cid} contributed no keyframes"
        T = np.asarray(kf.Tcw)[sel]
        C = np.stack([np.linalg.inv(t)[:3, 3] for t in T])
        span = C.max(0) - C.min(0)
        assert span[0] > 2 * span[1]
