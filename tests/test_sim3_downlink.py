"""Client<->map Sim3 scale carried across merges.

After a scale-changing merge, the map an agent streams into lives in a world
that differs from the agent's own by a Sim3 with s != 1 (monocular merges
generally change scale). Every pose/position crossing the channel must be
re-metrized by that Sim3 — uplink client KFs/landmarks into the map metric,
downlink vicinity corrections back into the client metric — or post-merge
updates shear the fused map. Reference: per-agent mg2oS_wcurmap_wclientmap
(include/cslam/CentralControl.h:86) applied during message conversion
(src/KeyFrame.cpp:1351-1418).
"""
import numpy as np
import jax.numpy as jnp

from motioncheck_ccm_slam.config import CommParams
from motioncheck_ccm_slam.models import map_merging
from motioncheck_ccm_slam.models import map_state as ms
from motioncheck_ccm_slam.parallel import comm as comm_mod

from synth_map import SynthWorld, add_pass, arc_poses
from test_aux import CONFIG as AUX_CONFIG

CONFIG = AUX_CONFIG.replace(comm=CommParams(server_kfs_to_client=8))

SCALE = 1.3


def _fusion_sim3(s=SCALE):
    th = 0.3
    R = np.array([[np.cos(th), 0.0, np.sin(th)],
                  [0.0, 1.0, 0.0],
                  [-np.sin(th), 0.0, np.cos(th)]])
    S = np.eye(4)
    S[:3, :3] = s * R
    S[:3, 3] = [0.7, -0.2, 1.1]
    return S


def _conv_pose(T_cli, S):
    """Independent expectation: client-world SE3 -> map-world SE3 in the
    map metric (rotation conjugated, translation re-metrized by s)."""
    s = np.cbrt(np.linalg.det(S[:3, :3]))
    R = S[:3, :3] / s
    Rm = T_cli[:3, :3] @ R.T
    out = np.eye(4)
    out[:3, :3] = Rm
    out[:3, 3] = s * T_cli[:3, 3] - Rm @ S[:3, 3]
    return out


def _mirror(client_map, ccomm, scomm, n=4):
    for _ in range(n):
        ccomm.tick(client_map)
        scomm.tick()
    ccomm.tick(client_map)   # consume the final acks + vicinity


def _setup():
    world = SynthWorld(CONFIG, n_points=250, seed=3)
    client_map = ms.MapState.create(CONFIG, server=False)
    server_map = ms.MapState.create(CONFIG, server=True)
    ch = comm_mod.Channel()
    ccomm = comm_mod.ClientComm(config=CONFIG, channel=ch, client_id=0)
    scomm = comm_mod.ServerComm(config=CONFIG, channel=ch, map=server_map,
                                client_id=0)
    return world, client_map, server_map, ccomm, scomm


def test_uplink_remetrizes_after_merge():
    world, client_map, server_map, ccomm, scomm = _setup()
    poses, ts = arc_poses(6, step=0.3)

    # phase 1 (identity Sim3): stream the first 4 KFs up
    slots_c = add_pass(client_map, world, poses[:4], ts[:4])
    for s in slots_c:
        ccomm.on_new_keyframe(client_map, s)
    _mirror(client_map, ccomm, scomm)
    assert (3, 0) in server_map.kf_slot_by_id

    # the merge: this agent's map is fused into another world by S
    S = _fusion_sim3()
    map_merging.sim3_transform_map(
        server_map, jnp.asarray(S.astype(np.float32)))
    scomm.compose_fusion_sim3(S)
    assert abs(scomm.map_scale - SCALE) < 1e-3

    # phase 2: the client keeps streaming in its OWN world/metric
    slots_c2 = add_pass(client_map, world, poses[4:], ts[4:],
                        kf_id_start=4, chain_from=slots_c[-1], seed=1)
    for s in slots_c2:
        ccomm.on_new_keyframe(client_map, s)
    _mirror(client_map, ccomm, scomm)

    # uplink pose: server KF 5 must equal the Sim3-converted client pose
    slot_s = server_map.kf_slot_by_id[(5, 0)]
    T_srv = np.asarray(server_map.kf.Tcw[slot_s])
    T_cli = np.asarray(client_map.kf.Tcw[slots_c2[-1]])
    exp = _conv_pose(T_cli, S)
    np.testing.assert_allclose(T_srv, exp.astype(np.float32), atol=2e-3)

    # uplink landmark: a phase-2 landmark must land at S(X_client)
    checked = 0
    for (mp_id, cid), mslot_s in server_map.mp_slot_by_id.items():
        if mp_id < 4 * 100000 or cid != 0:
            continue   # phase-1 landmark
        mslot_c = client_map.mp_slot_by_id[(mp_id, 0)]
        X_cli = np.asarray(client_map.mp.Xw[mslot_c])
        X_srv = np.asarray(server_map.mp.Xw[mslot_s])
        exp_X = S[:3, :3] @ X_cli + S[:3, 3]
        np.testing.assert_allclose(X_srv, exp_X.astype(np.float32), atol=5e-3)
        checked += 1
        if checked >= 10:
            break
    assert checked > 0, "no phase-2 landmark reached the server"


def test_downlink_vicinity_remetrizes_after_merge():
    world, client_map, server_map, ccomm, scomm = _setup()
    poses, ts = arc_poses(5, step=0.3)
    slots_c = add_pass(client_map, world, poses, ts)
    for s in slots_c:
        ccomm.on_new_keyframe(client_map, s)
    _mirror(client_map, ccomm, scomm)

    S = _fusion_sim3()
    map_merging.sim3_transform_map(
        server_map, jnp.asarray(S.astype(np.float32)))
    scomm.compose_fusion_sim3(S)

    # the merged map's poses round-trip: vicinity updates must leave the
    # client's (already consistent) poses unchanged
    T_cli_before = np.asarray(client_map.kf.Tcw).copy()
    scomm.tick()
    ccomm.tick(client_map)
    np.testing.assert_allclose(np.asarray(client_map.kf.Tcw),
                               T_cli_before, atol=2e-3)

    # a server-side correction (as a GBA would apply, in the MAP frame) on
    # the newest KF flows down re-metrized into the client's world
    newest_s = server_map.kf_slot_by_id[(4, 0)]
    T_new_map = np.asarray(server_map.kf.Tcw[newest_s]).astype(np.float64)
    T_new_map[:3, 3] += np.array([0.08, -0.03, 0.05])
    server_map.kf = server_map.kf._replace(
        Tcw=server_map.kf.Tcw.at[newest_s].set(
            jnp.asarray(T_new_map.astype(np.float32))))
    scomm.tick()
    ccomm.tick(client_map)

    # expectation, derived independently: invert the uplink conversion
    s = SCALE
    R = S[:3, :3] / s
    exp = np.eye(4)
    exp[:3, :3] = T_new_map[:3, :3] @ R
    exp[:3, 3] = (T_new_map[:3, 3] + T_new_map[:3, :3] @ S[:3, 3]) / s
    T_cli = np.asarray(client_map.kf.Tcw[slots_c[-1]])
    np.testing.assert_allclose(T_cli, exp.astype(np.float32), atol=2e-3)
    # and it is a REAL move, not a no-op
    assert np.linalg.norm(T_cli[:3, 3] - T_cli_before[slots_c[-1]][:3, 3]) \
        > 0.01
