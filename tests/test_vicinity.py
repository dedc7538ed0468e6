"""Server->client vicinity packing: corrected poses flow back down."""
import numpy as np
import jax.numpy as jnp

from motioncheck_ccm_slam.config import CommParams
from motioncheck_ccm_slam.parallel import comm as comm_mod
from motioncheck_ccm_slam.models import map_state as ms

from synth_map import SynthWorld, add_pass, arc_poses
from test_aux import CONFIG as AUX_CONFIG

CONFIG = AUX_CONFIG.replace(
    comm=CommParams(server_kfs_to_client=8)
)


def test_vicinity_poses_flow_back():
    # build identical client and server maps
    world = SynthWorld(CONFIG, n_points=200, seed=0)
    client_map = ms.MapState.create(CONFIG, server=False)
    server_map = ms.MapState.create(CONFIG, server=False)
    poses, ts = arc_poses(4, step=0.3)
    slots_c = add_pass(client_map, world, poses, ts)
    slots_s = add_pass(server_map, world, poses, ts)

    ch = comm_mod.Channel()
    ccomm = comm_mod.ClientComm(config=CONFIG, channel=ch, client_id=0)
    scomm = comm_mod.ServerComm(config=CONFIG, channel=ch, map=server_map,
                                client_id=0)

    # simulate a server-side GBA correction on the newest KF
    newest = slots_s[-1]
    T_old = np.asarray(server_map.kf.Tcw[newest])
    T_new = T_old.copy()
    T_new[:3, 3] += np.array([0.05, -0.02, 0.03], np.float32)
    server_map.kf = server_map.kf._replace(
        Tcw=server_map.kf.Tcw.at[newest].set(jnp.asarray(T_new))
    )

    scomm.tick()                  # server publishes acks + vicinity
    ccomm.tick(client_map)        # client applies corrections

    # the client's copy of the newest KF pose must now match the server's
    T_client = np.asarray(client_map.kf.Tcw[slots_c[-1]])
    T_server = np.asarray(server_map.kf.Tcw[newest])
    np.testing.assert_allclose(T_client, T_server, atol=1e-4)
