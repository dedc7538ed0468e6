"""Relocalization after tracking loss.

The reference fork resets on loss (src/Tracking.cpp:249-259); our client
recovers via brute-force map matching + PnP RANSAC (Tracker._relocalize).
A blackout (featureless frames) forces LOST; the camera keeps moving; on
the first good frame the client must snap back onto the map.
"""
import numpy as np
import pytest

from motioncheck_ccm_slam.config import (
    CameraParams, CapacityParams, Config, ExtractorParams, TrackingParams,
)
from motioncheck_ccm_slam.models.tracking import TrackState
from motioncheck_ccm_slam.system.client import ClientSystem
from motioncheck_ccm_slam.utils.csv_io import ate_rmse

from synth_scene import SynthScene

TEST_CONFIG = Config().replace(
    extractor=ExtractorParams(max_features=512, n_levels=4, n_features=512),
    capacity=CapacityParams(client_max_kfs=24, client_max_mps=2048),
    camera=CameraParams(k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0),
    # young-map bar low so the blackout doesn't trigger the reset path
    tracking=TrackingParams(init_kfs=2),
)


@pytest.fixture(scope="module")
def run_blackout():
    fps = 20.0
    scene = SynthScene(TEST_CONFIG, n_points=500, seed=3, speed=0.9)
    client = ClientSystem(config=TEST_CONFIG)
    blank = np.zeros(
        (TEST_CONFIG.camera.height, TEST_CONFIG.camera.width), np.float32
    )
    log = []  # (frame_kind, est_Tcw, gt_Tcw, state)
    n_pre, n_blank, n_post = 12, 3, 5
    for i in range(n_pre + n_blank + n_post):
        t = i / fps
        gt = scene.pose(t)
        if n_pre <= i < n_pre + n_blank:
            fr = client.process_image(blank, t)
            kind = "blank"
        else:
            fr = client.process_image(scene.render(gt), t)
            kind = "good"
        log.append((kind, np.asarray(fr.Tcw), gt, client.tracker.state))
    return client, log, n_pre, n_blank


def test_loses_tracking_on_blackout(run_blackout):
    client, log, n_pre, n_blank = run_blackout
    assert log[n_pre - 1][3] == TrackState.OK
    assert log[n_pre][3] == TrackState.LOST


def test_relocalizes_after_blackout(run_blackout):
    client, log, n_pre, n_blank = run_blackout
    # must recover within 2 good frames
    states = [s for _, _, _, s in log[n_pre + n_blank:]]
    assert TrackState.OK in states[:2], states
    assert log[-1][3] == TrackState.OK


def test_relocalized_pose_consistent(run_blackout):
    """The post-reloc poses must live in the same (Sim3-gauged) frame as the
    pre-loss trajectory: a joint Sim3 alignment of pre+post positions against
    ground truth must stay tight."""
    client, log, n_pre, n_blank = run_blackout
    est, gt = [], []
    for kind, Tcw_est, Tcw_gt, state in log:
        if kind != "good" or state != TrackState.OK:
            continue
        if np.allclose(Tcw_est, np.eye(4)):
            continue  # pre-init frames
        est.append(np.linalg.inv(Tcw_est)[:3, 3])
        gt.append(np.linalg.inv(Tcw_gt)[:3, 3])
    rmse, mx = ate_rmse(np.stack(est), np.stack(gt))
    assert rmse < 0.05, f"ATE RMSE {rmse} (max {mx})"
