"""End-to-end single-agent test: synthetic sequence -> init -> tracking ->
mapping -> trajectory accuracy (the minimum end-to-end slice of SURVEY.md §7)."""
import numpy as np
import pytest

from motioncheck_ccm_slam.config import (
    CameraParams, CapacityParams, Config, ExtractorParams,
)
from motioncheck_ccm_slam.models.tracking import TrackState
from motioncheck_ccm_slam.system.client import ClientSystem
from motioncheck_ccm_slam.utils.csv_io import ate_rmse

from synth_scene import SynthScene

# small capacities keep the CPU test fast; the synthetic renderer is a pure
# pinhole, so the camera model must carry zero distortion
TEST_CONFIG = Config().replace(
    extractor=ExtractorParams(max_features=512, n_levels=4, n_features=512),
    capacity=CapacityParams(client_max_kfs=24, client_max_mps=2048),
    camera=CameraParams(k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0),
)


@pytest.fixture(scope="module")
def run_sequence():
    scene = SynthScene(TEST_CONFIG, n_points=500, seed=3, speed=0.9)
    client = ClientSystem(config=TEST_CONFIG)
    gt = []
    # 40 frames (~1.8 m travel): long enough that the old constant-velocity
    # feedback runaway (fixed by the two-candidate pass 1, see ROADMAP #1)
    # would trip tracking loss if it regressed
    n_frames = 40
    for t, Tcw_gt, img in scene.sequence(n_frames):
        client.process_image(img, t)
        gt.append(Tcw_gt)
    return client, np.stack(gt)


def test_initializes_and_tracks(run_sequence):
    client, gt = run_sequence
    assert client.tracker.state == TrackState.OK
    assert client.map.n_kfs >= 2
    assert client.map.n_mps > 50


def test_trajectory_accuracy(run_sequence):
    client, gt = run_sequence
    est_t = np.stack([np.linalg.inv(T)[ :3, 3] for _, T in client.tracker.trajectory])
    gt_t = np.stack([np.linalg.inv(T)[:3, 3] for T in gt])
    # skip the pre-init frames (identity poses until two-view bootstrap)
    moved = np.linalg.norm(est_t, axis=-1) > 1e-6
    k = int(np.argmax(moved)) + 1
    rmse, mx = ate_rmse(est_t[k:], gt_t[k:])
    # trajectory spans ~1.8 m; <= 2-3% of span is solid monocular VO
    # without loop closure (measured ~3.7 cm at 40 frames)
    assert rmse < 0.05, f"ATE RMSE {rmse}"


def test_keyframes_created(run_sequence):
    client, gt = run_sequence
    # sideways motion must force regular keyframe creation
    assert client.mapper.next_kf_id >= 3
    assert client.mapper.n_created > 0


def test_trajectory_export(run_sequence):
    client, gt = run_sequence
    tum = client.trajectory_tum()
    lines = tum.strip().split("\n")
    assert len(lines) == len(client.tracker.trajectory)
    assert all(len(l.split()) == 8 for l in lines)
