"""KITTI odometry replay harness (reference cslam/conf/kitti_mono*.yaml +
launch/KITTI/Client0_kitti*.launch). No KITTI data ships in this image, so
this synthesizes a miniature sequence in the exact KITTI folder layout
(sequences/00/image_0/%06d.png + times.txt, poses/00.txt) and drives the
REAL dataset path — cli.cmd_kitti -> KittiSequence -> Client/ServerSystem ->
ATE vs the 3x4 ground-truth poses."""
import argparse
import os

import numpy as np
import pytest

from motioncheck_ccm_slam import cli
from motioncheck_ccm_slam.config import (
    CameraParams, Config, KITTI_CONFIG, KITTI_HALF_RES_CONFIG,
)
from motioncheck_ccm_slam.utils.kitti import KittiSequence

from synth_scene import SynthScene

N_FRAMES = 30


def _write_fixture(root: str) -> str:
    from PIL import Image

    config = cli._small_preset(Config().replace(
        camera=CameraParams(k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0)
    ))
    scene = SynthScene(config, n_points=500, seed=3, speed=0.9)
    seq_dir = os.path.join(root, "sequences", "00")
    img_dir = os.path.join(seq_dir, "image_0")
    poses_dir = os.path.join(root, "poses")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(poses_dir, exist_ok=True)

    times, pose_lines = [], []
    for i, (t, Tcw, img) in enumerate(scene.sequence(N_FRAMES)):
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            os.path.join(img_dir, f"{i:06d}.png")
        )
        times.append(f"{t:.6e}")
        Twc = np.linalg.inv(Tcw)
        pose_lines.append(" ".join(f"{x:.9e}" for x in Twc[:3].reshape(-1)))
    with open(os.path.join(seq_dir, "times.txt"), "w") as f:
        f.write("\n".join(times) + "\n")
    with open(os.path.join(poses_dir, "00.txt"), "w") as f:
        f.write("\n".join(pose_lines) + "\n")
    return seq_dir


@pytest.fixture(scope="module")
def kitti_run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti_root"))
    out = str(tmp_path_factory.mktemp("kitti_out"))
    seq_dir = _write_fixture(root)
    args = argparse.Namespace(
        seq=seq_dir, poses=None, half_res=False, frames=None, stride=1,
        out=out, small=True, synth_camera=True,
    )
    stats = cli.cmd_kitti(args)
    return seq_dir, out, stats


def test_reader_roundtrip(kitti_run):
    seq_dir, _, _ = kitti_run
    seq = KittiSequence(seq_dir)
    assert len(seq) == N_FRAMES
    frames = list(seq.frames(stop=3))
    assert len(frames) == 3
    t0, img0 = frames[0]
    assert img0.ndim == 2 and img0.dtype == np.float32
    # ground truth auto-discovered from ../../poses/00.txt
    gt = seq.ground_truth()
    assert gt is not None and gt.shape == (N_FRAMES, 3, 4)
    pos = seq.gt_positions_at(np.array([t0]))
    assert pos.shape == (1, 3)


def test_replay_ate(kitti_run):
    _, out, stats = kitti_run
    assert stats["agents"][0]["state"] == "OK"
    assert "ate_rmse_m" in stats, "ground truth present -> ATE must report"
    assert stats["ate_rmse_m"] < 0.15, \
        f"synthetic KITTI replay ATE too large: {stats['ate_rmse_m']}"
    assert os.path.exists(os.path.join(out, "stats.json"))


def test_kitti_operating_points_match_reference():
    """Calibration constants must match cslam/conf/kitti_mono.yaml and
    kitti_mono_half_res.yaml."""
    c = KITTI_CONFIG.camera
    assert (c.fx, c.fy, c.cx, c.cy) == (718.856, 718.856, 607.1928, 185.2157)
    assert c.fps == 10.0
    assert (c.k1, c.k2, c.p1, c.p2, c.k3) == (0.0, 0.0, 0.0, 0.0, 0.0)
    assert np.allclose(c.T_SC(), np.eye(4))
    h = KITTI_HALF_RES_CONFIG.camera
    assert (h.fx, h.fy, h.cx, h.cy) == (359.428, 359.428, 303.5964, 92.60785)
    assert h.width == 620 and h.height == 188
