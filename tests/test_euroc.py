"""EuRoC ASL-format replay harness test (ROADMAP #2).

The environment ships no EuRoC data, so this test synthesizes a miniature
sequence in the exact ASL folder layout (mav0/cam0/data.csv + PNGs +
state_groundtruth_estimate0/data.csv), then drives the REAL dataset path —
``cli.cmd_euroc`` → EurocSequence → ClientSystem/ServerSystem → ATE vs
ground truth — end to end. This validates the reader, the replay loop, the
trajectory export, and the Sim3-aligned ATE evaluation that the reference
relies on external tooling for (SURVEY.md §4).
"""
import argparse
import json
import os

import numpy as np
import jax.numpy as jnp
import pytest

from motioncheck_ccm_slam import cli
from motioncheck_ccm_slam.config import CameraParams, Config
from motioncheck_ccm_slam.ops import lie
from motioncheck_ccm_slam.utils.euroc import EurocSequence

from synth_scene import SynthScene

N_FRAMES = 30


def _write_fixture(root: str) -> None:
    """Render a synthetic scene into a real ASL-format directory."""
    from PIL import Image

    config = cli._small_preset(Config().replace(
        camera=CameraParams(k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0)
    ))
    scene = SynthScene(config, n_points=500, seed=3, speed=0.9)
    cam_dir = os.path.join(root, "mav0", "cam0")
    data_dir = os.path.join(cam_dir, "data")
    gt_dir = os.path.join(root, "mav0", "state_groundtruth_estimate0")
    os.makedirs(data_dir, exist_ok=True)
    os.makedirs(gt_dir, exist_ok=True)

    T_SC_inv = np.linalg.inv(config.camera.T_SC())
    cam_rows, gt_rows = [], []
    for t, Tcw, img in scene.sequence(N_FRAMES):
        ts_ns = int(round(t * 1e9))
        fname = f"{ts_ns}.png"
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            os.path.join(data_dir, fname)
        )
        cam_rows.append(f"{ts_ns},{fname}")
        # groundtruth is the body pose: Tws = Twc @ T_SC^-1 (csv_io convention)
        Tws = np.linalg.inv(Tcw) @ T_SC_inv
        q = np.asarray(lie.rot_to_quat(jnp.asarray(Tws[:3, :3], jnp.float32)))
        p = Tws[:3, 3]
        gt_rows.append(
            f"{ts_ns},{p[0]:.9f},{p[1]:.9f},{p[2]:.9f},"
            f"{q[0]:.9f},{q[1]:.9f},{q[2]:.9f},{q[3]:.9f}"
        )
    with open(os.path.join(cam_dir, "data.csv"), "w") as f:
        f.write("#timestamp [ns],filename\n" + "\n".join(cam_rows) + "\n")
    with open(os.path.join(gt_dir, "data.csv"), "w") as f:
        f.write("#timestamp,px,py,pz,qw,qx,qy,qz\n" + "\n".join(gt_rows) + "\n")


@pytest.fixture(scope="module")
def euroc_run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("euroc_seq"))
    out = str(tmp_path_factory.mktemp("euroc_out"))
    _write_fixture(root)
    args = argparse.Namespace(
        seq=root, frames=None, stride=1, out=out, small=True,
        synth_camera=True,
    )
    stats = cli.cmd_euroc(args)
    return root, out, stats


def test_reader_roundtrip(euroc_run):
    root, _, _ = euroc_run
    seq = EurocSequence(root)
    assert len(seq) == N_FRAMES
    ts, img = next(iter(seq.frames()))
    assert img.shape == (480, 752)
    gt = seq.ground_truth()
    assert gt is not None and gt.shape == (N_FRAMES, 8)


def test_replay_tracks_and_exports(euroc_run):
    _, out, stats = euroc_run
    assert stats["agents"][0]["state"] == "OK"
    assert stats["agents"][0]["client_kfs"] >= 2
    assert os.path.exists(os.path.join(out, "frames_client0.tum"))
    assert os.path.exists(os.path.join(out, "KF_FINAL_0.tum"))
    with open(os.path.join(out, "stats.json")) as f:
        on_disk = json.load(f)
    assert on_disk["agents"]["0"]["frames"] == N_FRAMES


def test_ate_vs_groundtruth(euroc_run):
    _, _, stats = euroc_run
    # scene spans ~1.3 m over 30 frames; Sim3-aligned KF ATE of a few cm is
    # healthy mono VO (matches test_client_e2e's tolerance)
    assert "ate_rmse_m" in stats
    assert stats["ate_rmse_m"] < 0.06, stats
