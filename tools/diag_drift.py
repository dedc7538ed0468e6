"""Diagnose monocular scale drift on the synthetic corridor (ROADMAP #1).

Runs the client-only pipeline for N frames and prints, per frame:
  frame, state, n_tracked, n_kfs, step_ratio (est step len / gt step len,
  scale-aligned on the first 10 steps), cumulative scale creep.

Usage: JAX_PLATFORMS=cpu python tools/diag_drift.py [n_frames]
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from motioncheck_ccm_slam.config import (
    CameraParams, CapacityParams, Config, ExtractorParams,
)
from motioncheck_ccm_slam.system.client import ClientSystem
from synth_scene import SynthScene

CONFIG = Config().replace(
    extractor=ExtractorParams(max_features=512, n_levels=4, n_features=512),
    capacity=CapacityParams(client_max_kfs=64, client_max_mps=4096),
    camera=CameraParams(k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0),
)


def main(n_frames=80):
    scene = SynthScene(CONFIG, n_points=700, seed=3, speed=0.9)
    client = ClientSystem(config=CONFIG)
    # ablations (env switches):
    #   NO_VEL=1    — disable the constant-velocity motion model
    #   NO_BA=1     — skip local BA in the mapping pipeline
    #   NO_KFS=1    — never insert keyframes after bootstrap
    if os.environ.get("NO_VEL"):
        cls = type(client.tracker)
        orig = cls._track
        def _track_novel(self, fr):
            self.velocity = None
            return orig(self, fr)
        cls._track = _track_novel
    if os.environ.get("NO_BA"):
        from motioncheck_ccm_slam.models import mapping as mapping_mod
        mapping_mod.run_local_ba = lambda *a, **k: 0.0
    if os.environ.get("NO_KFS"):
        client.tracker.need_new_keyframe = lambda fr: False
    est, gt = [], []
    for t, Tcw_gt, img in scene.sequence(n_frames):
        fr = client.process_image(img, t)
        est.append(np.linalg.inv(np.asarray(fr.Tcw))[:3, 3])
        gt.append(np.linalg.inv(Tcw_gt)[:3, 3])
        i = len(est) - 1
        if i >= 1:
            es = np.linalg.norm(est[i] - est[i - 1])
            gs = np.linalg.norm(gt[i] - gt[i - 1])
            ratio = es / max(gs, 1e-9)
        else:
            ratio = 0.0
        print(
            f"f={i:3d} state={client.tracker.state.name:4.4s} "
            f"trk={fr.n_tracked:4d} kfs={client.map.n_kfs:3d} "
            f"mps={client.map.n_mps:5d} step_ratio={ratio:7.4f}",
            flush=True,
        )
    est = np.stack(est)
    gt = np.stack(gt)
    # scale calibration on frames 3..13
    es = np.linalg.norm(np.diff(est[3:13], axis=0), axis=-1).sum()
    gs = np.linalg.norm(np.diff(gt[3:13], axis=0), axis=-1).sum()
    s0 = es / gs
    print(f"\nbase scale (frames 3..13): {s0:.4f}")
    for a, b in [(10, 20), (20, 40), (40, 60), (60, n_frames - 1)]:
        if b >= len(est):
            break
        es = np.linalg.norm(np.diff(est[a:b], axis=0), axis=-1).sum()
        gs = np.linalg.norm(np.diff(gt[a:b], axis=0), axis=-1).sum()
        print(f"scale[{a}:{b}] / base = {es / gs / s0:.4f}")
    from motioncheck_ccm_slam.utils.csv_io import ate_rmse

    rmse, mx = ate_rmse(est[3:], gt[3:])
    print(f"ATE rmse={rmse*100:.2f}cm max={mx*100:.2f}cm (Sim3-aligned)")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 80)
