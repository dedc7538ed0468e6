"""Diagnose tracking loss on the full-preset ring world.

Runs ONE agent on the ring, printing the tracker state + inlier count per
frame, with an optional client-capacity override to test the
map-clipping-kills-tracking hypothesis (loss observed at ~frame 140 ==
the frame the 70-KF client cap is first hit).

Usage: python tools/diag_ring.py [--frames 220] [--kf-cap 70]
       [--start-deg 0]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=220)
    ap.add_argument("--kf-cap", type=int, default=None)
    ap.add_argument("--start-deg", type=float, default=0.0)
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args()

    from motioncheck_ccm_slam.utils import compile_cache

    compile_cache.enable()

    from motioncheck_ccm_slam.config import (CameraParams, CapacityParams,
                                                 Config)
    from motioncheck_ccm_slam.cli import _build_system, _small_preset

    config = Config().replace(
        camera=CameraParams(k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0))
    if args.small:
        config = _small_preset(config)
    if args.kf_cap:
        cap = config.capacity
        config = config.replace(capacity=CapacityParams(
            client_max_kfs=args.kf_cap,
            client_max_mps=cap.client_max_mps,
            server_max_kfs=cap.server_max_kfs,
            server_max_mps=cap.server_max_mps))
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tests"))
    from synth_scene import RingScene

    server, clients = _build_system(config, 1)
    c = clients[0]
    scene = RingScene(config, seed=3, start_deg=args.start_deg)
    t0 = time.time()
    last_state = None
    for i, (t, _, img) in enumerate(scene.sequence(args.frames)):
        c.process_image(img, t)
        server.spin_once()
        st = c.tracker.state.name
        nt = getattr(c.tracker.last_frame, "n_tracked", -1)
        if st != last_state:
            print(f"frame {i:4d} t={time.time() - t0:5.0f}s state -> {st} "
                  f"kfs={c.map.n_kfs} mps={c.map.n_mps} inl={nt}",
                  flush=True)
            last_state = st
        elif i % 5 == 0:
            print(f"frame {i:4d} t={time.time() - t0:5.0f}s {st} "
                  f"kfs={c.map.n_kfs} mps={c.map.n_mps} inl={nt}",
                  flush=True)
    print(f"final: {c.tracker.state.name} relocs={c.tracker.n_relocs} "
          f"kfs={c.map.n_kfs} mps={c.map.n_mps} "
          f"wall={time.time() - t0:.0f}s")


if __name__ == "__main__":
    main()
