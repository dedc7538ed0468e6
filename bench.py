"""Headline benchmark: tracking-step throughput and server GBA rate on one GPU.

Measures the client hot loop at the reference's EuRoC operating point
(752x480 mono, 1000-feature ORB budget over 8 pyramid levels): ORB
extraction + undistortion + two-pass projection tracking against a
populated local map + motion-only pose optimization, all fused into one
jitted program.

Methodology: the step is iterated ON DEVICE inside a ``lax.fori_loop``
(each iteration consumes a different image and the previous pose, and a
carried checksum keeps every output live), and one scalar is fetched at
the end, which waits for the device.

Baseline: the reference client must sustain the EuRoC camera rate of
20 fps (cslam/conf/vi_euroc.yaml Camera.fps) to run real time;
``vs_baseline`` is the speedup over that real-time requirement.

Needs a GPU (exits non-zero without one). Prints ONE JSON line, which
names the device it ran on.
"""
import json
import time

import numpy as np

N_ITERS = 64
N_IMGS = 4


def bench_gba(jax, jnp):
    """Matrix-free GBA throughput at the reference server operating point:
    2048 KFs, 65536 landmarks, ~2M observations (config.py capacity +
    cslam/conf/config.yaml budgets). The dense-W formulation would need a
    ~9.7 GB Schur W here; the matrix-free PCG path is what the server
    actually runs. Returns LM iterations/s."""
    from motioncheck_ccm_slam.models import gba as gba_mod
    from motioncheck_ccm_slam.solvers import ba_core

    rng = np.random.default_rng(7)
    C, L = 2048, 65536
    obs_per_cam = 1000
    O = C * obs_per_cam                      # ~2M observations
    pts = rng.uniform(-8, 8, (L, 3)).astype(np.float32)
    pts[:, 2] = np.abs(pts[:, 2]) + 4.0
    Tcw = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    Tcw[:, 0, 3] = rng.uniform(-0.5, 0.5, C)
    Tcw[:, 1, 3] = rng.uniform(-0.5, 0.5, C)
    fx = fy = 458.0
    cx, cy = 376.0, 240.0
    K = jnp.asarray(
        np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
    )
    cam_idx = np.repeat(np.arange(C), obs_per_cam).astype(np.int32)
    lm_idx = rng.integers(0, L, O).astype(np.int32)
    pc = np.einsum("oij,oj->oi", Tcw[cam_idx][:, :3, :3], pts[lm_idx]) \
        + Tcw[cam_idx][:, :3, 3]
    z = np.maximum(pc[:, 2], 1e-3)
    uv = np.stack([fx * pc[:, 0] / z + cx, fy * pc[:, 1] / z + cy], -1)
    uv = (uv + rng.normal(0, 0.5, uv.shape)).astype(np.float32)
    obs = ba_core.BAObservations(
        cam_idx=jnp.asarray(cam_idx), lm_idx=jnp.asarray(lm_idx),
        uv=jnp.asarray(uv), inv_sigma2=jnp.ones(O, jnp.float32),
        valid=jnp.ones(O, bool),
    )
    # the product solver choice (models/gba._pick_solver): the matrix-free
    # solver on one device, the mesh-sharded one on several
    gba = gba_mod._pick_solver(C, L, pcg_iters=25)
    fixed_cam = jnp.zeros(C, bool).at[0].set(True)
    fixed_lm = jnp.zeros(L, bool)
    args = (jnp.asarray(Tcw), jnp.asarray(pts), obs, K, fixed_cam, fixed_lm)
    # warm up (compile) with one iteration, then time a 10-iteration run
    float(gba(*args, n_iterations=1).cost)
    n_it = 10
    t0 = time.perf_counter()
    float(gba(*args, n_iterations=n_it).cost)
    dt = time.perf_counter() - t0
    return n_it / dt


def main():
    import jax
    import jax.numpy as jnp

    from motioncheck_ccm_slam.utils import compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {dev.platform}")
    compile_cache.enable()

    from __graft_entry__ import entry

    fn, args = entry()
    img0, Tcw_pred0, Tcw_last0 = args[0], args[1], args[2]
    map_args = args[3:]

    rng = np.random.default_rng(1)
    imgs = jnp.asarray(
        rng.uniform(0, 255, (N_IMGS,) + img0.shape).astype(np.float32)
    )

    def loop(imgs, Tcw_pred0, Tcw_last0, map_args):
        def body(i, carry):
            Tcw_pred, Tcw_last, acc = carry
            img = jax.lax.dynamic_index_in_dim(
                imgs, i % N_IMGS, axis=0, keepdims=False
            )
            Tcw, assoc, n_inl, vis, found = fn(
                img, Tcw_pred, Tcw_last, *map_args
            )
            # keep every output live in the carry
            acc = (
                acc
                + n_inl.astype(jnp.float32)
                + jnp.sum(assoc).astype(jnp.float32)
                + jnp.sum(vis).astype(jnp.float32)
                + jnp.sum(found).astype(jnp.float32)
            )
            return Tcw, Tcw_pred, acc

        Tcw, _, acc = jax.lax.fori_loop(
            0, N_ITERS, body, (Tcw_pred0, Tcw_last0, jnp.float32(0.0))
        )
        return Tcw[0, 0] + acc

    step_loop = jax.jit(loop)
    # compile + warm up (fetch forces completion)
    float(step_loop(imgs, Tcw_pred0, Tcw_last0, map_args))

    t0 = time.perf_counter()
    out = float(step_loop(imgs, Tcw_pred0, Tcw_last0, map_args))
    dt = time.perf_counter() - t0
    fps = N_ITERS / dt

    gba_iters_per_s = bench_gba(jax, jnp)

    print(json.dumps({
        "metric": "tracking_step_frames_per_s",
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / 20.0, 2),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "extra": {
            # full-map GBA at the server operating point (2048 KFs, 65k MPs,
            # ~2M obs), the solver _pick_solver chooses
            "gba_iters_per_s_2048kf_2Mobs": round(gba_iters_per_s, 3),
            # the reference's GBA budget is 20 LM iterations
            # (cslam/conf/config.yaml:129): seconds per full server GBA
            "gba_20it_wallclock_s": round(20.0 / gba_iters_per_s, 2),
        },
    }))


if __name__ == "__main__":
    main()
