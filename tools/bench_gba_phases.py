"""Bisect the dual-layout GBA PCG sweep on the device: time (a) the exact
PCG loop (fixed 25 sweeps, early exit disabled by rtol=0) with
realistically-shaped inputs, (b) one Schur matvec, (c) the matvec's stages,
cumulatively. Each time is an in-graph repetition inside one jitted loop.

Usage: python tools/bench_gba_phases.py [--kfs 2048] [--mps 65536]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from motioncheck_ccm_slam.utils import compile_cache

compile_cache.enable()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--kfs", type=int, default=2048)
    ap.add_argument("--mps", type=int, default=65536)
    ap.add_argument("--obs-per-kf", type=int, default=1000)
    ap.add_argument("--pcg", type=int, default=25)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--probe-convergence", action="store_true",
                    help="sweeps-to-tolerance curve instead of timings")
    args = ap.parse_args()

    from motioncheck_ccm_slam.parallel import sharded_ba as sb
    from motioncheck_ccm_slam.solvers import ba_core

    C, L, seg = args.kfs, args.mps, args.obs_per_kf
    O = C * seg
    rng = np.random.default_rng(0)
    lm_idx = rng.integers(0, L, O).astype(np.int32)
    order = np.argsort(lm_idx, kind="stable").astype(np.int32)
    cam_idx_l = (np.arange(O, dtype=np.int32) // seg)[order]
    lm_sorted = lm_idx[order]

    Wcl_t = jnp.asarray(rng.normal(0, 0.1, (6, 3, O)).astype(np.float32))
    Wl_t = Wcl_t[:, :, jnp.asarray(order)]
    Hcc_d = jnp.broadcast_to(jnp.eye(6) * 3.0, (C, 6, 6)).astype(jnp.float32)
    Hll_inv_t = jnp.broadcast_to(
        (jnp.eye(3) * 0.3)[..., None], (3, 3, L)).astype(jnp.float32)
    M_inv = jnp.broadcast_to(jnp.eye(6) / 3.0, (C, 6, 6)).astype(jnp.float32)
    b = jnp.asarray(rng.normal(0, 1, (C, 6)).astype(np.float32))
    lm_idx_j = jnp.asarray(lm_idx)
    cam_idx_l_j = jnp.asarray(cam_idx_l)
    lm_sorted_j = jnp.asarray(lm_sorted)

    # Big arrays are passed as ARGUMENTS, never closed over: a closed-over
    # device array is inlined into the HLO as a constant and bloats the
    # executable.
    big = (Wl_t, Wcl_t, Hll_inv_t, Hcc_d, M_inv, cam_idx_l_j, lm_idx_j,
           lm_sorted_j)

    def timeit(name, fn, *a, reps=None):
        """Time ``fn`` with ``reps`` in-graph repetitions inside one jitted
        fori_loop (the carry perturbs the input so XLA cannot hoist the
        body), so per-dispatch overhead is amortized over the reps."""
        reps = args.reps if reps is None else reps

        def loop(x0, *rest):
            def body(_, carry):
                x, acc = carry
                r = fn(x * (1.0 + acc * 1e-30), *rest)
                return x, acc + jnp.sum(r).astype(jnp.float32) * 1e-30
            _, acc = jax.lax.fori_loop(0, reps, body, (x0, jnp.float32(0.0)))
            return acc

        f = jax.jit(loop)
        float(f(*a, *big))                 # compile + warm; fetch completes
        t0 = time.perf_counter()
        float(f(*a, *big))
        ms = (time.perf_counter() - t0) / reps * 1e3
        print(f"{name:34s} {ms:9.1f} ms", flush=True)
        return ms

    def matvec(v, Wl_t, Wcl_t, Hll_inv_t, Hcc_d, M_inv, cam_idx_l_j,
               lm_idx_j, lm_sorted_j):
        Hv = jnp.einsum("cij,cj->ci", Hcc_d, v)
        vgl = v.T[:, cam_idx_l_j]
        wtv = jnp.einsum("ijo,io->jo", Wl_t, vgl)
        u = jnp.einsum("ijl,jl->il", Hll_inv_t,
                       sb._lm_sum_t(wtv, lm_sorted_j, L))
        ug = u[:, lm_idx_j]
        wu = jnp.einsum("ijo,jo->io", Wcl_t, ug)
        return Hv - sb._cam_sum_t(wu, C, seg).T

    # (a) the exact PCG with the exact matvec
    def pcg_full(bb, Wl_t, Wcl_t, Hll_inv_t, Hcc_d, M_inv, cam_idx_l_j,
                 lm_idx_j, lm_sorted_j):
        mv = lambda v: matvec(v, Wl_t, Wcl_t, Hll_inv_t, Hcc_d, M_inv,
                              cam_idx_l_j, lm_idx_j, lm_sorted_j)
        return sb._pcg(mv, bb, M_inv, args.pcg, rtol=0.0)[0]

    ms_pcg = timeit(f"PCG x{args.pcg} (exact matvec)", pcg_full, b, reps=2)
    ms_mv = timeit("one Schur matvec", matvec, b)

    # matvec stages, cumulative
    def s1(v, Wl_t, Wcl_t, Hll_inv_t, Hcc_d, M_inv, cam_idx_l_j, lm_idx_j,
           lm_sorted_j):
        return jnp.einsum("ijo,io->jo", Wl_t, v.T[:, cam_idx_l_j])

    def s2(v, Wl_t, Wcl_t, Hll_inv_t, Hcc_d, M_inv, cam_idx_l_j, lm_idx_j,
           lm_sorted_j):
        return sb._lm_sum_t(
            jnp.einsum("ijo,io->jo", Wl_t, v.T[:, cam_idx_l_j]), lm_sorted_j,
            L)

    def s3(v, Wl_t, Wcl_t, Hll_inv_t, Hcc_d, M_inv, cam_idx_l_j, lm_idx_j,
           lm_sorted_j):
        return jnp.einsum(
            "ijl,jl->il", Hll_inv_t, sb._lm_sum_t(
                jnp.einsum("ijo,io->jo", Wl_t, v.T[:, cam_idx_l_j]),
                lm_sorted_j, L))[:, lm_idx_j]

    def s4(v, Wl_t, Wcl_t, Hll_inv_t, Hcc_d, M_inv, cam_idx_l_j, lm_idx_j,
           lm_sorted_j):
        return sb._cam_sum_t(jnp.einsum(
            "ijo,jo->io", Wcl_t, jnp.einsum(
                "ijl,jl->il", Hll_inv_t, sb._lm_sum_t(
                    jnp.einsum("ijo,io->jo", Wl_t, v.T[:, cam_idx_l_j]),
                    lm_sorted_j, L))[:, lm_idx_j]), C, seg).T

    ms_s1 = timeit("  gather-v + einsum Wl", s1, b)
    ms_s2 = timeit("  + lm segment sum", s2, b)
    ms_s3 = timeit("  + solve + u gather", s3, b)
    ms_s4 = timeit("  + einsum Wcl + cam sum", s4, b)

    print(f"PCG overhead per sweep: "
          f"{(ms_pcg - args.pcg * ms_mv) / args.pcg:.2f} ms "
          f"(dots/axpys/precond)")


if __name__ == "__main__":
    main()
