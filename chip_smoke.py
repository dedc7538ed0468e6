"""Smoke check: the main path runs on an NVIDIA GPU at full width.

Usage:
    python chip_smoke.py            # one GPU: all single-card phases
    python chip_smoke.py --four     # four GPUs: only the sharded-GBA phase

Phases, in order, in one process (``--phase NAME`` runs a subset):

1. device   — JAX must report a GPU (no CPU fallback); prints the card's
              name and power limit as nvidia-smi gives them.
2. compile  — cold-compiles the flagship tracking step (752x480, 1000 ORB
              features over 8 levels, 8192-landmark local map) and the
              server GBA body (2048 KFs, 65,536 landmarks, ~2M observations)
              and prints compile seconds and ``memory_analysis()``.
3. tracking — runs the step on 32 frames of the synthetic wall world
              against a map built from the first frame; every output must be
              finite. Parity with plain references: the int8-matmul Hamming
              matrix against XOR+popcount, the FAST/blur/moment maps against
              the CPU device, tracking + pose optimization against the CPU
              device at HIGHEST precision on steady-state frames. Reads the
              extraction's share of the step from a profiler trace.
4. product  — ``cli synth --agents 2 --frames 60`` (wall world, full
              preset) in this process; both agents must end OK, the final
              GBA must run, the watchdog must stay quiet.
5. gba      — the product ``GBAJob`` -> ``_pick_solver`` path for its full
              20-iteration budget (LM it/s, ms per PCG sweep, memory
              roofline share), then 5 iterations at default precision and at
              HIGHEST against the CPU device at HIGHEST.
6. four     — (``--four`` only) the same GBA through ``make_sharded_gba``
              on four cards against the single-card solve, with a check that
              the observations really spread over the mesh.

Any failed phase makes the exit code 1. On success the last stdout line is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
Files (trace, product-run outputs) go under ``--out``.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import glob
import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))

# tolerances (reasons in PERF.md)
TRACK_INLIER_REL = 0.02       # GPU vs CPU inlier count
TRACK_TRANS_M = 1e-3          # GPU vs CPU camera centre
TRACK_ROT_RAD = 1e-4          # GPU vs CPU rotation
MAP_TOL_255 = 1e-4            # blur / moments on the 0-255 scale
GBA_COST_REL = 1e-3           # GBA cost vs the CPU (or single-card) solve
GBA_ERR_REL = 0.10            # mean pose error vs the CPU's
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Widths of every phase. The defaults are the real operating points."""
    track_frames: int = 32
    # steady-state frames (the motion model predicts them); see PERF.md for
    # the cold-start frame
    parity_frames: tuple = (8, 16, 32)
    product_agents: int = 2
    product_frames: int = 60
    gba_kfs: int = 2048
    gba_mps: int = 65536
    gba_obs_per_kf: int = 1024
    gba_iters: int = 20
    gba_cmp_iters: int = 5
    product_small: bool = False   # cli --small preset (CPU rehearsals only)


def log(msg: str) -> None:
    print(msg, flush=True)


def _nvidia_smi() -> list:
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return [ln.strip() for ln in r.stdout.splitlines() if ln.strip()]
    except (OSError, subprocess.SubprocessError) as e:
        return [f"nvidia-smi unavailable: {e}"]


def _memory_line(compiled) -> str:
    ma = compiled.memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "alias_size_in_bytes",
              "generated_code_size_in_bytes")
    parts = [f"{f.replace('_size_in_bytes', '')}="
             f"{getattr(ma, f) / 2**20:.1f}MiB"
             for f in fields if getattr(ma, f, None) is not None]
    return " ".join(parts) if parts else repr(ma)


def _pinhole_config():
    """The configuration ``cli synth`` runs: full preset, no lens
    distortion (the synthetic renderer applies none)."""
    from motioncheck_ccm_slam.config import CameraParams, Config

    return Config().replace(
        camera=CameraParams(k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0))


def _rot_angle(Ra, Rb):
    """Angle between two rotations, from ||Ra - Rb||_F = 2 sqrt(2)
    sin(angle / 2) (exact at small angles, where arccos of the trace is
    not)."""
    import numpy as np

    d = float(np.linalg.norm(np.asarray(Ra, np.float64)
                             - np.asarray(Rb, np.float64)))
    return float(2.0 * np.arcsin(min(d / (2.0 * np.sqrt(2.0)), 1.0)))


def _center(T):
    import numpy as np

    T = np.asarray(T, np.float64)
    return -T[:3, :3].T @ T[:3, 3]


# ---------------------------------------------------------------------------
# tracking-step inputs
# ---------------------------------------------------------------------------

def map_from_frame(scene, cfg, Tcw, feats):
    """A local map built from one frame's features at the scene's true
    depth: a feature on a rendered blob takes the blob's depth, any other
    lies on the textured wall (z = 7.5 in the world). Returns the nine map
    arrays of the tracking step, padded to ``client_max_mps``."""
    import numpy as np

    from motioncheck_ccm_slam.ops import orb

    nm = cfg.capacity.client_max_mps
    K = cfg.camera.K().astype(np.float64)
    Kinv = np.linalg.inv(K)
    R, t = Tcw[:3, :3].astype(np.float64), Tcw[:3, 3].astype(np.float64)
    C = -R.T @ t
    xy = np.asarray(feats.xy, np.float64)
    ok = np.asarray(feats.valid)
    octv = np.asarray(feats.octave)
    desc = np.asarray(feats.desc)

    pc = scene.pts.astype(np.float64) @ R.T + t
    z = pc[:, 2]
    vis = z > 0.2
    uvb = (pc[:, :2] / np.where(vis, z, 1.0)[:, None]) * [K[0, 0], K[1, 1]] \
        + [K[0, 2], K[1, 2]]
    rad = np.maximum(2.0, scene.radii * 6.0 / np.where(vis, z, 1.0)) + 1.5

    rays_c = np.concatenate([xy, np.ones((len(xy), 1))], 1) @ Kinv.T
    d2 = ((xy[:, None, :] - uvb[None, :, :]) ** 2).sum(-1)
    d2 = np.where(vis[None, :] & (d2 <= rad[None, :] ** 2), d2, np.inf)
    nearest = np.argmin(d2, 1)
    on_blob = np.isfinite(d2[np.arange(len(xy)), nearest])
    # blob features: the blob's camera depth; others: the wall plane
    rays_w = rays_c @ R
    s_wall = (7.5 - C[2]) / np.maximum(rays_w[:, 2], 1e-9)
    X_wall = C + s_wall[:, None] * rays_w
    X_blob = (rays_c * z[nearest][:, None] - t) @ R
    X = np.where(on_blob[:, None], X_blob, X_wall)

    sel = np.flatnonzero(ok)[:nm]
    n = len(sel)
    v = X[sel] - C
    dist = np.linalg.norm(v, axis=-1)
    sf = orb.scale_factors(cfg.extractor)
    max_d = dist * sf[octv[sel]]
    min_d = max_d / sf[-1]

    def pad(a, fill=0):
        out = np.full((nm,) + a.shape[1:], fill, a.dtype)
        out[:n] = a
        return out

    valid = np.zeros(nm, bool)
    valid[:n] = True
    return (
        pad(X[sel].astype(np.float32)),
        pad(desc[sel].astype(np.uint32)),
        pad((v / dist[:, None]).astype(np.float32)),
        pad(min_d.astype(np.float32)),
        pad(max_d.astype(np.float32), 1.0),
        valid,
    ), int(on_blob[sel].sum()), n


# ---------------------------------------------------------------------------
# trace reading
# ---------------------------------------------------------------------------

def scope_times(xplane_path, scopes):
    """Device kernel time per named scope from a profiler trace.

    A kernel that an XLA fusion launched carries its op's
    ``jax.named_scope`` path in the event's ``name`` stat. Library calls
    (cuBLAS, sort) and memsets carry none; each is given the scope of the
    kernel before it on the same stream (a program runs its ops in order).
    Returns ({scope or "other": ns}, Counter{(scope, kernel): ns})."""
    from jax.profiler import ProfileData

    totals = dict.fromkeys(tuple(scopes) + ("other",), 0)
    kernels = collections.Counter()
    for plane in ProfileData.from_file(xplane_path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            scope = "other"
            for ev in sorted(line.events, key=lambda e: e.start_ns):
                name = next((str(v) for k, v in ev.stats if k == "name"), "")
                scope = next((sc for sc in scopes if sc in name), scope)
                totals[scope] += ev.duration_ns
                kernels[(scope, ev.name)] += ev.duration_ns
    return totals, kernels


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

class Context:
    """What the phases share: output directory, widths, the tracking
    configuration, and what an earlier phase compiled or built."""

    def __init__(self, out: str, sizes: Sizes, cfg):
        self.out = out
        self.sizes = sizes
        self.cfg = cfg


def phase_compile(ctx):
    import jax

    from __graft_entry__ import entry
    from motioncheck_ccm_slam.models import gba as gba_mod
    from motioncheck_ccm_slam.utils import bigmap

    sz = ctx.sizes
    fn, args = entry(ctx.cfg)
    ctx.step_fn = jax.jit(fn)
    t0 = time.perf_counter()
    lowered = ctx.step_fn.lower(*args)
    compiled = lowered.compile()
    log(f"compile tracking step: {time.perf_counter() - t0:.1f} s "
        f"({ctx.cfg.camera.width}x{ctx.cfg.camera.height}, "
        f"{ctx.cfg.extractor.max_features} features / "
        f"{ctx.cfg.extractor.n_levels} levels, "
        f"{ctx.cfg.capacity.client_max_mps}-landmark map)")
    log(f"  memory_analysis: {_memory_line(compiled)}")
    ctx.step = compiled
    ctx.example_args = args

    t0 = time.perf_counter()
    ctx.gba_map = bigmap.build_server_scale_map(
        n_kfs=sz.gba_kfs, n_mps=sz.gba_mps, obs_per_kf=sz.gba_obs_per_kf,
        seed=0)
    m, gcfg, _ = ctx.gba_map
    job = gba_mod.GBAJob(m=m, config=gcfg, iterations=sz.gba_iters,
                         enable_motion_check=False, chunk=5)
    log(f"build server map: {time.perf_counter() - t0:.1f} s "
        f"(C={m.nk} L={m.nm} O={job.obs.cam_idx.shape[0]})")
    if job.solver is None:
        raise AssertionError("server GBA took the dense-W path")
    t0 = time.perf_counter()
    compiled = job.solver.lower(job.Tcw, job.Xw, job.obs, job.K,
                                job.fixed_j, job.fixed_lm, 5).compile()
    log(f"compile server GBA body: {time.perf_counter() - t0:.1f} s "
        f"(solver {job.solver.__qualname__.split('.')[0]})")
    log(f"  memory_analysis: {_memory_line(compiled)}")


def _ensure_compiled(ctx):
    if not hasattr(ctx, "step"):
        phase_compile(ctx)


def phase_tracking(ctx):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from motioncheck_ccm_slam.models import frame as frame_mod
    from motioncheck_ccm_slam.models.tracking import _track_two_pass
    from motioncheck_ccm_slam.ops import image as image_ops, matching, orb
    from synth_scene import SynthScene

    _ensure_compiled(ctx)
    sz, cfg = ctx.sizes, ctx.cfg
    gpu = jax.devices()[0]
    cpu = jax.devices("cpu")[0]
    scene = SynthScene(cfg, n_points=700, seed=3, speed=0.9)
    frames = list(scene.sequence(sz.track_frames + 1))
    extract = frame_mod.make_extractor(cfg)
    feats0 = extract(jnp.asarray(frames[0][2]))
    mp, n_blob, n_mp = map_from_frame(scene, cfg, frames[0][1], feats0)
    mp = tuple(jnp.asarray(a) for a in mp)
    log(f"tracking map: {n_mp} landmarks from frame 0 ({n_blob} on blobs)")

    # --- 32 frames through the compiled step ---------------------------
    Tcw_prev, Tcw_prev2 = frames[0][1], frames[0][1]
    inl, err, step_s, inputs = [], [], [], {}
    for i in range(1, sz.track_frames + 1):
        vel = Tcw_prev @ np.linalg.inv(Tcw_prev2)
        Tcw_pred = (vel @ Tcw_prev).astype(np.float32)
        args = (jnp.asarray(frames[i][2]), jnp.asarray(Tcw_pred),
                jnp.asarray(Tcw_prev.astype(np.float32))) + mp
        inputs[i] = args
        t0 = time.perf_counter()
        out = jax.block_until_ready(ctx.step(*args))
        step_s.append(time.perf_counter() - t0)
        Tcw, assoc, n_inl, vis, found = (np.asarray(o) for o in out)
        if not np.all(np.isfinite(Tcw)):
            raise AssertionError(f"frame {i}: non-finite pose")
        if not (0 <= int(n_inl) <= cfg.extractor.max_features):
            raise AssertionError(f"frame {i}: inlier count {n_inl}")
        inl.append(int(n_inl))
        err.append(float(np.linalg.norm(_center(Tcw)
                                        - _center(frames[i][1]))))
        Tcw_prev2, Tcw_prev = Tcw_prev, Tcw.astype(np.float64)
    log(f"tracking {sz.track_frames} frames: inliers min {min(inl)} "
        f"mean {np.mean(inl):.1f}; camera-centre error vs ground truth "
        f"max {max(err) * 100:.2f} cm; host step time median "
        f"{np.median(step_s[1:]) * 1e3:.2f} ms")
    if min(inl) < 30 or max(err) > 0.10:
        raise AssertionError("tracking lost the synthetic camera")

    # --- Hamming matrix: int8 matmul vs XOR + popcount -----------------
    feats = extract(jnp.asarray(frames[1][2]))
    d_map = ctx.example_args[4]          # (8192, 8) random descriptors
    ham = jax.jit(matching.hamming_matrix)(feats.desc, d_map)
    ref = jax.jit(lambda a, b: jnp.sum(matching.popcount_u32(
        a[:, None, :] ^ b[None, :, :]), -1))(feats.desc, d_map)
    n_bad = int(jnp.sum(ham != ref))
    log(f"parity hamming_matrix {feats.desc.shape[0]}x{d_map.shape[0]}: "
        f"{n_bad} mismatches (exact required)")
    if n_bad:
        raise AssertionError("hamming_matrix differs from XOR+popcount")

    # --- dense FAST / blur / IC moments: GPU vs CPU device -------------
    ex = cfg.extractor

    def maps(img):
        (c_hi, s_hi), (c_lo, s_lo) = orb.fast_response_two_thresholds(
            img, float(ex.ini_th_fast), float(ex.min_th_fast))
        m10, m01 = orb.ic_moment_maps(img, ex.half_patch_size)
        return (c_hi, c_lo, s_hi, s_lo, image_ops.gaussian_blur(img, 7, 2.0),
                m10, m01)

    img = np.asarray(frames[1][2], np.float32)
    mg = [np.asarray(a) for a in jax.jit(maps)(jax.device_put(img, gpu))]
    mc = [np.asarray(a) for a in jax.jit(maps)(jax.device_put(img, cpu))]
    mask, dxg, _ = orb._ic_angle_mask(ex.half_patch_size)
    k_l1 = float(np.abs(dxg * mask).sum())
    corner_bad = int((mg[0] != mc[0]).sum() + (mg[1] != mc[1]).sum())
    score_d = float(max(np.abs(mg[2] - mc[2]).max(),
                        np.abs(mg[3] - mc[3]).max()))
    blur_d = float(np.abs(mg[4] - mc[4]).max())
    mom_d = float(max(np.abs(mg[5] - mc[5]).max(),
                      np.abs(mg[6] - mc[6]).max())) / k_l1
    log(f"parity FAST/blur/moments {img.shape[1]}x{img.shape[0]} GPU vs CPU:"
        f" corner mismatches {corner_bad}, score max diff {score_d:.3g}, "
        f"blur max diff {blur_d:.3g}, moments max diff {mom_d:.3g} "
        f"(0-255 scale)")
    if corner_bad or blur_d > MAP_TOL_255 or mom_d > MAP_TOL_255:
        raise AssertionError("dense front-end maps differ GPU vs CPU")

    # --- tracking + pose optimization: GPU vs CPU at HIGHEST -----------
    K = jnp.asarray(cfg.camera.K())
    sf = jnp.asarray(orb.scale_factors(ex))
    inv_s2 = jnp.asarray(orb.inv_level_sigma2(ex))
    worst = (0.0, 0.0, 0.0)
    for i in sz.parity_frames:
        f = extract(inputs[i][0])
        targs = (f.xy, f.desc, f.octave, f.angle, f.valid,
                 inputs[i][1], inputs[i][2]) + mp + (
            K, cfg.camera.width, cfg.camera.height, sf, inv_s2)
        g = _track_two_pass(*targs, ex.n_levels)
        with jax.default_matmul_precision("highest"):
            c = _track_two_pass(*jax.device_put(targs, cpu), ex.n_levels)
        ng, nc = int(g[2]), int(c[2])
        dn = abs(ng - nc) / max(ng, nc, 1)
        dt = float(np.linalg.norm(_center(g[0]) - _center(c[0])))
        dr = _rot_angle(np.asarray(g[0])[:3, :3].astype(np.float64),
                        np.asarray(c[0])[:3, :3].astype(np.float64))
        log(f"parity tracking frame {i}: inliers GPU {ng} CPU {nc}, "
            f"centre diff {dt * 1e3:.4f} mm, rotation diff {dr:.3g} rad")
        worst = tuple(max(a, b) for a, b in zip(worst, (dn, dt, dr)))
    if (worst[0] > TRACK_INLIER_REL or worst[1] > TRACK_TRANS_M
            or worst[2] > TRACK_ROT_RAD):
        raise AssertionError(f"tracking parity outside tolerance {worst}")

    # --- extraction share of the step, from a profiler trace -----------
    try:
        tdir = os.path.join(ctx.out, "trace_tracking")
        jax.profiler.start_trace(tdir)
        for i in range(1, 6):
            jax.block_until_ready(ctx.step(*inputs[i]))
        jax.profiler.stop_trace()
        path = sorted(glob.glob(os.path.join(
            tdir, "plugins", "profile", "*", "*.xplane.pb")))[-1]
        totals, kernels = scope_times(path, ("orb_extract", "track"))
        all_ns = sum(totals.values())
        if not all_ns:
            raise RuntimeError("no GPU kernel events in the trace")
        log(f"trace (5 steps): device kernel time {all_ns / 5e6:.3f} ms/step"
            f" = extraction {totals['orb_extract'] / 5e6:.3f} + tracking "
            f"{totals['track'] / 5e6:.3f} + other {totals['other'] / 5e6:.3f}"
            f"; extraction share {totals['orb_extract'] / all_ns:.3f}")
        for (scope, kern), ns in kernels.most_common(8):
            log(f"  {ns / 5e3:9.1f} us/step  {scope:11s} {kern[:90]}")
    except Exception as e:   # measurement only: never fails the phase
        log(f"trace: extraction share not measured ({e!r})")


def phase_product(ctx):
    from motioncheck_ccm_slam import cli

    sz = ctx.sizes
    out = os.path.join(ctx.out, "product")
    os.makedirs(out, exist_ok=True)
    args = argparse.Namespace(
        agents=sz.product_agents, frames=sz.product_frames, out=out,
        shared_world=True, blackout=None, world="wall", arc_offset_deg=None,
        motion_check=True, small=sz.product_small, live=None, save_map=None,
        load_map=None)
    with open(os.path.join(out, "log.txt"), "w") as f, \
            contextlib.redirect_stdout(f):
        stats = cli.cmd_synth(args)
    states = {cid: a["state"] for cid, a in stats["agents"].items()}
    log(f"product run: wall_s {stats['wall_s']} n_merges "
        f"{stats['n_merges']} final_gba_done {stats['final_gba_done']} "
        f"watchdog_silent {stats['watchdog_silent']}")
    for cid, a in stats["agents"].items():
        log(f"  agent {cid}: {a['state']} frames {a['frames']} client KFs "
            f"{a['client_kfs']} MPs {a['client_mps']} relocs {a['relocs']} "
            f"ATE {a.get('ate_rmse_m')} m")
    for sm in stats["server_maps"]:
        log(f"  server map: KFs {sm['kfs']} MPs {sm['mps']} loops "
            f"{sm['loops']}")
    if (any(s != "OK" for s in states.values())
            or not stats["final_gba_done"] or stats["watchdog_silent"]):
        raise AssertionError("product run did not end healthy")


def _pose_err(Tcw, Tcw_true):
    import numpy as np

    n = Tcw_true.shape[0]
    return float(np.mean(np.linalg.norm(
        np.asarray(Tcw)[:n, :3, 3] - Tcw_true[:, :3, 3], axis=-1)))


def _timed_job(m, gcfg, iters, solver=None):
    """Compile (zero-iteration call), then run the product GBAJob for
    ``iters`` LM iterations in chunks of 5. Returns (job, seconds)."""
    import jax

    from motioncheck_ccm_slam.models import gba as gba_mod

    job = gba_mod.GBAJob(m=m, config=gcfg, iterations=iters,
                         enable_motion_check=False, chunk=5, solver=solver)
    jax.block_until_ready(job.solver(job.Tcw, job.Xw, job.obs, job.K,
                                     job.fixed_j, job.fixed_lm, 0).cost)
    t0 = time.perf_counter()
    while not job.step():
        pass
    jax.block_until_ready(job.Tcw)
    return job, time.perf_counter() - t0


def phase_gba(ctx):
    import jax
    import numpy as np

    from motioncheck_ccm_slam.parallel import sharded_ba
    from motioncheck_ccm_slam.utils import bigmap

    sz = ctx.sizes
    card = _nvidia_smi()[0]
    if not hasattr(ctx, "gba_map"):
        ctx.gba_map = bigmap.build_server_scale_map(
            n_kfs=sz.gba_kfs, n_mps=sz.gba_mps,
            obs_per_kf=sz.gba_obs_per_kf, seed=0)
    m, gcfg, Tcw_true = ctx.gba_map

    job, dt = _timed_job(m, gcfg, sz.gba_iters)
    O = job.obs.cam_idx.shape[0]
    sweeps = job.pcg_sweeps
    _, dt0 = _timed_job(m, gcfg, sz.gba_iters,
                        solver=sharded_ba.make_matrix_free_gba(pcg_iters=0))
    ms_sweep = (dt - dt0) / max(sweeps, 1) * 1e3
    # bytes a sweep must read: both W copies (6x3 f32 per obs) and both
    # index streams (i32 per obs)
    sweep_bytes = O * (2 * 18 * 4 + 2 * 4)
    roof_ms = sweep_bytes / HBM_BYTES_PER_S * 1e3
    log(f"server GBA [{card}] C={m.nk} L={m.nm} O={O}: "
        f"{sz.gba_iters} LM iterations in {dt:.3f} s = "
        f"{sz.gba_iters / dt:.3f} LM it/s, {sweeps} PCG sweeps, "
        f"no-sweep run {dt0:.3f} s -> {ms_sweep:.3f} ms per PCG sweep; "
        f"memory roofline {roof_ms:.4f} ms/sweep ({sweep_bytes / 1e6:.1f} MB"
        f" at 3.35 TB/s) -> share {roof_ms / ms_sweep:.3f}; cost "
        f"{job._cost:.6g}, mean pose err {_pose_err(job.Tcw, Tcw_true):.5f}")

    def run(mm):
        j, _ = _timed_job(mm, gcfg, sz.gba_cmp_iters)
        return j._cost, _pose_err(j.Tcw, Tcw_true)

    res = {"default": run(m)}
    with jax.default_matmul_precision("highest"):
        res["highest"] = run(m)
    cpu = jax.devices("cpu")[0]
    t0 = time.perf_counter()
    with jax.default_device(cpu), jax.default_matmul_precision("highest"):
        m_cpu, _, _ = bigmap.build_server_scale_map(
            n_kfs=sz.gba_kfs, n_mps=sz.gba_mps,
            obs_per_kf=sz.gba_obs_per_kf, seed=0)
        cpu_cost, cpu_err = run(m_cpu)
    log(f"CPU reference ({sz.gba_cmp_iters} LM it, float32 HIGHEST): cost "
        f"{cpu_cost:.6g}, mean pose err {cpu_err:.5f} "
        f"({time.perf_counter() - t0:.1f} s)")
    ok = True
    for name, (cost, err) in res.items():
        dc = abs(cost - cpu_cost) / max(abs(cpu_cost), 1e-12)
        de = abs(err - cpu_err) / max(cpu_err, 1e-12)
        good = dc <= GBA_COST_REL and de <= GBA_ERR_REL
        log(f"parity GBA GPU precision={name}: cost {cost:.6g} "
            f"(rel diff {dc:.3g}), mean pose err {err:.5f} "
            f"(rel diff {de:.3g}) -> {'ok' if good else 'OUTSIDE'}")
        ok &= good if name == "default" else True
    if not ok:
        raise AssertionError("GBA at default precision misses the CPU "
                             "reference")


def phase_four(ctx):
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from motioncheck_ccm_slam.models import gba as gba_mod
    from motioncheck_ccm_slam.parallel import sharded_ba
    from motioncheck_ccm_slam.utils import bigmap

    sz = ctx.sizes
    devs = jax.devices()
    if len(devs) != 4:
        raise AssertionError(f"--four needs 4 GPUs, JAX has {len(devs)}")
    m, gcfg, Tcw_true = bigmap.build_server_scale_map(
        n_kfs=sz.gba_kfs, n_mps=sz.gba_mps, obs_per_kf=sz.gba_obs_per_kf,
        seed=0)
    gba_mod._matrix_free_cache.clear()
    solver = gba_mod._pick_solver(m.nk, m.nm)
    name = solver.__qualname__.split(".")[0]
    if name != "make_sharded_gba":
        raise AssertionError(f"4 devices routed to {name}")

    # the observations really spread over the mesh
    probe = gba_mod.GBAJob(m=m, config=gcfg, iterations=1,
                           enable_motion_check=False)
    mesh = Mesh(np.array(devs), (sharded_ba.AXIS,))
    placed = sharded_ba.shard_obs(sharded_ba._pad_obs(probe.obs, 4), mesh)
    O = probe.obs.cam_idx.shape[0]
    for a in placed:
        where = sorted(s.device.id for s in a.addressable_shards)
        rows = {s.data.shape[0] for s in a.addressable_shards}
        if where != [d.id for d in devs] or rows != {-(-O // 4)}:
            raise AssertionError(f"obs not spread: devices {where} "
                                 f"rows {rows}")
    log(f"obs spread: {len(placed)} arrays x 4 devices, "
        f"{-(-O // 4)} rows each")
    del placed, probe

    job4, dt4 = _timed_job(m, gcfg, sz.gba_iters)
    used = [(d.memory_stats() or {}).get("peak_bytes_in_use", 0)
            for d in devs]
    log(f"mesh GBA [{'; '.join(_nvidia_smi())}] 4 devices: "
        f"{sz.gba_iters / dt4:.3f} LM it/s, cost {job4._cost:.6g}, mean "
        f"pose err {_pose_err(job4.Tcw, Tcw_true):.5f}, PCG sweeps "
        f"{job4.pcg_sweeps}; peak MiB per device "
        f"{[round(u / 2**20) for u in used]}")
    if devs[0].platform == "gpu" and min(used[1:]) < O // 4 * 20:
        raise AssertionError("devices 1-3 hold less than their obs shard")

    job1, dt1 = _timed_job(m, gcfg, sz.gba_iters,
                           solver=sharded_ba.make_matrix_free_gba())
    e1 = _pose_err(job1.Tcw, Tcw_true)
    e4 = _pose_err(job4.Tcw, Tcw_true)
    dc = abs(job4._cost - job1._cost) / max(abs(job1._cost), 1e-12)
    de = abs(e4 - e1) / max(e1, 1e-12)
    log(f"single-card GBA (device 0): {sz.gba_iters / dt1:.3f} LM it/s, "
        f"cost {job1._cost:.6g}, mean pose err {e1:.5f}; mesh vs single: "
        f"cost rel diff {dc:.3g}, pose err rel diff {de:.3g}")
    if dc > GBA_COST_REL or de > GBA_ERR_REL:
        raise AssertionError("4-device GBA differs from the single card")


PHASES = {
    "compile": phase_compile,
    "tracking": phase_tracking,
    "product": phase_product,
    "gba": phase_gba,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU sharded-GBA phase")
    ap.add_argument("--phase", action="append", choices=sorted(PHASES),
                    help="run only these single-card phases (repeatable)")
    ap.add_argument("--out", default=os.path.join("runs", "chip_smoke"))
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {devs[0].platform}",
              file=sys.stderr)
        return 1
    for line in _nvidia_smi():
        log(f"card: {line}")
    log(f"jax {jax.__version__}: {devs[0].platform} {devs[0].device_kind} "
        f"x{len(devs)}")

    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    from motioncheck_ccm_slam.utils import compile_cache

    log(f"compile cache: {compile_cache.enable()}")
    os.makedirs(args.out, exist_ok=True)
    ctx = Context(args.out, Sizes(), _pinhole_config())
    if args.four:
        phases = [("four", phase_four)]
    else:
        phases = [(n, f) for n, f in PHASES.items()
                  if not args.phase or n in args.phase]
    failed = []
    t_all = time.perf_counter()
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn(ctx)
            status = "ok"
        except Exception:
            traceback.print_exc()
            sys.stdout.flush()
            failed.append(name)
            status = "FAILED"
        log(f"[phase {name}] {status} in {time.perf_counter() - t0:.1f} s")
    log(f"total {time.perf_counter() - t_all:.1f} s")
    if failed:
        log(f"chip_smoke: failed phases {failed}")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
