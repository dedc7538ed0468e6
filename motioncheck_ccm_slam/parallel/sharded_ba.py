"""Global bundle adjustment: matrix-free Schur-PCG on one device or a mesh.

The replacement for g2o's ``MapFusionGBA`` + OpenMP (reference
src/Optimizer.cpp:646, optimizer.initMultiThreading :792). Two entry
points share the PCG loop and the LM accept/reject rule:

- :func:`make_matrix_free_gba` (one device): component-major dual-layout
  iteration over a camera-major observation stream; no O(C*L) memory.
- :func:`make_sharded_gba` (a 1-D device mesh): the observation set is
  sharded across the mesh's ``obs`` axis, camera poses and landmarks are
  replicated. Each LM iteration computes residuals and Jacobians on the
  local shard, assembles per-entity Hessian blocks by segment-sum and
  ``psum``s them, solves the reduced camera system matrix-free (every
  ``S @ v`` is two gather/segment-sum sweeps over the local shard plus a
  ``psum``), then back-substitutes landmarks and accepts or rejects.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..solvers import ba_core
from ..solvers.local_ba import BAResult, _robust_cost

AXIS = "obs"

# Eisenstat-Walker forcing for the inner PCG solve: the reduced camera
# system only needs to be solved as accurately as the outer LM
# linearization warrants. rtol_k = clip(sqrt(|g_k| / |g_0|), EW_FLOOR,
# EW_MAX) — loose solves while the gradient is large (early LM
# iterations), tightening toward EW_FLOOR as the gradient drops. The exact
# cost re-evaluation gates every step, so a too-loose step can only be
# rejected, never silently accepted; truncated early solves leave more of
# the sweep budget to the later, tighter ones.
#
# On SMALL systems the tradeoff inverts: a tight solve costs microseconds,
# and at short iteration budgets loose early steps waste LM iterations
# (measured on the 8-camera fixture: final pose error ~2x worse). Forcing
# only engages at EW_MIN_CAMS+ cameras, where a sweep is expensive.
EW_MAX = 0.1
EW_FLOOR = 1e-5
EW_MIN_CAMS = 512


def _ew_rtol(gnorm, g0, n_cams: int):
    """Forcing tolerance from the current/initial reduced-gradient norms.

    ``g0 < 0`` marks the first LM iteration (no reference yet) -> EW_MAX.
    ``n_cams`` is static: below EW_MIN_CAMS this collapses to the fixed
    tight tolerance.
    """
    if n_cams < EW_MIN_CAMS:
        return EW_FLOOR
    ratio = jnp.where(g0 > 0, gnorm / jnp.maximum(g0, 1e-30), 1.0)
    return jnp.clip(jnp.sqrt(ratio), EW_FLOOR, EW_MAX)


def _pad_obs(obs: ba_core.BAObservations, n_dev: int) -> ba_core.BAObservations:
    O = obs.cam_idx.shape[0]
    pad = (-O) % n_dev
    if pad == 0:
        return obs
    return ba_core.BAObservations(
        cam_idx=jnp.pad(obs.cam_idx, (0, pad)),
        lm_idx=jnp.pad(obs.lm_idx, (0, pad)),
        uv=jnp.pad(obs.uv, ((0, pad), (0, 0))),
        inv_sigma2=jnp.pad(obs.inv_sigma2, (0, pad)),
        valid=jnp.pad(obs.valid, (0, pad)),
    )


def _schur_matvec(v, Hcc_d, Hll_inv, Wcl, cam_idx, lm_idx, C, L, reduce):
    """S @ v for the reduced camera system, on the local obs shard + psum.

    v: (C, 6) replicated. Wcl: (O_local, 6, 3). ``reduce`` is a psum over
    the mesh's obs axis, or identity when running unsharded on one device.
    """
    Hv = jnp.einsum("cij,cj->ci", Hcc_d, v)
    # u_l = sum_obs Wcl^T v[cam]  -> (L, 3)
    wtv = jnp.einsum("oij,oi->oj", Wcl, v[cam_idx])
    u = reduce(ba_core.segment_sum(lm_idx, wtv, L))
    u = jnp.einsum("lij,lj->li", Hll_inv, u)
    # w_c = sum_obs Wcl u[lm]    -> (C, 6)
    wu = jnp.einsum("oij,oj->oi", Wcl, u[lm_idx])
    w = reduce(ba_core.segment_sum(cam_idx, wu, C))
    return Hv - w


def _pcg(matvec, b, M_inv_blocks, iters: int, rtol=1e-5):
    """Block-Jacobi preconditioned CG on the (C,6) camera system.

    Returns (x, sweeps run). Runs at most ``iters`` sweeps with residual-
    based early exit: the loop stops once the preconditioned residual norm
    r.z drops below rtol^2 * (r0.z0) — converged LM steps skip the remaining
    sweeps instead of burning a fixed budget. ``rtol`` may be a traced
    scalar (the LM loop passes an Eisenstat-Walker forcing tolerance). All
    loop-carried scalars are replicated under shard_map (matvec psums before
    any reduction), so the exit condition is consistent across devices.
    """

    def precond(r):
        return jnp.einsum("cij,cj->ci", M_inv_blocks, r)

    x0 = jnp.zeros_like(b)
    r0 = b
    z0 = precond(r0)
    rz0 = jnp.sum(r0 * z0)
    thresh = (rtol * rtol) * rz0

    def cond(state):
        _x, _r, _z, _p, rz, i = state
        return (i < iters) & (rz > thresh)

    def body(state):
        x, r, z, p, rz, i = state
        Ap = matvec(p)
        pAp = jnp.sum(p * Ap)
        alpha = rz / jnp.where(jnp.abs(pAp) < 1e-12, 1.0, pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = jnp.sum(r * z)
        beta = rz_new / jnp.where(jnp.abs(rz) < 1e-12, 1.0, rz)
        p = z + beta * p
        return x, r, z, p, rz_new, i + 1

    x, _r, _z, _p, _rz, n = jax.lax.while_loop(
        cond, body, (x0, r0, z0, z0, rz0, jnp.int32(0))
    )
    return x, n


def _gba_iteration(state, obs_shard: ba_core.BAObservations, K, fixed_cam,
                   fixed_lm, C, L, pcg_iters, reduce):
    Tcw, Xw, lam, g0, sweeps = state
    r, pc, depth_ok = ba_core.reproject_residuals(Tcw, Xw, obs_shard, K)
    w, chi2 = ba_core.robust_obs_weights(r, obs_shard, depth_ok)
    cost = reduce(_robust_cost(chi2, obs_shard.valid))
    Rm = Tcw[obs_shard.cam_idx][:, :3, :3]
    Jc, Jl = ba_core.reproject_jacobians(pc, Rm, K)
    Hcc, bc, Hll, bl, Wcl = ba_core.assemble_blocks(
        Jc, Jl, r, w, obs_shard.cam_idx, obs_shard.lm_idx, C, L)
    Hcc = reduce(Hcc)
    bc = reduce(bc)
    Hll = reduce(Hll)
    bl = reduce(bl)

    Hcc_d = ba_core.damp_blocks(Hcc, lam)
    Hll_d = ba_core.damp_blocks(Hll, lam)
    eye6 = jnp.eye(6, dtype=Hcc.dtype)
    Hcc_d = jnp.where(fixed_cam[:, None, None], eye6[None], Hcc_d)
    bc = jnp.where(fixed_cam[:, None], 0.0, bc)
    Hll_d = jnp.where(
        fixed_lm[:, None, None], jnp.eye(3, dtype=Hll.dtype)[None], Hll_d
    )
    bl = jnp.where(fixed_lm[:, None], 0.0, bl)
    Wcl = jnp.where(
        fixed_cam[obs_shard.cam_idx][:, None, None]
        | fixed_lm[obs_shard.lm_idx][:, None, None],
        0.0, Wcl,
    )
    Hll_inv = ba_core.inv33(Hll_d)

    # reduced RHS: br = bc - W Hll^-1 bl
    u = jnp.einsum("lij,lj->li", Hll_inv, bl)
    wu = jnp.einsum("oij,oj->oi", Wcl, u[obs_shard.lm_idx])
    Wu = reduce(ba_core.segment_sum(obs_shard.cam_idx, wu, C))
    br = bc - Wu

    matvec = functools.partial(
        _schur_matvec, Hcc_d=Hcc_d, Hll_inv=Hll_inv, Wcl=Wcl,
        cam_idx=obs_shard.cam_idx, lm_idx=obs_shard.lm_idx, C=C, L=L,
        reduce=reduce,
    )
    # block-Jacobi on the TRUE Schur diagonal (see _gba_iteration_cm)
    WG = jnp.einsum("oij,ojk->oik", Wcl, Hll_inv[obs_shard.lm_idx])
    S_obs = jnp.einsum("oik,ojk->oij", WG, Wcl)
    S_diag = Hcc_d - reduce(ba_core.segment_sum(obs_shard.cam_idx, S_obs, C))
    M_inv = ba_core.inv66_spd(S_diag + 1e-6 * eye6[None])
    gnorm = jnp.linalg.norm(br)
    g0 = jnp.where(g0 > 0, g0, gnorm)
    dc, n_sw = _pcg(matvec, br, M_inv, pcg_iters,
                    rtol=_ew_rtol(gnorm, g0, C))
    dc = jnp.where(fixed_cam[:, None], 0.0, dc)
    # back-substitute landmarks: dl = Hll^-1 (bl - W^T dc)
    wtv = jnp.einsum("oij,oi->oj", Wcl, dc[obs_shard.cam_idx])
    Wt_dc = reduce(ba_core.segment_sum(obs_shard.lm_idx, wtv, L))
    dl = jnp.einsum("lij,lj->li", Hll_inv, bl - Wt_dc)
    dl = jnp.where(fixed_lm[:, None], 0.0, dl)

    T_new = ba_core.apply_pose_update(Tcw, dc, mask=~fixed_cam)
    X_new = Xw + dl
    r2, _, _ = ba_core.reproject_residuals(T_new, X_new, obs_shard, K)
    chi2_new = jnp.sum(r2 * r2, -1) * obs_shard.inv_sigma2
    cost_new = reduce(_robust_cost(chi2_new, obs_shard.valid))
    accept = cost_new < cost
    Tcw = jnp.where(accept, T_new, Tcw)
    Xw = jnp.where(accept, X_new, Xw)
    lam = jnp.where(accept, jnp.maximum(lam * 0.5, 1e-8),
                    jnp.minimum(lam * 4.0, 1e4))
    return (Tcw, Xw, lam, g0, sweeps + n_sw), cost_new


def _gba_body(Tcw, Xw, K, fixed_cam, fixed_lm, n_iters,
              cam_idx, lm_idx, uv, inv_sigma2, valid,
              pcg_iters, reduce):
    """n_iters LM iterations + final inlier classification on the (local)
    observation set. ``n_iters`` is a traced scalar — chunked callers vary
    it without recompiling."""
    obs_shard = ba_core.BAObservations(
        cam_idx=cam_idx, lm_idx=lm_idx, uv=uv,
        inv_sigma2=inv_sigma2, valid=valid,
    )
    C = Tcw.shape[0]
    L = Xw.shape[0]

    def it(_, st):
        st, _cost = _gba_iteration(
            st, obs_shard, K, fixed_cam, fixed_lm, C, L, pcg_iters, reduce)
        return st

    Tcw, Xw, lam, _g0, sweeps = jax.lax.fori_loop(
        0, n_iters, it,
        (Tcw, Xw, jnp.float32(1e-4), jnp.float32(-1.0), jnp.int32(0))
    )
    # final classification on the local shard
    r, _, depth_ok = ba_core.reproject_residuals(Tcw, Xw, obs_shard, K)
    chi2 = jnp.sum(r * r, -1) * obs_shard.inv_sigma2
    inlier = obs_shard.valid & (chi2 <= ba_core.CHI2_MONO) & depth_ok
    cost = reduce(_robust_cost(chi2, inlier))
    return Tcw, Xw, inlier, cost, sweeps


def make_sharded_gba(mesh: Mesh, iterations: int = 5, pcg_iters: int = 25):
    """Build a jitted distributed GBA step for a 1-D mesh.

    Returns ``gba(Tcw, Xw, obs, K, fixed_cam, fixed_lm, n_iterations)`` — a
    ``BAResult``-returning callable matching gba.run_gba's
    ``sharded_solver`` interface. ``iterations`` is only the default;
    per-call ``n_iterations`` is dynamic (no recompile across chunk sizes).
    """
    n_dev = mesh.devices.size

    def shard_body(Tcw, Xw, K, fixed_cam, fixed_lm, n_iters,
                   cam_idx, lm_idx, uv, inv_sigma2, valid):
        return _gba_body(
            Tcw, Xw, K, fixed_cam, fixed_lm, n_iters,
            cam_idx, lm_idx, uv, inv_sigma2, valid,
            pcg_iters, functools.partial(jax.lax.psum, axis_name=AXIS),
        )

    sharded = jax.jit(
        jax.shard_map(
            shard_body, mesh=mesh,
            in_specs=(P(), P(), P(), P(), P(), P(),
                      P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS)),
            out_specs=(P(), P(), P(AXIS), P(), P()),
        )
    )

    def _args(Tcw, Xw, obs, K, fixed_cam, fixed_lm, n_iterations=None):
        n_it = jnp.int32(iterations if n_iterations is None else n_iterations)
        return (Tcw, Xw, K, fixed_cam, fixed_lm, n_it,
                *shard_obs(_pad_obs(obs, n_dev), mesh))

    def gba(Tcw, Xw, obs: ba_core.BAObservations, K, fixed_cam, fixed_lm,
            n_iterations=None):
        Tcw_o, Xw_o, inlier, cost, sweeps = sharded(
            *_args(Tcw, Xw, obs, K, fixed_cam, fixed_lm, n_iterations))
        return BAResult(Tcw=Tcw_o, Xw=Xw_o,
                        obs_inlier=inlier[:obs.cam_idx.shape[0]],
                        cost=cost, pcg_sweeps=sweeps)

    def lower(*a, **kw):
        """The jitted program lowered for these arguments (compile
        inspection)."""
        return sharded.lower(*_args(*a, **kw))

    gba.lower = lower
    return gba


def shard_obs(obs: ba_core.BAObservations, mesh: Mesh):
    """Place each observation array in row blocks over the mesh's ``obs``
    axis (the row count must divide the mesh size; see ``_pad_obs``)."""
    return jax.device_put(tuple(obs), NamedSharding(mesh, P(AXIS)))


def _rep_cam(x, seg: int):
    """(..., C) -> (..., C*seg): per-observation camera quantity for a
    camera-major contiguous observation stream — a broadcast+reshape, never
    a gather."""
    b = jnp.broadcast_to(x[..., None], x.shape + (seg,))
    return b.reshape(x.shape[:-1] + (x.shape[-1] * seg,))


def _cam_sum_t(x, C: int, seg: int):
    """(..., C*seg) -> (..., C) reshape-sum."""
    return x.reshape(x.shape[:-1] + (C, seg)).sum(-1)


def _lm_sum_t(x_sorted, lm_sorted, L: int):
    """(..., O) sorted by landmark -> (..., L): per-landmark sums along the
    minor axis. Each segment is summed on its own (a sorted scatter-add); a
    cumsum + boundary difference would carry the rounding error of the
    whole prefix into every segment (relative error ~eps * O / segment
    length, about 1e-2 on a late landmark's Hll at 2M observations)."""
    out = jnp.zeros(x_sorted.shape[:-1] + (L,), x_sorted.dtype)
    return out.at[..., lm_sorted].add(x_sorted, indices_are_sorted=True)


def _obs_pipeline(R_t, t_t, X_t, uv_t, inv_sigma2, valid, K):
    """Residual + Jacobian pipeline for one observation stream in
    component-major layout (every array (components..., O), the obs axis
    minor). Pure per-element arithmetic: producing
    the same observations in a different order yields bitwise-identical
    values, which the dual-layout iteration below relies on."""
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    pc = jnp.einsum("ijo,jo->io", R_t, X_t) + t_t              # (3,O)
    z = pc[2]
    depth_ok = z > 1e-6
    zs = jnp.where(depth_ok, z, 1.0)
    iz = 1.0 / zs
    r_t = uv_t - jnp.stack([fx * pc[0] * iz + cx,
                            fy * pc[1] * iz + cy])             # (2,O)
    chi2 = jnp.sum(r_t * r_t, 0) * inv_sigma2
    w = inv_sigma2 * ba_core.huber_weights(chi2)
    w = jnp.where(valid & depth_ok, w, 0.0)                    # (O,)
    # dproj/dpc (2,3,O); dpc/dxi = [-hat(pc) | I] (3,6,O); dpc/dX = R
    iz2 = iz * iz
    zo = jnp.zeros_like(z)
    dproj = jnp.stack([
        jnp.stack([fx * iz, zo, -fx * pc[0] * iz2]),
        jnp.stack([zo, fy * iz, -fy * pc[1] * iz2]),
    ])                                                         # (2,3,O)
    one = jnp.ones_like(z)
    hat = jnp.stack([
        jnp.stack([zo, -pc[2], pc[1]]),
        jnp.stack([pc[2], zo, -pc[0]]),
        jnp.stack([-pc[1], pc[0], zo]),
    ])                                                         # (3,3,O)
    eye_t = jnp.stack([
        jnp.stack([one, zo, zo]),
        jnp.stack([zo, one, zo]),
        jnp.stack([zo, zo, one]),
    ])
    dpc_dxi = jnp.concatenate([-hat, eye_t], 1)                # (3,6,O)
    Jc = -jnp.einsum("ijo,jko->iko", dproj, dpc_dxi)           # (2,6,O)
    Jl = -jnp.einsum("ijo,jko->iko", dproj, R_t)               # (2,3,O)
    return r_t, chi2, w, Jc, Jl


def _gba_iteration_cm(state, K, fixed_cam, fixed_lm, C, L, seg, pcg_iters,
                      uv_t, inv_sigma2, valid, lm_idx,
                      cam_idx_l, lm_sorted, uv_s, is2_s, valid_s):
    """One LM iteration in DUAL-LAYOUT component-major form.

    The observation stream is materialized in BOTH orders, so no
    per-observation data is permuted inside the PCG loop:

    - camera-major (obs o = c*seg + i): camera quantities form by
      broadcast+reshape, camera reductions by reshape-sum; produces Hcc, bc
      and the cam-side W copy ``Wcl_t``.
    - landmark-sorted (static host permutation ``lm_order``): landmark
      reductions are sorted segment sums with NO in-graph permute;
      camera quantities gather from the tiny (6,C)/(3,3,C) tables;
      produces Hll, bl and the lm-side W copy ``Wl_t``.

    The residual/Jacobian pipeline runs once per layout (pure streaming
    arithmetic). Per-element results are bitwise identical across layouts,
    so the PCG operator stays exactly symmetric. Each Schur matvec is then:
    small-table gather -> einsum -> sorted segment sum -> 3x3 solve ->
    (3,L)->(3,O) gather -> einsum -> reshape-sum.
    """
    Tcw, Xw, lam, g0, sweeps = state

    # ---- camera-major pass -------------------------------------------
    R_t = _rep_cam(jnp.moveaxis(Tcw[:, :3, :3], 0, -1), seg)   # (3,3,O)
    t_t = _rep_cam(Tcw[:, :3, 3].T, seg)                       # (3,O)
    X_t = Xw.T[:, lm_idx]                                      # (3,O) gather
    r_t, chi2, w, Jc, Jl = _obs_pipeline(
        R_t, t_t, X_t, uv_t, inv_sigma2, valid, K)
    cost = _robust_cost(chi2, valid)
    wJc = Jc * w
    # camera blocks as obs-major streams + reshape-sum: a per-camera
    # einsum ("kics,kjcs->cij") would lower to C batched (6 x seg)@(seg x 6)
    # matmuls, which stream no faster than this elementwise form
    P66 = jnp.einsum("kio,kjo->ijo", wJc, Jc)                  # (6,6,O)
    Hcc = jnp.moveaxis(P66.reshape(6, 6, C, seg).sum(-1), -1, 0)  # (C,6,6)
    bc = -jnp.einsum("kio,ko->io", wJc, r_t).reshape(
        6, C, seg).sum(-1).T                                   # (C,6)
    Wcl_t = jnp.einsum("kio,kjo->ijo", wJc, Jl)                # (6,3,O)

    # ---- landmark-sorted pass ----------------------------------------
    Rc_t = jnp.moveaxis(Tcw[:, :3, :3], 0, -1)                 # (3,3,C)
    R_l = Rc_t[:, :, cam_idx_l]                                # small-src gather
    t_l = Tcw[:, :3, 3].T[:, cam_idx_l]
    X_l = Xw.T[:, lm_sorted]                                   # sorted gather
    r_l, _chi2_l, w_l, Jc_l, Jl_l = _obs_pipeline(
        R_l, t_l, X_l, uv_s, is2_s, valid_s, K)
    wJl_l = Jl_l * w_l
    Hll = jnp.moveaxis(
        _lm_sum_t(jnp.einsum("kio,kjo->ijo", wJl_l, Jl_l), lm_sorted, L),
        -1, 0)                                                 # (L,3,3)
    bl = -_lm_sum_t(jnp.einsum("kio,ko->io", wJl_l, r_l), lm_sorted, L).T
    Wl_t = jnp.einsum("kio,kjo->ijo", Jc_l * w_l, Jl_l)        # (6,3,O)

    # ---- damping / gauge fixing ---------------------------------------
    Hcc_d = ba_core.damp_blocks(Hcc, lam)
    Hll_d = ba_core.damp_blocks(Hll, lam)
    eye6 = jnp.eye(6, dtype=Hcc.dtype)
    Hcc_d = jnp.where(fixed_cam[:, None, None], eye6[None], Hcc_d)
    bc = jnp.where(fixed_cam[:, None], 0.0, bc)
    Hll_d = jnp.where(
        fixed_lm[:, None, None], jnp.eye(3, dtype=Hll.dtype)[None], Hll_d
    )
    bl = jnp.where(fixed_lm[:, None], 0.0, bl)
    free_obs = ~(_rep_cam(fixed_cam[None], seg)[0] | fixed_lm[lm_idx])
    Wcl_t = jnp.where(free_obs, Wcl_t, 0.0)
    free_obs_l = ~(fixed_cam[cam_idx_l] | fixed_lm[lm_sorted])
    Wl_t = jnp.where(free_obs_l, Wl_t, 0.0)
    Hll_inv = ba_core.inv33(Hll_d)
    Hll_inv_t = jnp.moveaxis(Hll_inv, 0, -1)                   # (3,3,L)

    # ---- reduced camera system ----------------------------------------
    def lm_solve_t(x_t):                                       # (3,L)->(3,L)
        return jnp.einsum("ijl,jl->il", Hll_inv_t, x_t)

    def matvec(v):                                             # (C,6)
        Hv = jnp.einsum("cij,cj->ci", Hcc_d, v)
        vgl = v.T[:, cam_idx_l]                                # (6,O) tiny-src
        wtv = jnp.einsum("ijo,io->jo", Wl_t, vgl)              # (3,O)
        u = lm_solve_t(_lm_sum_t(wtv, lm_sorted, L))           # (3,L)
        ug = u[:, lm_idx]                                      # (3,O) gather
        wu = jnp.einsum("ijo,jo->io", Wcl_t, ug)               # (6,O)
        return Hv - _cam_sum_t(wu, C, seg).T

    u0 = lm_solve_t(bl.T)
    br = bc - _cam_sum_t(
        jnp.einsum("ijo,jo->io", Wcl_t, u0[:, lm_idx]), C, seg
    ).T
    # block-Jacobi preconditioner on the TRUE Schur diagonal
    # M_c = Hcc_c - sum_{o in c} w_o Hll^-1[l(o)] w_o^T  — one extra
    # assembly-shaped pass per LM iteration, but it tracks S (not just Hcc)
    # and with residual early exit buys back whole PCG sweeps.
    # (obs-major product + reshape-sum, as for Hcc above.)
    G = Hll_inv_t[:, :, lm_idx]                                # (3,3,O)
    WG = jnp.einsum("ijo,jko->iko", Wcl_t, G)                  # (6,3,O)
    S66 = jnp.einsum("iko,jko->ijo", WG, Wcl_t)                # (6,6,O)
    S_diag = Hcc_d - jnp.moveaxis(
        S66.reshape(6, 6, C, seg).sum(-1), -1, 0)
    M_inv = ba_core.inv66_spd(S_diag + 1e-6 * eye6[None])
    gnorm = jnp.linalg.norm(br)
    g0 = jnp.where(g0 > 0, g0, gnorm)
    dc, n_sw = _pcg(matvec, br, M_inv, pcg_iters,
                    rtol=_ew_rtol(gnorm, g0, C))
    dc = jnp.where(fixed_cam[:, None], 0.0, dc)

    # ---- landmark back-substitution -----------------------------------
    # dl = Hll^-1 (bl - W^T dc)
    wtv = jnp.einsum("ijo,io->jo", Wl_t, dc.T[:, cam_idx_l])
    dl = lm_solve_t(bl.T - _lm_sum_t(wtv, lm_sorted, L)).T
    dl = jnp.where(fixed_lm[:, None], 0.0, dl)

    # ---- accept / reject ----------------------------------------------
    T_new = ba_core.apply_pose_update(Tcw, dc, mask=~fixed_cam)
    X_new = Xw + dl
    R2_t = _rep_cam(jnp.moveaxis(T_new[:, :3, :3], 0, -1), seg)
    t2_t = _rep_cam(T_new[:, :3, 3].T, seg)
    pc2 = jnp.einsum("ijo,jo->io", R2_t, X_new.T[:, lm_idx]) + t2_t
    z2 = jnp.where(pc2[2] > 1e-6, pc2[2], 1.0)
    r2 = uv_t - jnp.stack([K[0, 0] * pc2[0] / z2 + K[0, 2],
                           K[1, 1] * pc2[1] / z2 + K[1, 2]])
    cost_new = _robust_cost(jnp.sum(r2 * r2, 0) * inv_sigma2, valid)
    accept = cost_new < cost
    Tcw = jnp.where(accept, T_new, Tcw)
    Xw = jnp.where(accept, X_new, Xw)
    lam = jnp.where(accept, jnp.maximum(lam * 0.5, 1e-8),
                    jnp.minimum(lam * 4.0, 1e4))
    return (Tcw, Xw, lam, g0, sweeps + n_sw), cost_new


def make_matrix_free_gba(iterations: int = 5, pcg_iters: int = 25):
    """Single-device matrix-free GBA in component-major layout
    (:func:`_gba_iteration_cm`). This is what ``run_gba`` picks on one
    device when the dense-W Schur solve would not fit (server operating
    point: 2048 KFs x 65k MPs would need a ~9.7 GB dense W — reference
    scale, per src/Optimizer.cpp:646 MapFusionGBA).

    Requires camera-major contiguous observations (O = C * F) — exactly
    what map_state.gather_observations produces. The landmark sort order is
    built on host once per problem and cached by array identity (strong
    refs, so a recycled id() can never alias a stale plan)."""

    bodies = {}
    plan_cache: list = [None]

    def _get_body(seg: int):
        if seg not in bodies:
            def body_fn(Tcw, Xw, K, fixed_cam, fixed_lm, n_iters,
                        uv_t, inv_sigma2, valid, lm_idx, lm_order,
                        cam_idx_l, lm_sorted):
                C = Tcw.shape[0]
                L = Xw.shape[0]
                # loop-invariant landmark-sorted streams: permute once per
                # call, outside the LM loop (the iteration itself never
                # permutes per-observation data)
                uv_s = uv_t[:, lm_order]
                is2_s = inv_sigma2[lm_order]
                valid_s = valid[lm_order]

                def it(_, st):
                    st, _cost = _gba_iteration_cm(
                        st, K, fixed_cam, fixed_lm, C, L, seg, pcg_iters,
                        uv_t, inv_sigma2, valid, lm_idx,
                        cam_idx_l, lm_sorted, uv_s, is2_s, valid_s,
                    )
                    return st

                Tcw_o, Xw_o, lam, _g0, sweeps = jax.lax.fori_loop(
                    0, n_iters, it,
                    (Tcw, Xw, jnp.float32(1e-4), jnp.float32(-1.0),
                     jnp.int32(0))
                )
                # final inlier classification
                R_t = _rep_cam(jnp.moveaxis(Tcw_o[:, :3, :3], 0, -1), seg)
                t_t = _rep_cam(Tcw_o[:, :3, 3].T, seg)
                pc = jnp.einsum("ijo,jo->io", R_t, Xw_o.T[:, lm_idx]) + t_t
                depth_ok = pc[2] > 1e-6
                zs = jnp.where(depth_ok, pc[2], 1.0)
                r = uv_t - jnp.stack([
                    K[0, 0] * pc[0] / zs + K[0, 2],
                    K[1, 1] * pc[1] / zs + K[1, 2],
                ])
                chi2 = jnp.sum(r * r, 0) * inv_sigma2
                inlier = valid & (chi2 <= ba_core.CHI2_MONO) & depth_ok
                cost = _robust_cost(chi2, inlier)
                return Tcw_o, Xw_o, inlier, cost, sweeps
            bodies[seg] = jax.jit(body_fn)
        return bodies[seg]

    def _args(Tcw, Xw, obs, K, fixed_cam, fixed_lm, n_iterations=None):
        n_it = jnp.int32(iterations if n_iterations is None else n_iterations)
        C, L = Tcw.shape[0], Xw.shape[0]
        O = obs.cam_idx.shape[0]
        assert O % C == 0, "matrix-free GBA needs camera-major contiguous obs"
        seg = O // C
        ent = plan_cache[0]
        if (ent is None or ent[0] is not obs.lm_idx
                or ent[1] is not obs.cam_idx or ent[2] != (C, L)):
            lm_np = np.asarray(obs.lm_idx)
            order_np = np.argsort(lm_np, kind="stable").astype(np.int32)
            cam_np_l = (np.arange(O, dtype=np.int32) // seg)[order_np]
            sorted_args = (jnp.asarray(order_np), jnp.asarray(cam_np_l),
                           jnp.asarray(lm_np[order_np]))
            ent = (obs.lm_idx, obs.cam_idx, (C, L), sorted_args)
            plan_cache[0] = ent
        return _get_body(seg), (
            Tcw, Xw, K, fixed_cam, fixed_lm, n_it,
            obs.uv.T, obs.inv_sigma2, obs.valid, obs.lm_idx, *ent[3])

    def gba(Tcw, Xw, obs: ba_core.BAObservations, K, fixed_cam, fixed_lm,
            n_iterations=None):
        body, args = _args(Tcw, Xw, obs, K, fixed_cam, fixed_lm,
                           n_iterations)
        Tcw_o, Xw_o, inlier, cost, sweeps = body(*args)
        return BAResult(Tcw=Tcw_o, Xw=Xw_o, obs_inlier=inlier, cost=cost,
                        pcg_sweeps=sweeps)

    def lower(*a, **kw):
        """The jitted body lowered for these arguments (compile
        inspection)."""
        body, args = _args(*a, **kw)
        return body.lower(*args)

    gba.lower = lower
    return gba
