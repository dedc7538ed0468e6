"""Local & full bundle adjustment with dense-W Schur complement.

Replaces the reference's g2o BA variants for client-scale problems:
``Optimizer::BundleAdjustmentClient`` (src/Optimizer.cpp:40, full BA),
``GlobalBundleAdjustemntClient`` (:32), and
``LocalBundleAdjustmentClient`` (:349, covis-window BA with fixed frontier,
two-pass 5+10 iterations with an outlier erase between passes).

Device formulation: landmarks are marginalized with an explicitly materialized
dense W (6C x 3L) — for client-scale problems (C<=~100, L<=~10k) this fits
easily and turns the Schur reduction into two dense matmuls:

    S  = Hcc - (W Hll^-1) W^T          (6C x 6C, dense Cholesky)
    br = bc  - (W Hll^-1) bl
    dl = Hll^-1 (bl - W^T dc)          (per-landmark 3x3 back-substitution)

For server-scale maps use parallel/sharded_ba.py (matrix-free, sharded over
the observation axis).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..ops import lie
from . import ba_core


class BAResult(NamedTuple):
    Tcw: jax.Array        # (C, 4, 4)
    Xw: jax.Array         # (L, 3)
    obs_inlier: jax.Array  # (O,) bool final classification
    cost: jax.Array       # () final robust cost
    pcg_sweeps: Optional[jax.Array] = None  # () i32 Schur-PCG sweeps run


def _scatter_W(Wcl, cam_idx, lm_idx, C: int, L: int):
    """Scatter per-observation (6, 3) blocks into dense (6C, 3L)."""
    O = Wcl.shape[0]
    rows = cam_idx[:, None, None] * 6 + jnp.arange(6)[None, :, None]
    cols = lm_idx[:, None, None] * 3 + jnp.arange(3)[None, None, :]
    W = jnp.zeros((C * 6, L * 3), Wcl.dtype)
    return W.at[
        jnp.broadcast_to(rows, (O, 6, 3)), jnp.broadcast_to(cols, (O, 6, 3))
    ].add(Wcl)


def _solve_schur(Hcc, bc, Hll, bl, Wcl, cam_idx, lm_idx, lam, fixed_cam):
    """One damped Schur solve. Returns (dc (C,6), dl (L,3))."""
    C, L = Hcc.shape[0], Hll.shape[0]
    Hcc_d = ba_core.damp_blocks(Hcc, lam)
    Hll_d = ba_core.damp_blocks(Hll, lam)
    # fixed cameras: identity rows (dx forced ~0) by zeroing their blocks and
    # gradients, putting 1 on the diagonal
    fix = fixed_cam[:, None, None]
    eye6 = jnp.eye(6, dtype=Hcc.dtype)
    Hcc_d = jnp.where(fix, eye6[None], Hcc_d)
    bc = jnp.where(fixed_cam[:, None], 0.0, bc)

    Hll_inv = ba_core.inv33(Hll_d)
    W = _scatter_W(Wcl, cam_idx, lm_idx, C, L)              # (6C, 3L)
    # zero rows of fixed cameras so S keeps them decoupled
    W = jnp.where(jnp.repeat(fixed_cam, 6)[:, None], 0.0, W)
    # Y = W @ blockdiag(Hll_inv): scale 3-col groups
    Wb = W.reshape(C * 6, L, 3)
    Yb = jnp.einsum("rlj,ljk->rlk", Wb, Hll_inv)
    Y = Yb.reshape(C * 6, L * 3)
    # dense reduced camera system
    Hcc_dense = jnp.zeros((C * 6, C * 6), Hcc.dtype)
    ci = jnp.arange(C)[:, None, None] * 6 + jnp.arange(6)[None, :, None]
    cj = jnp.arange(C)[:, None, None] * 6 + jnp.arange(6)[None, None, :]
    Hcc_dense = Hcc_dense.at[
        jnp.broadcast_to(ci, (C, 6, 6)), jnp.broadcast_to(cj, (C, 6, 6))
    ].set(Hcc_d)
    S = Hcc_dense - Y @ W.T
    br = bc.reshape(-1) - Y @ bl.reshape(-1)
    # solve via Cholesky
    Sd = S + 1e-7 * jnp.eye(C * 6, dtype=S.dtype)
    dc_flat = jax.scipy.linalg.cho_solve(jax.scipy.linalg.cho_factor(Sd), br)
    dc = dc_flat.reshape(C, 6)
    dc = jnp.where(fixed_cam[:, None], 0.0, dc)
    # back-substitute landmarks: dl = Hll^-1 (bl - W^T dc)
    rhs = bl - jnp.einsum(
        "rlk,r->lk", Wb, jnp.where(jnp.repeat(fixed_cam, 6), 0.0, dc_flat)
    )
    dl = jnp.einsum("ljk,lk->lj", Hll_inv, rhs)
    return dc, dl


def _robust_cost(chi2, mask):
    """Summed Huber cost over active observations."""
    d = ba_core.HUBER_DELTA
    e = jnp.sqrt(jnp.maximum(chi2, 1e-12))
    rho = jnp.where(e <= d, chi2, 2.0 * d * e - d * d)
    return jnp.sum(jnp.where(mask, rho, 0.0))


def bundle_adjust(
    Tcw0,
    Xw0,
    obs: ba_core.BAObservations,
    K,
    fixed_cam,
    fixed_lm=None,
    iterations: int = 10,
    outlier_pass_at=None,
    chi2_thres: float = ba_core.CHI2_MONO,
) -> BAResult:
    """Robust LM bundle adjustment with landmarks marginalized.

    fixed_cam: (C,) bool — gauge / frontier cameras that stay put
    fixed_lm: optional (L,) bool — landmarks excluded from updates
    outlier_pass_at: optional iteration index at which observations failing
    the chi2 gate are dropped for the remaining iterations (mirrors the
    reference's two-pass 5+10 local BA).
    """
    C = Tcw0.shape[0]
    L = Xw0.shape[0]
    if fixed_lm is None:
        fixed_lm = jnp.zeros((L,), bool)

    def iteration(i, state):
        Tcw, Xw, lam, active = state
        r, pc, depth_ok = ba_core.reproject_residuals(Tcw, Xw, obs, K)
        w, chi2 = ba_core.robust_obs_weights(r, obs, depth_ok, extra_mask=active)
        # cost counts ALL active obs: residuals of behind-camera points are
        # computed with clamped depth and blow up, so steps that push points
        # behind the camera are rejected (masking them out instead would make
        # such steps look artificially cheap -> divergence)
        cost = _robust_cost(chi2, obs.valid & active)
        Rm = Tcw[obs.cam_idx][:, :3, :3]
        Jc, Jl = ba_core.reproject_jacobians(pc, Rm, K)
        Hcc, bc, Hll, bl, Wcl = ba_core.assemble_blocks(
            Jc, Jl, r, w, obs.cam_idx, obs.lm_idx, C, L
        )
        # freeze fixed landmarks by zeroing their gradient & W-blocks and
        # setting their diagonal to identity
        flm = fixed_lm[:, None]
        bl = jnp.where(flm, 0.0, bl)
        Hll = jnp.where(
            fixed_lm[:, None, None], jnp.eye(3, dtype=Hll.dtype)[None], Hll
        )
        Wcl = jnp.where(fixed_lm[obs.lm_idx][:, None, None], 0.0, Wcl)
        dc, dl = _solve_schur(
            Hcc, bc, Hll, bl, Wcl, obs.cam_idx, obs.lm_idx, lam, fixed_cam
        )
        dl = jnp.where(flm, 0.0, dl)
        T_new = ba_core.apply_pose_update(Tcw, dc, mask=~fixed_cam)
        X_new = Xw + dl
        # accept/reject
        r2, _, d2ok = ba_core.reproject_residuals(T_new, X_new, obs, K)
        chi2_new = jnp.sum(r2 * r2, -1) * obs.inv_sigma2
        cost_new = _robust_cost(chi2_new, obs.valid & active)
        accept = cost_new < cost
        Tcw = jnp.where(accept, T_new, Tcw)
        Xw = jnp.where(accept, X_new, Xw)
        lam = jnp.where(
            accept, jnp.maximum(lam * 0.5, 1e-8), jnp.minimum(lam * 4.0, 1e4)
        )
        # optional mid-run outlier erase (two-pass structure of the reference)
        if outlier_pass_at is not None:
            do_gate = i == outlier_pass_at
            r3, _, d3ok = ba_core.reproject_residuals(Tcw, Xw, obs, K)
            chi2_cur = jnp.sum(r3 * r3, -1) * obs.inv_sigma2
            gated = active & (chi2_cur <= chi2_thres) & d3ok
            active = jnp.where(do_gate, gated, active)
        return Tcw, Xw, lam, active

    active0 = jnp.ones_like(obs.valid)
    Tcw, Xw, _, active = jax.lax.fori_loop(
        0, iterations, iteration, (Tcw0, Xw0, jnp.float32(1e-4), active0)
    )
    # final classification against the CONVERGED state, independent of the
    # mid-run gate: an observation dropped at the (pre-convergence) outlier
    # pass is re-admitted if it fits now. Without re-admission every BA run
    # permanently deletes its momentarily-worst observations and the map's
    # observation graph thins until the scale gauge drifts away.
    r, _, depth_ok = ba_core.reproject_residuals(Tcw, Xw, obs, K)
    chi2 = jnp.sum(r * r, -1) * obs.inv_sigma2
    inlier = obs.valid & (chi2 <= chi2_thres) & depth_ok
    return BAResult(
        Tcw=Tcw, Xw=Xw, obs_inlier=inlier, cost=_robust_cost(chi2, inlier)
    )
