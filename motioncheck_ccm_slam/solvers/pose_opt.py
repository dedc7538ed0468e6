"""Motion-only pose optimization (frame tracking inner loop).

Replaces the reference's ``Optimizer::PoseOptimizationClient``
(src/Optimizer.cpp:215): optimize a single camera pose against its matched
landmarks, 4 rounds of 10 LM iterations, re-classifying outliers between
rounds at chi2 = 5.991, with a Huber kernel inside each round.

Everything is fixed-iteration ``lax.fori_loop`` state-machine code — no
data-dependent control flow, so the whole optimization jits into one XLA
program and can be vmapped over frames/agents.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..ops import lie
from . import ba_core

# The pose solve's small products (3x3 rotations of every landmark, the
# 6x6 normal equations summed over every observation) are written as
# elementwise multiply + reduce: XLA fuses them at full float32, where a
# matmul may run in TF32 on a GPU (about three decimal digits) or become one
# library call per LM iteration. The 4x4 pose update asks for full float32.
_HI = jax.lax.Precision.HIGHEST


class PoseOptResult(NamedTuple):
    Tcw: jax.Array      # (4, 4) optimized pose
    inliers: jax.Array  # (N,) bool final inlier classification
    n_inliers: jax.Array  # () i32


def _residuals_single(Tcw, Xw, uv, K):
    R, t = Tcw[:3, :3], Tcw[:3, 3]
    pc = jnp.sum(Xw[:, None, :] * R[None], -1) + t
    z = jnp.maximum(pc[:, 2], 1e-6)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    u = fx * pc[:, 0] / z + cx
    v = fy * pc[:, 1] / z + cy
    r = uv - jnp.stack([u, v], -1)
    return r, pc


def optimize_pose(
    Tcw0,
    Xw,
    uv,
    inv_sigma2,
    valid,
    K,
    n_rounds: int = 4,
    iters_per_round: int = 10,
    chi2_thres: float = ba_core.CHI2_MONO,
    active0=None,
) -> PoseOptResult:
    """Optimize one camera pose. All args device arrays; shapes static.

    Xw (N, 3) world landmarks; uv (N, 2) measurements; inv_sigma2 (N,)
    per-octave weights; valid (N,) live associations. ``active0`` optionally
    seeds the first round's active set (e.g. RANSAC inliers) while later
    rounds may re-admit any ``valid`` observation that fits — mirrors the
    reference's re-inclusion of recovered outliers between rounds.
    """
    N = Xw.shape[0]

    def gn_iters(Tcw, active):
        """One round: fixed LM iterations on the active set."""

        def body(_, state):
            Tcw, lam, last_cost = state
            r, pc = _residuals_single(Tcw, Xw, uv, K)
            chi2 = jnp.sum(r * r, -1) * inv_sigma2
            w = inv_sigma2 * ba_core.huber_weights(chi2)
            w = jnp.where(active & (pc[:, 2] > 1e-6), w, 0.0)
            cost = jnp.sum(jnp.where(active, jnp.minimum(chi2, 2 * ba_core.HUBER_DELTA * jnp.sqrt(jnp.maximum(chi2, 1e-12)) - ba_core.HUBER_DELTA**2), 0.0))
            Rm = jnp.broadcast_to(Tcw[:3, :3], (N, 3, 3))
            Jc, _ = ba_core.reproject_jacobians(pc, Rm, K)
            wJ = Jc * w[:, None, None]
            H = jnp.sum(wJ[..., :, None] * Jc[..., None, :], axis=(0, 1))
            b = -jnp.sum(wJ * r[..., None], axis=(0, 1))
            Hd = H + jnp.eye(6, dtype=H.dtype) * (lam * jnp.diag(H) + 1e-9)
            dx = jnp.linalg.solve(Hd, b)
            T_new = jnp.matmul(lie.se3_exp(dx), Tcw, precision=_HI)
            # evaluate new cost; accept/reject (classic LM)
            r2, pc2 = _residuals_single(T_new, Xw, uv, K)
            chi2_new = jnp.sum(r2 * r2, -1) * inv_sigma2
            cost_new = jnp.sum(jnp.where(active, jnp.minimum(chi2_new, 2 * ba_core.HUBER_DELTA * jnp.sqrt(jnp.maximum(chi2_new, 1e-12)) - ba_core.HUBER_DELTA**2), 0.0))
            accept = cost_new < cost
            Tcw = jnp.where(accept, T_new, Tcw)
            lam = jnp.where(accept, jnp.maximum(lam * 0.5, 1e-8), jnp.minimum(lam * 4.0, 1e4))
            return Tcw, lam, jnp.where(accept, cost_new, cost)

        Tcw, _, _ = jax.lax.fori_loop(
            0, iters_per_round, body, (Tcw, jnp.float32(1e-3), jnp.float32(jnp.inf))
        )
        return Tcw

    def round_body(_, state):
        Tcw, active = state
        Tcw = gn_iters(Tcw, active)
        # reclassify: inlier if chi2 <= thres and positive depth (reference
        # re-includes previous outliers that now fit — same here since we
        # always classify against the full valid set)
        r, pc = _residuals_single(Tcw, Xw, uv, K)
        chi2 = jnp.sum(r * r, -1) * inv_sigma2
        active = valid & (chi2 <= chi2_thres) & (pc[:, 2] > 1e-6)
        return Tcw, active

    start_active = valid if active0 is None else (valid & active0)
    Tcw, active = jax.lax.fori_loop(0, n_rounds, round_body, (Tcw0, start_active))
    return PoseOptResult(Tcw=Tcw, inliers=active, n_inliers=jnp.sum(active))
