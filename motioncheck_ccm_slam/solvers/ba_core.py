"""Bundle-adjustment building blocks shared by all optimizers.

Array-native replacement for g2o's SparseOptimizer + BlockSolver machinery
(reference: cslam/thirdparty/g2o core, used by src/Optimizer.cpp). Instead of
a pointer-graph of vertices/edges, the problem is flat SoA:

- camera poses    Tcw        (C, 4, 4)
- landmarks       Xw         (L, 3)
- observations    cam_idx    (O,) i32   — which camera sees it
                  lm_idx     (O,) i32   — which landmark
                  uv         (O, 2) f32 — measured pixel
                  inv_sigma2 (O,) f32   — per-octave information
                  valid      (O,) bool

All Jacobians/Hessian blocks are computed for every observation at once;
invalid slots carry zero weight. The Schur trick (marginalize landmarks,
solve the reduced camera system) is expressed two ways:

- dense-W: scatter J-blocks into a dense (6C, 3L) W and reduce with two
  matmuls — used when 6C*3L fits comfortably (local BA).
- matrix-free: S @ x products via per-observation gathers + segment-sums —
  no O(C*L) memory, shardable over the observation axis with psum, used by
  the distributed global BA.

Perturbation convention: left-multiplicative se3, xi = (omega, upsilon),
Tcw <- exp(xi) @ Tcw (matches ops/lie.py).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import lie

CHI2_MONO = 5.991          # 2-dof 95% gate (reference Optimizer.cpp thHuberMono^2)
HUBER_DELTA = 2.447        # sqrt(5.991)


class BAObservations(NamedTuple):
    cam_idx: jax.Array     # (O,) i32
    lm_idx: jax.Array      # (O,) i32
    uv: jax.Array          # (O, 2) f32
    inv_sigma2: jax.Array  # (O,) f32
    valid: jax.Array       # (O,) bool


def reproject_residuals(Tcw, Xw, obs: BAObservations, K):
    """Residuals r = uv_meas - proj(Tcw_c Xw_l) and camera-frame points.

    Returns (r (O,2), pc (O,3), depth_ok (O,)).
    """
    Tc = Tcw[obs.cam_idx]                       # (O, 4, 4)
    X = Xw[obs.lm_idx]                          # (O, 3)
    R, t = Tc[..., :3, :3], Tc[..., :3, 3]
    pc = jnp.einsum("oij,oj->oi", R, X) + t
    z = pc[:, 2]
    depth_ok = z > 1e-6
    zs = jnp.where(depth_ok, z, 1.0)
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    u = fx * pc[:, 0] / zs + cx
    v = fy * pc[:, 1] / zs + cy
    r = obs.uv - jnp.stack([u, v], -1)
    return r, pc, depth_ok


def reproject_jacobians(pc, Tcw_R, K):
    """Per-observation Jacobians of the residual wrt camera (6) and landmark (3).

    pc: (O, 3) camera-frame points; Tcw_R: (O, 3, 3) rotation of each obs's
    camera. Residual r = uv - proj(pc); J = -d proj/d state.

    Returns (Jc (O, 2, 6), Jl (O, 2, 3)).
    """
    fx, fy = K[0, 0], K[1, 1]
    x, y, z = pc[:, 0], pc[:, 1], jnp.maximum(pc[:, 2], 1e-6)
    iz = 1.0 / z
    iz2 = iz * iz
    # d proj / d pc: (O, 2, 3)
    zero = jnp.zeros_like(x)
    dproj = jnp.stack(
        [
            jnp.stack([fx * iz, zero, -fx * x * iz2], -1),
            jnp.stack([zero, fy * iz, -fy * y * iz2], -1),
        ],
        -2,
    )
    # d pc / d xi (left perturbation): [ -hat(pc) | I ]
    dpc_dxi = jnp.concatenate(
        [-lie.hat(pc), jnp.broadcast_to(jnp.eye(3, dtype=pc.dtype), pc.shape[:-1] + (3, 3))],
        -1,
    )  # (O, 3, 6)
    Jc = -jnp.einsum("oij,ojk->oik", dproj, dpc_dxi)
    # d pc / d Xw = R
    Jl = -jnp.einsum("oij,ojk->oik", dproj, Tcw_R)
    return Jc, Jl


def huber_weights(chi2, delta: float = HUBER_DELTA):
    """Huber IRLS weight per observation given unweighted chi2=r^T W r."""
    e = jnp.sqrt(jnp.maximum(chi2, 1e-12))
    return jnp.where(e <= delta, 1.0, delta / e)


def robust_obs_weights(r, obs: BAObservations, depth_ok, extra_mask=None):
    """Total scalar weight per obs: inv_sigma2 * huber * validity."""
    chi2 = jnp.sum(r * r, -1) * obs.inv_sigma2
    w = obs.inv_sigma2 * huber_weights(chi2)
    m = obs.valid & depth_ok
    if extra_mask is not None:
        m = m & extra_mask
    return jnp.where(m, w, 0.0), chi2


def segment_sum(idx, x, n: int):
    """(O, ...) -> (N, ...) per-entity sums of ``x`` over ids ``idx``."""
    return jnp.zeros((n,) + x.shape[1:], x.dtype).at[idx].add(x)


def assemble_blocks(Jc, Jl, r, w, cam_idx, lm_idx, C: int, L: int):
    """Per-entity Hessian blocks and gradients by segment-sum.

    Returns:
      Hcc (C, 6, 6), bc (C, 6)  — camera diagonal blocks & gradient
      Hll (L, 3, 3), bl (L, 3)  — landmark diagonal blocks & gradient
      Wcl (O, 6, 3)             — per-observation off-diagonal blocks
    """
    wJc = Jc * w[:, None, None]
    wJl = Jl * w[:, None, None]
    Hcc = segment_sum(cam_idx, jnp.einsum("oic,oid->ocd", wJc, Jc), C)
    Hll = segment_sum(lm_idx, jnp.einsum("oic,oid->ocd", wJl, Jl), L)
    # gradient of 0.5 r^T W r wrt params: b = -J^T W r (we solve H dx = b)
    bc = segment_sum(cam_idx, -jnp.einsum("oic,oi->oc", wJc, r), C)
    bl = segment_sum(lm_idx, -jnp.einsum("oic,oi->oc", wJl, r), L)
    Wcl = jnp.einsum("oic,oid->ocd", wJc, Jl)  # (O, 6, 3)
    return Hcc, bc, Hll, bl, Wcl


def damp_blocks(H, lam):
    """LM damping: H + lam * diag(diag(H)) + tiny absolute floor."""
    d = jnp.diagonal(H, axis1=-2, axis2=-1)  # (..., k)
    damp = lam * d + 1e-9
    eye = jnp.eye(H.shape[-1], dtype=H.dtype)
    return H + eye * damp[..., None, :]


def inv33(H, eps: float = 1e-8):
    """Batched 3x3 inverse with Tikhonov floor (landmark block inversion).

    Closed-form adjugate/determinant instead of ``jnp.linalg.inv``: the
    batched LU path lowers to pivoting loops, the adjugate to ~30 fused
    elementwise ops over the batch; on damped SPD blocks its accuracy
    matches LU to f32 roundoff.
    """
    H = H + eps * jnp.eye(3, dtype=H.dtype)
    a, b, c = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    d, e, f = H[..., 1, 0], H[..., 1, 1], H[..., 1, 2]
    g, h, i = H[..., 2, 0], H[..., 2, 1], H[..., 2, 2]
    A = e * i - f * h
    B = f * g - d * i
    Cc = d * h - e * g
    det = a * A + b * B + c * Cc
    # sign-preserving floor: flooring a tiny NEGATIVE determinant to +1e-30
    # would flip the inverse's sign (the helper is used beyond damped SPD
    # blocks, e.g. inv66_spd's Schur pieces)
    det_floor = jnp.where(det < 0, -1e-30, 1e-30)
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-30, det_floor, det)
    adj = jnp.stack([
        jnp.stack([A, c * h - b * i, b * f - c * e], -1),
        jnp.stack([B, a * i - c * g, c * d - a * f], -1),
        jnp.stack([Cc, b * g - a * h, a * e - b * d], -1),
    ], -2)
    return adj * inv_det[..., None, None]


def inv66_spd(M, eps: float = 1e-8):
    """Batched 6x6 SPD inverse by 2x2-block Schur complement of 3x3s.

    M = [[A, B], [B^T, D]]; M^-1 assembled from adjugate 3x3 inverses of
    A and S = D - B^T A^-1 B. Replaces the batched-LU ``jnp.linalg.inv``
    for the PCG block-Jacobi preconditioner with fused elementwise ops;
    preconditioner accuracy is uncritical.
    """
    A = M[..., :3, :3]
    B = M[..., :3, 3:]
    D = M[..., 3:, 3:]
    Ai = inv33(A, eps)
    AiB = jnp.einsum("...ij,...jk->...ik", Ai, B)
    S = D - jnp.einsum("...ji,...jk->...ik", B, AiB)
    Si = inv33(S, eps)
    TL = Ai + jnp.einsum("...ij,...jk,...lk->...il", AiB, Si, AiB)
    TR = -jnp.einsum("...ij,...jk->...ik", AiB, Si)
    BL = jnp.swapaxes(TR, -1, -2)
    top = jnp.concatenate([TL, TR], -1)
    bot = jnp.concatenate([BL, Si], -1)
    return jnp.concatenate([top, bot], -2)


def apply_pose_update(Tcw, dx, mask=None):
    """Tcw <- exp(dx) Tcw per camera; masked cameras stay fixed."""
    dT = lie.se3_exp(dx)
    Tnew = jnp.einsum("cij,cjk->cik", dT, Tcw)
    if mask is not None:
        Tnew = jnp.where(mask[:, None, None], Tnew, Tcw)
    return Tnew
