"""SO3 / SE3 / Sim3 Lie-group operations, batched and jit-friendly.

Array-native replacement for the reference's g2o pose types and converters
(reference: cslam/thirdparty/g2o/g2o/types/se3quat.h, sim3.h,
src/Converter.cc). All functions broadcast over arbitrary leading batch
dimensions and are safe at the small-angle limit (Taylor fallbacks chosen by
``jnp.where`` so gradients stay finite).

Conventions
-----------
- Rigid transforms are 4x4 row-major matrices ``T`` mapping points as
  ``x' = T[:3,:3] @ x + T[:3,3]``. ``Tcw`` maps world -> camera like the
  reference.
- se3 tangent vectors are ordered ``xi = (omega[3], upsilon[3])`` —
  rotation-first, matching g2o's ``SE3Quat::exp`` update convention.
- sim3 tangent vectors are ``(omega[3], upsilon[3], sigma)`` with scale
  ``s = exp(sigma)``; a Sim3 element is stored as ``(R, t, s)`` acting as
  ``x' = s * R @ x + t`` (g2o sim3.h convention).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-8


# ---------------------------------------------------------------------------
# so3
# ---------------------------------------------------------------------------

def hat(w):
    """Skew-symmetric matrix of w (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([zeros, -wz, wy], -1),
            jnp.stack([wz, zeros, -wx], -1),
            jnp.stack([-wy, wx, zeros], -1),
        ],
        -2,
    )


def vee(W):
    """Inverse of hat: (..., 3, 3) -> (..., 3)."""
    return jnp.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], -1)


def so3_exp(w):
    """Rodrigues: (..., 3) axis-angle -> (..., 3, 3) rotation.

    Uses the double-where trick so gradients at theta=0 are exact (a plain
    ``where`` would leak NaN from d sqrt/d theta2 at 0 through autodiff).
    """
    theta2 = jnp.sum(w * w, -1)
    small = theta2 < _EPS
    theta2_safe = jnp.where(small, 1.0, theta2)
    theta = jnp.sqrt(theta2_safe)
    # sin(t)/t and (1-cos t)/t^2 with Taylor fallback
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2_safe)
    W = hat(w)
    I = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return I + a[..., None, None] * W + b[..., None, None] * (W @ W)


def so3_log(R):
    """Rotation (..., 3, 3) -> axis-angle (..., 3).

    theta is recovered via atan2(|vee(W)|, (tr-1)/2) — |vee(W)| equals
    sin(theta) exactly, which keeps the theta/sin scale well-conditioned all
    the way to ~1e-3 of pi (arccos-based recovery loses ~3 digits there).
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    W = 0.5 * (R - jnp.swapaxes(R, -1, -2))
    w = vee(W)  # = sin(theta) * axis
    # double-where so derivatives stay NaN-free at the identity (edges with
    # zero residual sit exactly there; autodiff pose-graph Jacobians would
    # otherwise poison the whole normal system)
    sin2 = jnp.sum(w * w, -1)
    small = sin2 < 1e-12
    sin_safe = jnp.sqrt(jnp.where(small, 1.0, sin2))
    sin_theta = jnp.where(small, 0.0, sin_safe)
    theta = jnp.arctan2(sin_theta, cos_theta)
    near_pi = (cos_theta < 0.0) & (sin_theta < 1e-3)
    # generic scale theta / sin(theta); Taylor at identity (theta^2 ~ sin2)
    scale = jnp.where(small, 1.0 + sin2 / 6.0, theta / sin_safe)
    w_generic = w * scale[..., None]
    # near pi: axis from diagonal of (R + I)/2 = axis axis^T (1+cos)/2 ... use
    # the standard S = R + I trick: columns of S are parallel to the axis.
    S = R + jnp.broadcast_to(jnp.eye(3, dtype=R.dtype), R.shape)
    # pick the column with the largest norm
    norms = jnp.linalg.norm(S, axis=-2)  # (..., 3)
    col_idx = jnp.argmax(norms, axis=-1)
    axis_raw = jnp.take_along_axis(S, col_idx[..., None, None], axis=-1)[..., 0]
    axis = axis_raw / jnp.maximum(jnp.linalg.norm(axis_raw, axis=-1, keepdims=True), _EPS)
    # sign: make consistent with w (sin-theta * axis) when sin != 0; at exactly
    # pi the sign is arbitrary (R(pi, a) == R(pi, -a)).
    sign = jnp.where(jnp.sum(axis * w, -1, keepdims=True) < 0.0, -1.0, 1.0)
    w_pi = axis * sign * theta[..., None]
    return jnp.where(near_pi[..., None], w_pi, w_generic)


# ---------------------------------------------------------------------------
# SE3
# ---------------------------------------------------------------------------

def _V_coeffs(theta2, dtype):
    """Coefficients for the left-Jacobian V = I + b*W + c*W^2 (double-where
    for NaN-free gradients at theta=0)."""
    small = theta2 < _EPS
    theta2_safe = jnp.where(small, 1.0, theta2)
    theta = jnp.sqrt(theta2_safe)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2_safe)
    c = jnp.where(
        small,
        1.0 / 6.0 - theta2 / 120.0,
        (theta - jnp.sin(theta)) / (theta2_safe * theta),
    )
    return b, c


def se3_exp(xi):
    """se3 (..., 6) = (omega, upsilon) -> (..., 4, 4)."""
    w, v = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    theta2 = jnp.sum(w * w, -1)
    b, c = _V_coeffs(theta2, xi.dtype)
    W = hat(w)
    I = jnp.broadcast_to(jnp.eye(3, dtype=xi.dtype), R.shape)
    V = I + b[..., None, None] * W + c[..., None, None] * (W @ W)
    t = jnp.einsum("...ij,...j->...i", V, v)
    return make_T(R, t)


def se3_log(T):
    """(..., 4, 4) -> se3 (..., 6) = (omega, upsilon)."""
    R, t = split_T(T)
    w = so3_log(R)
    theta2 = jnp.sum(w * w, -1)
    b, c = _V_coeffs(theta2, T.dtype)
    W = hat(w)
    I = jnp.broadcast_to(jnp.eye(3, dtype=T.dtype), R.shape)
    V = I + b[..., None, None] * W + c[..., None, None] * (W @ W)
    v = jnp.linalg.solve(V, t[..., None])[..., 0]
    return jnp.concatenate([w, v], -1)


def make_T(R, t):
    """(..., 3, 3), (..., 3) -> (..., 4, 4)."""
    batch = jnp.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = jnp.broadcast_to(R, batch + (3, 3))
    t = jnp.broadcast_to(t, batch + (3,))
    top = jnp.concatenate([R, t[..., None]], -1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=R.dtype), batch + (1, 4)
    )
    return jnp.concatenate([top, bottom], -2)


def split_T(T):
    return T[..., :3, :3], T[..., :3, 3]


def inv_T(T):
    """Closed-form inverse of a rigid transform."""
    R, t = split_T(T)
    Rt = jnp.swapaxes(R, -1, -2)
    return make_T(Rt, -jnp.einsum("...ij,...j->...i", Rt, t))


def transform_points(T, pts):
    """Apply (..., 4, 4) to points (..., N, 3)."""
    R, t = split_T(T)
    return jnp.einsum("...ij,...nj->...ni", R, pts) + t[..., None, :]


# ---------------------------------------------------------------------------
# Quaternions (w, x, y, z) — used for CSV export & message encoding
# ---------------------------------------------------------------------------

def rot_to_quat(R):
    """(..., 3, 3) -> (..., 4) quaternion (w, x, y, z), w >= 0."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    # four candidate constructions, pick numerically best (largest pivot)
    qw0 = jnp.sqrt(jnp.maximum(1.0 + tr, 0.0)) * 0.5
    d0 = 4.0 * jnp.maximum(qw0, _EPS)
    cand0 = jnp.stack([qw0, (m21 - m12) / d0, (m02 - m20) / d0, (m10 - m01) / d0], -1)

    qx1 = jnp.sqrt(jnp.maximum(1.0 + m00 - m11 - m22, 0.0)) * 0.5
    d1 = 4.0 * jnp.maximum(qx1, _EPS)
    cand1 = jnp.stack([(m21 - m12) / d1, qx1, (m01 + m10) / d1, (m02 + m20) / d1], -1)

    qy2 = jnp.sqrt(jnp.maximum(1.0 - m00 + m11 - m22, 0.0)) * 0.5
    d2 = 4.0 * jnp.maximum(qy2, _EPS)
    cand2 = jnp.stack([(m02 - m20) / d2, (m01 + m10) / d2, qy2, (m12 + m21) / d2], -1)

    qz3 = jnp.sqrt(jnp.maximum(1.0 - m00 - m11 + m22, 0.0)) * 0.5
    d3 = 4.0 * jnp.maximum(qz3, _EPS)
    cand3 = jnp.stack([(m10 - m01) / d3, (m02 + m20) / d3, (m12 + m21) / d3, qz3], -1)

    pivots = jnp.stack([tr, m00 - m11 - m22, -m00 + m11 - m22, -m00 - m11 + m22], -1)
    best = jnp.argmax(pivots, -1)
    cands = jnp.stack([cand0, cand1, cand2, cand3], -2)  # (..., 4cand, 4)
    q = jnp.take_along_axis(cands, best[..., None, None], axis=-2)[..., 0, :]
    q = q / jnp.maximum(jnp.linalg.norm(q, axis=-1, keepdims=True), _EPS)
    return q * jnp.where(q[..., :1] < 0, -1.0, 1.0)


def quat_to_rot(q):
    """(..., 4) (w, x, y, z) -> (..., 3, 3)."""
    q = q / jnp.maximum(jnp.linalg.norm(q, axis=-1, keepdims=True), _EPS)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = jnp.stack(
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1
    )
    row1 = jnp.stack(
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1
    )
    row2 = jnp.stack(
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1
    )
    return jnp.stack([row0, row1, row2], -2)


# ---------------------------------------------------------------------------
# Sim3: (R, t, s) acting as x' = s R x + t
# ---------------------------------------------------------------------------

def make_sim3(R, t, s):
    """Pack a Sim3 as a (..., 4, 4) matrix with scaled rotation block plus a
    separate convention: we store [sR, t; 0, 1]. Scale is recoverable as
    det(sR)^(1/3)."""
    batch = jnp.broadcast_shapes(R.shape[:-2], t.shape[:-1], jnp.shape(s))
    sR = jnp.broadcast_to(s[..., None, None] * R, batch + (3, 3))
    return make_T(sR, jnp.broadcast_to(t, batch + (3,)))


def split_sim3(S):
    """(..., 4, 4) [sR, t] -> (R, t, s)."""
    sR, t = split_T(S)
    s = jnp.cbrt(jnp.linalg.det(sR))
    R = sR / s[..., None, None]
    return R, t, s


def sim3_inv(S):
    """Inverse of [sR, t]: [R^T/s, -R^T t / s]."""
    R, t, s = split_sim3(S)
    Rt = jnp.swapaxes(R, -1, -2)
    s_inv = 1.0 / s
    return make_sim3(Rt, -s_inv[..., None] * jnp.einsum("...ij,...j->...i", Rt, t), s_inv)


def sim3_apply(S, pts):
    """Apply Sim3 (..., 4, 4) to points (..., N, 3)."""
    sR, t = split_T(S)
    return jnp.einsum("...ij,...nj->...ni", sR, pts) + t[..., None, :]


def sim3_exp(xi):
    """sim3 (..., 7) = (omega, upsilon, sigma) -> (..., 4, 4) [sR, t].

    Uses the closed-form W matrix from Strasdat's thesis (as in g2o sim3.h
    ctor from Vector7d).
    """
    w, v, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    s = jnp.exp(sigma)
    R = so3_exp(w)
    theta2 = jnp.sum(w * w, -1)
    theta = jnp.sqrt(jnp.maximum(theta2, 0.0))
    W = hat(w)
    W2 = W @ W
    I = jnp.broadcast_to(jnp.eye(3, dtype=xi.dtype), R.shape)

    eps_s = jnp.abs(sigma) < 1e-5
    small_t = theta2 < _EPS
    safe_sigma = jnp.where(eps_s, 1.0, sigma)
    safe_theta = jnp.where(small_t, 1.0, theta)
    safe_theta2 = jnp.where(small_t, 1.0, theta2)

    # A = (s - 1)/sigma  (-> 1 as sigma -> 0)
    A = jnp.where(eps_s, 1.0 + sigma / 2.0, (s - 1.0) / safe_sigma)

    sig2_t2 = sigma * sigma + theta2
    safe_denom = jnp.where(small_t & eps_s, 1.0, jnp.where(sig2_t2 == 0, 1.0, sig2_t2))

    # Coefficients for V = A*I + B*W + C*W^2 (Strasdat RSS'10 appendix):
    # generic case (theta != 0, sigma != 0):
    #  B = (a_c)/(theta) stuff — use the standard formulation:
    a = s * jnp.sin(theta)
    b = s * jnp.cos(theta)
    B_gen = (a * sigma + (1.0 - b) * theta) / (safe_theta * safe_denom)
    C_gen = (A - ((b - 1.0) * sigma + a * theta) / safe_denom) / safe_theta2
    # sigma -> 0 limits: B = (1 - cos)/theta^2, C = (theta - sin)/theta^3
    B_s0 = (1.0 - jnp.cos(theta)) / safe_theta2
    C_s0 = (theta - jnp.sin(theta)) / (safe_theta2 * safe_theta)
    # theta -> 0 limits: B = ((sigma-1)s + 1)/sigma^2, C = (s(sigma^2/2 - sigma + 1) - 1)/sigma^3
    B_t0 = jnp.where(
        eps_s, 0.5 + sigma / 3.0, ((sigma - 1.0) * s + 1.0) / (safe_sigma * safe_sigma)
    )
    C_t0 = jnp.where(
        eps_s,
        1.0 / 6.0 + sigma / 8.0,
        (s * (sigma * sigma / 2.0 - sigma + 1.0) - 1.0) / (safe_sigma ** 3),
    )
    B = jnp.where(small_t, B_t0, jnp.where(eps_s, B_s0, B_gen))
    C = jnp.where(small_t, C_t0, jnp.where(eps_s, C_s0, C_gen))

    V = A[..., None, None] * I + B[..., None, None] * W + C[..., None, None] * W2
    t = jnp.einsum("...ij,...j->...i", V, v)
    return make_sim3(R, t, s)


def sim3_log(S):
    """[sR, t] (..., 4, 4) -> (..., 7) = (omega, upsilon, sigma).

    Computed by inverting the V matrix from sim3_exp numerically (3x3 solve) —
    exact, and avoids duplicating the coefficient case analysis.
    """
    R, t, s = split_sim3(S)
    w = so3_log(R)
    sigma = jnp.log(s)
    # rebuild V from (w, sigma) exactly as in sim3_exp, then solve V v = t
    xi_rot = jnp.concatenate([w, jnp.zeros_like(w), sigma[..., None]], -1)
    # recompute V by calling sim3_exp's internals through jvp-free reuse:
    V = _sim3_V(w, sigma, S.dtype)
    v = jnp.linalg.solve(V, t[..., None])[..., 0]
    return jnp.concatenate([w, v, sigma[..., None]], -1)


def _sim3_V(w, sigma, dtype):
    s = jnp.exp(sigma)
    theta2 = jnp.sum(w * w, -1)
    theta = jnp.sqrt(jnp.maximum(theta2, 0.0))
    W = hat(w)
    W2 = W @ W
    I = jnp.broadcast_to(jnp.eye(3, dtype=dtype), W.shape)
    eps_s = jnp.abs(sigma) < 1e-5
    small_t = theta2 < _EPS
    safe_sigma = jnp.where(eps_s, 1.0, sigma)
    safe_theta = jnp.where(small_t, 1.0, theta)
    safe_theta2 = jnp.where(small_t, 1.0, theta2)
    A = jnp.where(eps_s, 1.0 + sigma / 2.0, (s - 1.0) / safe_sigma)
    sig2_t2 = sigma * sigma + theta2
    safe_denom = jnp.where(small_t & eps_s, 1.0, jnp.where(sig2_t2 == 0, 1.0, sig2_t2))
    a = s * jnp.sin(theta)
    b = s * jnp.cos(theta)
    B_gen = (a * sigma + (1.0 - b) * theta) / (safe_theta * safe_denom)
    C_gen = (A - ((b - 1.0) * sigma + a * theta) / safe_denom) / safe_theta2
    B_s0 = (1.0 - jnp.cos(theta)) / safe_theta2
    C_s0 = (theta - jnp.sin(theta)) / (safe_theta2 * safe_theta)
    B_t0 = jnp.where(
        eps_s, 0.5 + sigma / 3.0, ((sigma - 1.0) * s + 1.0) / (safe_sigma * safe_sigma)
    )
    C_t0 = jnp.where(
        eps_s,
        1.0 / 6.0 + sigma / 8.0,
        (s * (sigma * sigma / 2.0 - sigma + 1.0) - 1.0) / (safe_sigma ** 3),
    )
    B = jnp.where(small_t, B_t0, jnp.where(eps_s, B_s0, B_gen))
    C = jnp.where(small_t, C_t0, jnp.where(eps_s, C_s0, C_gen))
    return A[..., None, None] * I + B[..., None, None] * W + C[..., None, None] * W2


# ---------------------------------------------------------------------------
# Horn closed-form alignment (similarity): used by Sim3Solver and map merging
# ---------------------------------------------------------------------------

def horn_align(p1, p2, w=None, fix_scale: bool = False):
    """Closed-form similarity aligning point sets: p2 ~ s R p1 + t.

    Horn's quaternion method (reference src/Sim3Solver.cpp:ComputeSim3),
    batched over leading dims. ``p1``/``p2`` are (..., N, 3); ``w`` optional
    per-point weights (..., N).

    Returns (R, t, s) with p2 ≈ s * R @ p1 + t.
    """
    if w is None:
        w = jnp.ones(p1.shape[:-1], dtype=p1.dtype)
    wsum = jnp.sum(w, -1, keepdims=True)
    wn = w / jnp.maximum(wsum, _EPS)
    c1 = jnp.sum(p1 * wn[..., None], -2)
    c2 = jnp.sum(p2 * wn[..., None], -2)
    q1 = p1 - c1[..., None, :]
    q2 = p2 - c2[..., None, :]
    # weighted covariance S_ab = sum_n w_n q1_a q1_b' with a from frame1
    # (left), b from frame2 (right) — Horn's convention for R: frame1->frame2
    M = jnp.einsum("...n,...ni,...nj->...ij", wn, q1, q2)
    # N matrix (Horn 1987)
    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    N = jnp.stack(
        [
            jnp.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
            jnp.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
            jnp.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
            jnp.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
        ],
        -2,
    )
    evals, evecs = jnp.linalg.eigh(N)
    q = evecs[..., :, -1]  # eigenvector of largest eigenvalue, (w,x,y,z)
    R = quat_to_rot(q)
    # scale: symmetric Horn scale sqrt(sum|q2|^2 / sum|q1|^2) in rotated sense;
    # use the standard s = <q2, R q1> / <q1, q1> (asymmetric, matches g2o's
    # Sim3Solver for mono scale-free case closely enough; symmetric variant
    # below is more stable):
    Rq1 = jnp.einsum("...ij,...nj->...ni", R, q1)
    num = jnp.sum(wn[..., None] * q2 * Rq1, (-2, -1))
    den = jnp.sum(wn[..., None] * Rq1 * Rq1, (-2, -1))
    s = jnp.where(fix_scale, 1.0, num / jnp.maximum(den, _EPS))
    t = c2 - s[..., None] * jnp.einsum("...ij,...j->...i", R, c1)
    return R, t, s
