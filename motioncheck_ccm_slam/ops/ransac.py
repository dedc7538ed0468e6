"""Batched RANSAC solvers: two-view init (H/F), PnP, Sim3.

Batched replacements for the reference's hypothesis-loop solvers:

- ``initialize_two_view`` — reference src/Initializer.cpp: parallel RANSAC
  over homography H and fundamental F with robust symmetric-transfer scores,
  model selection by score ratio (RH > 0.40 -> H), then motion recovery +
  triangulation with cheirality/parallax checks.
- ``pnp_ransac`` — reference src/PnPSolver.cpp (EPnP inside RANSAC). We use
  batched DLT-PnP minimal solves (6 pts) + GN polish on the inlier set; same
  contract (pose from 2D-3D matches with outliers), better suited to batched
  linear algebra than EPnP's beta-case analysis.
- ``sim3_ransac`` — reference src/Sim3Solver.cpp: Horn 3-point closed-form
  similarity + mutual reprojection inlier check.

Everywhere: RANSAC's adaptive early exit becomes a fixed batch of hypotheses
evaluated at once with an argmax winner — the XLA-friendly formulation.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from . import lie

_EPS = 1e-9


def _sample_indices(key, n_hyp: int, set_size: int, n_pts: int, weights=None):
    """(n_hyp, set_size) random indices into [0, n_pts). Draws are
    independent (collisions produce degenerate models that simply lose the
    vote — cheaper than per-hypothesis permutations)."""
    if weights is None:
        return jax.random.randint(key, (n_hyp, set_size), 0, n_pts)
    logits = jnp.log(jnp.maximum(weights, 1e-20))
    return jax.random.categorical(key, logits[None, :], axis=-1,
                                  shape=(n_hyp, set_size))


def _normalize_points(uv, mask):
    """Hartley normalization over the masked set: returns (uv_norm, T (3,3))."""
    m = mask.astype(uv.dtype)
    n = jnp.maximum(jnp.sum(m), 1.0)
    mean = jnp.sum(uv * m[:, None], 0) / n
    d = jnp.abs(uv - mean) * m[:, None]
    mean_dev = jnp.sum(d, 0) / n
    s = 1.0 / jnp.maximum(mean_dev, _EPS)
    T = jnp.array(
        [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]], uv.dtype
    )
    T = T.at[0, 0].set(s[0]).at[1, 1].set(s[1])
    T = T.at[0, 2].set(-mean[0] * s[0]).at[1, 2].set(-mean[1] * s[1])
    uvn = (uv - mean) * s
    return uvn, T


# ---------------------------------------------------------------------------
# Homography / Fundamental estimation (minimal DLT per hypothesis)
# ---------------------------------------------------------------------------

def _solve_h_dlt(p1, p2, w=None):
    """Batched 4+-point homography DLT. p1, p2: (B, S, 2) -> H (B, 3, 3).

    Optional row weights w (B, S) enable least-squares refit on an inlier set.
    """
    B, S, _ = p1.shape
    x, y = p1[..., 0], p1[..., 1]
    u, v = p2[..., 0], p2[..., 1]
    z = jnp.zeros_like(x)
    o = jnp.ones_like(x)
    r1 = jnp.stack([z, z, z, -x, -y, -o, v * x, v * y, v], -1)
    r2 = jnp.stack([x, y, o, z, z, z, -u * x, -u * y, -u], -1)
    A = jnp.concatenate([r1, r2], -2)  # (B, 2S, 9)
    if w is not None:
        A = A * jnp.concatenate([w, w], -1)[..., None]
    _, _, vt = jnp.linalg.svd(A, full_matrices=True)
    h = vt[..., -1, :]
    return h.reshape(B, 3, 3)


def _solve_f_8pt(p1, p2, w=None):
    """Batched 8-point fundamental. p1, p2: (B, S, 2) -> F (B, 3, 3) rank-2."""
    B, S, _ = p1.shape
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    o = jnp.ones_like(x1)
    A = jnp.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, o], -1
    )  # (B, S, 9)
    if w is not None:
        A = A * w[..., None]
    _, _, vt = jnp.linalg.svd(A, full_matrices=True)
    F = vt[..., -1, :].reshape(B, 3, 3)
    # enforce rank 2
    U, s, Vt = jnp.linalg.svd(F)
    s = s.at[..., 2].set(0.0)
    return U @ (s[..., None] * Vt)


def _score_h(H, uv1, uv2, mask, sigma2: float):
    """Robust symmetric transfer score of homographies (B, 3, 3) over all
    correspondences. Returns (score (B,), inliers (B, N))."""
    th = 5.991
    inv_s2 = 1.0 / sigma2
    Hinv = jnp.linalg.inv(H)
    ones = jnp.ones_like(uv1[:, :1])
    x1 = jnp.concatenate([uv1, ones], -1)  # (N, 3)
    x2 = jnp.concatenate([uv2, ones], -1)

    def transfer(M, src, dst):
        p = jnp.einsum("bij,nj->bni", M, src)
        w = jnp.where(jnp.abs(p[..., 2]) < _EPS, _EPS, p[..., 2])
        uv = p[..., :2] / w[..., None]
        return jnp.sum((uv - dst[None, :, :2]) ** 2, -1) * inv_s2

    chi2_12 = transfer(H, x1, x2)      # (B, N)
    chi2_21 = transfer(Hinv, x2, x1)
    in12 = (chi2_12 < th) & mask[None]
    in21 = (chi2_21 < th) & mask[None]
    score = jnp.sum(jnp.where(in12, th - chi2_12, 0.0), -1) + jnp.sum(
        jnp.where(in21, th - chi2_21, 0.0), -1
    )
    return score, in12 & in21


def _score_f(F, uv1, uv2, mask, sigma2: float):
    """Robust epipolar-distance score of fundamentals (B, 3, 3)."""
    th = 3.841
    th_score = 5.991
    inv_s2 = 1.0 / sigma2
    ones = jnp.ones_like(uv1[:, :1])
    x1 = jnp.concatenate([uv1, ones], -1)
    x2 = jnp.concatenate([uv2, ones], -1)
    l2 = jnp.einsum("bij,nj->bni", F, x1)              # line in img2
    l1 = jnp.einsum("bji,nj->bni", F, x2)              # line in img1
    d2 = (jnp.einsum("ni,bni->bn", x2, l2)) ** 2 / jnp.maximum(
        l2[..., 0] ** 2 + l2[..., 1] ** 2, _EPS
    )
    d1 = (jnp.einsum("ni,bni->bn", x1, l1)) ** 2 / jnp.maximum(
        l1[..., 0] ** 2 + l1[..., 1] ** 2, _EPS
    )
    chi2_2 = d2 * inv_s2
    chi2_1 = d1 * inv_s2
    in2 = (chi2_2 < th) & mask[None]
    in1 = (chi2_1 < th) & mask[None]
    score = jnp.sum(jnp.where(in2, th_score - chi2_2, 0.0), -1) + jnp.sum(
        jnp.where(in1, th_score - chi2_1, 0.0), -1
    )
    return score, in1 & in2


# ---------------------------------------------------------------------------
# Motion recovery
# ---------------------------------------------------------------------------

def _triangulate_and_check(R, t, K, uv1, uv2, mask, sigma2: float,
                           min_parallax_cos: float = 0.99998):
    """Cheirality check of one (R, t) candidate. Camera1 at identity.

    Returns (n_good, pts3d (N, 3), good (N,), median_parallax_cos).
    """
    T1 = jnp.eye(4, dtype=R.dtype)
    T2 = lie.make_T(R, t)
    P1 = K @ T1[:3, :]
    P2 = K @ T2[:3, :]
    # DLT per point
    r0 = uv1[:, 0:1, None] * P1[None, 2:3, :] - P1[None, 0:1, :]
    r1 = uv1[:, 1:2, None] * P1[None, 2:3, :] - P1[None, 1:2, :]
    r2 = uv2[:, 0:1, None] * P2[None, 2:3, :] - P2[None, 0:1, :]
    r3 = uv2[:, 1:2, None] * P2[None, 2:3, :] - P2[None, 1:2, :]
    A = jnp.concatenate([r0, r1, r2, r3], 1)  # (N, 4, 4)
    _, _, vt = jnp.linalg.svd(A)
    X = vt[:, -1, :]
    w = jnp.where(jnp.abs(X[:, 3]) < _EPS, _EPS, X[:, 3])
    pts = X[:, :3] / w[:, None]
    # depths
    z1 = pts[:, 2]
    pc2 = pts @ R.T + t
    z2 = pc2[:, 2]
    # parallax
    C1 = jnp.zeros(3, R.dtype)
    C2 = -R.T @ t
    v1 = pts - C1
    v2 = pts - C2
    cosp = jnp.sum(v1 * v2, -1) / jnp.maximum(
        jnp.linalg.norm(v1, axis=-1) * jnp.linalg.norm(v2, axis=-1), _EPS
    )
    # reprojection errors
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    e1 = jnp.stack(
        [fx * pts[:, 0] / jnp.maximum(z1, _EPS) + cx,
         fy * pts[:, 1] / jnp.maximum(z1, _EPS) + cy], -1
    ) - uv1
    e2 = jnp.stack(
        [fx * pc2[:, 0] / jnp.maximum(z2, _EPS) + cx,
         fy * pc2[:, 1] / jnp.maximum(z2, _EPS) + cy], -1
    ) - uv2
    th2 = 4.0 * sigma2
    good = (
        mask
        & (z1 > 0)
        & (z2 > 0)
        & (cosp < min_parallax_cos)
        & (jnp.sum(e1 * e1, -1) < th2)
        & (jnp.sum(e2 * e2, -1) < th2)
    )
    return jnp.sum(good), pts, good, cosp


class TwoViewInit(NamedTuple):
    success: jax.Array       # () bool
    Tcw2: jax.Array          # (4, 4) pose of view 2 (view 1 = identity)
    pts3d: jax.Array         # (N, 3) triangulated points
    good: jax.Array          # (N,) which correspondences triangulated well
    used_homography: jax.Array  # () bool


def initialize_two_view(
    key,
    uv1,
    uv2,
    mask,
    K,
    n_hyp: int = 256,
    sigma: float = 1.0,
    min_triangulated: int = 50,
) -> TwoViewInit:
    """Monocular two-view bootstrap (reference Initializer::Initialize).

    uv1/uv2 (N, 2) matched undistorted keypoints, mask (N,) valid matches.
    """
    sigma2 = sigma * sigma
    N = uv1.shape[0]
    k1, k2 = jax.random.split(key)
    idx = _sample_indices(k1, n_hyp, 8, N, weights=mask.astype(jnp.float32))
    s1 = uv1[idx]  # (B, 8, 2)
    s2 = uv2[idx]

    # Hartley-normalize full sets once (like the reference's Normalize())
    uv1n, T1 = _normalize_points(uv1, mask)
    uv2n, T2 = _normalize_points(uv2, mask)
    s1n = uv1n[idx]
    s2n = uv2n[idx]

    # Homography hypotheses
    Hn = _solve_h_dlt(s1n, s2n)
    H = jnp.linalg.inv(T2) @ Hn @ T1
    score_h, inl_h = _score_h(H, uv1, uv2, mask, sigma2)
    best_h = jnp.argmax(score_h)
    # refit on the winner's inliers (reference FindHomography recomputes with
    # all inliers of the best iteration)
    w_h = inl_h[best_h].astype(uv1.dtype)
    Hn_ref = _solve_h_dlt(uv1n[None], uv2n[None], w=w_h[None])[0]
    H_ref = jnp.linalg.inv(T2) @ Hn_ref @ T1
    score_h2, _ = _score_h(H_ref[None], uv1, uv2, mask, sigma2)
    better_h = score_h2[0] > score_h[best_h]
    SH = jnp.where(better_h, score_h2[0], score_h[best_h])
    H_best = jnp.where(better_h, H_ref, H[best_h])

    # Fundamental hypotheses
    Fn = _solve_f_8pt(s1n, s2n)
    F = T2.T @ Fn @ T1
    score_f, inl_f = _score_f(F, uv1, uv2, mask, sigma2)
    best_f = jnp.argmax(score_f)
    w_f = inl_f[best_f].astype(uv1.dtype)
    Fn_ref = _solve_f_8pt(uv1n[None], uv2n[None], w=w_f[None])[0]
    F_ref = T2.T @ Fn_ref @ T1
    score_f2, _ = _score_f(F_ref[None], uv1, uv2, mask, sigma2)
    better_f = score_f2[0] > score_f[best_f]
    SF = jnp.where(better_f, score_f2[0], score_f[best_f])
    F_best = jnp.where(better_f, F_ref, F[best_f])

    RH = SH / jnp.maximum(SH + SF, _EPS)
    use_h = RH > 0.40  # reference threshold

    # --- motion candidates ---
    # From F: E = K^T F K -> 4 candidates
    E = K.T @ F_best @ K
    U, s, Vt = jnp.linalg.svd(E)
    # proper rotations
    W = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], E.dtype)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    R1 = R1 * jnp.sign(jnp.linalg.det(R1))
    R2 = R2 * jnp.sign(jnp.linalg.det(R2))
    tu = U[:, 2]
    tu = tu / jnp.maximum(jnp.linalg.norm(tu), _EPS)
    f_cands = [(R1, tu), (R1, -tu), (R2, tu), (R2, -tu)]

    # From H: Faugeras/Zhang decomposition via A = K^-1 H K
    A = jnp.linalg.inv(K) @ H_best @ K
    Ua, sa, Vta = jnp.linalg.svd(A)
    # normalize by middle singular value; hypothesis set from the +-
    # combinations (8 candidates in the reference; we evaluate the same 8)
    d1, d2, d3 = sa[0], sa[1], sa[2]
    An = A / jnp.maximum(d2, _EPS)
    h_cands = _homography_motions(Ua, sa, Vta)

    cands = f_cands + h_cands  # 4 + 8 = 12 (R, t) candidates
    n_goods, ptss, goods, par50s = [], [], [], []
    for (Rc, tc) in cands:
        ng, pts, good, cosp = _triangulate_and_check(Rc, tc, K, uv1, uv2, mask, sigma2)
        n_goods.append(ng)
        ptss.append(pts)
        goods.append(good)
        # parallax of the min(50, n_good)-th best point (reference CheckRT:
        # sorted cos, index min(50,N)-1) — gates low-baseline bootstraps
        cos_sorted = jnp.sort(jnp.where(good, cosp, 1.0))
        kth = jnp.clip(jnp.minimum(ng, 50) - 1, 0, cosp.shape[0] - 1)
        # ALSO gate on the median parallax: with hundreds of matches the
        # 50th-best point is the top few percent, and triangulation noise
        # at a near-zero true baseline inflates exactly that tail (a
        # 0.6-degree-parallax bootstrap passed the 50th-best-only gate).
        # The median is more noise-robust — it defers the wall-world
        # bootstrap from frame 1 to frame ~4 — though reconstructed
        # parallax remains noise-inflated at degenerate baselines, so this
        # tightens rather than closes the leak; landmark-creation health
        # (mapping.N_TRIANG_NEIGHBORS) is what makes weak bootstraps
        # recoverable.
        med = jnp.clip((ng - 1) // 2, 0, cosp.shape[0] - 1)
        cos_km = jnp.maximum(cos_sorted[kth], cos_sorted[med])
        par50s.append(jnp.degrees(jnp.arccos(jnp.clip(cos_km, -1.0, 1.0))))
    n_goods = jnp.stack(n_goods)           # (12,)
    ptss = jnp.stack(ptss)                 # (12, N, 3)
    goods = jnp.stack(goods)               # (12, N)
    par50s = jnp.stack(par50s)             # (12,)
    Rs = jnp.stack([c[0] for c in cands])
    ts = jnp.stack([c[1] for c in cands])

    # restrict to the selected model's candidates
    cand_is_f = jnp.arange(12) < 4
    sel_mask = jnp.where(use_h, ~cand_is_f, cand_is_f)
    n_sel = jnp.where(sel_mask, n_goods, -1)
    win = jnp.argmax(n_sel)
    n_best = n_sel[win]
    # uniqueness: clear winner (reference: second best < 0.75 * best)
    n_second = jnp.sort(n_sel)[-2]
    distinct = n_second.astype(jnp.float32) < 0.75 * n_best.astype(jnp.float32)
    # minimum parallax gate (reference minParallax = 1.0 deg): refuse
    # low-baseline bootstraps whose structure would be depth-degenerate
    enough_parallax = par50s[win] > 1.0
    success = (n_best >= min_triangulated) & distinct & enough_parallax
    Tcw2 = lie.make_T(Rs[win], ts[win])
    return TwoViewInit(
        success=success,
        Tcw2=Tcw2,
        pts3d=ptss[win],
        good=goods[win] & success,
        used_homography=use_h,
    )


def _homography_motions(U, s, Vt):
    """8 (R, t) candidates from the SVD of A = K^-1 H K (Faugeras 1988,
    as in reference Initializer::ReconstructH)."""
    d1, d2, d3 = s[0], s[1], s[2]
    det = jnp.linalg.det(U) * jnp.linalg.det(Vt)
    x1_abs = jnp.sqrt(jnp.maximum((d1 * d1 - d2 * d2) / jnp.maximum(d1 * d1 - d3 * d3, _EPS), 0.0))
    x3_abs = jnp.sqrt(jnp.maximum((d2 * d2 - d3 * d3) / jnp.maximum(d1 * d1 - d3 * d3, _EPS), 0.0))
    cands = []
    # case d' = +d2
    sin_t = jnp.sqrt(
        jnp.maximum((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)
    ) / jnp.maximum((d1 + d3) * d2, _EPS)
    cos_t = (d2 * d2 + d1 * d3) / jnp.maximum((d1 + d3) * d2, _EPS)
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            st = e1 * e3 * sin_t
            Rp = jnp.array(
                [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]], U.dtype
            )
            Rp = Rp.at[0, 0].set(cos_t).at[0, 2].set(-st)
            Rp = Rp.at[2, 0].set(st).at[2, 2].set(cos_t)
            R = det * (U @ Rp @ Vt)
            tp = jnp.array([e1 * x1_abs, 0.0, -e3 * x3_abs], U.dtype) * (d1 - d3)
            t = U @ tp
            t = t / jnp.maximum(jnp.linalg.norm(t), _EPS)
            cands.append((R, t))
    # case d' = -d2
    sin_p = jnp.sqrt(
        jnp.maximum((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)
    ) / jnp.maximum((d1 - d3) * d2, _EPS)
    cos_p = (d1 * d3 - d2 * d2) / jnp.maximum((d1 - d3) * d2, _EPS)
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            sp = e1 * e3 * sin_p
            Rp = jnp.zeros((3, 3), U.dtype)
            Rp = Rp.at[0, 0].set(cos_p).at[0, 2].set(sp)
            Rp = Rp.at[1, 1].set(-1.0)
            Rp = Rp.at[2, 0].set(sp).at[2, 2].set(-cos_p)
            R = det * (U @ Rp @ Vt)
            tp = jnp.array([e1 * x1_abs, 0.0, e3 * x3_abs], U.dtype) * (d1 + d3)
            t = U @ tp
            t = t / jnp.maximum(jnp.linalg.norm(t), _EPS)
            cands.append((R, t))
    return cands[:8]


# ---------------------------------------------------------------------------
# PnP RANSAC
# ---------------------------------------------------------------------------

class PnPResult(NamedTuple):
    success: jax.Array   # () bool
    Tcw: jax.Array       # (4, 4)
    inliers: jax.Array   # (N,) bool


def _dlt_pnp(Xw, uv, K):
    """Batched DLT pose from (B, S, 3) points and (B, S, 2) pixels.

    Solves for P = [R|t] up to scale via SVD, then projects onto SE3.
    """
    Kinv = jnp.linalg.inv(K)
    ones = jnp.ones(uv.shape[:-1] + (1,), uv.dtype)
    rays = jnp.einsum("ij,bsj->bsi", Kinv, jnp.concatenate([uv, ones], -1))
    x, y = rays[..., 0], rays[..., 1]
    X, Y, Z = Xw[..., 0], Xw[..., 1], Xw[..., 2]
    o = jnp.ones_like(x)
    z = jnp.zeros_like(x)
    r1 = jnp.stack([X, Y, Z, o, z, z, z, z, -x * X, -x * Y, -x * Z, -x], -1)
    r2 = jnp.stack([z, z, z, z, X, Y, Z, o, -y * X, -y * Y, -y * Z, -y], -1)
    A = jnp.concatenate([r1, r2], -2)  # (B, 2S, 12)
    _, _, vt = jnp.linalg.svd(A, full_matrices=True)
    p = vt[..., -1, :].reshape(-1, 3, 4)
    Rr = p[:, :, :3]
    # project to rotation: R = U V^T, fix scale/sign by det and singular values
    U, s, Vt = jnp.linalg.svd(Rr)
    detUV = jnp.linalg.det(U @ Vt)
    D = jnp.stack([jnp.ones_like(detUV), jnp.ones_like(detUV), detUV], -1)
    R = U @ (D[:, :, None] * Vt)
    scale = jnp.sum(s, -1) / 3.0 * jnp.sign(detUV)
    t = p[:, :, 3] / jnp.where(jnp.abs(scale) < _EPS, _EPS, scale)[:, None]
    return R, t


def pnp_ransac(
    key, Xw, uv, mask, K, n_hyp: int = 128, chi2_thres: float = 5.991,
    min_inliers: int = 10, refine_iters: int = 8,
) -> PnPResult:
    """Pose from 2D-3D matches with outliers (reference PnPsolver::iterate)."""
    N = Xw.shape[0]
    idx = _sample_indices(key, n_hyp, 6, N, weights=mask.astype(jnp.float32))
    R, t = _dlt_pnp(Xw[idx], uv[idx], K)  # (B, 3, 3), (B, 3)
    # count inliers per hypothesis
    pc = jnp.einsum("bij,nj->bni", R, Xw) + t[:, None, :]
    z = jnp.maximum(pc[..., 2], _EPS)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    u = fx * pc[..., 0] / z + cx
    v = fy * pc[..., 1] / z + cy
    err2 = (u - uv[None, :, 0]) ** 2 + (v - uv[None, :, 1]) ** 2
    inl = (err2 < chi2_thres) & (pc[..., 2] > 0) & mask[None]
    counts = jnp.sum(inl, -1)
    win = jnp.argmax(counts)
    Tcw = lie.make_T(R[win], t[win])
    inliers = inl[win]
    # GN polish seeded with the winner's inliers; later rounds re-admit any
    # masked observation that fits the refined pose
    from ..solvers import pose_opt

    res = pose_opt.optimize_pose(
        Tcw, Xw, uv, jnp.ones((N,), uv.dtype), mask, K,
        n_rounds=3, iters_per_round=refine_iters, active0=inliers,
    )
    success = res.n_inliers >= min_inliers
    return PnPResult(success=success, Tcw=res.Tcw, inliers=res.inliers)


# ---------------------------------------------------------------------------
# Sim3 RANSAC
# ---------------------------------------------------------------------------

class Sim3Result(NamedTuple):
    success: jax.Array   # () bool
    R: jax.Array         # (3, 3) with p2 ~ s R p1 + t
    t: jax.Array         # (3,)
    s: jax.Array         # ()
    inliers: jax.Array   # (N,) bool


def sim3_ransac(
    key, p1, p2, uv1, uv2, Tcw1, Tcw2, K, mask,
    n_hyp: int = 128, fix_scale: bool = False,
    chi2_thres: float = 9.21, min_inliers: int = 20,
) -> Sim3Result:
    """Similarity between matched 3D landmark sets with mutual reprojection
    inlier check (reference Sim3Solver::iterate + CheckInliers).

    p1/p2: (N, 3) world points in map1/map2 frames; uv1/uv2 their observed
    pixels in KF1/KF2; Tcw1/Tcw2 the keyframe poses; mask valid matches.
    """
    N = p1.shape[0]
    idx = _sample_indices(key, n_hyp, 3, N, weights=mask.astype(jnp.float32))
    R, t, s = lie.horn_align(p1[idx], p2[idx], fix_scale=fix_scale)  # batched
    # inlier check: project p1 through S12 into KF2 and p2 through S21 into KF1
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]

    def reproj_err(pts_world, Tcw, uv):
        pc = lie.transform_points(Tcw, pts_world)
        z = jnp.maximum(pc[..., 2], _EPS)
        u = fx * pc[..., 0] / z + cx
        v = fy * pc[..., 1] / z + cy
        return (u - uv[None, :, 0]) ** 2 + (v - uv[None, :, 1]) ** 2

    p1_in_2 = s[:, None, None] * jnp.einsum("bij,nj->bni", R, p1) + t[:, None, :]
    err_2 = reproj_err(p1_in_2, Tcw2, uv2)
    s_inv = 1.0 / jnp.maximum(s, _EPS)
    Rt = jnp.swapaxes(R, -1, -2)
    t_inv = -s_inv[:, None] * jnp.einsum("bij,bj->bi", Rt, t)
    p2_in_1 = s_inv[:, None, None] * jnp.einsum("bij,nj->bni", Rt, p2) + t_inv[:, None, :]
    err_1 = reproj_err(p2_in_1, Tcw1, uv1)
    inl = (err_2 < chi2_thres) & (err_1 < chi2_thres) & mask[None]
    counts = jnp.sum(inl, -1)
    win = jnp.argmax(counts)
    # re-fit on the winner's inliers (all points, weighted by inlier mask)
    w = inl[win].astype(p1.dtype)
    R_f, t_f, s_f = lie.horn_align(p1, p2, w=w, fix_scale=fix_scale)
    success = counts[win] >= min_inliers
    return Sim3Result(success=success, R=R_f, t=t_f, s=s_f, inliers=inl[win])
