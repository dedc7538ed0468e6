"""Sim3 essential-graph pose-graph optimization.

Replaces the reference's ``Optimizer::OptimizeEssentialGraphLoopClosure``
(src/Optimizer.cpp:1064) and ``OptimizeEssentialGraphMapFusion`` (:1339):
after a loop closure / map merge, distribute the Sim3 correction over the
whole keyframe graph (loop edges + spanning tree + strong covisibility
edges), then the map layer corrects landmarks through their reference
keyframes.

Formulation
-----------
Vertices: S_iw (world -> KF i Sim3, stored [sR|t] 4x4). Edge measurements
follow the reference exactly (src/Optimizer.cpp:1140-1283): *normal* edges
(spanning tree / old loop edges / strong covisibility) measure
S_ji = S_jw S_iw^-1 from the **pre-correction** poses (``NonCorrectedSim3``),
while *loop-connection* edges (the new cross-loop covisibility links created
by landmark fusion) measure from the **corrected** estimates. The vertex
initialization mixes corrected (covis group) and uncorrected (everyone else)
poses — so the loop correction discrepancy appears as residuals on the edges
straddling the corrected-group boundary and the solver distributes it over
the whole graph. Edge error: e_ij = log_sim3(S_ji_meas^-1 . S_jw . S_iw^-1)
in R^7.

Two solver paths share the per-edge residual/Jacobian kernel:

- ``dense``: normal equations assembled into a (7V, 7V) system, Cholesky.
  Matmul-friendly for compacted graphs up to a few hundred vertices.
- ``cg``: matrix-free LM — only the (V, 7, 7) block diagonal is
  materialized; every H @ v product is two edge-gather einsums plus a
  scatter-add, solved with block-Jacobi preconditioned conjugate gradients.
  Scales to the server operating point (2048+ KFs) with O(E) memory.

``method="auto"`` picks dense for small V. Callers should compact vertices
to valid keyframes first (see loop_closing._optimize_essential_graph).

Fixed vertices (the loop KF / map origin) are frozen by identity rows.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import lie

DENSE_MAX_V = 192   # above this, (7V)^2 assembly loses to matrix-free CG


class PoseGraphEdges(NamedTuple):
    """Fixed-capacity edge list (E slots, masked)."""

    i: jax.Array          # (E,) i32 — vertex index i
    j: jax.Array          # (E,) i32 — vertex index j
    S_ji_meas: jax.Array  # (E, 4, 4) measured S_jw S_iw^-1
    weight: jax.Array     # (E,) f32 edge information scale
    valid: jax.Array      # (E,) bool


class PoseGraphResult(NamedTuple):
    S_iw: jax.Array       # (V, 4, 4) optimized Sim3 poses
    cost: jax.Array


def make_edge_measurements(S_iw, edges_i, edges_j):
    """S_ji_meas = S_jw S_iw^-1 from the given vertex poses. Pass the
    PRE-correction poses for normal edges (reference ``NonCorrectedSim3``)
    and the corrected estimates for loop-connection edges."""
    Sj = S_iw[edges_j]
    Si_inv = lie.sim3_inv(S_iw[edges_i])
    return Sj @ Si_inv


def _edge_error(Si, Sj, S_ji_meas_inv):
    """log_sim3(S_ji_meas^-1 Sj Si^-1) -> (7,)."""
    return lie.sim3_log(S_ji_meas_inv @ Sj @ lie.sim3_inv(Si))


def _edge_error_perturbed(xi_i, xi_j, Si, Sj, S_ji_meas_inv):
    Si_p = lie.sim3_exp(xi_i[None])[0] @ Si
    Sj_p = lie.sim3_exp(xi_j[None])[0] @ Sj
    return _edge_error(Si_p, Sj_p, S_ji_meas_inv)


def _edge_res_jac(Si, Sj, Minv):
    zero7 = jnp.zeros(7, jnp.float32)
    r = _edge_error(Si, Sj, Minv)
    Ji = jax.jacfwd(lambda x: _edge_error_perturbed(x, zero7, Si, Sj, Minv))(zero7)
    Jj = jax.jacfwd(lambda x: _edge_error_perturbed(zero7, x, Si, Sj, Minv))(zero7)
    return r, Ji, Jj


_edge_rj = jax.vmap(_edge_res_jac)


def _edge_terms(S, edges: PoseGraphEdges, meas_inv):
    """Residuals, weighted Jacobians, and robust cost for all edges."""
    Si = S[edges.i]
    Sj = S[edges.j]
    r, Ji, Jj = _edge_rj(Si, Sj, meas_inv)   # (E,7), (E,7,7), (E,7,7)
    w = jnp.where(edges.valid, edges.weight, 0.0)
    cost = jnp.sum(w * jnp.sum(r * r, -1))
    return r, Ji, Jj, w, cost


def _edge_cost(S, edges: PoseGraphEdges, meas_inv):
    Si = S[edges.i]
    Sj = S[edges.j]
    r = jax.vmap(_edge_error)(Si, Sj, meas_inv)
    w = jnp.where(edges.valid, edges.weight, 0.0)
    return jnp.sum(w * jnp.sum(r * r, -1))


# ---------------------------------------------------------------------------
# Dense path (small compacted graphs)
# ---------------------------------------------------------------------------

def _assemble_dense(S, edges: PoseGraphEdges, meas_inv, V: int):
    E = edges.i.shape[0]
    r, Ji, Jj, w, cost = _edge_terms(S, edges, meas_inv)
    wJi = Ji * w[:, None, None]
    wJj = Jj * w[:, None, None]
    H = jnp.zeros((V * 7, V * 7), jnp.float32)
    b = jnp.zeros((V * 7,), jnp.float32)

    def rows(idx):
        return idx[:, None, None] * 7 + jnp.arange(7)[None, :, None]

    def cols(idx):
        return idx[:, None, None] * 7 + jnp.arange(7)[None, None, :]

    Hii = jnp.einsum("eai,eaj->eij", wJi, Ji)
    Hjj = jnp.einsum("eai,eaj->eij", wJj, Jj)
    Hij = jnp.einsum("eai,eaj->eij", wJi, Jj)
    ri = rows(edges.i)
    ci = cols(edges.i)
    rj = rows(edges.j)
    cj = cols(edges.j)
    shape = (E, 7, 7)
    H = H.at[jnp.broadcast_to(ri, shape), jnp.broadcast_to(ci, shape)].add(Hii)
    H = H.at[jnp.broadcast_to(rj, shape), jnp.broadcast_to(cj, shape)].add(Hjj)
    H = H.at[jnp.broadcast_to(ri, shape), jnp.broadcast_to(cj, shape)].add(Hij)
    H = H.at[jnp.broadcast_to(rj, shape), jnp.broadcast_to(ci, shape)].add(
        jnp.swapaxes(Hij, -1, -2)
    )
    b = b.at[(edges.i[:, None] * 7 + jnp.arange(7)[None, :]).reshape(-1)].add(
        (-jnp.einsum("eai,ea->ei", wJi, r)).reshape(-1)
    )
    b = b.at[(edges.j[:, None] * 7 + jnp.arange(7)[None, :]).reshape(-1)].add(
        (-jnp.einsum("eai,ea->ei", wJj, r)).reshape(-1)
    )
    return H, b, cost


def _optimize_dense(S_iw_init, edges, fixed, meas_inv, iterations,
                    lambda_init):
    V = S_iw_init.shape[0]
    fixed_rows = jnp.repeat(fixed, 7)

    def body(_, state):
        S, lam = state
        H, b, cost = _assemble_dense(S, edges, meas_inv, V)
        # freeze fixed vertices
        H = jnp.where(fixed_rows[:, None], 0.0, H)
        H = jnp.where(fixed_rows[None, :], 0.0, H)
        H = H + jnp.diag(jnp.where(fixed_rows, 1.0, 0.0))
        b = jnp.where(fixed_rows, 0.0, b)
        d = jnp.diag(H)
        Hd = H + jnp.diag(lam * d + 1e-10)
        dx = jax.scipy.linalg.cho_solve(
            jax.scipy.linalg.cho_factor(Hd + 1e-8 * jnp.eye(V * 7)), b
        ).reshape(V, 7)
        dx = jnp.where(fixed[:, None], 0.0, dx)
        S_new = lie.sim3_exp(dx) @ S
        cost_new = _edge_cost(S_new, edges, meas_inv)
        accept = cost_new < cost
        S = jnp.where(accept, S_new, S)
        lam = jnp.where(accept, jnp.maximum(lam * 0.3, 1e-16),
                        jnp.minimum(jnp.maximum(lam, 1e-10) * 10.0, 1e2))
        return S, lam

    S, _ = jax.lax.fori_loop(
        0, iterations, body, (S_iw_init, jnp.float32(lambda_init))
    )
    return S, _edge_cost(S, edges, meas_inv)


# ---------------------------------------------------------------------------
# Matrix-free PCG path (server-scale graphs)
# ---------------------------------------------------------------------------

def _optimize_cg(S_iw_init, edges, fixed, meas_inv, iterations,
                 lambda_init, pcg_iters: int):
    """LM where each damped-normal-equation solve is block-Jacobi PCG with
    H @ v computed edge-wise: u_e = Ji v_i + Jj v_j, then scatter
    wJi^T u_e / wJj^T u_e. Memory is O(E * 49 + V * 49) — no (7V)^2."""
    V = S_iw_init.shape[0]
    eye7 = jnp.eye(7, dtype=jnp.float32)

    def body(_, state):
        S, lam = state
        r, Ji, Jj, w, cost = _edge_terms(S, edges, meas_inv)
        wJi = Ji * w[:, None, None]
        wJj = Jj * w[:, None, None]
        # block diagonal + gradient
        Hii = jnp.einsum("eai,eaj->eij", wJi, Ji)
        Hjj = jnp.einsum("eai,eaj->eij", wJj, Jj)
        Hd = jnp.zeros((V, 7, 7), jnp.float32)
        Hd = Hd.at[edges.i].add(Hii).at[edges.j].add(Hjj)
        b = jnp.zeros((V, 7), jnp.float32)
        b = b.at[edges.i].add(-jnp.einsum("eai,ea->ei", wJi, r))
        b = b.at[edges.j].add(-jnp.einsum("eai,ea->ei", wJj, r))
        b = jnp.where(fixed[:, None], 0.0, b)
        # damping on the diagonal entries (same rule as the dense path)
        d = jnp.diagonal(Hd, axis1=-2, axis2=-1)           # (V, 7)
        damp = lam * d + 1e-10

        def matvec(v):
            vz = jnp.where(fixed[:, None], 0.0, v)
            u = (jnp.einsum("eab,eb->ea", Ji, vz[edges.i])
                 + jnp.einsum("eab,eb->ea", Jj, vz[edges.j]))
            out = jnp.zeros((V, 7), jnp.float32)
            out = out.at[edges.i].add(jnp.einsum("eab,ea->eb", wJi, u))
            out = out.at[edges.j].add(jnp.einsum("eab,ea->eb", wJj, u))
            out = out + damp * vz
            return jnp.where(fixed[:, None], v, out)

        # block-Jacobi preconditioner from the damped diagonal blocks
        Hd_damped = Hd + jnp.eye(7)[None] * damp[:, :, None] * eye7[None]
        Hd_damped = jnp.where(fixed[:, None, None], eye7[None], Hd_damped)
        M_inv = jnp.linalg.inv(Hd_damped + 1e-8 * eye7[None])

        def precond(rv):
            return jnp.einsum("vij,vj->vi", M_inv, rv)

        x0 = jnp.zeros_like(b)
        r0 = b
        z0 = precond(r0)

        def cg_step(_, st):
            x, rr, z, p, rz = st
            Ap = matvec(p)
            pAp = jnp.sum(p * Ap)
            alpha = rz / jnp.where(jnp.abs(pAp) < 1e-12, 1.0, pAp)
            x = x + alpha * p
            rr = rr - alpha * Ap
            z = precond(rr)
            rz_new = jnp.sum(rr * z)
            beta = rz_new / jnp.where(jnp.abs(rz) < 1e-12, 1.0, rz)
            p = z + beta * p
            return x, rr, z, p, rz_new

        dx, *_ = jax.lax.fori_loop(
            0, pcg_iters, cg_step, (x0, r0, z0, z0, jnp.sum(r0 * z0))
        )
        dx = jnp.where(fixed[:, None], 0.0, dx)
        S_new = lie.sim3_exp(dx) @ S
        cost_new = _edge_cost(S_new, edges, meas_inv)
        accept = cost_new < cost
        S = jnp.where(accept, S_new, S)
        lam = jnp.where(accept, jnp.maximum(lam * 0.3, 1e-16),
                        jnp.minimum(jnp.maximum(lam, 1e-10) * 10.0, 1e2))
        return S, lam

    S, _ = jax.lax.fori_loop(
        0, iterations, body, (S_iw_init, jnp.float32(lambda_init))
    )
    return S, _edge_cost(S, edges, meas_inv)


def optimize_pose_graph(
    S_iw_init,
    edges: PoseGraphEdges,
    fixed,
    iterations: int = 10,
    lambda_init: float = 1e-16,
    method: str = "auto",
    pcg_iters: int = 60,
) -> PoseGraphResult:
    """LM over the Sim3 pose graph. V static; E static with masks.

    fixed: (V,) bool — gauge vertices (loop KF, reference Optimizer.cpp:1085).
    method: "dense" | "cg" | "auto" (dense below DENSE_MAX_V vertices).
    """
    V = S_iw_init.shape[0]
    meas_inv = lie.sim3_inv(edges.S_ji_meas)
    if method == "auto":
        method = "dense" if V <= DENSE_MAX_V else "cg"
    if method == "dense":
        S, cost = _optimize_dense(S_iw_init, edges, fixed, meas_inv,
                                  iterations, lambda_init)
    else:
        S, cost = _optimize_cg(S_iw_init, edges, fixed, meas_inv,
                               iterations, lambda_init, pcg_iters)
    return PoseGraphResult(S_iw=S, cost=cost)


def correct_landmarks(Xw, ref_kf_idx, S_iw_before, S_iw_after):
    """Move landmarks with their reference keyframes after a pose-graph solve
    (reference Optimizer.cpp:1287-1326): X' = S_after^-1( S_before( X ) )."""
    Sb = S_iw_before[ref_kf_idx]          # (L, 4, 4) world->kf (old)
    Sa_inv = lie.sim3_inv(S_iw_after[ref_kf_idx])
    x_kf = jnp.einsum("lij,lj->li", Sb[:, :3, :3], Xw) + Sb[:, :3, 3]
    return jnp.einsum("lij,lj->li", Sa_inv[:, :3, :3], x_kf) + Sa_inv[:, :3, 3]


def se3_from_sim3(S):
    """Project optimized Sim3 back to SE3: divide translation by scale
    (reference: [R t/s; 0 1] after essential-graph optimization)."""
    R, t, s = lie.split_sim3(S)
    return lie.make_T(R, t / s[..., None])
