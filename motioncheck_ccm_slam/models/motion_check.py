"""Motion Check: trajectory-shape gating of Global Bundle Adjustment.

The fork's headline safeguard (reference src/Map.cpp:1754-4090, survey §5.9):
compare each keyframe's post-GBA step vector against its pre-GBA ("tracking")
step vector in the IMU/body frame; keyframes whose motion changed shape
implausibly accumulate "doubt"; doubted keyframes become violators; the
verdict either reverts the whole GBA or surgically deletes the violators.

Device formulation: the per-KF comparison (reference ``MotionCheck``
src/Map.cpp:2853-2909) is cheap vector math, but the anchor bookkeeping of
``CorrectKF_V3`` (:3647-3840) is inherently sequential (each KF's step is
measured from the previous non-doubted anchor) — expressed as one
``lax.scan`` per pass carrying (anchor indices, margins, doubt array).
Two passes run (forward, then reversed with margin relaxation near doubted
anchors), then a vectorized verdict (``SetViolateFlag`` :3879 + ``CheckMVKF``
:3932 + the revert/delete decision :3801-3820).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import MotionCheckParams
from ..ops import lie
from . import map_state as ms


def body_positions(Tcw, T_SC_inv):
    """Tws translation per KF: (Tcw^-1 . T_SC^-1)[0:3, 3] (reference
    ComputeTws src/Map.cpp:3632 / SetTcwCurrent :4027)."""
    Twc = lie.inv_T(Tcw)
    Tws = Twc @ T_SC_inv
    return Tws[..., :3, 3]


def _angle_deg(a, b):
    """Angle (deg) between vectors; the reference uses 180/3.14 (not pi) —
    reproduced for parity (src/Map.cpp:2878)."""
    na = jnp.linalg.norm(a, axis=-1)
    nb = jnp.linalg.norm(b, axis=-1)
    cos = jnp.sum(a * b, -1) / jnp.maximum(na * nb, 1e-12)
    return jnp.arccos(jnp.clip(cos, -1.0, 1.0)) * (180.0 / 3.14)


def _plane_angle_deg(a, b, i, j):
    pa = jnp.stack([a[..., i], a[..., j]], -1)
    pb = jnp.stack([b[..., i], b[..., j]], -1)
    return _angle_deg(pa, pb)


def motion_violates(step_post, prev_step_post, step_pre, prev_step_pre,
                    degree_margin, movement_margin,
                    params: MotionCheckParams):
    """The three checks of reference Map::MotionCheck (:2894-2907). Returns
    True if the KF violates motion (any check fails).

    Quirk preserved: all three per-plane limits use the *xy* tracking angle
    (reference :2902 uses tracking_xy_degree for xy, yz and zx)."""
    deg = _angle_deg(step_post, prev_step_post)
    tdeg = _angle_deg(step_pre, prev_step_pre)
    fail_dir = jnp.abs(deg - tdeg) > (
        jnp.minimum(tdeg * params.dir3d_track_mult, params.dir3d_cap_deg)
        * degree_margin
    )

    mr = jnp.linalg.norm(step_post) / jnp.maximum(
        jnp.linalg.norm(prev_step_post), 1e-12
    )
    tmr = jnp.linalg.norm(step_pre) / jnp.maximum(
        jnp.linalg.norm(prev_step_pre), 1e-12
    )
    rfac = params.ratio_mult * movement_margin
    fail_ratio = ((mr / jnp.maximum(tmr, 1e-12)) > rfac) | (
        (tmr / jnp.maximum(mr, 1e-12)) > rfac
    )

    xy = _plane_angle_deg(step_post, prev_step_post, 0, 1)
    yz = _plane_angle_deg(step_post, prev_step_post, 1, 2)
    zx = _plane_angle_deg(step_post, prev_step_post, 2, 0)
    txy = _plane_angle_deg(step_pre, prev_step_pre, 0, 1)
    tyz = _plane_angle_deg(step_pre, prev_step_pre, 1, 2)
    tzx = _plane_angle_deg(step_pre, prev_step_pre, 2, 0)
    lim_pl = (
        jnp.minimum(txy * params.plane_track_mult, params.plane_cap_deg)
        * degree_margin
    )
    fail_plane = (
        (jnp.abs(xy - txy) > lim_pl)
        | (jnp.abs(yz - tyz) > lim_pl)
        | (jnp.abs(zx - tzx) > lim_pl)
    )
    return fail_dir | fail_ratio | fail_plane


def motion_check_pass(pos_post, pos_pre, valid, doubt0,
                      params: MotionCheckParams, reverse: bool):
    """One CorrectKF_V3 pass over a time-ordered (or reversed) sequence.

    pos_post/pos_pre: (N, 3); valid: (N,) live slots in scan order; doubt0:
    (N,) doubt at pass start (doubted KFs are skipped entirely, reference
    :3698-3703). Returns (doubt (N,), n_failures ()).
    """
    N = pos_post.shape[0]
    n_valid = jnp.sum(valid)
    rank = jnp.cumsum(valid.astype(jnp.int32))  # 1-based KF_check_count
    in_window = (rank > params.skip_edge_kfs) & (
        rank < n_valid - params.skip_edge_kfs
    )

    def step(carry, k):
        (last, last2, nanchors, deg_m, mov_m, doubt, nfail) = carry
        act = valid[k]
        skipped = act & in_window[k] & (doubt0[k] >= params.violate_doubt_thres)
        process = act & ~skipped
        checkable = process & in_window[k] & (nanchors >= 2)

        p_post = pos_post[k]
        p_pre = pos_pre[k]
        lp_post = pos_post[last]
        lp_pre = pos_pre[last]
        l2p_post = pos_post[last2]
        l2p_pre = pos_pre[last2]
        step_post = p_post - lp_post
        step_pre = p_pre - lp_pre
        prev_step_post = lp_post - l2p_post
        prev_step_pre = lp_pre - l2p_pre

        fail = checkable & motion_violates(
            step_post, prev_step_post, step_pre, prev_step_pre,
            deg_m, mov_m, params,
        )
        inc = jnp.where(fail, 1, 0)
        doubt = doubt.at[k].add(inc)
        doubt = doubt.at[last].add(jnp.where(fail & (nanchors >= 1), 1, 0))
        nfail = nfail + inc

        # margin update for the NEXT iteration (reference :3716-3729):
        # reverse pass relaxes when recent anchors carry doubt; else reset
        if reverse:
            relax = (doubt0[last] >= params.violate_doubt_thres) | (
                doubt0[last2] >= params.violate_doubt_thres
            )
            deg_m = jnp.where(relax, jnp.minimum(deg_m * params.margin_relax,
                                                 params.margin_cap), 1.0)
            mov_m = jnp.where(relax, jnp.minimum(mov_m * params.margin_relax,
                                                 params.margin_cap), 1.0)

        # anchor update for every processed KF (edge KFs included, :3752-3778)
        last2 = jnp.where(process, last, last2)
        last = jnp.where(process, k, last)
        nanchors = jnp.where(process, jnp.minimum(nanchors + 1, 2), nanchors)
        return (last, last2, nanchors, deg_m, mov_m, doubt, nfail), None

    init = (jnp.int32(0), jnp.int32(0), jnp.int32(0),
            jnp.float32(1.0), jnp.float32(1.0), doubt0, jnp.int32(0))
    (last, last2, _, _, _, doubt, nfail), _ = jax.lax.scan(
        step, init, jnp.arange(N)
    )
    return doubt, nfail


class MotionCheckVerdict(NamedTuple):
    revert: jax.Array        # () bool — roll the whole map back
    violate: jax.Array       # (N,) bool in scan order
    doubt: jax.Array         # (N,) i32
    longest_run: jax.Array   # () i32
    n_rev_failures: jax.Array  # () i32 — failures during the reverse pass


def run_motion_check(pos_post, pos_pre, valid, params: MotionCheckParams
                     ) -> MotionCheckVerdict:
    """Forward + reverse CorrectKF_V3 passes + verdict over one client's
    time-ordered KF sequence."""
    doubt0 = jnp.zeros(pos_post.shape[0], jnp.int32)
    doubt_f, _ = motion_check_pass(pos_post, pos_pre, valid, doubt0,
                                   params, reverse=False)
    doubt_r_rev, nfail_rev = motion_check_pass(
        pos_post[::-1], pos_pre[::-1], valid[::-1], doubt_f[::-1],
        params, reverse=True,
    )
    doubt = doubt_r_rev[::-1]
    violate = valid & (doubt >= params.violate_doubt_thres)

    # longest consecutive violating run (CheckMVKF :3932)
    def run_step(carry, v):
        cur, best = carry
        cur = jnp.where(v, cur + 1, 0)
        return (cur, jnp.maximum(best, cur)), None

    (_, longest), _ = jax.lax.scan(
        run_step, (jnp.int32(0), jnp.int32(0)), violate.astype(jnp.int32)
    )
    n_valid = jnp.sum(valid)
    # revert if long run OR >=10% of KFs failed the reverse pass (reference
    # :3805: badKF_counter >= foundKFs.size()/10)
    revert = (longest >= params.revert_run_thres) | (
        nfail_rev.astype(jnp.float32)
        >= params.revert_frac_thres * n_valid.astype(jnp.float32)
    )
    return MotionCheckVerdict(
        revert=revert, violate=violate, doubt=doubt,
        longest_run=longest, n_rev_failures=nfail_rev,
    )


# ---------------------------------------------------------------------------
# Map-level integration
# ---------------------------------------------------------------------------

def snapshot_pre_gba(kf: ms.KFBlock, T_SC_inv) -> ms.KFBlock:
    """SetTcwCurrent (reference src/Map.cpp:4027): record pre-GBA poses and
    body positions for every valid KF."""
    tws = body_positions(kf.Tcw, T_SC_inv)
    return kf._replace(
        Tcw_pre_gba=jnp.where(kf.valid[:, None, None], kf.Tcw, kf.Tcw_pre_gba),
        tracking_tws=jnp.where(kf.valid[:, None], tws, kf.tracking_tws),
    )


def check_after_gba(kf: ms.KFBlock, T_SC_inv, params: MotionCheckParams,
                    client_id=None):
    """Run the double-pass check on the current (post-GBA) poses vs the
    snapshot. Returns (verdict, order) where order maps scan position ->
    KF slot."""
    ts = np.asarray(kf.timestamp)
    valid = np.asarray(kf.valid)
    if client_id is not None:
        valid = valid & (np.asarray(kf.client_id) == client_id)
    order = np.argsort(np.where(valid, ts, np.inf), kind="stable")
    order_j = jnp.asarray(order.astype(np.int32))
    pos_post = body_positions(kf.Tcw, T_SC_inv)[order_j]
    pos_pre = kf.tracking_tws[order_j]
    valid_sorted = jnp.asarray(valid)[order_j]
    verdict = run_motion_check(pos_post, pos_pre, valid_sorted, params)
    return verdict, order


def apply_verdict(kf: ms.KFBlock, mp: ms.MPBlock, verdict: MotionCheckVerdict,
                  order: np.ndarray) -> Tuple[ms.KFBlock, ms.MPBlock, bool]:
    """Apply the Motion Check verdict (reference CorrectKF_V3 :3807-3820):

    - revert: every KF pose resets to the pre-GBA snapshot (``SetPose(
      Tcw_current)``); the GBA driver restores its own landmark snapshot;
    - else: violating KFs are deleted (``DeleteMotionViolateKF`` :3920) and
      their observations dropped; landmarks left with no observations die.
    Returns (kf, mp, reverted).
    """
    if bool(verdict.revert):
        kf2 = kf._replace(Tcw=jnp.where(kf.valid[:, None, None],
                                        kf.Tcw_pre_gba, kf.Tcw))
        return kf2, mp, True
    violate_slots = jnp.zeros(kf.valid.shape[0], bool).at[
        jnp.asarray(order.astype(np.int32))
    ].set(verdict.violate)
    new_valid = kf.valid & ~violate_slots
    kf2 = kf._replace(
        valid=new_valid,
        mp_idx=jnp.where(new_valid[:, None], kf.mp_idx, -1),
        feat_valid=kf.feat_valid & new_valid[:, None],
    )
    n_obs = ms.mp_observation_counts(kf2, mp.valid.shape[0])
    mp2 = mp._replace(valid=mp.valid & (n_obs > 0))
    return kf2, mp2, False
