"""Client tracking: the frame-rate visual-odometry state machine.

Replaces the reference ``Tracking`` (src/Tracking.cpp): monocular
initialization, constant-velocity motion model, local-map tracking, keyframe
decision. The thread-and-spinlock structure is gone — ``Tracker.process`` is
called per frame by the client system; all numeric stages run as one jitted
kernel over the fixed-capacity map blocks.

Key redesign: the reference's three matching stages (last-frame
projection, reference-KF BoW, local-map projection — Tracking.cpp:516-722)
collapse into two passes of one dense projection-match kernel against the
*whole clipped client map* (<= a few thousand landmarks): pass 1 with a wide
radius at the motion-model pose, pose-optimize, pass 2 with a tight radius at
the refined pose, pose-optimize again. Brute force over the clipped map is
cheaper as one batched kernel than replicating the covisibility bookkeeping.
"""
from __future__ import annotations

import dataclasses
import enum
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Config
from ..ops import geometry, lie, matching, orb, ransac
from ..solvers import pose_opt
from . import frame as frame_mod
from .map_state import MapState


class TrackState(enum.Enum):
    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    OK = 2
    LOST = 3


# ---------------------------------------------------------------------------
# Jitted tracking kernel
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("n_levels",))
def _project_and_predict(Tcw, Xw, normal, min_dist, max_dist, mp_valid, K,
                         width, height, scale_factor, n_levels):
    """Frustum/scale/angle visibility + predicted octave for all landmarks
    (reference Frame::isInFrustum + MapPoint::PredictScale)."""
    R, t = Tcw[:3, :3], Tcw[:3, 3]
    # elementwise multiply + reduce: full f32 (a matmul may run in TF32)
    pc = jnp.sum(Xw[:, None, :] * R[None], -1) + t
    z = pc[:, 2]
    uv = geometry.project(pc[None], K)[0]
    Ow = -jnp.sum(R * t[:, None], 0)
    v = Xw - Ow
    dist = jnp.linalg.norm(v, axis=-1)
    cos_view = jnp.sum(v * normal, -1) / jnp.maximum(dist, 1e-9)
    visible = (
        mp_valid
        & (z > 0.05)
        & geometry.in_image(uv, width, height)
        & (dist >= min_dist)
        & (dist <= max_dist)
        & (cos_view > 0.5)
    )
    ratio = jnp.maximum(max_dist / jnp.maximum(dist, 1e-9), 1e-9)
    octave = jnp.ceil(jnp.log(ratio) / jnp.log(scale_factor)).astype(jnp.int32)
    octave = jnp.clip(octave, 0, n_levels - 1)
    return uv, octave, visible


@functools.partial(jax.jit, static_argnames=("n_levels",))
def _track_two_pass(
    feats_xy, feats_desc, feats_octave, feats_angle, feats_valid,
    Tcw_pred, Tcw_last,
    mp_Xw, mp_desc, mp_normal, mp_min_dist, mp_max_dist, mp_valid,
    K, width, height, scale_factor_arr, inv_sigma2_arr,
    n_levels,
):
    """Two-pass projection tracking. Returns (Tcw, per-feature mp slot,
    n_inliers, n_visible)."""
    scale_factor = scale_factor_arr[1] / scale_factor_arr[0]

    def match_pass(Tcw, base_radius, nn_ratio):
        uv_proj, oct_pred, visible = _project_and_predict(
            Tcw, mp_Xw, mp_normal, mp_min_dist, mp_max_dist, mp_valid,
            K, width, height, scale_factor, n_levels,
        )
        radius = base_radius * scale_factor_arr[jnp.clip(oct_pred, 0, n_levels - 1)]
        m = matching.search_by_projection(
            mp_desc, uv_proj, oct_pred, visible,
            feats_desc, feats_xy, feats_octave, feats_valid,
            radius, max_dist=matching.TH_HIGH, nn_ratio=nn_ratio,
        )
        return m, visible

    F = feats_xy.shape[0]
    NM = mp_Xw.shape[0]
    inv_s2 = inv_sigma2_arr[jnp.clip(feats_octave, 0, n_levels - 1)]

    def pass1(Tcw0):
        """Wide-radius match at a pose candidate + quick pose opt."""
        m1, vis1 = match_pass(Tcw0, 15.0, 0.9)
        feat_mp = jnp.full((F,), -1, jnp.int32)
        feat_mp = feat_mp.at[jnp.where(m1.ok, m1.idx, F)].set(
            jnp.where(m1.ok, jnp.arange(NM, dtype=jnp.int32), -1), mode="drop"
        )
        has = feat_mp >= 0
        Xg = mp_Xw[jnp.maximum(feat_mp, 0)]
        return pose_opt.optimize_pose(
            Tcw0, Xg, feats_xy, inv_s2, has & feats_valid, K,
            n_rounds=2, iters_per_round=8,
        )

    # pass 1 evaluates BOTH pose candidates — the constant-velocity
    # prediction and the last frame's pose — and keeps the one with more
    # inliers. A bad velocity (after a map update or a pose spike) would
    # otherwise overshoot the prediction into feature-aliasing territory and
    # self-amplify frame over frame; the last-pose candidate breaks that
    # feedback loop (the reference's TrackReferenceKeyFrame fallback plays
    # this role, src/Tracking.cpp:516-567).
    resA = pass1(Tcw_pred)
    resB = pass1(Tcw_last)
    use_a = resA.n_inliers >= resB.n_inliers
    res1 = pose_opt.PoseOptResult(
        Tcw=jnp.where(use_a, resA.Tcw, resB.Tcw),
        inliers=jnp.where(use_a, resA.inliers, resB.inliers),
        n_inliers=jnp.where(use_a, resA.n_inliers, resB.n_inliers),
    )
    # pass 2: tight radius at refined pose, full map again
    m2, vis2 = match_pass(res1.Tcw, 4.0, 1.0)
    feat_mp2 = jnp.full((F,), -1, jnp.int32)
    feat_mp2 = feat_mp2.at[jnp.where(m2.ok, m2.idx, F)].set(
        jnp.where(m2.ok, jnp.arange(NM, dtype=jnp.int32), -1), mode="drop"
    )
    has2 = feat_mp2 >= 0
    Xg2 = mp_Xw[jnp.maximum(feat_mp2, 0)]
    res2 = pose_opt.optimize_pose(
        res1.Tcw, Xg2, feats_xy, inv_s2, has2 & feats_valid, K,
        n_rounds=2, iters_per_round=10,
    )
    final_assoc = jnp.where(res2.inliers, feat_mp2, -1)
    # per-landmark stats for culling (reference IncreaseVisible/IncreaseFound)
    found = jnp.zeros((NM,), bool)
    found = found.at[jnp.where(res2.inliers, feat_mp2, NM)].set(True, mode="drop")
    return res2.Tcw, final_assoc, res2.n_inliers, vis2, found


# ---------------------------------------------------------------------------
# Tracker
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Tracker:
    """Per-agent tracking front-end. Owns no map — reads/writes the client
    MapState through the local mapper."""

    config: Config
    map: MapState
    state: TrackState = TrackState.NO_IMAGES_YET
    velocity: Optional[np.ndarray] = None        # Tcl: last->current
    last_frame: Optional[frame_mod.Frame] = None
    init_ref_frame: Optional[frame_mod.Frame] = None
    frames_since_kf: int = 0
    last_kf_tracked: int = 0                      # inliers of last KF creation
    max_tracked_since_kf: int = 0                 # running max since last KF
    n_frames: int = 0
    n_relocs: int = 0
    # trajectory log: (timestamp, Tcw (4,4) np) per frame for CSV export
    trajectory: list = dataclasses.field(default_factory=list)
    trajectory_ok: list = dataclasses.field(default_factory=list)
    rng_key: jax.Array = dataclasses.field(
        default_factory=lambda: jax.random.PRNGKey(0)
    )

    # results the client system inspects
    init_result: Optional[dict] = None

    def _camera_arrays(self):
        cam = self.config.camera
        K = jnp.asarray(cam.K())
        sf = jnp.asarray(orb.scale_factors(self.config.extractor))
        inv_s2 = jnp.asarray(orb.inv_level_sigma2(self.config.extractor))
        return K, sf, inv_s2

    def process(self, img, timestamp: float) -> frame_mod.Frame:
        """Main per-frame entry (reference GrabImageMonocular + Track)."""
        fr = frame_mod.make_frame(self.config, self.n_frames, timestamp, img)
        self.n_frames += 1
        if self.state == TrackState.NO_IMAGES_YET:
            self.state = TrackState.NOT_INITIALIZED
            self.init_ref_frame = fr
        elif self.state == TrackState.NOT_INITIALIZED:
            self._try_initialize(fr)
        elif self.state == TrackState.OK:
            self._track(fr)
        elif self.state == TrackState.LOST and self.config.tracking.relocalize:
            self._relocalize(fr)
        self.last_frame = fr
        self.trajectory.append((timestamp, np.asarray(fr.Tcw)))
        # lockstep per-frame state flag (ATE evaluation excludes frames
        # before initialization / while lost)
        self.trajectory_ok.append(self.state == TrackState.OK)
        return fr

    # -- initialization -----------------------------------------------------
    def _try_initialize(self, fr: frame_mod.Frame):
        """Two-view bootstrap (reference MonocularInitialization :291)."""
        ref = self.init_ref_frame
        m = matching.search_for_initialization(
            ref.feats.desc, ref.feats.xy, ref.feats.valid,
            fr.feats.desc, fr.feats.xy, fr.feats.valid,
            window=100.0, angle1=ref.feats.angle, angle2=fr.feats.angle,
        )
        n_matches = int(jnp.sum(m.ok))
        if n_matches < 100:
            # not enough matches: re-seat the reference frame
            self.init_ref_frame = fr
            return
        K, _, _ = self._camera_arrays()
        self.rng_key, sub = jax.random.split(self.rng_key)
        uv2 = fr.feats.xy[m.idx]
        res = ransac.initialize_two_view(sub, ref.feats.xy, uv2, m.ok, K)
        if not bool(res.success):
            return
        # hand the triangulated structure to the client system / mapper
        fr.Tcw = res.Tcw2
        self.init_result = {
            "ref_frame": ref,
            "cur_frame": fr,
            "match_idx": np.asarray(m.idx),
            "good": np.asarray(res.good),
            "pts3d": np.asarray(res.pts3d),
        }
        self.state = TrackState.OK
        self.velocity = None
        self.frames_since_kf = 0

    # -- normal tracking ----------------------------------------------------
    def _track(self, fr: frame_mod.Frame):
        cfg = self.config
        K, sf, inv_s2 = self._camera_arrays()
        Tcw_last = self.last_frame.Tcw if self.last_frame is not None else fr.Tcw
        if self.velocity is not None and self.last_frame is not None:
            Tcw_pred = jnp.asarray(self.velocity) @ self.last_frame.Tcw
        else:
            Tcw_pred = Tcw_last
        mp = self.map.mp
        Tcw, assoc, n_inl, vis_mask, found_mask = _track_two_pass(
            fr.feats.xy, fr.feats.desc, fr.feats.octave, fr.feats.angle,
            fr.feats.valid,
            Tcw_pred, Tcw_last,
            mp.Xw, mp.desc, mp.normal, mp.min_dist, mp.max_dist, mp.valid,
            K, cfg.camera.width, cfg.camera.height, sf, inv_s2,
            cfg.extractor.n_levels,
        )
        n_inliers = int(n_inl)
        fr.Tcw = Tcw
        fr.mp_idx = assoc
        fr.n_tracked = n_inliers
        # landmark visibility/found statistics feed MapPoint culling
        self.map.mp = self.map.mp._replace(
            n_visible=self.map.mp.n_visible + vis_mask.astype(jnp.int32),
            n_found=self.map.mp.n_found + found_mask.astype(jnp.int32),
        )
        if n_inliers < cfg.tracking.matches_inliers_thres:
            self.state = TrackState.LOST
            self.velocity = None
            return
        # motion model update
        if self.last_frame is not None:
            self.velocity = np.asarray(
                Tcw @ lie.inv_T(self.last_frame.Tcw)
            )
        self.frames_since_kf += 1
        self.max_tracked_since_kf = max(self.max_tracked_since_kf, n_inliers)

    # -- relocalization -------------------------------------------------------
    def _relocalize(self, fr: frame_mod.Frame) -> bool:
        """Recover the pose against the clipped local map after tracking loss.

        The reference fork resets on loss (src/Tracking.cpp:249-259); base
        ORB-SLAM2's Relocalization() does BoW candidate retrieval + per-KF
        EPnP RANSAC. Here the clipped client map (<= a few thousand
        landmarks) fits one brute-force Hamming match + one batched PnP
        RANSAC, so candidate KF selection is unnecessary: match the frame
        against *all* landmarks, solve PnP over the matches, then densify and
        polish with the regular two-pass tracking kernel.
        """
        cfg = self.config
        K, sf, inv_s2 = self._camera_arrays()
        mp = self.map.mp
        m = matching.mutual_match(
            mp.desc, mp.valid, fr.feats.desc, fr.feats.valid,
            max_dist=matching.TH_LOW, nn_ratio=0.85,
        )
        if int(jnp.sum(m.ok)) < 10:
            return False
        self.rng_key, sub = jax.random.split(self.rng_key)
        res = ransac.pnp_ransac(
            sub, mp.Xw, fr.feats.xy[m.idx], m.ok, K,
            min_inliers=cfg.tracking.reloc_min_inliers,
        )
        if not bool(res.success):
            return False
        Tcw, assoc, n_inl, vis_mask, found_mask = _track_two_pass(
            fr.feats.xy, fr.feats.desc, fr.feats.octave, fr.feats.angle,
            fr.feats.valid,
            res.Tcw, res.Tcw,
            mp.Xw, mp.desc, mp.normal, mp.min_dist, mp.max_dist, mp.valid,
            K, cfg.camera.width, cfg.camera.height, sf, inv_s2,
            cfg.extractor.n_levels,
        )
        n_inliers = int(n_inl)
        if n_inliers < cfg.tracking.matches_inliers_thres:
            return False
        fr.Tcw = Tcw
        fr.mp_idx = assoc
        fr.n_tracked = n_inliers
        self.state = TrackState.OK
        self.velocity = None
        self.frames_since_kf = 0
        self.max_tracked_since_kf = n_inliers
        self.n_relocs += 1
        return True

    def need_new_keyframe(self, fr: frame_mod.Frame) -> bool:
        """KF decision (reference NeedNewKeyFrame :730, simplified to its
        active conditions: enough frames elapsed or tracking weakening vs the
        reference KF, with a minimum quality bar)."""
        if self.state != TrackState.OK:
            return False
        cfg = self.config.tracking
        if fr.n_tracked < cfg.matches_inliers_thres:
            return False
        # the bar is the best tracking quality achieved since the last KF
        # (equivalent of the reference's nRefMatches: mapping keeps adding
        # landmarks after a KF, so the creation-time count goes stale)
        bar = max(self.max_tracked_since_kf, self.last_kf_tracked, 1)
        weak = fr.n_tracked < cfg.ref_ratio * bar
        stale = self.frames_since_kf >= cfg.max_frames
        return weak or stale

    def notify_kf_created(self, n_tracked: int):
        self.frames_since_kf = 0
        self.last_kf_tracked = n_tracked
        self.max_tracked_since_kf = n_tracked

    def reset(self):
        """Tracking reset (reference Tracking::Reset via ClientHandler)."""
        self.state = TrackState.NO_IMAGES_YET
        self.velocity = None
        self.last_frame = None
        self.init_ref_frame = None
        self.init_result = None
        self.frames_since_kf = 0
