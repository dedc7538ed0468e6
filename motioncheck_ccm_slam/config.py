"""Typed runtime configuration.

Mirrors the reference's two-tier config (compile-time feature flags +
eagerly-loaded YAML constants in ``params::`` namespaces — reference:
include/cslam/config.h:40-49,180-313 and cslam/conf/config.yaml), re-expressed
as frozen dataclasses so configs are hashable and can be closed over by jitted
kernels as static arguments.

Values default to the reference's shipped operating point
(cslam/conf/config.yaml, cslam/conf/vi_euroc.yaml).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple

import numpy as np


@dataclass(frozen=True)
class ExtractorParams:
    """ORB extraction operating point (reference config.yaml:38-50)."""

    n_features: int = 1000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20
    min_th_fast: int = 7
    # Device-side capacity: features are padded to this per frame (pow2-ish,
    # lane-friendly). Must be >= n_features.
    max_features: int = 1024
    # Grid cell size used for FAST bucketing / spatial binning, px at level 0
    # (reference ORBextractor.cpp: W=30 cell sweep).
    cell_size: int = 30
    patch_size: int = 31
    half_patch_size: int = 15
    edge_threshold: int = 19


@dataclass(frozen=True)
class TrackingParams:
    """Tracking state machine thresholds (reference config.yaml:54-72)."""

    init_kfs: int = 5
    min_frames: int = 0
    max_frames: int = 20
    matches_inliers_thres: int = 15
    ref_ratio: float = 0.9
    track_ref_kf_inlier_thres_search: int = 15
    track_ref_kf_inlier_thres_opt: int = 10
    track_motion_model_inlier_thres_search: int = 20
    track_motion_model_inlier_thres_opt: int = 10
    track_local_map_inlier_thres: int = 30
    # Relocalization after tracking loss. The reference fork only resets
    # (src/Tracking.cpp:249-259); base ORB-SLAM2 relocalizes — we keep the
    # capability behind a flag (PnP RANSAC against the clipped local map).
    relocalize: bool = True
    reloc_min_inliers: int = 15


@dataclass(frozen=True)
class MappingParams:
    """Local mapping / culling (reference config.yaml:76-81)."""

    local_map_size: int = 50
    local_map_buffer: int = 20
    recent_kf_window: int = 20
    redundancy_thres: float = 0.98


@dataclass(frozen=True)
class CommParams:
    """Message budgets & rates (reference config.yaml:85-106)."""

    client_pub_freq_hz: float = 5.0
    client_kf_it_bound: int = 30
    client_mp_it_bound: int = 3000
    client_pub_max_kfs: int = 40
    client_pub_max_mps: int = 2500
    server_pub_freq_hz: float = 1.0
    server_kfs_to_client: int = 0
    server_kf_it_bound: int = 400
    server_mp_it_bound: int = 12000
    # FINALBA: seconds of empty messages before an agent is deemed finished
    # (reference Communicator.cpp:465-496, ~30 s).
    final_ba_idle_s: float = 30.0
    interrupt_gba_on_input: bool = True


@dataclass(frozen=True)
class PlaceRecParams:
    """Place recognition (reference config.yaml:110-115)."""

    new_loop_thres: int = 20
    start_map_matching_after_kf: int = 30
    covisibility_consistency_th: int = 3


@dataclass(frozen=True)
class OptParams:
    """Optimization budgets (reference config.yaml:119-129)."""

    solver_iterations: int = 5
    matches_thres: int = 20
    inliers_thres: int = 20
    total_matches_thres: int = 40
    probability: float = 0.99
    min_inliers: int = 6
    max_iterations: int = 300
    gba_iterations: int = 20
    ess_graph_min_feats: int = 100
    # essential-graph LM budget (reference Optimizer.cpp: optimize(20))
    ess_graph_iterations: int = 20


@dataclass(frozen=True)
class MotionCheckParams:
    """Motion Check thresholds (reference src/Map.cpp:2853-2909, §5.9 of
    SURVEY.md). All angle limits in degrees."""

    enabled: bool = True
    # 3D direction change: fail if |deg - tracking_deg| >
    #   min(dir3d_track_mult * tracking_deg, dir3d_cap_deg) * margin
    dir3d_track_mult: float = 2.0
    dir3d_cap_deg: float = 30.0
    # step-length ratio: fail if post/pre step ratio differs by > ratio_mult*margin
    ratio_mult: float = 2.0
    # per-plane (xy/yz/zx) direction change cap
    plane_track_mult: float = 5.0
    plane_cap_deg: float = 40.0
    # doubt bookkeeping
    violate_doubt_thres: int = 2
    margin_relax: float = 1.5
    margin_cap: float = 3.0
    skip_edge_kfs: int = 10
    # verdict: revert the whole GBA if longest violating run >= run_thres or
    # more than frac_thres of KFs are bad; else surgically delete violators.
    revert_run_thres: int = 5
    revert_frac_thres: float = 0.10


@dataclass(frozen=True)
class CameraParams:
    """Pinhole + radial-tangential distortion (reference conf/vi_euroc.yaml)."""

    fx: float = 458.654
    fy: float = 457.296
    cx: float = 367.215
    cy: float = 248.375
    k1: float = -0.28340811
    k2: float = 0.07395907
    p1: float = 0.00019359
    p2: float = 1.76187114e-05
    k3: float = 0.0
    fps: float = 20.0
    width: int = 752
    height: int = 480
    # T_SC: IMU(body)-from-camera extrinsic, row-major 4x4
    # (reference vi_euroc.yaml:26-42); used by Motion Check to express
    # trajectories in the body frame.
    t_sc: Tuple[float, ...] = (
        0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975,
        0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768,
        -0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949,
        0.0, 0.0, 0.0, 1.0,
    )

    def K(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=np.float32,
        )

    def dist_coeffs(self) -> np.ndarray:
        return np.array([self.k1, self.k2, self.p1, self.p2, self.k3], np.float32)

    def T_SC(self) -> np.ndarray:
        return np.asarray(self.t_sc, np.float32).reshape(4, 4)


@dataclass(frozen=True)
class CapacityParams:
    """Fixed device-side capacities (static-shape device pools; no reference
    analog — the reference uses dynamic std::map containers, we use
    fixed-capacity SoA with validity masks, grown by re-jit in blocks)."""

    client_max_kfs: int = 96        # local_map_size + buffer + slack
    client_max_mps: int = 8192
    server_max_kfs: int = 2048
    server_max_mps: int = 65536
    max_obs_per_mp: int = 32
    local_ba_max_kfs: int = 96
    local_ba_max_fixed_kfs: int = 32


@dataclass(frozen=True)
class SystemParams:
    client_id: int = 0
    n_agents: int = 1
    max_agents: int = 4             # reference MAXAGENTS (Optimizer.h:59)


@dataclass(frozen=True)
class Config:
    """Top-level bundle of all parameter namespaces."""

    sys: SystemParams = field(default_factory=SystemParams)
    extractor: ExtractorParams = field(default_factory=ExtractorParams)
    tracking: TrackingParams = field(default_factory=TrackingParams)
    mapping: MappingParams = field(default_factory=MappingParams)
    comm: CommParams = field(default_factory=CommParams)
    placerec: PlaceRecParams = field(default_factory=PlaceRecParams)
    opt: OptParams = field(default_factory=OptParams)
    motion_check: MotionCheckParams = field(default_factory=MotionCheckParams)
    camera: CameraParams = field(default_factory=CameraParams)
    capacity: CapacityParams = field(default_factory=CapacityParams)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = Config()

_KITTI_T_SC = (1.0, 0.0, 0.0, 0.0,
               0.0, 1.0, 0.0, 0.0,
               0.0, 0.0, 1.0, 0.0,
               0.0, 0.0, 0.0, 1.0)

# KITTI odometry grayscale operating point (reference
# cslam/conf/kitti_mono.yaml: fx/fy 718.856, cx 607.1928, cy 185.2157,
# zero distortion, 10 fps, identity T_SC). Image size is the KITTI
# odometry cam0 frame (sequences 00-02).
KITTI_CONFIG = Config().replace(
    camera=CameraParams(
        fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
        k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0,
        fps=10.0, width=1241, height=376, t_sc=_KITTI_T_SC,
    )
)

# Half-resolution variant (reference cslam/conf/kitti_mono_half_res.yaml:
# every intrinsic halved).
KITTI_HALF_RES_CONFIG = Config().replace(
    camera=CameraParams(
        fx=359.428, fy=359.428, cx=303.5964, cy=92.60785,
        k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0,
        fps=10.0, width=620, height=188, t_sc=_KITTI_T_SC,
    )
)
