"""Device-resident SoA map state.

The array-native replacement for the reference's pointer-graph data model
(reference: src/KeyFrame.cpp, src/MapPoint.cpp, src/Map.cpp and their
headers). Instead of `std::map<idpair, shared_ptr<KeyFrame>>` plus per-object
mutexes, the map is a pair of fixed-capacity structure-of-arrays blocks with
validity masks, wrapped by a small host-side allocator:

- ``KFBlock``: poses, per-feature keypoints/descriptors, feature->landmark
  association table (the observation store), spanning-tree parent, Motion
  Check pose snapshots.
- ``MPBlock``: landmark positions, distinctive descriptors, view normals,
  scale-invariance distances, tracking statistics.

Derived structures the reference maintains incrementally (covisibility
weights, observation lists, per-landmark observation counts) are recomputed
on device in one shot when needed — a (NK x NMP) membership matmul replaces
UpdateConnections bookkeeping entirely.

Capacity growth: blocks are padded to fixed sizes from config; the client's
map is naturally bounded by MapTrimming (reference src/Map.cpp:869); the
server grows by re-allocating a larger block (re-jit amortized).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Config
from ..ops import lie

INVALID = -1


class KFBlock(NamedTuple):
    """Keyframe SoA, capacity NK, F features per KF."""

    kf_id: jax.Array        # (NK,) i32 — client-local id ("idpair.id")
    client_id: jax.Array    # (NK,) i32 — owning agent ("idpair.clientId")
    unique_id: jax.Array    # (NK,) i32 — server-global uid (0 = unset)
    timestamp: jax.Array    # (NK,) f64-as-f32 seconds
    Tcw: jax.Array          # (NK, 4, 4) world->camera
    xy: jax.Array           # (NK, F, 2) undistorted keypoints (level-0 px)
    angle: jax.Array        # (NK, F) f32
    octave: jax.Array       # (NK, F) i32
    desc: jax.Array         # (NK, F, 8) u32
    feat_valid: jax.Array   # (NK, F) bool
    mp_idx: jax.Array       # (NK, F) i32 — landmark slot or -1 (observations)
    parent: jax.Array       # (NK,) i32 — spanning-tree parent slot or -1
    pred: jax.Array         # (NK,) i32 — temporal predecessor slot or -1
    valid: jax.Array        # (NK,) bool
    loop_edge: jax.Array    # (NK,) i32 — loop-closure partner slot or -1
    # Motion Check snapshots (reference KeyFrame.h:187-216)
    Tcw_pre_gba: jax.Array  # (NK, 4, 4) pose snapshot before GBA
    tracking_tws: jax.Array  # (NK, 3) pre-GBA body-frame position


class MPBlock(NamedTuple):
    """Landmark SoA, capacity NM."""

    mp_id: jax.Array        # (NM,) i32
    client_id: jax.Array    # (NM,) i32
    unique_id: jax.Array    # (NM,) i32
    Xw: jax.Array           # (NM, 3) world position
    desc: jax.Array         # (NM, 8) u32 distinctive descriptor
    normal: jax.Array       # (NM, 3) mean viewing direction
    min_dist: jax.Array     # (NM,) scale-invariance range
    max_dist: jax.Array     # (NM,)
    ref_kf: jax.Array       # (NM,) i32 reference keyframe slot
    first_kf_id: jax.Array  # (NM,) i32 kf_id at creation (culling rules)
    n_visible: jax.Array    # (NM,) i32 — frames it was in frustum
    n_found: jax.Array      # (NM,) i32 — frames it was matched
    valid: jax.Array        # (NM,) bool


def empty_kf_block(nk: int, f: int) -> KFBlock:
    return KFBlock(
        kf_id=jnp.full((nk,), INVALID, jnp.int32),
        client_id=jnp.full((nk,), INVALID, jnp.int32),
        unique_id=jnp.zeros((nk,), jnp.int32),
        timestamp=jnp.zeros((nk,), jnp.float32),
        Tcw=jnp.tile(jnp.eye(4, dtype=jnp.float32), (nk, 1, 1)),
        xy=jnp.zeros((nk, f, 2), jnp.float32),
        angle=jnp.zeros((nk, f), jnp.float32),
        octave=jnp.zeros((nk, f), jnp.int32),
        desc=jnp.zeros((nk, f, 8), jnp.uint32),
        feat_valid=jnp.zeros((nk, f), bool),
        mp_idx=jnp.full((nk, f), INVALID, jnp.int32),
        parent=jnp.full((nk,), INVALID, jnp.int32),
        pred=jnp.full((nk,), INVALID, jnp.int32),
        valid=jnp.zeros((nk,), bool),
        loop_edge=jnp.full((nk,), INVALID, jnp.int32),
        Tcw_pre_gba=jnp.tile(jnp.eye(4, dtype=jnp.float32), (nk, 1, 1)),
        tracking_tws=jnp.zeros((nk, 3), jnp.float32),
    )


def empty_mp_block(nm: int) -> MPBlock:
    return MPBlock(
        mp_id=jnp.full((nm,), INVALID, jnp.int32),
        client_id=jnp.full((nm,), INVALID, jnp.int32),
        unique_id=jnp.zeros((nm,), jnp.int32),
        Xw=jnp.zeros((nm, 3), jnp.float32),
        desc=jnp.zeros((nm, 8), jnp.uint32),
        normal=jnp.zeros((nm, 3), jnp.float32),
        min_dist=jnp.zeros((nm,), jnp.float32),
        max_dist=jnp.full((nm,), 1e9, jnp.float32),
        ref_kf=jnp.full((nm,), INVALID, jnp.int32),
        first_kf_id=jnp.full((nm,), INVALID, jnp.int32),
        n_visible=jnp.ones((nm,), jnp.int32),
        n_found=jnp.ones((nm,), jnp.int32),
        valid=jnp.zeros((nm,), bool),
    )


# ---------------------------------------------------------------------------
# Device kernels over blocks
# ---------------------------------------------------------------------------

def observation_membership(kf: KFBlock, nm: int):
    """(NK, NM) bool: does KF k observe landmark m (via the mp_idx table)."""
    nk, f = kf.mp_idx.shape
    obs_ok = kf.feat_valid & (kf.mp_idx >= 0) & kf.valid[:, None]
    # one-hot scatter: membership[k, mp_idx[k, f]] |= obs_ok
    safe_idx = jnp.where(obs_ok, kf.mp_idx, nm)  # park invalid in extra slot
    memb = jnp.zeros((nk, nm + 1), bool)
    memb = memb.at[jnp.arange(nk)[:, None], safe_idx].set(True)
    return memb[:, :nm]


def covisibility(kf: KFBlock, nm: int, dtype=jnp.float32):
    """(NK, NK) covisibility weights = # shared landmarks (reference
    KeyFrame::UpdateConnections), one matmul over the membership."""
    memb = observation_membership(kf, nm).astype(dtype)
    W = memb @ memb.T
    return W - jnp.diag(jnp.diag(W))


@jax.jit
def _covis_row_kernel(kf: KFBlock, memb_row):
    nm = memb_row.shape[0]
    nk, f = kf.mp_idx.shape
    obs_ok = kf.feat_valid & (kf.mp_idx >= 0) & kf.valid[:, None]
    shared = jnp.where(
        obs_ok, memb_row[jnp.maximum(kf.mp_idx, 0)], False
    ).sum(1).astype(jnp.float32)
    return shared


def covisibility_row(kf: KFBlock, nm: int, slot: int):
    """(NK,) covisibility weights of ONE keyframe — O(NK·F) gather instead
    of the full O(NK²) matrix; per-tick consumers (vicinity packing,
    neighbor selection, consistency groups) only ever need one row."""
    obs_ok = kf.feat_valid[slot] & (kf.mp_idx[slot] >= 0) & kf.valid[slot]
    memb_row = jnp.zeros(nm + 1, bool).at[
        jnp.where(obs_ok, kf.mp_idx[slot], nm)
    ].set(True)[:nm]
    row = _covis_row_kernel(kf, memb_row)
    return row.at[slot].set(0.0)


def covisibility_rows(kf: KFBlock, nm: int, slots):
    """(S, NK) covisibility rows for a batch of keyframes — one membership
    matmul instead of the full O(NK²) matrix when only a neighborhood's rows
    are needed (loop-closure correction groups, merge seams)."""
    slots = jnp.asarray(slots, jnp.int32)
    memb = observation_membership(kf, nm).astype(jnp.float32)   # (NK, NM)
    rows = memb[slots] @ memb.T                                 # (S, NK)
    return rows.at[jnp.arange(slots.shape[0]), slots].set(0.0)


def mp_observation_counts(kf: KFBlock, nm: int):
    """(NM,) i32 number of keyframes observing each landmark."""
    return observation_membership(kf, nm).sum(0).astype(jnp.int32)


def gather_observations(kf: KFBlock, max_obs: int):
    """Flatten the (NK, F) association table into BA observation arrays.

    Returns (cam_idx, feat_idx, lm_idx, uv, octave, valid) each (NO,) /
    (NO, 2) with NO = NK * F (static). Callers mask by ``valid``.
    """
    nk, f = kf.mp_idx.shape
    ok = kf.feat_valid & (kf.mp_idx >= 0) & kf.valid[:, None]
    cam = jnp.broadcast_to(jnp.arange(nk, dtype=jnp.int32)[:, None], (nk, f))
    feat = jnp.broadcast_to(jnp.arange(f, dtype=jnp.int32)[None, :], (nk, f))
    return (
        cam.reshape(-1),
        feat.reshape(-1),
        jnp.where(ok, kf.mp_idx, 0).reshape(-1),
        kf.xy.reshape(-1, 2),
        kf.octave.reshape(-1),
        ok.reshape(-1),
    )


def update_mp_descriptors_and_normals(kf: KFBlock, mp: MPBlock,
                                      scale_factors, max_obs: int = 16):
    """Recompute distinctive descriptors, normals, and scale ranges for all
    landmarks from their observations (reference
    MapPoint::ComputeDistinctiveDescriptors + UpdateNormalAndDepth), batched.

    The distinctive descriptor = observation descriptor with minimum median
    distance to the others; we approximate with min *mean* distance (same
    argmin for the typical unimodal case, one popcount matmul per landmark's
    <=max_obs descriptors).
    """
    from ..ops import matching

    nm = mp.Xw.shape[0]
    nk, f = kf.mp_idx.shape
    # build per-landmark observation lists (first max_obs in scan order)
    ok = kf.feat_valid & (kf.mp_idx >= 0) & kf.valid[:, None]
    flat_lm = jnp.where(ok, kf.mp_idx, nm).reshape(-1)            # (NK*F,)
    order = jnp.argsort(flat_lm)                                   # stable
    sorted_lm = flat_lm[order]
    # rank of each obs within its landmark group
    idx_arange = jnp.arange(sorted_lm.shape[0])
    first_of_group = jnp.searchsorted(sorted_lm, sorted_lm, side="left")
    rank = idx_arange - first_of_group
    slot_ok = (sorted_lm < nm) & (rank < max_obs)
    obs_table = jnp.full((nm + 1, max_obs), -1, jnp.int32)
    obs_table = obs_table.at[
        jnp.where(slot_ok, sorted_lm, nm), jnp.where(slot_ok, rank, 0)
    ].set(jnp.where(slot_ok, order.astype(jnp.int32), -1))
    obs_table = obs_table[:nm]                                     # (NM, max_obs)
    has_obs = obs_table >= 0
    flat_cam = jnp.broadcast_to(
        jnp.arange(nk, dtype=jnp.int32)[:, None], (nk, f)
    ).reshape(-1)
    flat_desc = kf.desc.reshape(-1, 8)
    obs_cam = jnp.where(has_obs, flat_cam[jnp.maximum(obs_table, 0)], 0)
    obs_desc = flat_desc[jnp.maximum(obs_table, 0)]                # (NM, max_obs, 8)

    # distinctive descriptor: medoid (min mean Hamming to co-observations),
    # tie-biased toward RECENT observations — under viewpoint-induced
    # appearance drift the medoid of a long history lags the current look
    # and tracking starves; a small recency bonus keeps it fresh while still
    # rejecting one-off outlier descriptors.
    x = obs_desc[:, :, None, :] ^ obs_desc[:, None, :, :]
    dmat = matching.popcount_u32(x).sum(-1)                        # (NM, mo, mo)
    pair_ok = has_obs[:, :, None] & has_obs[:, None, :]
    dsum = jnp.where(pair_ok, dmat, 0).sum(-1)
    cnt = jnp.maximum(pair_ok.sum(-1), 1)
    mean_d = jnp.where(has_obs, dsum / cnt, jnp.inf)
    obs_kf_id = jnp.where(has_obs, kf.kf_id[obs_cam], -1)
    newest = jnp.max(obs_kf_id, axis=-1, keepdims=True)
    recency_bonus = jnp.where(obs_kf_id == newest, 16.0, 0.0)
    best = jnp.argmin(mean_d - recency_bonus, -1)                  # (NM,)
    new_desc = jnp.take_along_axis(obs_desc, best[:, None, None], 1)[:, 0]
    any_obs = has_obs.any(-1)
    desc = jnp.where(any_obs[:, None], new_desc, mp.desc)

    # normal = mean of unit vectors landmark->camera-center; depth range from
    # the reference KF's octave and distance
    centers = -jnp.einsum("kji,kj->ki", kf.Tcw[:, :3, :3], kf.Tcw[:, :3, 3])
    v = mp.Xw[:, None, :] - centers[obs_cam]                       # (NM, mo, 3)
    vn = v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-9)
    normal = jnp.where(
        any_obs[:, None],
        jnp.where(has_obs[..., None], vn, 0.0).sum(1)
        / jnp.maximum(has_obs.sum(-1, keepdims=True), 1),
        mp.normal,
    )
    # scale range from the first observation's octave
    first_obs = obs_table[:, 0]
    first_cam = jnp.where(any_obs, flat_cam[jnp.maximum(first_obs, 0)], 0)
    first_oct = jnp.where(
        any_obs, kf.octave.reshape(-1)[jnp.maximum(first_obs, 0)], 0
    )
    dist_ref = jnp.linalg.norm(mp.Xw - centers[first_cam], axis=-1)
    sf = jnp.asarray(scale_factors)
    n_levels = sf.shape[0]
    level_factor = sf[jnp.clip(first_oct, 0, n_levels - 1)]
    max_d = dist_ref * level_factor
    min_d = max_d / sf[n_levels - 1]
    return mp._replace(
        desc=desc,
        normal=normal,
        max_dist=jnp.where(any_obs, max_d * 1.2, mp.max_dist),
        min_dist=jnp.where(any_obs, min_d * 0.8, mp.min_dist),
        ref_kf=jnp.where(any_obs, first_cam, mp.ref_kf),
    )


def check_structure(m: "MapState", repair: bool = False):
    """Map-invariant checker (reference Map::CheckStructure src/Map.cpp:5444,
    DEBUGGING2): detects orphan references, self-parents, associations to
    dead landmarks, and dangling graph links. Returns a list of violation
    strings; with ``repair=True`` the fixable ones are repaired in place like
    the reference's auto-repair.
    """
    problems = []
    kf_valid = np.asarray(m.kf.valid)
    mp_valid = np.asarray(m.mp.valid)
    mp_idx = np.asarray(m.kf.mp_idx)
    parent = np.asarray(m.kf.parent)
    pred = np.asarray(m.kf.pred)
    ref_kf = np.asarray(m.mp.ref_kf)

    # associations referencing dead/out-of-range landmarks
    assoc = mp_idx[kf_valid]
    bad_range = (assoc >= m.nm)
    bad_dead = (assoc >= 0) & (assoc < m.nm) & ~mp_valid[np.clip(assoc, 0, m.nm - 1)]
    if bad_range.any():
        problems.append(f"{bad_range.sum()} associations out of range")
    if bad_dead.any():
        problems.append(f"{bad_dead.sum()} associations to dead landmarks")
    # self-parent / dead-parent / dead-pred — vectorized (this runs on
    # fused 2048-KF server maps when something misbehaves; Python loops
    # over every slot made the diagnostic itself the bottleneck)
    live = np.flatnonzero(kf_valid)
    for s in live[parent[live] == live]:
        problems.append(f"KF slot {s} is its own parent")
    pl_ = parent[live]
    dead_par = live[(pl_ >= 0) & ~kf_valid[np.clip(pl_, 0, m.nk - 1)]]
    for s in dead_par:
        problems.append(f"KF slot {s} parent {parent[s]} is dead")
    pr_ = pred[live]
    dead_pred = live[(pr_ >= 0) & ~kf_valid[np.clip(pr_, 0, m.nk - 1)]]
    for s in dead_pred:
        problems.append(f"KF slot {s} pred {pred[s]} is dead")
    # landmarks with dead reference keyframes
    mlive = np.flatnonzero(mp_valid)
    rf = ref_kf[mlive]
    dead_ref = mlive[(rf >= 0) & ~kf_valid[np.clip(rf, 0, m.nk - 1)]]
    for s in dead_ref:
        problems.append(f"MP slot {s} ref_kf {ref_kf[s]} is dead")

    if repair and problems:
        import jax.numpy as jnp

        dead_assoc = (m.kf.mp_idx >= 0) & ~jnp.asarray(mp_valid)[
            jnp.maximum(m.kf.mp_idx, 0)
        ]
        m.kf = m.kf._replace(
            mp_idx=jnp.where(dead_assoc, -1, m.kf.mp_idx),
            parent=jnp.where(
                jnp.asarray(~kf_valid)[jnp.maximum(m.kf.parent, 0)]
                & (m.kf.parent >= 0),
                -1, m.kf.parent,
            ),
            pred=jnp.where(
                jnp.asarray(~kf_valid)[jnp.maximum(m.kf.pred, 0)]
                & (m.kf.pred >= 0),
                -1, m.kf.pred,
            ),
        )
        # re-anchor landmarks whose reference KF died: first live observer
        memb = np.asarray(observation_membership(m.kf, m.nm))
        new_ref = ref_kf.copy()
        for s in np.flatnonzero(mp_valid):
            if new_ref[s] >= 0 and not kf_valid[new_ref[s]]:
                obs = np.flatnonzero(memb[:, s])
                new_ref[s] = obs[0] if len(obs) else -1
        import jax.numpy as jnp2

        m.mp = m.mp._replace(ref_kf=jnp2.asarray(new_ref))
    return problems


# ---------------------------------------------------------------------------
# Host-side allocator / wrapper
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MapState:
    """Host wrapper owning the device blocks plus slot allocation.

    One instance per (role, map); after a server-side merge several agents
    share one instance (reference Map merge ctor src/Map.cpp:100).
    """

    kf: KFBlock
    mp: MPBlock
    config: Config
    next_kf_slot: int = 0
    next_mp_slot: int = 0
    # id -> slot lookup kept on host (cheap, avoids device scans)
    kf_slot_by_id: dict = dataclasses.field(default_factory=dict)
    mp_slot_by_id: dict = dataclasses.field(default_factory=dict)
    # Motion Check latches (reference Map.h:304 request_GBA and the
    # CorrectKF_switch latch, src/Map.cpp:3784-3799): a gating-mode MC run
    # after a loop-closure GBA may disable future corrective action and/or
    # request a follow-up GBA.
    correct_kf_switch: bool = True
    request_gba: bool = False

    @classmethod
    def create(cls, config: Config, server: bool = False) -> "MapState":
        cap = config.capacity
        nk = cap.server_max_kfs if server else cap.client_max_kfs
        nm = cap.server_max_mps if server else cap.client_max_mps
        f = config.extractor.max_features
        return cls(kf=empty_kf_block(nk, f), mp=empty_mp_block(nm), config=config)

    # -- capacities ---------------------------------------------------------
    @property
    def nk(self) -> int:
        return self.kf.valid.shape[0]

    @property
    def nm(self) -> int:
        return self.mp.valid.shape[0]

    @property
    def n_kfs(self) -> int:
        return len(self.kf_slot_by_id)

    @property
    def n_mps(self) -> int:
        return len(self.mp_slot_by_id)

    # -- capacity growth ------------------------------------------------
    # Blocks grow by doubling when full (append-only: existing slot indices
    # stay valid). Each growth changes array shapes and therefore re-jits
    # the kernels once — amortized O(log growth) recompiles over a run.
    # The reference's server map is unbounded (std::map); the client's is
    # bounded by MapTrimming, so client blocks rarely grow.
    n_kf_growths: int = 0
    n_mp_growths: int = 0

    def _grow_kf_block(self):
        f = self.kf.xy.shape[1]
        extra = empty_kf_block(self.nk, f)
        self.kf = KFBlock(*[
            jnp.concatenate([a, b], 0) for a, b in zip(self.kf, extra)
        ])
        self.n_kf_growths += 1

    def _grow_mp_block(self):
        extra = empty_mp_block(self.nm)
        self.mp = MPBlock(*[
            jnp.concatenate([a, b], 0) for a, b in zip(self.mp, extra)
        ])
        self.n_mp_growths += 1

    # -- slot management ----------------------------------------------------
    def alloc_kf_slot(self, kf_id: int, client_id: int) -> int:
        """Next free KF slot (round-robin over invalid slots); grows the
        block when full."""
        valid = np.asarray(self.kf.valid)
        for probe in range(self.nk):
            s = (self.next_kf_slot + probe) % self.nk
            if not valid[s]:
                self.next_kf_slot = (s + 1) % self.nk
                self.kf_slot_by_id[(kf_id, client_id)] = s
                return s
        s = self.nk
        self._grow_kf_block()
        self.next_kf_slot = s + 1
        self.kf_slot_by_id[(kf_id, client_id)] = s
        return s

    def alloc_mp_slots(self, n: int, ids) -> np.ndarray:
        valid = np.asarray(self.mp.valid)
        free = np.flatnonzero(~valid)
        while len(free) < n:
            old_nm = self.nm
            self._grow_mp_block()
            free = np.concatenate([free, np.arange(old_nm, self.nm)])
        slots = free[:n]
        for s, pid in zip(slots, ids):
            self.mp_slot_by_id[pid] = int(s)
        return slots

    def drop_kf_id(self, kf_id: int, client_id: int):
        self.kf_slot_by_id.pop((kf_id, client_id), None)

    def drop_mp_id(self, pid):
        self.mp_slot_by_id.pop(pid, None)

    def sync_host_index(self):
        """Rebuild the host id->slot dicts from device state (after batched
        device-side deletions like culling/trimming)."""
        kf_valid = np.asarray(self.kf.valid)
        kf_ids = np.asarray(self.kf.kf_id)
        kf_cids = np.asarray(self.kf.client_id)
        self.kf_slot_by_id = {
            (int(kf_ids[s]), int(kf_cids[s])): s for s in np.flatnonzero(kf_valid)
        }
        mp_valid = np.asarray(self.mp.valid)
        mp_ids = np.asarray(self.mp.mp_id)
        mp_cids = np.asarray(self.mp.client_id)
        self.mp_slot_by_id = {
            (int(mp_ids[s]), int(mp_cids[s])): s for s in np.flatnonzero(mp_valid)
        }
