"""Synthetic map-state builder: construct KF/MP blocks directly from a known
world + trajectory, bypassing image rendering. Used by loop-closing,
pose-graph, and GBA tests."""
import numpy as np
import jax.numpy as jnp

from motioncheck_ccm_slam.config import Config
from motioncheck_ccm_slam.models import map_state as ms
from motioncheck_ccm_slam.ops import lie


class SynthWorld:
    def __init__(self, config: Config, n_points=400, seed=0, depth=6.0):
        rng = np.random.default_rng(seed)
        self.config = config
        self.pts = np.stack(
            [
                rng.uniform(-6, 6, n_points),
                rng.uniform(-3.5, 3.5, n_points),
                depth + rng.uniform(-1.0, 1.0, n_points),
            ],
            -1,
        ).astype(np.float32)
        self.desc = rng.integers(0, 2**32, (n_points, 8), dtype=np.uint32)
        self.K = config.camera.K()

    def observe(self, Tcw, max_feats=None, noise_px=0.3, rng=None):
        """Project world points: returns (world_idx, uv) for visible points."""
        rng = rng or np.random.default_rng(0)
        cam = self.config.camera
        F = max_feats or self.config.extractor.max_features
        R, t = Tcw[:3, :3], Tcw[:3, 3]
        pc = self.pts @ R.T + t
        z = pc[:, 2]
        u = self.K[0, 0] * pc[:, 0] / np.maximum(z, 1e-6) + self.K[0, 2]
        v = self.K[1, 1] * pc[:, 1] / np.maximum(z, 1e-6) + self.K[1, 2]
        vis = (z > 0.2) & (u >= 10) & (u < cam.width - 10) & (v >= 10) \
            & (v < cam.height - 10)
        idx = np.flatnonzero(vis)[:F]
        uv = np.stack([u[idx], v[idx]], -1)
        uv = uv + rng.normal(0, noise_px, uv.shape)
        return idx, uv.astype(np.float32)


def add_pass(m: ms.MapState, world: SynthWorld, poses, timestamps,
             client_id=0, kf_id_start=0, lm_pose_error=None, seed=0,
             chain_from=-1):
    """Insert a trajectory pass: each pose becomes a KF observing NEW copies
    of the world landmarks (as real SLAM would triangulate its own), with
    positions consistent with the (possibly drifted) poses.

    lm_pose_error: optional (4,4) rigid/sim3 matrix D — or a list of one per
    KF for progressive drift: landmarks (at first observation) and poses of
    this pass are expressed in the D-transformed frame (simulating drift).
    chain_from: optional KF slot the first KF of this pass links to
    (pred/parent), for temporal continuity across passes.
    Returns list of KF slots.
    """
    rng = np.random.default_rng(seed)
    cfg = world.config
    F = cfg.extractor.max_features
    world_to_slot = {}
    first_obs_kf = {}
    kf_slots = []
    if lm_pose_error is not None and not isinstance(lm_pose_error, list):
        lm_pose_error = [lm_pose_error] * len(poses)
    drift_list = lm_pose_error
    for k, (Tcw, ts) in enumerate(zip(poses, timestamps)):
        lm_pose_error = drift_list[k] if drift_list is not None else None
        idx, uv = world.observe(Tcw, rng=rng)
        # landmark copies for this pass: true world position, optionally
        # transformed by the drift D (consistency with drifted poses)
        feats_xy = np.zeros((F, 2), np.float32)
        feats_valid = np.zeros(F, bool)
        desc = np.zeros((F, 8), np.uint32)
        mp_idx = np.full(F, -1, np.int32)
        n = min(len(idx), F)
        feats_xy[:n] = uv[:n]
        feats_valid[:n] = True
        desc[:n] = world.desc[idx[:n]]
        new_world = [w for w in idx[:n] if w not in world_to_slot]
        if new_world:
            ids = [(kf_id_start * 100000 + int(w), client_id)
                   for w in new_world]
            slots = m.alloc_mp_slots(len(new_world), ids)
            X = world.pts[new_world]
            if lm_pose_error is not None:
                D = lm_pose_error
                X = X @ D[:3, :3].T + D[:3, 3]
            m.mp = m.mp._replace(
                mp_id=m.mp.mp_id.at[jnp.asarray(slots)].set(
                    jnp.asarray([i for i, _ in ids], dtype=jnp.int32)),
                client_id=m.mp.client_id.at[jnp.asarray(slots)].set(client_id),
                Xw=m.mp.Xw.at[jnp.asarray(slots)].set(jnp.asarray(X)),
                desc=m.mp.desc.at[jnp.asarray(slots)].set(
                    jnp.asarray(world.desc[new_world])),
                min_dist=m.mp.min_dist.at[jnp.asarray(slots)].set(0.1),
                max_dist=m.mp.max_dist.at[jnp.asarray(slots)].set(100.0),
                valid=m.mp.valid.at[jnp.asarray(slots)].set(True),
                first_kf_id=m.mp.first_kf_id.at[jnp.asarray(slots)].set(
                    kf_id_start + k),
            )
            for w, s in zip(new_world, slots):
                world_to_slot[w] = int(s)
        new_world_slot_pending = [world_to_slot[w] for w in new_world]
        for f in range(n):
            mp_idx[f] = world_to_slot[int(idx[f])]
        # pose of this KF in the (possibly drifted) frame
        T_eff = Tcw.copy()
        if lm_pose_error is not None:
            T_eff = Tcw @ np.linalg.inv(lm_pose_error)
        kf_id = kf_id_start + k
        slot = m.alloc_kf_slot(kf_id, client_id)
        m.kf = m.kf._replace(
            kf_id=m.kf.kf_id.at[slot].set(kf_id),
            client_id=m.kf.client_id.at[slot].set(client_id),
            timestamp=m.kf.timestamp.at[slot].set(float(ts)),
            Tcw=m.kf.Tcw.at[slot].set(jnp.asarray(T_eff.astype(np.float32))),
            xy=m.kf.xy.at[slot].set(jnp.asarray(feats_xy)),
            desc=m.kf.desc.at[slot].set(jnp.asarray(desc)),
            feat_valid=m.kf.feat_valid.at[slot].set(jnp.asarray(feats_valid)),
            mp_idx=m.kf.mp_idx.at[slot].set(jnp.asarray(mp_idx)),
            valid=m.kf.valid.at[slot].set(True),
            parent=m.kf.parent.at[slot].set(
                kf_slots[-1] if kf_slots else chain_from),
            pred=m.kf.pred.at[slot].set(
                kf_slots[-1] if kf_slots else chain_from),
        )
        kf_slots.append(slot)
        # landmarks first seen here reference this KF
        for s in new_world_slot_pending:
            first_obs_kf.setdefault(s, slot)
    # ref_kf: first observing KF slot
    ref = np.asarray(m.mp.ref_kf).copy()
    for w, s in world_to_slot.items():
        if ref[s] < 0:
            ref[s] = first_obs_kf.get(s, kf_slots[0])
    m.mp = m.mp._replace(ref_kf=jnp.asarray(ref))
    return kf_slots


def ring_world(config, n_points=1500, ring_radius=11.0, seed=0):
    """Landmarks on a cylindrical band around the origin — cameras on an
    inner circle facing outward see only a limited arc, so covisibility is
    local (unlike the box world where every KF sees everything)."""
    world = SynthWorld(config, n_points=n_points, seed=seed)
    rng = np.random.default_rng(seed + 1)
    th = rng.uniform(0, 2 * np.pi, n_points)
    r = ring_radius + rng.uniform(-1.0, 1.0, n_points)
    y = rng.uniform(-2.5, 2.5, n_points)
    world.pts = np.stack(
        [r * np.cos(th), y, r * np.sin(th)], -1
    ).astype(np.float32)
    return world


def ring_poses(angles_deg, cam_radius=5.0, t0=0.0, dt=0.25, y_amp=0.0):
    """Cameras on a circle of ``cam_radius`` facing radially outward, one per
    angle (degrees). ``y_amp`` adds a vertical bob (real trajectories are
    never perfectly planar — Motion Check's per-plane limits scale with the
    tracking xy angle, which degenerates to 0 on planar motion)."""
    poses, ts = [], []
    for k, a in enumerate(angles_deg):
        th = np.deg2rad(a)
        y = y_amp * np.sin(3.0 * th)
        C = np.array([cam_radius * np.cos(th), y,
                      cam_radius * np.sin(th)], np.float32)
        fwd = np.array([np.cos(th), 0.0, np.sin(th)], np.float32)
        up = np.array([0.0, 1.0, 0.0], np.float32)
        x = np.cross(up, fwd)
        x /= np.linalg.norm(x)
        y = np.cross(fwd, x)
        R_wc = np.stack([x, y, fwd], -1)   # columns = camera axes in world
        Tcw = np.eye(4, dtype=np.float32)
        Tcw[:3, :3] = R_wc.T
        Tcw[:3, 3] = -R_wc.T @ C
        poses.append(Tcw)
        ts.append(t0 + k * dt)
    return poses, ts


def arc_poses(n, step=0.25, seed=0):
    """Simple translating trajectory poses."""
    poses, ts = [], []
    for k in range(n):
        xi = np.array([0, 0.002 * k, 0, step * k, 0, 0], np.float32)
        poses.append(np.asarray(lie.se3_exp(jnp.asarray(xi))))
        ts.append(k * 0.25)
    return poses, ts
