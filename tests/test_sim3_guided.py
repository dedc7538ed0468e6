"""Sim3-guided match densification and the multi-hit seam essential graph.

Covers the reference's second ComputeSim3 stage — SearchBySim3 (radius 7.5)
then OptimizeSim3 over the union, gated at Opt.InliersThres AFTER the
harvest while the RANSAC itself only needs Opt.MinInliers = 6
(src/LoopFinder.cpp:277,326-333, cslam/conf/config.yaml:123-127) — and the
map-fusion seam graph fed by multiple measured MapMatchHits
(src/MapMatcher.cpp:439-448, Optimizer::OptimizeEssentialGraphMapFusion).
"""
import numpy as np
import jax.numpy as jnp

from motioncheck_ccm_slam.config import (
    CameraParams, CapacityParams, Config, ExtractorParams, OptParams,
    PlaceRecParams,
)
from motioncheck_ccm_slam.models import loop_closing, map_merging
from motioncheck_ccm_slam.models import database as db_mod
from motioncheck_ccm_slam.models import map_state as ms
from motioncheck_ccm_slam.models import vocabulary as vocab_mod
from motioncheck_ccm_slam.ops import lie, matching

from synth_map import SynthWorld, add_pass, arc_poses

CONFIG = Config().replace(
    extractor=ExtractorParams(max_features=256, n_levels=4, n_features=256),
    capacity=CapacityParams(client_max_kfs=48, client_max_mps=8192),
    camera=CameraParams(k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0),
    placerec=PlaceRecParams(start_map_matching_after_kf=0),
)


def _flip_bits(rng, desc_row, n_bits):
    """XOR n_bits random bits into one packed (8,) u32 descriptor."""
    d = desc_row.copy()
    bits = rng.choice(256, size=n_bits, replace=False)
    for b in bits:
        d[b // 32] ^= np.uint32(1) << np.uint32(b % 32)
    return d


def _marginal_revisit_map(n_clean=22, n_bad3d=10, seed=0):
    """A map with a revisit KF whose mutual matches alone cannot pass the
    inlier gate: most descriptors are ~60 bits off (fail TH_LOW mutual
    matching, pass TH_HIGH guided matching) and n_bad3d of the clean-
    descriptor landmarks have corrupted 3D (killed by RANSAC/chi2), leaving
    fewer than inliers_thres=20 mutual inliers."""
    world = SynthWorld(CONFIG, n_points=400, seed=seed)
    m = ms.MapState.create(CONFIG, server=False)
    poses, ts = arc_poses(3, step=0.25)
    slots = add_pass(m, world, poses, ts, kf_id_start=0, seed=seed + 1)
    # the revisit: same viewpoint as KF 1, its own landmark copies
    rev = add_pass(m, world, poses[1:2], [9.0], kf_id_start=50,
                   seed=seed + 2, chain_from=slots[-1])[0]
    rng = np.random.default_rng(seed + 3)
    desc = np.asarray(m.kf.desc).copy()
    valid = np.asarray(m.kf.feat_valid[rev])
    mp_idx = np.asarray(m.kf.mp_idx[rev])
    feats = np.flatnonzero(valid & (mp_idx >= 0))
    assert len(feats) > n_clean + 40
    clean = feats[:n_clean]
    for f in feats[n_clean:]:
        desc[rev, f] = _flip_bits(rng, desc[rev, f], 60)
    m.kf = m.kf._replace(desc=jnp.asarray(desc))
    # corrupt the 3D of n_bad3d clean-descriptor landmark copies of the
    # revisit so they survive mutual matching but fail the geometric gates
    Xw = np.asarray(m.mp.Xw).copy()
    for f in clean[:n_bad3d]:
        Xw[mp_idx[f]] += rng.normal(0.4, 0.1, 3).astype(np.float32)
    m.mp = m.mp._replace(Xw=jnp.asarray(Xw))
    return m, slots, rev


def test_marginal_revisit_rescued_by_guided_matching():
    m, slots, rev = _marginal_revisit_map()
    vocab = vocab_mod.default_vocabulary()
    lc = loop_closing.LoopCloser(
        config=CONFIG, map=m,
        database=db_mod.KeyFrameDatabase(vocab=vocab, capacity=m.nk),
    )
    got = lc.compute_sim3(rev, slots[1])
    assert got is not None, \
        "guided densification must rescue the marginal revisit"
    S12, (feat1, feat2, mp1, mp2, inl) = got
    assert int(inl.sum()) >= CONFIG.opt.inliers_thres
    # many inliers must be guided harvests (beyond the 22 mutual matches)
    assert int(inl.sum()) > 30
    # the revisit shares the viewpoint: S12 ~ identity
    S = np.asarray(S12)
    assert np.allclose(S[:3, :3], np.eye(3), atol=0.05)
    assert np.linalg.norm(S[:3, 3]) < 0.15


def test_marginal_revisit_fails_without_guided_matching(monkeypatch):
    """Negative control: with the guided harvest disabled the same revisit
    must be rejected (mutual inliers < inliers_thres)."""
    m, slots, rev = _marginal_revisit_map()

    def no_matches(desc1, Xc1, valid1, desc2, Xc2, valid2, S12, K, **kw):
        n = desc1.shape[0]
        return matching.MatchResult(
            idx=jnp.zeros(n, jnp.int32), dist=jnp.zeros(n, jnp.int32),
            ok=jnp.zeros(n, bool),
        )

    monkeypatch.setattr(loop_closing.matching, "search_by_sim3", no_matches)
    vocab = vocab_mod.default_vocabulary()
    lc = loop_closing.LoopCloser(
        config=CONFIG, map=m,
        database=db_mod.KeyFrameDatabase(vocab=vocab, capacity=m.nk),
    )
    assert lc.compute_sim3(rev, slots[1]) is None


def test_seam_measurement_zero_residual_for_applied_alignment():
    """The seam edge built from the alignment that was actually applied must
    equal the current relative transform (zero residual at the solve's
    initial point) — including for a scaled alignment, where the naive Sim3
    composition would leave a pure scale residual."""
    rng = np.random.default_rng(1)
    T_pre = np.eye(4, dtype=np.float32)
    T_pre[:3, 3] = rng.normal(0, 1, 3)
    T_match = np.eye(4, dtype=np.float32)
    T_match[:3, 3] = rng.normal(0, 1, 3)
    xi = jnp.asarray(np.r_[rng.normal(0, 0.2, 6), 0.3].astype(np.float32))
    A = lie.sim3_exp(xi[None])[0]    # alignment with scale e^0.3
    meas = map_merging.seam_measurement(
        jnp.asarray(T_pre), jnp.asarray(T_match), A
    )
    # the pose the transform actually wrote into the fused map
    from motioncheck_ccm_slam.solvers import pose_graph
    U_pre = lie.make_sim3(jnp.asarray(T_pre[:3, :3]),
                          jnp.asarray(T_pre[:3, 3]), jnp.float32(1.0))
    T_post = pose_graph.se3_from_sim3((U_pre @ lie.sim3_inv(A))[None])[0]
    U_post = lie.make_sim3(T_post[:3, :3], T_post[:3, 3], jnp.float32(1.0))
    U_match = lie.make_sim3(jnp.asarray(T_match[:3, :3]),
                            jnp.asarray(T_match[:3, 3]), jnp.float32(1.0))
    rel = U_match @ lie.sim3_inv(U_post)
    assert np.abs(np.asarray(meas) - np.asarray(rel)).max() < 1e-5


def test_seam_graph_distributes_multi_hit_disagreement():
    """Fused map where the applied alignment carries a small rigid error but
    a second confirmed hit measured the TRUE alignment: the seam essential
    graph must pull the mis-aligned chain toward truth (with a single hit it
    is a consistent fixed point — reference parity)."""
    cfg = CONFIG.replace(opt=OptParams(solver_iterations=15))
    world = SynthWorld(cfg, n_points=400, seed=4)
    m = ms.MapState.create(cfg, server=False)
    poses, ts = arc_poses(6, step=0.4)
    slots_a = add_pass(m, world, poses, ts, client_id=0, kf_id_start=0,
                       seed=5)
    # chain B: same true trajectory, stored displaced by rigid error E
    # (simulating a merge aligned with an imperfect Sim3)
    E = np.eye(4, dtype=np.float32)
    th = np.deg2rad(2.0)
    E[:3, :3] = np.array([[np.cos(th), 0, np.sin(th)],
                          [0, 1, 0],
                          [-np.sin(th), 0, np.cos(th)]], np.float32)
    E[:3, 3] = [0.15, 0.0, 0.10]
    slots_b = add_pass(m, world, poses, [t + 50.0 for t in ts], client_id=1,
                       kf_id_start=100, seed=6, lm_pose_error=E)
    E_sim3 = lie.make_sim3(jnp.asarray(E[:3, :3]), jnp.asarray(E[:3, 3]),
                           jnp.float32(1.0))
    # hit 0: the alignment actually applied (identity in B's stored frame)
    meas0 = map_merging.seam_measurement(
        m.kf.Tcw[slots_b[0]], m.kf.Tcw[slots_a[0]], jnp.eye(4))
    # hit 1: an independent hit that measured the TRUE alignment E^-1
    meas1 = map_merging.seam_measurement(
        m.kf.Tcw[slots_b[3]], m.kf.Tcw[slots_a[3]], lie.sim3_inv(E_sim3))

    def b_error():
        errs = []
        for k, s in enumerate(slots_b):
            C = np.linalg.inv(np.asarray(m.kf.Tcw[s]))[:3, 3]
            C_true = np.linalg.inv(poses[k])[:3, 3]
            errs.append(np.linalg.norm(C - C_true))
        return float(np.mean(errs))

    err_before = b_error()
    map_merging.optimize_seam_essential_graph(
        m, [(slots_b[0], slots_a[0], meas0), (slots_b[3], slots_a[3], meas1)],
        slots_a[0], cfg,
    )
    err_after = b_error()
    assert err_before > 0.1   # the error was injected
    assert err_after < 0.75 * err_before, (err_before, err_after)
