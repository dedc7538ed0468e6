"""Aux subsystem tests: persistence, viewer export, structure checking,
watchdog, Sim3-guided matching."""
import os

import numpy as np
import jax.numpy as jnp

from motioncheck_ccm_slam.config import (
    CameraParams, CapacityParams, Config, ExtractorParams,
)
from motioncheck_ccm_slam.models import map_state as ms
from motioncheck_ccm_slam import persistence
from motioncheck_ccm_slam.ops import lie, matching
from motioncheck_ccm_slam.utils.watchdog import PhaseTimer, Watchdog

from synth_map import SynthWorld, add_pass, arc_poses

CONFIG = Config().replace(
    extractor=ExtractorParams(max_features=128, n_levels=4, n_features=128),
    capacity=CapacityParams(client_max_kfs=16, client_max_mps=1024),
    camera=CameraParams(k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0),
)


def build_map():
    world = SynthWorld(CONFIG, n_points=200, seed=0)
    m = ms.MapState.create(CONFIG, server=False)
    poses, ts = arc_poses(4, step=0.3)
    slots = add_pass(m, world, poses, ts)
    return m, slots


def test_save_load_roundtrip(tmp_path):
    m, slots = build_map()
    path = str(tmp_path / "map.npz")
    persistence.save_map(m, path)
    m2 = persistence.load_map(path, CONFIG)
    assert m2.n_kfs == m.n_kfs
    assert m2.n_mps == m.n_mps
    np.testing.assert_array_equal(np.asarray(m2.kf.Tcw), np.asarray(m.kf.Tcw))
    np.testing.assert_array_equal(np.asarray(m2.mp.Xw), np.asarray(m.mp.Xw))
    np.testing.assert_array_equal(
        np.asarray(m2.kf.mp_idx), np.asarray(m.kf.mp_idx)
    )
    assert m2.kf_slot_by_id == m.kf_slot_by_id


def test_check_structure_clean_and_repair():
    m, slots = build_map()
    assert ms.check_structure(m) == []
    # break an invariant: association to a dead landmark
    m.mp = m.mp._replace(valid=m.mp.valid.at[0].set(False))
    problems = ms.check_structure(m)
    assert problems
    ms.check_structure(m, repair=True)
    assert all("dead landmarks" not in p for p in ms.check_structure(m))


def test_viewer_export(tmp_path):
    m, slots = build_map()
    from motioncheck_ccm_slam.utils import viewer

    out = str(tmp_path / "map.png")
    viewer.render_map(m, out, show_covis=True)
    assert os.path.getsize(out) > 5000


def test_viewer_html_export(tmp_path):
    m, slots = build_map()
    from motioncheck_ccm_slam.utils import viewer

    out = str(tmp_path / "map.html")
    viewer.export_html(m, out, title="t")
    with open(out) as f:
        html = f.read()
    assert "\"points\":" in html and "\"trajs\":" in html
    # every valid KF center must appear in some trajectory
    n_kf = int(np.asarray(m.kf.valid).sum())
    import json, re

    data = json.loads(re.search(r"const DATA = (\{.*?\});\n", html, re.S).group(1))
    assert sum(len(t["pts"]) for t in data["trajs"]) == n_kf


def test_watchdog():
    w = Watchdog(timeout_s=0.01)
    w.beat("tracking", "frame 5")
    import time

    time.sleep(0.03)
    silent = w.silent_modules()
    assert len(silent) == 1 and silent[0][0] == "tracking"
    assert "SILENT" in w.report()


def test_phase_timer():
    t = PhaseTimer()
    with t.phase("gba"):
        pass
    with t.phase("gba"):
        pass
    assert t.counts["gba"] == 2
    assert "gba" in t.summary()


def test_search_by_sim3():
    rng = np.random.default_rng(0)
    n = 60
    # landmarks in camera-2 frame; camera-1 related by a known Sim3
    X2 = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    X2[:, 2] += 6.0
    R = np.asarray(lie.so3_exp(jnp.asarray(np.array([0.05, -0.1, 0.02], np.float32))))
    t = np.array([0.4, -0.1, 0.3], np.float32)
    s = 1.3
    S12 = lie.make_sim3(jnp.asarray(R), jnp.asarray(t), jnp.float32(s))
    X1 = (s * X2 @ R.T + t).astype(np.float32)   # same physical points in cam1
    desc = jnp.asarray(rng.integers(0, 2**32, (n, 8), dtype=np.uint32))
    K = jnp.asarray(CONFIG.camera.K())
    # shuffle side 2
    perm = rng.permutation(n)
    m = matching.search_by_sim3(
        desc, jnp.asarray(X1), jnp.ones(n, bool),
        desc[jnp.asarray(perm)], jnp.asarray(X2[perm]), jnp.ones(n, bool),
        S12, K,
    )
    ok = np.asarray(m.ok)
    assert ok.sum() >= n - 3
    inv = np.argsort(perm)
    np.testing.assert_array_equal(np.asarray(m.idx)[ok], inv[ok])


def test_live_viewer_serves_and_updates():
    """LiveViewer (the RViz replacement) serves the orbit page and an
    updating /state.json."""
    import json as _json
    import urllib.request

    from motioncheck_ccm_slam.utils.live_viewer import LiveViewer

    world = SynthWorld(CONFIG, n_points=80, seed=0)
    m = ms.MapState.create(CONFIG, server=False)
    poses, ts = arc_poses(3, step=0.2)
    add_pass(m, world, poses, ts, kf_id_start=0, seed=1)

    lv = LiveViewer(port=0)
    try:
        page = urllib.request.urlopen(lv.url, timeout=5).read().decode()
        assert "state.json" in page and "canvas" in page
        s0 = _json.loads(urllib.request.urlopen(
            lv.url + "state.json", timeout=5).read())
        assert s0["seq"] == 0 and s0["trajs"] == []
        lv.update({"server0": m})
        s1 = _json.loads(urllib.request.urlopen(
            lv.url + "state.json", timeout=5).read())
        assert s1["seq"] == 1
        assert len(s1["trajs"]) == 1
        assert len(s1["trajs"][0]["pts"]) == 3
        assert len(s1["points"]) > 10
    finally:
        lv.close()
