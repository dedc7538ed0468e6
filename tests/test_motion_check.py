import numpy as np
import jax.numpy as jnp

from motioncheck_ccm_slam.config import MotionCheckParams
from motioncheck_ccm_slam.models import motion_check as mc


PARAMS = MotionCheckParams(skip_edge_kfs=3)


def smooth_trajectory(n, step=0.1, seed=0):
    """Forward motion with gentle curvature + realistic tracking jitter (the
    pre-GBA trajectory is real VO output, not an analytic curve — without
    jitter the reference's min(5*xy_angle, 40) limits collapse to ~0)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float32)
    pos = np.stack(
        [t * step, 0.2 * np.sin(t * 0.3), 0.08 * np.cos(t * 0.4)], -1
    ).astype(np.float32)
    pos += rng.normal(0, 0.008, pos.shape).astype(np.float32)
    return pos


def test_clean_gba_passes():
    """Post-GBA positions ~= pre-GBA (small smooth correction) -> no doubt."""
    n = 40
    pre = smooth_trajectory(n)
    post = pre + 0.0005 * np.sin(np.arange(n))[:, None].astype(np.float32)
    v = jnp.ones(n, bool)
    verdict = mc.run_motion_check(jnp.asarray(post), jnp.asarray(pre), v, PARAMS)
    assert int(np.asarray(verdict.violate).sum()) == 0
    assert not bool(verdict.revert)


def test_single_corrupted_kf_deleted_not_reverted():
    """One KF thrown far off -> flagged as violator, surgical verdict."""
    n = 40
    pre = smooth_trajectory(n)
    post = pre.copy()
    post[20] += np.array([0.5, -0.4, 0.3], np.float32)  # 5x the step size
    v = jnp.ones(n, bool)
    verdict = mc.run_motion_check(jnp.asarray(post), jnp.asarray(pre), v, PARAMS)
    assert int(np.asarray(verdict.violate).sum()) >= 1
    viol = np.asarray(verdict.violate)
    assert viol[19:22].any()          # the corruption neighborhood is flagged
    assert not bool(verdict.revert)   # short run -> delete, don't revert


def test_garbage_gba_reverted():
    """GBA scrambled a long stretch -> revert-all verdict."""
    rng = np.random.default_rng(1)
    n = 40
    pre = smooth_trajectory(n)
    post = pre.copy()
    post[10:30] += rng.uniform(-0.5, 0.5, (20, 3)).astype(np.float32)
    v = jnp.ones(n, bool)
    verdict = mc.run_motion_check(jnp.asarray(post), jnp.asarray(pre), v, PARAMS)
    assert bool(verdict.revert)


def test_edge_kfs_skipped():
    """Corruption inside the skip margin is not checked."""
    n = 30
    pre = smooth_trajectory(n)
    post = pre.copy()
    post[0] += 2.0
    post[-1] += 2.0
    v = jnp.ones(n, bool)
    verdict = mc.run_motion_check(jnp.asarray(post), jnp.asarray(pre), v, PARAMS)
    assert int(np.asarray(verdict.violate).sum()) == 0


def test_scale_change_alone_is_tolerated():
    """A global scale change (mono GBA does this legitimately) keeps step
    ratios and directions intact -> must NOT trigger."""
    n = 40
    pre = smooth_trajectory(n)
    post = pre * 1.5
    v = jnp.ones(n, bool)
    verdict = mc.run_motion_check(jnp.asarray(post), jnp.asarray(pre), v, PARAMS)
    assert int(np.asarray(verdict.violate).sum()) == 0


def test_apply_verdict_revert_and_delete():
    from motioncheck_ccm_slam.models import map_state as ms

    n = 24
    kf = ms.empty_kf_block(n, 8)
    pre = smooth_trajectory(n)
    Tcw = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    Tcw[:, :3, 3] = -pre  # camera at pre positions (R=I: Tcw t = -C)
    kf = kf._replace(
        valid=jnp.ones(n, bool),
        timestamp=jnp.arange(n, dtype=jnp.float32),
        Tcw=jnp.asarray(Tcw),
    )
    T_SC_inv = jnp.eye(4, dtype=jnp.float32)
    kf = mc.snapshot_pre_gba(kf, T_SC_inv)
    # corrupt one pose post-"GBA"
    Tbad = Tcw.copy()
    Tbad[12, :3, 3] += np.array([0.7, -0.6, 0.5], np.float32)
    kf = kf._replace(Tcw=jnp.asarray(Tbad))
    verdict, order = mc.check_after_gba(kf, T_SC_inv, PARAMS)
    mp = ms.empty_mp_block(16)
    kf2, mp2, reverted = mc.apply_verdict(kf, mp, verdict, order)
    if reverted:
        np.testing.assert_allclose(np.asarray(kf2.Tcw), Tcw, atol=1e-6)
    else:
        # the corrupted KF (or a neighbor) must be deleted
        assert not bool(np.asarray(kf2.valid)[11:14].all())
