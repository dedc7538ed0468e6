import numpy as np
import jax
import jax.numpy as jnp

from motioncheck_ccm_slam.config import ExtractorParams
from motioncheck_ccm_slam.ops import orb, image as image_ops


def dots_image(h, w, n_dots=120, seed=0):
    """Textured test image: random bright blobs on mid-gray — blob centers
    and edges are strong FAST corners (a checkerboard would NOT be: its
    X-junctions only give 8-contiguous arcs, below FAST-9's threshold)."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w), 80.0, np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    for _ in range(n_dots):
        cy, cx = rng.integers(10, h - 10), rng.integers(10, w - 10)
        r = rng.integers(2, 5)
        amp = rng.uniform(80, 160) * rng.choice([-1, 1])
        m = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
        img[m] = np.clip(80.0 + amp, 0, 255)
    img += rng.normal(0, 1.5, size=(h, w)).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.float32)


def checkerboard(h, w, sq=16, lo=40.0, hi=210.0, seed=0):
    return dots_image(h, w, n_dots=(h * w) // 400, seed=seed)


SMALL = ExtractorParams(max_features=256, n_levels=4)


def test_pyramid_shapes():
    shapes = image_ops.pyramid_shapes(480, 752, 8, 1.2)
    assert shapes[0] == (480, 752)
    assert shapes[1] == (400, 627)
    assert all(
        s[0] < p[0] and s[1] < p[1] for p, s in zip(shapes, shapes[1:])
    )


def test_budgets_sum():
    b = orb.level_feature_budgets(1024, 8, 1.2)
    assert sum(b) == 1024
    assert all(x > y for x, y in zip(b, b[1:]))


def test_fast_detects_corners():
    img = jnp.asarray(checkerboard(128, 128))
    corner, score = orb.fast_response(img, 20.0)
    n = int(jnp.sum(corner))
    assert n > 20  # checkerboard corners get detected
    # scores are positive exactly where response is meaningful
    assert float(jnp.max(score)) > 0


def test_fast_flat_image_has_no_corners():
    img = jnp.full((64, 64), 128.0, jnp.float32)
    corner, _ = orb.fast_response(img, 7.0)
    assert int(jnp.sum(corner)) == 0


def test_extract_orb_end_to_end():
    img = jnp.asarray(checkerboard(240, 320, sq=20))
    feats = jax.jit(lambda x: orb.extract_orb(x, SMALL))(img)
    k = SMALL.max_features
    assert feats.xy.shape == (k, 2)
    assert feats.desc.shape == (k, 8)
    assert feats.desc.dtype == jnp.uint32
    n_valid = int(jnp.sum(feats.valid))
    assert n_valid > 50
    # valid keypoints are inside the image
    xy = np.asarray(feats.xy)[np.asarray(feats.valid)]
    assert (xy[:, 0] >= 0).all() and (xy[:, 0] < 320).all()
    assert (xy[:, 1] >= 0).all() and (xy[:, 1] < 240).all()
    # multiple octaves fire on a textured image
    octs = np.asarray(feats.octave)[np.asarray(feats.valid)]
    assert len(np.unique(octs)) >= 2


def test_descriptors_stable_under_translation():
    """Shifting the image shifts keypoints but leaves descriptors mostly
    intact — the self-consistency property matching relies on."""
    from motioncheck_ccm_slam.ops import matching

    base = checkerboard(200, 260, sq=24, seed=1)
    shift = 8
    img1 = jnp.asarray(base)
    img2 = jnp.asarray(np.roll(base, shift, axis=1))
    f1 = orb.extract_orb(img1, SMALL)
    f2 = orb.extract_orb(img2, SMALL)
    m = matching.search_for_initialization(
        f1.desc, f1.xy, f1.valid, f2.desc, f2.xy, f2.valid,
        window=30.0, angle1=f1.angle, angle2=f2.angle,
    )
    ok = np.asarray(m.ok)
    assert ok.sum() > 30
    # matched pairs should be displaced by ~shift in x
    dx = np.asarray(f2.xy)[np.asarray(m.idx)][:, 0] - np.asarray(f1.xy)[:, 0]
    med_dx = np.median(dx[ok])
    assert abs(med_dx - shift) < 2.0


def test_ic_angle_points_at_brightness():
    """IC angle points toward the intensity centroid: put a bright blob to
    the right of the probe -> angle ~ 0; above -> angle ~ -pi/2 (y up is
    negative in image coords)."""
    def blob_img(cy, cx):
        img = np.full((96, 96), 50.0, np.float32)
        yy, xx = np.mgrid[0:96, 0:96]
        img[(yy - cy) ** 2 + (xx - cx) ** 2 <= 9] = 250.0
        return jnp.asarray(img)

    probe = jnp.array([[48.0, 48.0]], jnp.float32)
    a_right = float(orb.ic_angles(blob_img(48, 56), probe, 15)[0])
    a_up = float(orb.ic_angles(blob_img(40, 48), probe, 15)[0])
    assert abs(a_right) < 0.15
    assert abs(a_up + np.pi / 2) < 0.15
