"""Checks that need an NVIDIA GPU (``gpu`` marker; skipped elsewhere).

Run on a GPU machine: ``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu
tests/``. ``chip_smoke.py`` covers the same ground at full width."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from motioncheck_ccm_slam.ops import matching
from motioncheck_ccm_slam.parallel import sharded_ba

from test_ba import K
from test_gba_solvers import _perturbed

pytestmark = pytest.mark.gpu


def test_hamming_matrix_exact_on_gpu(gpu):
    rng = np.random.default_rng(0)
    d1 = rng.integers(0, 2 ** 32, (1000, 8), dtype=np.uint32)
    d2 = rng.integers(0, 2 ** 32, (2048, 8), dtype=np.uint32)
    ham = matching.hamming_matrix(jax.device_put(d1, gpu),
                                  jax.device_put(d2, gpu))
    assert ham.devices() == {gpu}
    ref = np.unpackbits((d1[:, None] ^ d2[None]).view(np.uint8), -1).sum(-1)
    np.testing.assert_array_equal(np.asarray(ham), ref)


def test_matrix_free_gba_gpu_matches_cpu(gpu):
    """The matrix-free GBA on the GPU at default precision lands on the
    CPU's float32 HIGHEST result."""
    rng = np.random.default_rng(0)
    Tcw_i, pts_i, obs, fixed_cam, fixed_lm, _, _ = _perturbed(rng)
    args = (Tcw_i, pts_i, obs, K, fixed_cam, fixed_lm)
    gba = sharded_ba.make_matrix_free_gba(iterations=8, pcg_iters=30)
    r_gpu = gba(*jax.device_put(args, gpu))
    cpu = jax.devices("cpu")[0]
    with jax.default_matmul_precision("highest"):
        r_cpu = gba(*jax.device_put(args, cpu))
    assert r_gpu.Tcw.devices() == {gpu}
    assert abs(float(r_gpu.cost) - float(r_cpu.cost)) <= (
        1e-3 * float(r_cpu.cost))
    assert float(jnp.abs(jnp.asarray(np.asarray(r_gpu.Tcw))
                         - np.asarray(r_cpu.Tcw)).max()) < 1e-3
