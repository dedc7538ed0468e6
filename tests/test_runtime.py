"""Runtime plumbing: where compiled programs are cached, which GBA solver
the device count selects, and that the GPU smoke check refuses to run
without a GPU."""
import os
import subprocess
import sys

import jax
import pytest

from motioncheck_ccm_slam.models import gba as gba_mod
from motioncheck_ccm_slam.utils import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir(env_set, monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins and nothing else is set; without it
    the cache sits at the fixed, git-ignored <checkout>/.jax_cache."""
    updates = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.__setitem__(k, v))
    if env_set:
        monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
        assert compile_cache.enable() == str(tmp_path)
        assert compile_cache.cache_dir() == str(tmp_path)
        assert updates == {}
    else:
        monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
        want = os.path.join(ROOT, ".jax_cache")
        assert compile_cache.enable() == want
        assert compile_cache.cache_dir() == want
        assert updates["jax_compilation_cache_dir"] == want
        with open(os.path.join(ROOT, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()


def test_pick_solver_routing(monkeypatch):
    """One device: dense-W (None) when the Schur complement fits, else the
    matrix-free solver. The 8-device mesh: the sharded solver."""
    monkeypatch.setattr(gba_mod, "_matrix_free_cache", {})
    all_devs = jax.devices()
    assert len(all_devs) == 8

    def name(solver):
        return solver.__qualname__.split(".")[0]

    assert name(gba_mod._pick_solver(64, 1024)) == "make_sharded_gba"
    assert name(gba_mod._pick_solver(2048, 65536)) == "make_sharded_gba"
    monkeypatch.setattr(jax, "devices", lambda *a: all_devs[:1])
    assert gba_mod._pick_solver(64, 1024) is None
    solver = gba_mod._pick_solver(2048, 65536)
    assert name(solver) == "make_matrix_free_gba"
    assert gba_mod._pick_solver(2048, 65536) is solver   # cached


def test_chip_smoke_refuses_cpu():
    """Without a GPU the smoke check exits non-zero and never prints the
    ok line (no CPU fallback)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "needs a GPU" in r.stderr
