"""chip_smoke.py, bench.py and their helpers on the CPU: both refuse to run
where JAX finds no GPU, and the program's compile cache goes where
JAX_COMPILATION_CACHE_DIR says."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("script,args", [
    ("chip_smoke.py", []), ("chip_smoke.py", ["--four"]),
    ("bench.py", []), ("bench.py", ["--grad"]),
])
def test_refuses_cpu_only_device(script, args):
    """No GPU: non-zero exit, and no result line on stdout."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, os.path.join(REPO, script), *args],
                       capture_output=True, text=True, env=env, timeout=300,
                       cwd=REPO)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout and '"metric"' not in p.stdout
    assert "no GPU" in p.stderr


def test_fails_without_the_repo(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_bytes(open(os.path.join(REPO, "chip_smoke.py"), "rb").read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, str(alone)], capture_output=True,
                       text=True, env=env, timeout=300, cwd=tmp_path)
    assert p.returncode != 0 and '"ok"' not in p.stdout


def test_require_gpu_raises_on_cpu():
    from raytrace2.utils import device

    with pytest.raises(device.NoGpuError):
        device.require_gpu()
    assert device.describe()["platform"] == "cpu"


def test_cache_dir_honours_env(monkeypatch, tmp_path):
    from raytrace2.utils import cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
    assert cache.cache_dir() == str(tmp_path / "cc")
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    assert cache.cache_dir() == os.path.join(REPO, ".jax_cache")
    assert cache.DEFAULT_DIR == os.path.join(REPO, ".jax_cache")


def test_enable_cache_is_off_on_cpu(monkeypatch, tmp_path):
    """The CPU keeps no program cache (the test suite sets its own)."""
    import jax

    from raytrace2.utils import cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
    assert cache.enable_compilation_cache() is None
    assert jax.config.jax_compilation_cache_dir == before
    assert not (tmp_path / "cc").exists()


def test_smoke_helpers():
    import numpy as np

    sys.path.insert(0, REPO)
    import chip_smoke

    a = np.zeros((4, 4, 3))
    assert chip_smoke.psnr(a, a) == float("inf")
    assert abs(chip_smoke.psnr(a, a + 0.1) - 20.0) < 1e-9
    with pytest.raises(chip_smoke.SmokeError):
        chip_smoke.check(False, "boom")
    lo, hi = chip_smoke.CORNELL_MEAN
    assert 0 < lo < hi


def test_light_emission_leaf_is_the_light(data_dir):
    sys.path.insert(0, REPO)
    import chip_smoke

    from raytrace2 import defs
    from raytrace2.scene import loader

    scene, _ = loader.load_scene(f"{data_dir}/cornell_box_original.json")
    tex, ch = chip_smoke._light_emission_leaf(scene)
    light = list(scene.materials.mtype).index(defs.MAT_DIFFUSE_LIGHT)
    assert tex == int(scene.materials.tex[light]) and ch == 0
    assert float(scene.textures.albedo[tex, 0]) == 7.0
