"""Runtime wiring that decides where the codec runs: the device_filters
auto rule, the persistent compile cache location, and chip_smoke.py's
refusal to run without a GPU."""
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("backend, pixels, expected", [
    ("gpu", 64 * 64, True),             # device decode is on for any frame
    ("cpu", 64 * 64, False),            # small frame: numpy filters
    ("cpu", 4 << 20, True),             # >= 4 MP: XLA filters on the CPU
])
def test_device_filters_auto_rule(monkeypatch, backend, pixels, expected):
    import jax

    from libjxl_tpu.config import config, device_filters_enabled
    monkeypatch.setattr(config, "device_filters", None)
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert device_filters_enabled(pixels) is expected


def _python(code: str, env: dict, cwd: str = REPO):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("preset", [True, False])
def test_compile_cache_dir(tmp_path, preset):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache is
    <checkout>/.jax_cache, a fixed path, so cache keys stay stable."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    want = str(tmp_path / "cache") if preset else \
        os.path.join(REPO, ".jax_cache")
    if preset:
        env["JAX_COMPILATION_CACHE_DIR"] = want
    r = _python("import libjxl_tpu, jax; "
                "print(jax.config.jax_compilation_cache_dir)", env)
    assert r.returncode == 0, r.stderr
    assert os.path.abspath(r.stdout.strip()) == os.path.abspath(want)


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_refuses_cpu(tmp_path, where):
    """Without a GPU (here: the CPU backend) or outside a checkout,
    chip_smoke.py exits non-zero before its first phase and prints no
    result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    script = os.path.join(REPO, "chip_smoke.py")
    if where == "alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = str(tmp_path / "chip_smoke.py")
    r = subprocess.run([sys.executable, script], cwd=os.path.dirname(script),
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "phase" not in r.stdout and '"ok"' not in r.stdout
