"""chip_smoke.py: every phase at rehearsal sizes on the CPU, its refusal to
run without a GPU, the compile-cache helper, and (marked ``gpu``, skipped
without a card) every phase at full size.

On the card:  JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/test_chip_smoke.py
"""

import os
import shutil
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from surikatoko_tpu.utils import compile_cache  # noqa: E402

PHASES = dict(chip_smoke.ONE_CARD + (("four", chip_smoke.phase_four),))


@pytest.fixture(scope="module")
def rehearsal():
    return chip_smoke.Smoke(chip_smoke.REHEARSE, "rehearsal")


@pytest.mark.parametrize("phase", list(PHASES))
def test_phase_rehearsal(rehearsal, phase):
    # the script runs with 64-bit types off; its f64 references turn them
    # on locally
    with jax.enable_x64(False):
        PHASES[phase](rehearsal)


def _run_script(path, cwd, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, path, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_refuses_to_run_without_gpu():
    out = _run_script(os.path.join(REPO, "chip_smoke.py"), REPO)
    assert out.returncode != 0
    assert "platform 'cpu'" in out.stderr
    assert '"ok"' not in out.stdout


def test_fails_without_the_repo(tmp_path):
    script = shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run_script(script, tmp_path, "--rehearse")
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_compile_cache_defers_to_environment(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        got = compile_cache.enable_compile_cache()
        assert got == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.fixture(scope="module")
def on_card():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX found "
                    f"{jax.devices()[0].platform!r})")
    return chip_smoke.Smoke(chip_smoke.FULL, chip_smoke.card_line())


@pytest.mark.gpu
@pytest.mark.parametrize("phase", [name for name, _ in chip_smoke.ONE_CARD])
def test_phase_on_card(on_card, phase):
    with jax.enable_x64(False), \
            jax.default_matmul_precision("highest"):
        PHASES[phase](on_card)
