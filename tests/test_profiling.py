"""utils.profiling: scope attribution of compiled HLO, the trace reduction to
device time per named scope (checked on a CPU trace), and the timing
helper."""

import glob

import jax
import jax.numpy as jnp
import pytest

from surikatoko_tpu.utils.profiling import (device_time_by_scope,
                                            hlo_scope_map, median_wall_time)


def _two_scopes(x):
    with jax.named_scope("alpha"):
        y = jnp.cos(x) * 2.0 + 1.0
    with jax.named_scope("beta"):
        return y @ x


def test_hlo_scope_map_finds_named_scopes():
    x = jnp.ones((64, 64), jnp.float32)
    text = jax.jit(_two_scopes).lower(x).compile().as_text()
    smap = hlo_scope_map(text, ("alpha", "beta"))
    assert "alpha" in smap.values() and "beta" in smap.values()
    assert set(smap.values()) <= {"alpha", "beta"}


def test_hlo_scope_map_fusion_inherits_called_computation():
    text = """
%fused_computation.1 (p: f32[4]) -> f32[4] {
  %p = f32[4]{0} parameter(0)
  ROOT %cos.1 = f32[4]{0} cosine(%p), metadata={op_name="jit(f)/ncc_search/cos"}
}

ENTRY %main (x: f32[4]) -> f32[4] {
  %x = f32[4]{0} parameter(0)
  %fusion.1 = f32[4]{0} fusion(%x), kind=kLoop, calls=%fused_computation.1
  ROOT %add.2 = f32[4]{0} add(%fusion.1, %x), metadata={op_name="jit(f)/add"}
}
"""
    smap = hlo_scope_map(text, ("ncc_search", "render"))
    assert smap["fusion.1"] == "ncc_search"
    assert smap["cos.1"] == "ncc_search"
    assert "add.2" not in smap


def test_device_time_by_scope_on_cpu_trace(tmp_path):
    x = jnp.ones((256, 256), jnp.float32)
    compiled = jax.jit(_two_scopes).lower(x).compile()
    jax.block_until_ready(compiled(x))
    with jax.profiler.trace(str(tmp_path)):
        jax.block_until_ready(compiled(x))
    xplane = glob.glob(str(tmp_path / "**" / "*.xplane.pb"),
                       recursive=True)[0]
    red = device_time_by_scope(xplane, compiled.as_text(),
                               ("alpha", "beta"), plane_prefix="/host:CPU")
    assert red["n_events"] >= 2
    assert red["by_scope"].get("beta", 0.0) > 0.0
    assert 0.0 < red["busy_ns"] <= red["window_ns"]
    assert 0.0 <= red["idle_share"] < 1.0
    # a trace with no events on the chosen planes reduces to nothing
    none = device_time_by_scope(xplane, compiled.as_text(), ("alpha",),
                                plane_prefix="/device:GPU")
    assert none["n_events"] == 0 and none["idle_share"] is None


@pytest.mark.parametrize("reps", [1, 3])
def test_median_wall_time_waits_for_the_result(reps):
    calls = []

    def thunk():
        calls.append(1)
        return jnp.arange(8.0) * 2.0

    t = median_wall_time(thunk, reps)
    assert len(calls) == reps
    assert t >= 0.0
