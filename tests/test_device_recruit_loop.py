"""Closed-loop on-device landmark lifecycle: the imageseq scan runner with
recruit=True must sustain steady-state add+delete churn (slots turn over,
templates follow) while the filter keeps tracking — the device analog of the
reference's per-frame RecruitNewSalientPoints hot path
(davison-mono-slam.cpp:923, :1812, :2597)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from surikatoko_tpu.geom import camera
from surikatoko_tpu.geom.align import aligned_rmse
from surikatoko_tpu.models.monoslam import make_params, init_state
from surikatoko_tpu.world.device_runner import (
    build_imageseq_scenario, init_imageseq, make_imageseq_scan_runner)


def _run_churn(recruit=True, capacity=20, n_points=30, frames=100,
               max_deviation=1.0, world="grid", dtype=jnp.float64):
    sc = build_imageseq_scenario(capacity=n_points, n_points=n_points,
                                 dtype=dtype, image_size=(320, 240),
                                 bg_cell=32, max_deviation=max_deviation,
                                 world=world)
    cam = camera.make_intrinsics((320, 240), (160.0, 120.0), 1.95,
                                 (0.01, 0.01), dtype=dtype)
    params = make_params(cam, None, dt=1.0,
                         process_noise_lin_veloc_std=0.075,
                         process_noise_ang_veloc_std=0.01,
                         sal_pnt_init_inv_dist=0.5,
                         sal_pnt_init_inv_dist_std=0.5,
                         max_undetected_frames=8, dtype=dtype)
    st = init_state(capacity, dtype=dtype)
    st, templates = jax.jit(lambda s: init_imageseq(
        params, sc, s, 15, max_bootstrap=capacity - 4))(st)
    run = make_imageseq_scan_runner(params, templ_width=15, search_radius=9,
                                    recruit=recruit, recruit_max=4)
    fr = jnp.arange(1, frames + 1)
    out = run(st, templates, sc, fr)
    gt_pos = -jnp.einsum("fji,fj->fi", sc.gt_cfw_R[fr], sc.gt_cfw_t[fr])
    return out, gt_pos


def test_recruit_loop_churns_and_tracks():
    (st, templates, (err, n, pos, nrec, nact)), gt_pos = _run_churn()

    # churn actually happened: recruits landed, slots were REUSED
    assert int(jnp.sum(nrec)) >= 5
    assert int(jnp.max(st.lm_generation)) >= 2
    # capacity stays near-full in equilibrium (delete+recruit balance)
    assert int(jnp.median(nact)) >= st.capacity - 4
    # the filter keeps tracking through the churn
    assert bool(jnp.all(jnp.isfinite(err)))
    assert int(jnp.median(n)) >= st.capacity // 2
    ate = float(aligned_rmse(pos, gt_pos))
    assert ate < 0.4, ate
    # recruited templates were cut from the live frame (non-zero patches in
    # reused slots)
    reused = np.asarray(st.lm_generation) >= 2
    if reused.any():
        assert float(jnp.max(jnp.abs(templates[np.argmax(reused)]))) > 0


def test_recruit_loop_beats_stranded_filter():
    """On a wide-oscillation trajectory landmarks leave the view; without
    recruitment the filter strands on whatever survives, with recruitment
    it re-acquires — and must track STRICTLY better (VERDICT r4 item 2:
    'beats' means ate_r < ate_n, not a vacuous 1.5x bound).

    Regime matters (measured, analysis/measure_churn_accuracy.py + CPU
    sweep 2026-08-21): at mild sweeps (max_deviation<=1.4 on the wide
    world) the stranded filter's few surviving GT-depth landmarks BEAT a
    churning filter diluted by prior-depth recruits; recruitment's value
    shows where stranding is fatal — at max_deviation=2.2 the stranded
    filter erodes to ~8 matched and ATE 0.75 while the recruiting loop
    holds ~15 matched at ATE 0.58."""
    (st_r, _, (_, _, pos_r, nrec, _)), gt_pos = _run_churn(
        recruit=True, max_deviation=2.2, world="wide")
    (st_n, (_, _, pos_n)), _ = _run_churn(recruit=False, max_deviation=2.2,
                                          world="wide")
    ate_r = float(aligned_rmse(pos_r, gt_pos))
    ate_n = float(aligned_rmse(pos_n, gt_pos))
    assert int(jnp.sum(nrec)) > 0
    assert ate_r < ate_n, (ate_r, ate_n)


def test_recruit_mode_rejects_other_impls():
    cam = camera.make_intrinsics((320, 240), (160.0, 120.0), 1.95,
                                 (0.01, 0.01), dtype=jnp.float64)
    params = make_params(cam, None, dtype=jnp.float64)
    with pytest.raises(ValueError):
        make_imageseq_scan_runner(params, recruit=True, update_impl=4)
