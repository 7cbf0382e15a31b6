"""Large-K f32 conditioning mechanisms (found at the K=768 regime, see
bench.py): the delete-unobserved policy folded into the fused congruence
(reference RemoveLongTermUnobservedSalientPoints, davison-mono-slam.cpp:799)
and the per-frame covariance diagonal inflation (f32 addition; the
reference's f64 never needed it)."""

import jax
import jax.numpy as jnp
import numpy as np

from surikatoko_tpu.geom import camera
from surikatoko_tpu.models.monoslam import make_params, init_state, measure
from surikatoko_tpu.models.monoslam.fused_step import fused_update_health_predict
from surikatoko_tpu.models.monoslam.state import CAM_STATE_COMPS as N

from tests.test_parallel_ekf import K, rand_problem


def _params(**kw):
    cam = camera.make_intrinsics((320, 240), (160.0, 120.0), 1.95,
                                 (0.01, 0.01))
    return make_params(cam, None, dt=1.0,
                       process_noise_lin_veloc_std=0.075,
                       process_noise_ang_veloc_std=0.01, **kw)


def test_covar_inflation_adds_to_live_diagonal(rng):
    x, P = rand_problem(rng)
    obs_mask = jnp.ones(K, bool)
    h0 = measure.project_all(_params(), x)
    obs = h0 + jnp.asarray(rng.normal(scale=0.5, size=(K, 2)))

    x0, P0, _, _ = fused_update_health_predict(
        _params(covar_diag_inflation=0.0), x, P, obs, obs_mask)
    x1, P1, _, _ = fused_update_health_predict(
        _params(covar_diag_inflation=0.5), x, P, obs, obs_mask)
    np.testing.assert_allclose(x1, x0, atol=0)
    d = np.diag(np.asarray(P1)) - np.diag(np.asarray(P0))
    # live variables gain exactly the inflation; off-diagonals untouched
    live = np.diag(np.asarray(P0)) != 0.0
    np.testing.assert_allclose(d[live], 0.5, atol=1e-9)
    off = np.asarray(P1) - np.asarray(P0)
    np.testing.assert_allclose(off - np.diag(np.diag(off)), 0.0, atol=0)


def test_deactivate_mask_zeroes_slot(rng):
    x, P = rand_problem(rng)
    obs_mask = jnp.ones(K, bool)
    params = _params()
    h0 = measure.project_all(params, x)
    obs = h0 + jnp.asarray(rng.normal(scale=0.5, size=(K, 2)))
    drop = jnp.zeros(K, bool).at[3].set(True)

    # a dropped slot is by construction unmatched this frame
    x1, P1, _, _ = fused_update_health_predict(
        params, x, P, obs, obs_mask & ~drop, deactivate_mask=drop)
    off = N + 3 * 6
    assert np.all(np.asarray(x1[off:off + 6]) == 0.0)
    assert np.all(np.asarray(P1[off:off + 6, :]) == 0.0)
    assert np.all(np.asarray(P1[:, off:off + 6]) == 0.0)
    # other slots unaffected vs the removal applied beforehand
    from surikatoko_tpu.models.monoslam import landmarks as lm_mod
    st = init_state(K)
    st = st._replace(x=x, P=P, lm_active=jnp.ones(K, bool))
    st_rm = lm_mod.remove_landmarks(st, drop)
    x2, P2, _, _ = fused_update_health_predict(
        params, st_rm.x, st_rm.P, obs, obs_mask & ~drop)
    np.testing.assert_allclose(np.asarray(x1), np.asarray(x2), atol=1e-10)
    np.testing.assert_allclose(np.asarray(P1), np.asarray(P2), atol=1e-10)


def test_imageseq_loop_deletes_long_unobserved():
    """Device-loop deletion policy: slots that stop matching for more than
    max_undetected_frames get deactivated and their covariance zeroed."""
    from surikatoko_tpu.world.device_runner import (
        build_imageseq_scenario, init_imageseq, make_imageseq_scan_runner)

    dtype = jnp.float64
    params = _params(max_undetected_frames=4, covar_diag_inflation=1e-9)
    cap = 24
    sc = build_imageseq_scenario(capacity=cap, dtype=dtype)
    # push some GT points far behind the camera path so they never render
    # after frame 0's bootstrap... simpler: shrink the image so border
    # points fall out of view as the camera oscillates
    st = init_state(cap, dtype=dtype)
    st, templates = jax.jit(lambda s: init_imageseq(params, sc, s, 9))(st)
    n0 = int(jnp.sum(st.lm_active))
    run = make_imageseq_scan_runner(params, templ_width=9, search_radius=5)
    st, (err, n, pos) = run(st, templates, sc, jnp.arange(1, 60))
    assert bool(jnp.all(jnp.isfinite(st.x)))
    n1 = int(jnp.sum(st.lm_active))
    assert n1 < n0, (n0, n1)          # some landmarks left view -> deleted
    # deactivated slots have exactly zero covariance rows
    inact = ~np.asarray(st.lm_active)
    for k in np.nonzero(inact)[0]:
        off = N + 6 * int(k)
        assert np.all(np.asarray(st.P[off:off + 6, :]) == 0.0)
