"""Fused landmark RECRUITMENT must be numerically identical to the sequential
pipeline it replaces: stacked update -> nonneg clamp -> delete -> rho
substitution -> quat renorm -> add_landmarks -> predict (the reference's
ProcessFrame order, davison-mono-slam.cpp:923 -> RecruitNewSalientPoints
:1812 -> AddSalientPoint :2597, with AddSalientPoint's A.58/A.67-A.79 math
exercised through landmarks.add_landmarks)."""

import jax
import jax.numpy as jnp
import numpy as np

from surikatoko_tpu.geom import camera
from surikatoko_tpu.geom.align import aligned_rmse
from surikatoko_tpu.models.monoslam import (
    fused_step, health, landmarks, make_params, init_state, predict, update)
from surikatoko_tpu.world.device_runner import (
    build_oscillating_scenario, init_with_gt_landmarks, _project_gt)


def _setup(capacity=12, n_free=4, dtype=jnp.float64, repres=2,
           warm_frames=2):
    """State with nontrivial covariance and ``n_free`` genuinely free slots
    (bootstrapped, then the tail slots removed, then a couple of plain fused
    frames to evolve P away from its bootstrap structure)."""
    sc = build_oscillating_scenario(capacity=capacity, dtype=dtype)
    cam = camera.make_intrinsics((320, 240), (160.0, 120.0), 1.95,
                                 (0.01, 0.01), dtype=dtype)
    params = make_params(cam, None, dt=1.0,
                        process_noise_lin_veloc_std=0.075,
                        process_noise_ang_veloc_std=0.01,
                        sal_pnt_init_inv_dist=0.5,
                        sal_pnt_init_inv_dist_std=0.4,
                        sal_pnt_repres=repres, dtype=dtype)
    state = init_state(capacity, dtype=dtype)
    state = init_with_gt_landmarks(params, sc, state, jax.random.PRNGKey(0))
    kill = jnp.arange(capacity) >= capacity - n_free
    state = landmarks.remove_landmarks(state, kill)
    for f in range(1, 1 + warm_frames):
        obs, vis = _project_gt(params, sc, jnp.asarray(f),
                               jax.random.PRNGKey(10 + f))
        m = jnp.logical_and(vis, state.lm_active)
        xn, Pn, _, _ = fused_step.fused_update_health_predict(
            params, state.x, state.P, obs, m)
        state = state._replace(x=xn, P=Pn)
    obs, vis = _project_gt(params, sc, jnp.asarray(1 + warm_frames),
                           jax.random.PRNGKey(1))
    obs_mask = jnp.logical_and(vis, state.lm_active)
    return params, state, obs, obs_mask, sc


def _candidates(m, key, image_size=(320, 240), dtype=jnp.float64):
    W, H = image_size
    u = jax.random.uniform(key, (m, 2), dtype)
    return u * jnp.asarray([W - 40.0, H - 40.0], dtype) + 20.0


def _sequential_recruit(params, state, obs, obs_mask, new_pix, new_valid,
                        drop=None):
    """The modular composition the fused op must reproduce exactly."""
    x, P, resid = update.stacked_update(params, state.x, state.P, obs, obs_mask)
    P = health.ensure_nonneg_variance(P)
    st = state._replace(x=x, P=P)
    if drop is not None:
        st = landmarks.remove_landmarks(st, drop)
    if params.sal_pnt_repres != 1:
        xs, _ = health.substitute_negative_inv_rho(
            st.x, params.sal_pnt_negative_inv_rho_substitute, st.capacity)
        st = st._replace(x=xs)
    xq, Pq = health.normalize_quat_and_covar(st.x, st.P)
    st = st._replace(x=xq, P=Pq)
    st, slots = landmarks.add_landmarks(params, st, new_pix, new_valid)
    st = predict.predict(params, st)
    return st, slots, resid


def _fused_recruit(params, state, obs, obs_mask, new_pix, new_valid,
                   drop=None):
    active_after = state.lm_active
    if drop is not None:
        active_after = jnp.logical_and(active_after, jnp.logical_not(drop))
    xn, Pn, resid, _, slots = fused_step.fused_update_health_recruit_predict(
        params, state.x, state.P, obs, obs_mask, new_pix, new_valid,
        jnp.logical_not(active_after), deactivate_mask=drop)
    return xn, Pn, resid, slots


def test_recruit_fused_matches_sequential():
    params, state, obs, obs_mask, _ = _setup()
    new_pix = _candidates(3, jax.random.PRNGKey(7))
    new_valid = jnp.asarray([True, False, True])

    st_s, slots_s, resid_s = _sequential_recruit(
        params, state, obs, obs_mask, new_pix, new_valid)
    xf, Pf, resid_f, slots_f = _fused_recruit(
        params, state, obs, obs_mask, new_pix, new_valid)

    np.testing.assert_array_equal(np.asarray(slots_f), np.asarray(slots_s))
    np.testing.assert_allclose(np.asarray(resid_f), np.asarray(resid_s),
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(xf), np.asarray(st_s.x), atol=1e-11)
    np.testing.assert_allclose(np.asarray(Pf), np.asarray(st_s.P),
                               rtol=1e-9, atol=1e-12)


def test_recruit_fused_with_deletion():
    """Drop two live slots the same frame recruits claim them: the fused keep
    congruence must zero the dropped blocks before the recruits' covariance
    rows land in them."""
    params, state, obs, obs_mask, _ = _setup(n_free=1)
    cap = state.capacity
    drop = jnp.zeros((cap,), bool).at[2].set(True).at[5].set(True)
    obs_mask = jnp.logical_and(obs_mask, jnp.logical_not(drop))
    new_pix = _candidates(3, jax.random.PRNGKey(8))
    new_valid = jnp.asarray([True, True, True])

    st_s, slots_s, _ = _sequential_recruit(
        params, state, obs, obs_mask, new_pix, new_valid, drop=drop)
    xf, Pf, _, slots_f = _fused_recruit(
        params, state, obs, obs_mask, new_pix, new_valid, drop=drop)

    np.testing.assert_array_equal(np.asarray(slots_f), np.asarray(slots_s))
    assert set(int(s) for s in np.asarray(slots_f)) == {2, 5, cap - 1}
    np.testing.assert_allclose(np.asarray(xf), np.asarray(st_s.x), atol=1e-11)
    np.testing.assert_allclose(np.asarray(Pf), np.asarray(st_s.P),
                               rtol=1e-9, atol=1e-12)


def test_recruit_budget_overflow():
    """More valid candidates than free slots: only n_free are added, in
    candidate order, exactly as add_landmarks' has_free guard produces."""
    params, state, obs, obs_mask, _ = _setup(n_free=2)
    new_pix = _candidates(5, jax.random.PRNGKey(9))
    new_valid = jnp.asarray([True, True, True, True, True])

    st_s, slots_s, _ = _sequential_recruit(
        params, state, obs, obs_mask, new_pix, new_valid)
    xf, Pf, _, slots_f = _fused_recruit(
        params, state, obs, obs_mask, new_pix, new_valid)

    np.testing.assert_array_equal(np.asarray(slots_f), np.asarray(slots_s))
    assert int(np.sum(np.asarray(slots_f) >= 0)) == 2
    np.testing.assert_allclose(np.asarray(xf), np.asarray(st_s.x), atol=1e-11)
    np.testing.assert_allclose(np.asarray(Pf), np.asarray(st_s.P),
                               rtol=1e-9, atol=1e-12)


def test_recruit_none_valid_equals_base_fused():
    params, state, obs, obs_mask, _ = _setup()
    new_pix = _candidates(3, jax.random.PRNGKey(10))
    new_valid = jnp.zeros((3,), bool)

    xb, Pb, rb, _ = fused_step.fused_update_health_predict(
        params, state.x, state.P, obs, obs_mask)
    xf, Pf, rf, slots = _fused_recruit(
        params, state, obs, obs_mask, new_pix, new_valid)
    assert int(np.sum(np.asarray(slots) >= 0)) == 0
    np.testing.assert_allclose(np.asarray(xf), np.asarray(xb), atol=1e-13)
    np.testing.assert_allclose(np.asarray(Pf), np.asarray(Pb),
                               rtol=1e-12, atol=1e-14)


def test_recruit_chained_frames():
    """Several frames each recruiting against evolving covariance: end-state
    parity of the fused chain vs the sequential chain (drift would compound
    here if any single-frame term were wrong)."""
    params, state, obs_mask_unused, _, sc = _setup(capacity=10, n_free=6)
    st_f = state
    st_s = state
    for f in range(3, 9):
        obs, vis = _project_gt(params, sc, jnp.asarray(f),
                               jax.random.PRNGKey(100 + f))
        new_pix = _candidates(2, jax.random.PRNGKey(200 + f))
        new_valid = jnp.asarray([True, f % 2 == 0])

        m_s = jnp.logical_and(vis, st_s.lm_active)
        st_s, slots_s, _ = _sequential_recruit(
            params, st_s, obs, m_s, new_pix, new_valid)

        m_f = jnp.logical_and(vis, st_f.lm_active)
        xf, Pf, _, slots_f = _fused_recruit(
            params, st_f, obs, m_f, new_pix, new_valid)
        # mirror the mask bookkeeping the device runner does
        cap = st_f.capacity
        slot_safe = jnp.where(slots_f >= 0, slots_f, cap)
        active = st_f.lm_active.at[slot_safe].set(True, mode="drop")
        unobs = st_f.lm_unobserved.at[slot_safe].set(0, mode="drop")
        gen = st_f.lm_generation.at[slot_safe].add(1, mode="drop")
        st_f = st_f._replace(x=xf, P=Pf, lm_active=active,
                             lm_unobserved=unobs, lm_generation=gen)
        np.testing.assert_array_equal(np.asarray(slots_f),
                                      np.asarray(slots_s))

    np.testing.assert_array_equal(np.asarray(st_f.lm_active),
                                  np.asarray(st_s.lm_active))
    np.testing.assert_allclose(np.asarray(st_f.x), np.asarray(st_s.x),
                               atol=1e-10)
    np.testing.assert_allclose(np.asarray(st_f.P), np.asarray(st_s.P),
                               rtol=1e-8, atol=1e-11)


def test_recruit_symmetry_exact():
    """P+ with recruits scattered in must stay exactly symmetric (the
    long-chain f32 invariant every fused step maintains)."""
    params, state, obs, obs_mask, _ = _setup(dtype=jnp.float32)
    new_pix = _candidates(3, jax.random.PRNGKey(11), dtype=jnp.float32)
    new_valid = jnp.asarray([True, True, False])
    _, Pf, _, slots = _fused_recruit(
        params, state, obs, obs_mask, new_pix, new_valid)
    Pf = np.asarray(Pf)
    np.testing.assert_array_equal(Pf, Pf.T)
    assert int(np.sum(np.asarray(slots) >= 0)) == 2


def test_recruit_xyz_repres():
    params, state, obs, obs_mask, _ = _setup(repres=1)
    new_pix = _candidates(2, jax.random.PRNGKey(12))
    new_valid = jnp.asarray([True, True])
    st_s, slots_s, _ = _sequential_recruit(
        params, state, obs, obs_mask, new_pix, new_valid)
    xf, Pf, _, slots_f = _fused_recruit(
        params, state, obs, obs_mask, new_pix, new_valid)
    np.testing.assert_array_equal(np.asarray(slots_f), np.asarray(slots_s))
    np.testing.assert_allclose(np.asarray(xf), np.asarray(st_s.x), atol=1e-11)
    np.testing.assert_allclose(np.asarray(Pf), np.asarray(st_s.P),
                               rtol=1e-9, atol=1e-12)


def test_local_tracked_inv_depth_follows_neighbourhood():
    """Two depth clusters on opposite image sides: each candidate's local
    prior must match ITS side's median inverse depth, not the global one;
    with nothing usable nearby the prior falls back to the configured one."""
    params, state, _, _, _ = _setup(capacity=12, n_free=0)
    cap = state.capacity
    x = state.x
    # overwrite rho: slots 0-5 shallow (rho=2.0), slots 6-11 deep (rho=0.2)
    lm = x[13:].reshape(cap, 6)
    lm = lm.at[:6, 5].set(2.0).at[6:, 5].set(0.2)
    x = x.at[13:].set(lm.reshape(-1))
    slot_pix = jnp.concatenate([
        jnp.stack([jnp.full((6,), 40.0), jnp.linspace(40, 200, 6)], axis=1),
        jnp.stack([jnp.full((6,), 280.0), jnp.linspace(40, 200, 6)], axis=1),
    ]).astype(x.dtype)
    active = jnp.ones((cap,), bool)
    cand = jnp.asarray([[45.0, 120.0], [275.0, 120.0]], x.dtype)
    rho0 = fused_step.local_tracked_inv_depth(
        params, x, active, cap, cand, slot_pix, k_nearest=4)
    np.testing.assert_allclose(np.asarray(rho0), [2.0, 0.2], rtol=1e-12)

    # clipping: local median far above the prior clips to 20x prior (0.5)
    lm2 = lm.at[:, 5].set(100.0)
    x2 = x.at[13:].set(lm2.reshape(-1))
    rho_hi = fused_step.local_tracked_inv_depth(
        params, x2, active, cap, cand, slot_pix, k_nearest=4)
    np.testing.assert_allclose(np.asarray(rho_hi), [10.0, 10.0], rtol=1e-12)

    # nothing active -> per-candidate fallback to the configured prior
    rho_fb = fused_step.local_tracked_inv_depth(
        params, x, jnp.zeros((cap,), bool), cap, cand, slot_pix)
    np.testing.assert_allclose(np.asarray(rho_fb), [0.5, 0.5], rtol=1e-12)


def test_recruit_rho0_vector_matches_scalar():
    """A constant per-candidate rho0 vector must reproduce the scalar-rho0
    fused recruit bitwise; a heterogeneous vector must place each recruit at
    ITS OWN inverse depth."""
    params, state, obs, obs_mask, _ = _setup()
    new_pix = _candidates(3, jax.random.PRNGKey(13))
    new_valid = jnp.asarray([True, True, True])
    free = jnp.logical_not(state.lm_active)

    rho_s = jnp.asarray(0.7, state.x.dtype)
    xs, Ps, _, _, slots_s = fused_step.fused_update_health_recruit_predict(
        params, state.x, state.P, obs, obs_mask, new_pix, new_valid, free,
        rho0=rho_s)
    xv, Pv, _, _, slots_v = fused_step.fused_update_health_recruit_predict(
        params, state.x, state.P, obs, obs_mask, new_pix, new_valid, free,
        rho0=jnp.full((3,), 0.7, state.x.dtype))
    np.testing.assert_array_equal(np.asarray(slots_s), np.asarray(slots_v))
    np.testing.assert_array_equal(np.asarray(xs), np.asarray(xv))
    np.testing.assert_array_equal(np.asarray(Ps), np.asarray(Pv))

    rho_het = jnp.asarray([0.3, 0.7, 1.4], state.x.dtype)
    xh, _, _, _, slots_h = fused_step.fused_update_health_recruit_predict(
        params, state.x, state.P, obs, obs_mask, new_pix, new_valid, free,
        rho0=rho_het)
    for m, s in enumerate(np.asarray(slots_h)):
        assert s >= 0
        got = float(xh[13 + 6 * int(s) + 5])
        np.testing.assert_allclose(got, float(rho_het[m]), rtol=1e-12)


def test_recruit_loop_local_depth_runs():
    """The imageseq runner's recruit_depth='local' lane compiles, churns and
    tracks (CPU, f64) — the on-chip accuracy decision lives in
    analysis/measure_churn_accuracy.py variants k/l."""
    (st, tm, (err, n, pos, nrec, nact)), gt_pos = _run_local_churn()
    assert bool(jnp.all(jnp.isfinite(err)))
    assert int(jnp.sum(nrec)) > 0
    ate = float(aligned_rmse(pos, gt_pos))
    assert np.isfinite(ate)


def _run_local_churn():
    from surikatoko_tpu.world.device_runner import (
        build_imageseq_scenario, init_imageseq, make_imageseq_scan_runner)
    dtype = jnp.float64
    sc = build_imageseq_scenario(capacity=24, n_points=24, dtype=dtype,
                                 image_size=(320, 240), bg_cell=32,
                                 max_deviation=1.0, world="grid")
    cam = camera.make_intrinsics((320, 240), (160.0, 120.0), 1.95,
                                 (0.01, 0.01), dtype=dtype)
    params = make_params(cam, None, dt=1.0,
                         process_noise_lin_veloc_std=0.075,
                         process_noise_ang_veloc_std=0.01,
                         sal_pnt_init_inv_dist=0.5,
                         sal_pnt_init_inv_dist_std=0.5,
                         max_undetected_frames=8, dtype=dtype)
    st = init_state(24, dtype=dtype)
    st, templates = jax.jit(lambda s: init_imageseq(
        params, sc, s, 15, max_bootstrap=20))(st)
    run = make_imageseq_scan_runner(params, templ_width=15, search_radius=9,
                                    recruit=True, recruit_max=4,
                                    recruit_depth="local")
    fr = jnp.arange(1, 41)
    out = run(st, templates, sc, fr)
    gt_pos = -jnp.einsum("fji,fj->fi", sc.gt_cfw_R[fr], sc.gt_cfw_t[fr])
    return out, gt_pos
