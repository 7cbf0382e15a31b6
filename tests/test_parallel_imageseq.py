"""Sharded imageseq closed loop (distributed render + local NCC + sharded
fused EKF, parallel/sharded_imageseq.py) vs the single-device scan runner —
the flagship perception pipeline's multi-chip twin must match it exactly
(VERDICT r3 item 5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from surikatoko_tpu.geom import camera
from surikatoko_tpu.models.monoslam import make_params, init_state
from surikatoko_tpu.parallel import landmark_mesh
from surikatoko_tpu.parallel.sharded_imageseq import (
    make_sharded_imageseq_runner)
from surikatoko_tpu.world import device_runner as dr


def _setup(capacity=16, dtype=jnp.float64):
    sc = dr.build_imageseq_scenario(capacity=capacity, dtype=dtype)
    cam = camera.make_intrinsics((320, 240), (160.0, 120.0), 1.95,
                                 (0.01, 0.01), dtype=dtype)
    params = make_params(cam, None, dt=1.0,
                         process_noise_lin_veloc_std=0.075,
                         process_noise_ang_veloc_std=0.01,
                         max_undetected_frames=4, dtype=dtype)
    st = init_state(capacity, dtype=dtype)
    st, templates = dr.init_imageseq(params, sc, st, 15)
    return params, sc, st, templates


@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_imageseq_matches_single(n_dev):
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    params, sc, st, templates = _setup()
    frames = jnp.arange(1, 13)

    run1 = dr.make_imageseq_scan_runner(params, templ_width=15)
    st1, (err1, n1, pos1) = run1(st, templates, sc, frames)

    runp = make_sharded_imageseq_runner(params, st.capacity,
                                        landmark_mesh(n_dev),
                                        templ_width=15)
    x2, P2, active2, unobs2, (err2, n2, pos2) = runp(
        st.x, st.P, templates, st.lm_active, st.lm_unobserved, sc, frames)

    # discrete perception decisions must agree exactly
    np.testing.assert_array_equal(np.asarray(n2), np.asarray(n1))
    np.testing.assert_array_equal(np.asarray(active2),
                                  np.asarray(st1.lm_active))
    np.testing.assert_array_equal(np.asarray(unobs2),
                                  np.asarray(st1.lm_unobserved))
    # continuous state matches at the sharded-fused tolerance
    np.testing.assert_allclose(np.asarray(err2), np.asarray(err1),
                               atol=1e-9)
    np.testing.assert_allclose(np.asarray(pos2), np.asarray(pos1),
                               atol=1e-9)
    np.testing.assert_allclose(np.asarray(x2), np.asarray(st1.x), atol=1e-9)
    np.testing.assert_allclose(np.asarray(P2), np.asarray(st1.P),
                               rtol=1e-7, atol=1e-10)


def _setup_churn(capacity=16, n_points=24, dtype=jnp.float64,
                 max_bootstrap=10, image_size=(320, 240)):
    """Churn world: more splats than slots, wide lateral sweep, free
    capacity at bootstrap — the regime where the recruit/delete lifecycle
    actually turns slots over."""
    sc = dr.build_imageseq_scenario(capacity=capacity, dtype=dtype,
                                    n_points=n_points, bg_cell=48,
                                    max_deviation=0.8, world="wide",
                                    image_size=image_size)
    W, H = image_size
    pitch = 0.01 * 320.0 / W          # same FOV at any resolution (bench
    cam = camera.make_intrinsics(      # K=768 uses 0.005 at 640x480)
        image_size, (W / 2.0, H / 2.0), 1.95, (pitch, pitch), dtype=dtype)
    params = make_params(cam, None, dt=1.0,
                         process_noise_lin_veloc_std=0.075,
                         process_noise_ang_veloc_std=0.01,
                         sal_pnt_init_inv_dist=0.5,
                         sal_pnt_init_inv_dist_std=0.5,
                         max_undetected_frames=4, dtype=dtype)
    st = init_state(capacity, dtype=dtype)
    st, templates = dr.init_imageseq(params, sc, st, 15,
                                     max_bootstrap=max_bootstrap)
    return params, sc, st, templates


@pytest.mark.parametrize("n_dev,depth", [(2, "prior"), (8, "prior"),
                                         (8, "local")])
def test_sharded_imageseq_recruit_matches_single(n_dev, depth):
    """The CHURNED sharded loop (per-frame recruitment through the
    distributed fused recruit congruence + delete-unobserved) must match
    the single-device recruit runner exactly on every discrete decision
    (slots claimed, generations, templates) and to fused-parity tolerance
    on the state (VERDICT r4 item 1 — the last capability asymmetry
    between the benchmarked flagship and its multi-chip twin). The "local"
    case additionally pins the per-candidate neighbourhood depth prior's
    replicated computation (all_gathered positions feed
    local_tracked_inv_depth identically on every device)."""
    params, sc, st, templates = _setup_churn()
    # kill one tracked slot's template: forces a delete (frame ~5) and a
    # later re-recruit into the freed slot — generation goes to 2 and the
    # run provably exercises the full lifecycle, not just first-fill
    templates = templates.at[3].set(0.0)
    frames = jnp.arange(1, 13)
    kw = dict(templ_width=15, recruit=True,
              recruit_max=4, detector_corners=24, recruit_depth=depth)

    run1 = dr.make_imageseq_scan_runner(params, **kw)
    st1, tm1, (err1, n1, pos1, nrec1, nact1) = run1(st, templates, sc,
                                                    frames)
    assert int(jnp.sum(nrec1)) >= 3          # recruitment actually fired
    assert not bool(st1.lm_active[3]) or int(st1.lm_generation[3]) >= 2

    runp = make_sharded_imageseq_runner(params, st.capacity,
                                        landmark_mesh(n_dev), **kw)
    x2, P2, tm2, act2, unobs2, gen2, (err2, n2, pos2, nrec2, nact2) = runp(
        st.x, st.P, templates, st.lm_active, st.lm_unobserved,
        st.lm_generation, sc, frames)

    # discrete lifecycle decisions must agree exactly
    np.testing.assert_array_equal(np.asarray(nrec2), np.asarray(nrec1))
    np.testing.assert_array_equal(np.asarray(nact2), np.asarray(nact1))
    np.testing.assert_array_equal(np.asarray(n2), np.asarray(n1))
    np.testing.assert_array_equal(np.asarray(act2),
                                  np.asarray(st1.lm_active))
    np.testing.assert_array_equal(np.asarray(unobs2),
                                  np.asarray(st1.lm_unobserved))
    np.testing.assert_array_equal(np.asarray(gen2),
                                  np.asarray(st1.lm_generation))
    # templates are cut from the psum-assembled frame: equal up to the
    # render reassociation roundoff (image scale ~255)
    np.testing.assert_allclose(np.asarray(tm2), np.asarray(tm1),
                               atol=1e-12)
    # continuous state at the sharded-fused tolerance
    np.testing.assert_allclose(np.asarray(err2), np.asarray(err1),
                               atol=1e-9)
    np.testing.assert_allclose(np.asarray(pos2), np.asarray(pos1),
                               atol=1e-9)
    np.testing.assert_allclose(np.asarray(x2), np.asarray(st1.x), atol=1e-9)
    np.testing.assert_allclose(np.asarray(P2), np.asarray(st1.P),
                               rtol=1e-7, atol=1e-10)


@pytest.mark.slow
def test_sharded_imageseq_recruit_parity_at_k256():
    """Same churned parity at K=256 on the 8-device virtual mesh — an order
    of magnitude closer to the K=768 benchmark regime (VERDICT r4 item 7:
    K=16 does not exercise the L*6-stripe shapes or per-slot A_own slicing
    at the sizes that matter)."""
    params, sc, st, templates = _setup_churn(capacity=256, n_points=320,
                                             max_bootstrap=224,
                                             image_size=(640, 480))
    frames = jnp.arange(1, 7)
    kw = dict(templ_width=15, recruit=True,
              recruit_max=8, detector_corners=48)

    run1 = dr.make_imageseq_scan_runner(params, **kw)
    st1, tm1, (err1, n1, pos1, nrec1, nact1) = run1(st, templates, sc,
                                                    frames)
    assert int(jnp.sum(nrec1)) >= 3

    runp = make_sharded_imageseq_runner(params, st.capacity,
                                        landmark_mesh(8), **kw)
    x2, P2, tm2, act2, unobs2, gen2, (err2, n2, pos2, nrec2, nact2) = runp(
        st.x, st.P, templates, st.lm_active, st.lm_unobserved,
        st.lm_generation, sc, frames)

    np.testing.assert_array_equal(np.asarray(nrec2), np.asarray(nrec1))
    np.testing.assert_array_equal(np.asarray(n2), np.asarray(n1))
    np.testing.assert_array_equal(np.asarray(act2),
                                  np.asarray(st1.lm_active))
    np.testing.assert_array_equal(np.asarray(gen2),
                                  np.asarray(st1.lm_generation))
    np.testing.assert_allclose(np.asarray(tm2), np.asarray(tm1),
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(pos2), np.asarray(pos1),
                               atol=1e-8)
    np.testing.assert_allclose(np.asarray(x2), np.asarray(st1.x), atol=1e-8)
    np.testing.assert_allclose(np.asarray(P2), np.asarray(st1.P),
                               rtol=1e-6, atol=1e-9)


def test_sharded_imageseq_delete_policy_fires():
    """The run must exercise the delete-unobserved fold (otherwise the
    parity above proves less than it claims): force a splat to vanish by
    deactivating its template, and check the slot is dropped identically
    in both runners."""
    params, sc, st, templates = _setup()
    # kill slot 3's template so NCC never matches it again
    templates = templates.at[3].set(0.0)
    frames = jnp.arange(1, 9)

    run1 = dr.make_imageseq_scan_runner(params, templ_width=15)
    st1, _ = run1(st, templates, sc, frames)
    assert not bool(st1.lm_active[3])      # dropped after 4 unmatched frames

    runp = make_sharded_imageseq_runner(params, st.capacity,
                                        landmark_mesh(8),
                                        templ_width=15)
    x2, P2, active2, _, _ = runp(
        st.x, st.P, templates, st.lm_active, st.lm_unobserved, sc, frames)
    np.testing.assert_array_equal(np.asarray(active2),
                                  np.asarray(st1.lm_active))
    # the dropped slot's covariance rows are zeroed on every shard
    off = 13 + 3 * 6
    assert float(jnp.max(jnp.abs(P2[off:off + 6, :]))) == 0.0
    np.testing.assert_allclose(np.asarray(P2), np.asarray(st1.P),
                               rtol=1e-7, atol=1e-10)
