"""On-device closed-loop scan runner: tracks scenario03 like the host loop."""

import jax
import jax.numpy as jnp
import numpy as np

from surikatoko_tpu.geom import camera
from surikatoko_tpu.geom.se3 import SE3
from surikatoko_tpu.models.monoslam import MonoSlamFilter, make_params, init_state
from surikatoko_tpu.world import scene_gen
from surikatoko_tpu.world.device_runner import (
    DeviceScenario, init_with_gt_landmarks, make_scan_runner)
from surikatoko_tpu.world.runner import gt_poses_in_tracker_frame


def build_device_scenario(capacity=32, dtype=jnp.float64):
    from surikatoko_tpu.world.device_runner import build_oscillating_scenario
    return build_oscillating_scenario(capacity=capacity, dtype=dtype)


def test_scan_runner_tracks():
    dtype = jnp.float64
    sc = build_device_scenario(capacity=32, dtype=dtype)
    cam = camera.make_intrinsics((320, 240), (160.0, 120.0), 1.95, (0.01, 0.01),
                                 dtype=dtype)
    params = make_params(cam, None, dt=1.0,
                         process_noise_lin_veloc_std=0.075,
                         process_noise_ang_veloc_std=0.01, dtype=dtype)
    state = init_state(32, dtype=dtype)
    key = jax.random.PRNGKey(0)
    state = init_with_gt_landmarks(params, sc, state, key)
    assert int(jnp.sum(state.lm_active)) >= 16

    run = make_scan_runner(params, update_impl=1)
    frames = jnp.arange(1, 61)
    state, errs, _, cam_pos = run(state, sc, frames, jax.random.PRNGKey(1))
    assert bool(jnp.all(jnp.isfinite(errs)))
    # residuals at the noise level, not diverging
    assert float(jnp.mean(errs[10:])) < 3.0
    # camera position tracks GT within scene scale
    gt_pos = np.stack([np.asarray(SE3(sc.gt_cfw_R[f], sc.gt_cfw_t[f]).inv().t)
                       for f in range(1, 61)])
    err = np.linalg.norm(np.asarray(cam_pos) - gt_pos, axis=1)
    assert err.max() < 0.5, err.max()


def test_scan_runner_all_update_impls():
    """All four reference update impls (davison-mono-slam.cpp:900-915) are
    dispatchable inside the device scan loop, and each one tracks."""
    dtype = jnp.float64
    sc = build_device_scenario(capacity=16, dtype=dtype)
    cam = camera.make_intrinsics((320, 240), (160.0, 120.0), 1.95, (0.01, 0.01),
                                 dtype=dtype)
    params = make_params(cam, None, dt=1.0,
                         process_noise_lin_veloc_std=0.075,
                         process_noise_ang_veloc_std=0.01, dtype=dtype)
    gt_pos = np.stack([np.asarray(SE3(sc.gt_cfw_R[f], sc.gt_cfw_t[f]).inv().t)
                       for f in range(1, 31)])
    for impl in (2, 3, 4):
        state = init_state(16, dtype=dtype)
        state = init_with_gt_landmarks(params, sc, state,
                                       jax.random.PRNGKey(0))
        run = make_scan_runner(params, update_impl=impl)
        state, errs, _, cam_pos = run(state, sc, jnp.arange(1, 31),
                                   jax.random.PRNGKey(1))
        assert bool(jnp.all(jnp.isfinite(errs))), impl
        err = np.linalg.norm(np.asarray(cam_pos) - gt_pos, axis=1)
        assert err.max() < 0.5, (impl, err.max())


def test_imageseq_runner_impl_2_3():
    """The imageseq (rendered-frame NCC) loop also dispatches the sequential
    impls 2/3 — VERDICT r3 item 8."""
    from surikatoko_tpu.world import device_runner as dr

    dtype = jnp.float64
    capacity = 16
    sc = dr.build_imageseq_scenario(capacity=capacity, dtype=dtype)
    cam = camera.make_intrinsics((320, 240), (160.0, 120.0), 1.95,
                                 (0.01, 0.01), dtype=dtype)
    params = make_params(cam, None, dt=1.0,
                         process_noise_lin_veloc_std=0.075,
                         process_noise_ang_veloc_std=0.01, dtype=dtype)
    for impl in (2, 3):
        st = init_state(capacity, dtype=dtype)
        st, templates = dr.init_imageseq(params, sc, st, 15)
        run = dr.make_imageseq_scan_runner(params, update_impl=impl)
        st2, (errs, nmatch, _) = run(st, templates, sc, jnp.arange(1, 21))
        assert bool(jnp.all(jnp.isfinite(errs))), impl
        # the sequential impls track a solid majority early and keep at least
        # half the landmarks matched throughout this short run
        nm = np.asarray(nmatch)
        assert nm[:10].min() > capacity * 3 // 4, (impl, nm)
        assert nm.min() >= capacity // 2, (impl, nm)
        assert float(jnp.mean(errs)) < 3.0, impl


def test_long_horizon_f32_stability():
    """f32 long-horizon run (the benchmark dtype): residuals stay at noise
    level, covariance healthy after 300+ frames (CPU executes f32 exactly;
    on a GPU this requires matmul precision 'highest' — bench.py sets it)."""
    dtype = jnp.float32
    sc = build_device_scenario(capacity=32, dtype=dtype)
    cam = camera.make_intrinsics((320, 240), (160.0, 120.0), 1.95, (0.01, 0.01),
                                 dtype=dtype)
    params = make_params(cam, None, dt=1.0,
                         process_noise_lin_veloc_std=0.075,
                         process_noise_ang_veloc_std=0.01, dtype=dtype)
    st = init_state(32, dtype=dtype)
    st = init_with_gt_landmarks(params, sc, st, jax.random.PRNGKey(0))
    run = make_scan_runner(params, update_impl=1)
    errs_all = []
    for rep in range(2):
        frames = jnp.arange(1, 160)
        st, errs, _, _ = run(st, sc, frames, jax.random.PRNGKey(rep))
        errs_all.append(np.asarray(errs))
    errs_all = np.concatenate(errs_all)
    assert np.isfinite(errs_all).all()
    assert errs_all[-80:].mean() < 2 * max(errs_all[:80].mean(), 0.5)
    assert abs(float(jnp.linalg.norm(st.x[3:7])) - 1) < 1e-3
    assert float(jnp.min(jnp.diag(st.P))) > -1e-5


def test_imageseq_device_loop_tracks():
    """Fully on-device real-perception loop: separable-splat renderer +
    ellipse-gated NCC search + EKF update inside one lax.scan."""
    from surikatoko_tpu.world import device_runner as dr

    dtype = jnp.float32
    capacity = 32
    sc = dr.build_imageseq_scenario(capacity=capacity, dtype=dtype)
    cam = camera.make_intrinsics((320, 240), (160.0, 120.0), 1.95,
                                 (0.01, 0.01), dtype=dtype)
    params = make_params(cam, None, dt=1.0,
                         process_noise_lin_veloc_std=0.075,
                         process_noise_ang_veloc_std=0.01, dtype=dtype)
    st = init_state(capacity, dtype=dtype)
    st, templates = dr.init_imageseq(params, sc, st, 15)
    assert int(jnp.sum(st.lm_active)) == capacity

    run = dr.make_imageseq_scan_runner(params)
    st2, (errs, nmatch, cam_pos) = run(st, templates, sc, jnp.arange(1, 61))
    errs = np.asarray(errs)
    nmatch = np.asarray(nmatch)
    assert np.isfinite(errs).all()
    # perception keeps a solid majority of landmarks matched and the filter
    # keeps residuals near the quantization/noise level
    assert (nmatch[1:] > capacity // 2).all()
    assert errs[nmatch > 0].mean() < 2.5

    # renderer: blobs land where the GT projects (frame 0 sanity)
    img = dr.render_frame(params, sc, jnp.asarray(0))
    assert img.shape == sc.background.shape
    assert float(img.max()) > 100.0  # blobs visibly brighter than background
