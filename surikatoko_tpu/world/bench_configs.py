"""The tracker configurations that bench.py and chip_smoke.py drive.

Each builder returns the filter parameters and the scenario of one
configuration at a given capacity, so the benchmark and the bring-up check
run the same thing:

- :func:`scenario03` — the reference's scenario03 closed loop with the
  GT-projecting matcher (world/device_runner.make_scan_runner);
- :func:`churned_imageseq` — the real-perception loop (render -> NCC ->
  Shi-Tomasi recruitment -> fused EKF with delete-unobserved) over a world
  that holds more splats than the filter has slots, so landmarks turn over
  every frame (world/device_runner.make_imageseq_scan_runner);
- :func:`host_sequence` — the reference's operating mode: 320x240 PGM frames
  through the frame loader, the NCC matcher and the host-driven filter loop
  (world/runner.run_image_sequence_pipelined).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from surikatoko_tpu.geom import camera
from surikatoko_tpu.models.monoslam import init_state, make_params
from surikatoko_tpu.world import device_runner as dr

# make_imageseq_scan_runner settings of the churned loop: recruit up to 12
# corners a frame with the spatially-local inverse-depth prior (median rho of
# the 8 nearest tracked slots), which tracked best of the priors measured
CHURN_RUNNER = dict(templ_width=15, recruit=True, recruit_max=12,
                    detector_corners=64, recruit_depth="local")


def scenario03(capacity: int, dtype=jnp.float32):
    """(params, scenario, bootstrapped state) of the scenario03 tracker."""
    sc = dr.build_oscillating_scenario(capacity=capacity, dtype=dtype)
    cam = camera.make_intrinsics((320, 240), (160.0, 120.0), 1.95,
                                 (0.01, 0.01), dtype=dtype)
    params = make_params(cam, None, dt=1.0,
                         process_noise_lin_veloc_std=0.075,
                         process_noise_ang_veloc_std=0.01, dtype=dtype)
    state = jax.jit(lambda st, key: dr.init_with_gt_landmarks(
        params, sc, st, key))(init_state(capacity, dtype=dtype),
                              jax.random.PRNGKey(0))
    return params, sc, state


def churned_params(dtype=jnp.float32, mitigations: bool = True):
    """Filter parameters of the churned 640x480 loop. ``mitigations`` turns
    on the f32 conditioning policy: delete landmarks unmatched for 30
    frames, and inflate the live covariance diagonal by 1e-6 a frame."""
    cam = camera.make_intrinsics((640, 480), (320.0, 240.0), 1.95,
                                 (0.005, 0.005), dtype=dtype)
    cond = (dict(max_undetected_frames=30, covar_diag_inflation=1e-6)
            if mitigations else {})
    return make_params(cam, None, dt=1.0,
                       process_noise_lin_veloc_std=0.075,
                       process_noise_ang_veloc_std=0.01,
                       sal_pnt_init_inv_dist=0.5,
                       sal_pnt_init_inv_dist_std=0.5, dtype=dtype, **cond)


def churned_imageseq(capacity: int, n_points: int, dtype=jnp.float32,
                     mitigations: bool = True):
    """(params, scenario, bootstrapped state, templates) of the churned loop.

    The "wide" world scatters ``n_points`` distinct splats over a strip wider
    than the field of view, and the camera's lateral sweep carries them in
    and out of view, so the recruit/delete lifecycle turns slots over."""
    params = churned_params(dtype, mitigations)
    sc = dr.build_imageseq_scenario(capacity=capacity, dtype=dtype,
                                    image_size=(640, 480), n_points=n_points,
                                    bg_cell=48, max_deviation=0.8,
                                    world="wide")
    state, templates = jax.jit(lambda st: dr.init_imageseq(
        params, sc, st, CHURN_RUNNER["templ_width"]))(
        init_state(capacity, dtype=dtype))
    return params, sc, state, templates


class HostSequence(NamedTuple):
    params: object          # MonoSlamParams
    gt_cfw: object          # SE3 [F] camera-from-tracker GT poses
    points: np.ndarray      # [N,3] tracker-frame world points
    cam: object             # CameraIntrinsics of the rendered frames


def host_sequence(dtype=jnp.float32) -> HostSequence:
    """The decoded-frame loop's world: a grid of points watched by a camera
    swinging 0.3 to either side, two periods of 100 frames."""
    from surikatoko_tpu.geom.se3 import SE3
    from surikatoko_tpu.world import scene_gen
    from surikatoko_tpu.world.runner import gt_poses_in_tracker_frame

    wb = scene_gen.WorldBounds(0.0, 0.6, 0.0, 0.6, 0.0, 0.6001)
    pts_world = np.asarray(
        scene_gen.generate_grid_points(wb, (0.5, 0.5, 0.5), 0.2))
    center = np.array([0.3, 0.3, 0.3])
    gt_cfw_world = scene_gen.oscillate_right_and_left(
        center + np.array([0, -1.5, 0]), center, (0, 0, 1),
        max_deviation=0.3, periods_count=2, shots_per_period=100,
        const_view_dir=True)
    gt_cfw = gt_poses_in_tracker_frame(gt_cfw_world)
    tfw = SE3(gt_cfw_world.R[0], gt_cfw_world.t[0])
    pts = np.asarray(pts_world @ np.asarray(tfw.R).T + np.asarray(tfw.t))
    cam = camera.make_intrinsics((320, 240), (160.0, 120.0), 1.95,
                                 (0.01, 0.01))
    params = make_params(cam, None, dt=1.0,
                         process_noise_lin_veloc_std=0.02,
                         process_noise_ang_veloc_std=0.005,
                         measurm_noise_std_pix=1.0,
                         sal_pnt_init_inv_dist=0.6,
                         sal_pnt_init_inv_dist_std=0.6, dtype=dtype)
    return HostSequence(params, gt_cfw, pts, cam)


def render_host_frame(seq: HostSequence, f: int) -> np.ndarray:
    """[240,320] uint8 frame ``f``: a static noise background plus a
    gaussian blob at every visible point (the same blob model as the
    on-device renderer)."""
    H, W = 240, 320
    R = np.asarray(seq.gt_cfw.R[f])
    t = np.asarray(seq.gt_cfw.t[f])
    xc = seq.points @ R.T + t
    vis = xc[:, 2] > 1e-6
    pix = np.asarray(camera.project_camera_point(seq.cam, None,
                                                 jnp.asarray(xc)))
    img = np.random.default_rng(0).uniform(20, 60, size=(H, W))
    ys, xs = np.mgrid[0:H, 0:W]
    for k in np.nonzero(vis)[0]:
        x, y = pix[k]
        if -10 < x < W + 10 and -10 < y < H + 10:
            img += 170.0 * np.exp(
                -((xs - x) ** 2 + (ys - y) ** 2) / (2 * 1.8 ** 2))
    return np.clip(img, 0, 255).astype(np.uint8)


def gt_positions(gt_R: jnp.ndarray, gt_t: jnp.ndarray) -> jnp.ndarray:
    """World-from-camera positions -R^T t of camera-from-world poses."""
    return -jnp.einsum("fji,fj->fi", gt_R, gt_t)
