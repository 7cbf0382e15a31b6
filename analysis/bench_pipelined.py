"""Measure the host-driven match/update pipeline overlap on the card.

Sequential ``run_image_sequence`` vs ``run_image_sequence_pipelined`` on the
same rendered sequence (identical results — pinned by
tests/test_imageseq.py::test_pipelined_loop_matches_sequential); only the
host schedule differs: the pipelined loop enqueues frame f+1's image upload
and Shi-Tomasi pass before blocking on frame f's EKF step, so host perception
work hides under device compute.

Prints one JSON line with both wall-clock timings and the speedup.
"""

from __future__ import annotations

import json
import sys


def main() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    jax.config.update("jax_default_matmul_precision", "highest")

    root = __file__.rsplit("/", 2)[0]
    sys.path.insert(0, root)
    sys.path.insert(0, root + "/tests")
    from test_imageseq import render_world

    from surikatoko_tpu.geom import camera
    from surikatoko_tpu.geom.se3 import SE3
    from surikatoko_tpu.models.monoslam import MonoSlamFilter, make_params
    from surikatoko_tpu.utils.profiling import median_wall_time
    from surikatoko_tpu.vision.matcher import ImageTemplCornersMatcher
    from surikatoko_tpu.world import scene_gen
    from surikatoko_tpu.world.runner import (
        gt_poses_in_tracker_frame, run_image_sequence,
        run_image_sequence_pipelined)

    wb = scene_gen.WorldBounds(0.0, 0.6, 0.0, 0.6, 0.0, 0.6001)
    points_world = np.asarray(
        scene_gen.generate_grid_points(wb, (0.5, 0.5, 0.5), 0.2))
    center = np.array([0.3, 0.3, 0.3])
    gt_cfw_world = scene_gen.oscillate_right_and_left(
        center + np.array([0, -1.5, 0]), center, (0, 0, 1),
        max_deviation=0.3, periods_count=1, shots_per_period=120,
        const_view_dir=True)
    gt_cfw = gt_poses_in_tracker_frame(gt_cfw_world)
    tfw = SE3(gt_cfw_world.R[0], gt_cfw_world.t[0])
    pts = np.asarray(points_world @ np.asarray(tfw.R).T + np.asarray(tfw.t))

    cam = camera.make_intrinsics((320, 240), (160.0, 120.0), 1.95,
                                 (0.01, 0.01))
    params = make_params(cam, None, dt=1.0,
                         process_noise_lin_veloc_std=0.02,
                         process_noise_ang_veloc_std=0.005,
                         measurm_noise_std_pix=1.0,
                         sal_pnt_init_inv_dist=0.6,
                         sal_pnt_init_inv_dist_std=0.6, dtype=jnp.float32)
    n_frames = 60
    images = [render_world(pts, gt_cfw, cam, f) for f in range(n_frames)]

    imgs = [np.asarray(im, np.float32) for im in images]

    def run(runner_fn):
        tracker = MonoSlamFilter(params, capacity=48, update_impl=1)
        matcher = ImageTemplCornersMatcher(
            tracker, templ_width=15, search_radius=10, min_corr_coeff=0.6,
            detector_max_corners=48, min_distance_new_to_tracked=15.0)
        return runner_fn(tracker, matcher, imgs)

    # warm the compile caches (both loops hit the same jitted programs)
    jax.block_until_ready(run(run_image_sequence))

    t_seq = median_wall_time(lambda: run(run_image_sequence))
    t_pipe = median_wall_time(lambda: run(run_image_sequence_pipelined))

    print(json.dumps({
        "metric": "imageseq_hostdriven_pipeline_speedup",
        "value": round(t_seq / t_pipe, 3),
        "unit": "x",
        "frames": n_frames,
        "fps_sequential": round(n_frames / t_seq, 2),
        "fps_pipelined": round(n_frames / t_pipe, 2),
    }))


if __name__ == "__main__":
    main()
