"""Davison MonoSlam demo driver.

Equivalent of reference demos/davison-mono-slam/
demo-davison-mono-slam.cpp: JSON scene/camera config + CLI flags, virtual
world (GT-projecting matcher with fault injection) or real image directory
(Shi-Tomasi + batched ellipse-gated NCC matcher), per-frame stats, and a
tracker-internals JSON compatible with the reference's MATLAB analysis.

Usage:
  python demos/demo_davison_mono_slam.py --scene_config configs/scenario01.json
      [--update_impl 1..4] [--frames N] [--capacity K]
      [--image_dir DIR] [--out_internals davison_tracker_internals.json]
      [--suppress_observations_from F0 --suppress_observations_to F1]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def build_virtual_scene(cfg):
    import numpy as np
    import jax.numpy as jnp
    from surikatoko_tpu.world import scene_gen

    wb = scene_gen.WorldBounds(
        *(cfg.get_seq("world_x_limits") + cfg.get_seq("world_y_limits")
          + cfg.get_seq("world_z_limits")))
    cell = tuple(cfg.get_seq("world_cell_size", float, [0.5, 0.5, 0.5]))
    z_ascent = cfg.get_value("world_z_ascent", float, 0.0)
    noise_std = cfg.get_value("world_noise_x3D_std", float, 0.0)
    rng = np.random.default_rng(cfg.get_value("world_seed", int, 0))
    points = scene_gen.generate_grid_points(
        wb, cell, z_ascent, noise_std, rng)

    scenario = cfg.get_value("virtual_scenario", str, "RectangularPath")
    eye_off = np.asarray(cfg.get_seq("viewer_eye_offset", float, [3, -2, 7]))
    center_off = np.asarray(cfg.get_seq("viewer_center_offset", float, [0, 0, 0]))
    up = np.asarray(cfg.get_seq("viewer_up", float, [0, 0, 1]))
    if scenario == "RectangularPath":
        cfw = scene_gen.rectangular_path(
            wb, cfg.get_value("viewer_steps_per_side_x", int, 10),
            cfg.get_value("viewer_steps_per_side_y", int, 10),
            eye_off, center_off, up)
    elif scenario == "OscilateRightAndLeft":
        wc = np.asarray([(wb.x_min + wb.x_max) / 2, (wb.y_min + wb.y_max) / 2,
                         (wb.z_min + wb.z_max) / 2])
        cfw = scene_gen.oscillate_right_and_left(
            wc + eye_off, wc + center_off, up,
            cfg.get_value("viewer_max_deviation", float, 0.6),
            cfg.get_value("viewer_periods_count", int, 100),
            cfg.get_value("viewer_shots_per_period", int, 160),
            cfg.get_value("viewer_const_view_dir", bool, True))
    elif scenario == "RotateLeftAndRight":
        wc = np.asarray([(wb.x_min + wb.x_max) / 2, (wb.y_min + wb.y_max) / 2, 0.0])
        cfw = scene_gen.rotate_left_and_right(
            wc + eye_off, up,
            cfg.get_value("viewer_min_ang", float, -0.5),
            cfg.get_value("viewer_max_ang", float, 0.5),
            cfg.get_value("viewer_periods_count", int, 10),
            cfg.get_value("viewer_shots_per_period", int, 40))
    else:
        raise ValueError(f"unknown virtual_scenario {scenario!r}; use one of "
                         "[RectangularPath, OscilateRightAndLeft, RotateLeftAndRight]")
    return points, cfw


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene_config", default=None, help="JSON scene config")
    ap.add_argument("--image_dir", default=None, help="real image sequence dir")
    ap.add_argument("--update_impl", type=int, default=1, choices=(1, 2, 3, 4))
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--capacity", type=int, default=32)
    ap.add_argument("--templ_width", type=int, default=17)
    ap.add_argument("--templ_min_corr_coeff", type=float, default=0.65)
    ap.add_argument("--out_internals", default="davison_tracker_internals.json")
    ap.add_argument("--suppress_observations_from", type=int, default=None)
    ap.add_argument("--suppress_observations_to", type=int, default=None)
    ap.add_argument("--detection_noise_std", type=float, default=0.0)
    ap.add_argument("--match_drop_prob", type=float, default=0.0)
    ap.add_argument("--x64", action="store_true", default=True)
    # the reference's 'u' hotkey (SetEstimStateAndCovarToGroundTruth)
    ap.add_argument("--reset_to_gt_at", type=int, default=None,
                    help="rebuild the FULL state+covariance from GT at this"
                         " frame (recovery)")
    ap.add_argument("--reset_to_gt_impl", type=int, default=2, choices=(1, 2),
                    help="covariance reinit: 1=diagonal stds (ignore"
                         " correlations), 2=as-if-AddSalientPoint"
                         " (monoslam_set_estim_state_covar_to_gt_impl)")
    # reference monoslam_cam_perfect_init_vel / _ang_vel (default false)
    ap.add_argument("--cam_perfect_init_vel", action="store_true",
                    default=True)
    ap.add_argument("--no_cam_perfect_init_vel", dest="cam_perfect_init_vel",
                    action="store_false")
    ap.add_argument("--cam_perfect_init_ang_vel", action="store_true",
                    default=True)
    ap.add_argument("--no_cam_perfect_init_ang_vel",
                    dest="cam_perfect_init_ang_vel", action="store_false")
    ap.add_argument("--max_new_blobs_per_frame", type=int, default=None)
    ap.add_argument("--max_new_blobs_in_first_frame", type=int, default=None)
    # live viewer (reduced-scope parity with the Pangolin UI):
    # hotkeys s/u/i/q inside the window
    ap.add_argument("--live", action="store_true",
                    help="live 3D scene + 2D view while tracking")
    ap.add_argument("--save_view_frames", default=None,
                    help="dump per-frame scene PNGs to this dir (headless"
                         " equivalent of ctrl_log_slam_images_*)")
    # the reference's 'i' hotkey (DumpTrackerState)
    ap.add_argument("--dump_state_at", type=int, default=None,
                    help="print the full filter state at this frame")
    # checkpoint/resume (north-star addition; reference has no load path)
    ap.add_argument("--checkpoint_every", type=int, default=None)
    ap.add_argument("--checkpoint_path", default="monoslam_ckpt.npz")
    ap.add_argument("--resume", action="store_true",
                    help="resume from --checkpoint_path (frame index included)")
    args = ap.parse_args()

    import jax

    from surikatoko_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if args.x64:
        jax.config.update("jax_enable_x64", True)
    import numpy as np
    import jax.numpy as jnp

    from surikatoko_tpu.geom import camera
    from surikatoko_tpu.geom.se3 import SE3
    from surikatoko_tpu.io.config_reader import ConfigReader
    from surikatoko_tpu.io.tracker_log import TrackerInternalsLogger
    from surikatoko_tpu.models.monoslam import MonoSlamFilter, make_params
    from surikatoko_tpu.world.demo_matcher import DemoCornersMatcher
    from surikatoko_tpu.world.runner import (
        gt_poses_in_tracker_frame, init_tracker_state_from_gt)

    cfg = ConfigReader(args.scene_config) if args.scene_config else ConfigReader(
        data={"scene_source": "virtscene", "virtual_scenario": "OscilateRightAndLeft",
              "world_x_limits": [0.0, 0.6], "world_y_limits": [0.0, 0.6],
              "world_z_limits": [0.0, 0.6001], "world_z_ascent": 0.2,
              "viewer_eye_offset": [0, -1.5, 0], "viewer_max_deviation": 0.6,
              "viewer_periods_count": 2, "viewer_shots_per_period": 160})

    img_size = cfg.get_seq("camera_image_size", int, [320, 240])
    cam = camera.make_intrinsics(
        tuple(img_size),
        tuple(cfg.get_seq("camera_princip_point", float, [160.0, 120.0])),
        cfg.get_value("camera_focal_length_mm", float, 1.95),
        tuple(cfg.get_seq("camera_pixel_size_mm", float, [0.01, 0.01])))
    dist = None
    if cfg.get_value("camera_enable_distortion", bool, False):
        k1k2 = cfg.get_seq("camera_distort_mikhail_k1k2", float, [0.0, 0.0])
        dist = camera.MikhailDistortion(jnp.asarray(k1k2[0]), jnp.asarray(k1k2[1]))

    dt = cfg.get_value("monoslam_dt", float, None)
    if dt is None:  # reference key name (demo-monoslam-imageseq.json)
        dt = cfg.get_value("monoslam_seconds_per_frame", float, 1.0)
    params = make_params(
        cam, dist,
        dt=dt,
        process_noise_lin_veloc_std=cfg.get_value(
            "monoslam_process_noise_cam_lin_veloc_std_mm", float, 0.075),
        process_noise_ang_veloc_std=cfg.get_value(
            "monoslam_process_noise_cam_ang_veloc_std_rad", float, 0.01),
        measurm_noise_std_pix=cfg.get_value(
            "monoslam_measurm_noise_std_pix", float, 1.0),
        sal_pnt_init_inv_dist=cfg.get_value(
            "monoslam_sal_pnt_init_inv_dist", float, 0.1),
        sal_pnt_init_inv_dist_std=cfg.get_value(
            "monoslam_sal_pnt_init_inv_dist_std", float, 1.0),
        max_undetected_frames=cfg.get_value(
            "monoslam_sal_pnt_max_undetected_frames_count", int, 0),
        ransac_corner_max_divergence_pix=cfg.get_value(
            "monoslam_1pransac_corner_max_divergence_pix", float, None),
        ransac_high_innov_chi_square_thresh=cfg.get_value(
            "monoslam_1pransac_high_innov_chisq_thr_pix2", float, 9.21034),
    )
    tracker = MonoSlamFilter(params, capacity=args.capacity,
                             update_impl=args.update_impl)
    logger = TrackerInternalsLogger()

    if args.image_dir:
        from surikatoko_tpu.io.frame_loader import FrameLoader
        from surikatoko_tpu.vision.matcher import ImageTemplCornersMatcher

        matcher = ImageTemplCornersMatcher(
            tracker, templ_width=args.templ_width,
            min_corr_coeff=args.templ_min_corr_coeff)
        loader = FrameLoader(args.image_dir)
        print(f"frame loader: native={loader.native} "
              f"{loader.frame_count} frames {loader.width}x{loader.height}")
        state = tracker.init_state()
        for f, gray in loader:
            if args.frames is not None and f >= args.frames:
                break
            logger.start_new_frame()
            matcher.analyze_frame(gray.astype(np.float32))
            obs, obs_mask = matcher.match_salient_points(state, f)
            new_pix, new_mask = matcher.recruit_new_salient_points(state, f, obs_mask)
            state, stats = tracker.process_frame(state, obs, obs_mask,
                                                 new_pix, new_mask)
            matcher.on_landmarks_added(np.asarray(stats.new_slots),
                                       np.asarray(new_pix), state)
            matcher.sync_removed(state)
            logger.record_from_stats(stats, state)
            if matcher.last_gate_stats:
                logger.record_gate_stats(matcher.last_gate_stats)
            logger.finish_frame()
            d = logger.slices[-1].frame_processing_dur
            gs = matcher.last_gate_stats
            gate_pct = (100.0 * gs["gated_evals"] / gs["window_evals"]
                        if gs.get("window_evals") else 0.0)
            print(f"f={f} track={d*1e3:.1f}ms | {1.0/max(d,1e-9):.1f}fps "
                  f"obs={int(stats.obs_count)} est={int(stats.estimated_count)}"
                  f" gate={gate_pct:.0f}%")
    else:
        points_w, gt_cfw_world = build_virtual_scene(cfg)
        gt_cfw = gt_poses_in_tracker_frame(gt_cfw_world)
        tfw = SE3(gt_cfw_world.R[0], gt_cfw_world.t[0])
        pts = np.asarray(jnp.einsum("ij,nj->ni", tfw.R, jnp.asarray(points_w)) + tfw.t)
        matcher = DemoCornersMatcher(
            tracker, gt_cfw, pts, image_size=tuple(img_size),
            detection_noise_std=args.detection_noise_std,
            match_drop_prob=args.match_drop_prob,
            max_new_per_frame=args.max_new_blobs_per_frame,
            max_new_in_first_frame=args.max_new_blobs_in_first_frame)
        n_frames = min(args.frames or 10**9, gt_cfw.t.shape[0])
        state = init_tracker_state_from_gt(
            tracker, gt_cfw, dt=float(params.dt),
            with_velocity=args.cam_perfect_init_vel,
            with_ang_velocity=args.cam_perfect_init_ang_vel)
        from surikatoko_tpu.io import checkpoint as ckpt_mod
        from surikatoko_tpu.models.monoslam import health as health_mod
        from surikatoko_tpu.models.monoslam.filter import format_state
        start_frame = 0
        if args.resume and os.path.exists(args.checkpoint_path):
            payload = ckpt_mod.load_pytree(
                args.checkpoint_path,
                {"state": state, "frame": 0,
                 "slot_to_frag": matcher.slot_to_frag,
                 "frag_to_slot": matcher.frag_to_slot})
            state, start_frame = payload["state"], int(payload["frame"])
            matcher.slot_to_frag = np.asarray(payload["slot_to_frag"])
            matcher.frag_to_slot = np.asarray(payload["frag_to_slot"])
            print(f"resumed from {args.checkpoint_path} at frame {start_frame}")
        view = None
        if args.live or args.save_view_frames:
            from surikatoko_tpu.viz.live_view import LiveMonoSlamView
            view = LiveMonoSlamView(
                image_size=tuple(img_size),
                save_frames_dir=args.save_view_frames)
        for f in range(start_frame, n_frames):
            if args.suppress_observations_from is not None:
                lo = args.suppress_observations_from
                hi = args.suppress_observations_to or 10**9
                matcher.suppress_observations = lo <= f < hi
            if view is not None:
                if view.want_quit:
                    print(f"f={f} stopped from the viewer ('q')")
                    break
                matcher.suppress_observations |= view.suppress
                if view.want_dump:
                    view.want_dump = False
                    print(format_state(state))
            do_reset = (args.reset_to_gt_at is not None
                        and f == args.reset_to_gt_at)
            if view is not None and view.want_reset:
                view.want_reset = False
                do_reset = True
            if do_reset:
                from surikatoko_tpu.geom import quat as quat_mod
                wfc_r = SE3(gt_cfw.R[f], gt_cfw.t[f]).inv()
                gt13r = jnp.concatenate([
                    jnp.asarray(wfc_r.t),
                    jnp.asarray(quat_mod.from_rotmat(wfc_r.R)),
                    jnp.zeros(6, state.x.dtype)])
                gt_pix, gt_rho, slot_mask = matcher.gt_state_for_reset(state, f)
                state = health_mod.reset_state_to_gt(
                    params, state, gt13r, jnp.asarray(gt_pix),
                    jnp.asarray(gt_rho), jnp.asarray(slot_mask),
                    impl=args.reset_to_gt_impl,
                    cam_pos_std=cfg.get_value(
                        "monoslam_cam_pos_std_m", float, 0.0),
                    cam_q_comp_std=cfg.get_value(
                        "monoslam_cam_orient_q_comp_std", float, 0.0),
                    cam_vel_std=cfg.get_value(
                        "monoslam_cam_vel_std", float, 0.0),
                    cam_ang_vel_std=cfg.get_value(
                        "monoslam_cam_ang_vel_std", float, 0.0),
                    sal_pnt_first_cam_pos_std=cfg.get_value(
                        "monoslam_sal_pnt_first_cam_pos_std_if_gt", float, 0.0),
                    sal_pnt_azimuth_std=cfg.get_value(
                        "monoslam_sal_pnt_azimuth_std_if_gt", float, 0.0),
                    sal_pnt_elevation_std=cfg.get_value(
                        "monoslam_sal_pnt_elevation_std_if_gt", float, 0.0),
                    sal_pnt_inv_dist_std=cfg.get_value(
                        "monoslam_sal_pnt_inv_dist_std_if_gt", float, 0.0))
                print(f"f={f} full state+covar reset to ground truth "
                      f"('u' hotkey, impl={args.reset_to_gt_impl})")
            if args.dump_state_at is not None and f == args.dump_state_at:
                print(format_state(state))
            logger.start_new_frame()
            obs, obs_mask = matcher.match_salient_points(state, f)
            new_pix, new_mask, gt_rho, frag_ids = matcher.recruit_new_salient_points(
                state, f, obs_mask)
            state, stats = tracker.process_frame(state, obs, obs_mask,
                                                 new_pix, new_mask, gt_rho)
            matcher.on_landmarks_added(np.asarray(stats.new_slots), frag_ids, state)
            matcher.sync_removed(state)
            cfw_f = SE3(gt_cfw.R[f], gt_cfw.t[f])
            wfc = cfw_f.inv()
            if view is not None:
                view.update(params, state, f, obs=obs, obs_mask=obs_mask,
                            gt_wfc_t=np.asarray(wfc.t))
            from surikatoko_tpu.geom import quat as quat_mod
            q_gt = np.asarray(quat_mod.from_rotmat(wfc.R))
            gt13 = np.concatenate([np.asarray(wfc.t), q_gt, np.zeros(6)])
            logger.record_from_stats(stats, state, cam_state_gt=gt13)
            logger.finish_frame()
            if args.checkpoint_every and (f + 1) % args.checkpoint_every == 0:
                ckpt_mod.save_pytree(
                    args.checkpoint_path,
                    {"state": state, "frame": f + 1,
                     "slot_to_frag": matcher.slot_to_frag,
                     "frag_to_slot": matcher.frag_to_slot})
            d = logger.slices[-1].frame_processing_dur
            err = np.linalg.norm(np.asarray(stats.cam_state[:3]) - np.asarray(wfc.t))
            print(f"f={f} track={d*1e3:.1f}ms | {1.0/max(d,1e-9):.1f}fps "
                  f"obs={int(stats.obs_count)} est={int(stats.estimated_count)} "
                  f"poserr={err:.4f}")

    unused = cfg.unused_params()
    if unused:
        print(f"WARNING: unused config parameters: {unused}")
    logger.write_json(args.out_internals)
    ate = logger.ate_rmse()
    ate_str = f" ate_rmse={ate:.5f}" if ate is not None else ""
    print(f"avg frame dur={logger.avg_frame_processing_dur()*1e3:.1f}ms;"
          f"{ate_str} internals -> {args.out_internals}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
