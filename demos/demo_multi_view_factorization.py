"""Incremental multi-view factorization demo.

Equivalent of reference demos/demo-multi-view-factorization.cpp:
synthetic rectangular-path world, GT-projecting corners matcher, first two
frames carry known pose+points ("well_known_frames"), then per-frame
IntegrateNewFrameCorners with BA triggering. fake_localization/fake_mapping
switches mirror the reference flags.

Usage: python demos/demo_multi_view_factorization.py [--frames 12]
    [--fake_localization] [--fake_mapping] [--noise_pix 0] [--loop_closure]

--loop_closure adds GT-measured relative-pose edges (last frame vs the two
bootstrap frames) and runs SE(3) pose-graph optimization + map
re-triangulation + fixed-keyframe BA (closure frames pinned) after the
sequence — the drift-correction path the reference lacks.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--fake_localization", action="store_true")
    ap.add_argument("--fake_mapping", action="store_true")
    ap.add_argument("--noise_pix", type=float, default=0.0,
                    help="detection noise std (pixels)")
    ap.add_argument("--loop_closure", action="store_true",
                    help="pose-graph loop closure after the sequence")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import jax

    from surikatoko_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    jax.config.update("jax_enable_x64", True)
    import numpy as np
    import jax.numpy as jnp

    from surikatoko_tpu.geom.se3 import SE3
    from surikatoko_tpu.models.mvf import MultiViewFactorizer, TrackStore
    from surikatoko_tpu.world import scene_gen

    # rectangular-path world (reference demo :383-460)
    wb = scene_gen.WorldBounds(-1.5, 1.5, -1.5, 1.5, 0.0, 0.2)
    points = np.asarray(scene_gen.generate_grid_points(wb, (0.4, 0.4, 0.4), 0.1))
    gt_cfw = scene_gen.rectangular_path(wb, args.frames // 4 + 1,
                                        args.frames // 4 + 1,
                                        (3, -2, 5), (0, 0, 0), (0, 0, 1))
    n_frames = min(args.frames, gt_cfw.t.shape[0])
    K = np.array([[520.0, 0, 160.0], [0, 520.0, 120.0], [0, 0, 1.0]])
    K_inv = np.linalg.inv(K)
    img_w, img_h = 320, 240

    ts = TrackStore(max_tracks=len(points), max_frames=n_frames)
    mvf = MultiViewFactorizer(
        track_store=ts, K=K,
        fake_localization=args.fake_localization,
        fake_mapping=args.fake_mapping,
        gt_cfw_fun=lambda f: SE3(gt_cfw.R[f], gt_cfw.t[f]),
        gt_point_fun=lambda tid: points[tid],
    )

    rng = np.random.default_rng(args.seed)

    def write_frame_corners(f):
        R, t = np.asarray(gt_cfw.R[f]), np.asarray(gt_cfw.t[f])
        xc = points @ R.T + t
        vis = xc[:, 2] > 1e-6
        ph = xc @ K.T
        pix = ph[:, :2] / ph[:, 2:3]
        if args.noise_pix:
            pix = pix + rng.normal(scale=args.noise_pix, size=pix.shape)
        vis &= (pix[:, 0] >= 0) & (pix[:, 0] < img_w) & (pix[:, 1] >= 0) & (pix[:, 1] < img_h)
        for tid in np.nonzero(vis)[0]:
            ts.add_corner(int(tid), f, pix[tid], K_inv)
        return np.nonzero(vis)[0]

    t0 = time.time()
    for f in range(n_frames):
        vis_ids = write_frame_corners(f)
        if f < 2:  # well-known frames
            mvf.add_known_frame(SE3(gt_cfw.R[f], gt_cfw.t[f]))
            for tid in vis_ids:
                mvf.set_known_point(int(tid), points[tid])
            continue
        ok = mvf.integrate_new_frame_corners()
        err = mvf._reproj_error()
        print(f"f={f} integrated={ok} points={len(mvf.point_coords)} "
              f"reproj_err={err:.3e} ba_runs={mvf.ba_runs}")

    if args.loop_closure:
        closures = []
        for j in (0, 1):
            i = n_frames - 1
            Ri, ti = np.asarray(gt_cfw.R[i]), np.asarray(gt_cfw.t[i])
            Rj, tj = np.asarray(gt_cfw.R[j]), np.asarray(gt_cfw.t[j])
            rel_R = Rj @ Ri.T
            closures.append((i, j, SE3(rel_R, tj - rel_R @ ti), 3.0))
        end_before = float(np.linalg.norm(
            -(mvf.cam_cfw_R[-1].T @ mvf.cam_cfw_t[-1])
            - np.asarray(SE3(gt_cfw.R[n_frames - 1], gt_cfw.t[n_frames - 1]).inv().t)))
        mvf.apply_pose_graph(closures, run_ba=True)  # BA with pinned closures
        end_after = float(np.linalg.norm(
            -(mvf.cam_cfw_R[-1].T @ mvf.cam_cfw_t[-1])
            - np.asarray(SE3(gt_cfw.R[n_frames - 1], gt_cfw.t[n_frames - 1]).inv().t)))
        print(f"loop closure: endpoint err {end_before:.4f} -> {end_after:.4f}")

    dt = time.time() - t0
    # final accuracy
    from surikatoko_tpu.geom.align import aligned_rmse
    tids = sorted(mvf.point_coords)
    est = np.stack([mvf.point_coords[t] for t in tids])
    gt = points[tids]
    ate = float(aligned_rmse(jnp.asarray(est), jnp.asarray(gt)))
    cam_est = np.stack([-(R.T @ t) for R, t in zip(mvf.cam_cfw_R, mvf.cam_cfw_t)])
    cam_gt = np.stack([np.asarray(SE3(gt_cfw.R[f], gt_cfw.t[f]).inv().t)
                       for f in range(n_frames)])
    cam_ate = float(aligned_rmse(jnp.asarray(cam_est), jnp.asarray(cam_gt)))
    print(f"done in {dt:.1f}s: {len(tids)} points, point-ATE={ate:.5f}, "
          f"camera-ATE={cam_ate:.5f}, ba_runs={mvf.ba_runs}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
