"""Oxford dinosaur bundle adjustment demo.

Equivalent of reference demos/demo-bundle-adj-dinosaur.cpp: load
36 P-matrices + point tracks (or the synthetic dino stand-in if the VGG files
aren't present), decompose/triangulate, run Kanatani-style LM+Schur BA,
report f0-scaled and per-point pixel error before/after.

Usage:
  python demos/demo_bundle_adj_dinosaur.py [--testdata DIR] [--f0 600]
      [--allowed_repr_err 4.56e-8] [--max_points N] [--synthetic]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--testdata", default=os.environ.get("SRK_TEST_DATA", "testdata"))
    ap.add_argument("--f0", type=float, default=600.0)
    ap.add_argument("--allowed_repr_err", type=float, default=4.56e-8,
                    help="reproj-err relative-change stop (flagfile-demo-dino)")
    ap.add_argument("--max_points", type=int, default=None)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--synthesize_fullscale", type=int, metavar="N_POINTS",
                    default=None,
                    help="write an N_POINTS-track full-shape synthetic in "
                         "the REAL file formats (36 stacked P-matrices + "
                         "viff.xy with -1 holes) into --testdata, then load "
                         "it through the real parse path (the reference-"
                         "scale run is N_POINTS=4983, "
                         "demo-bundle-adj-dinosaur.cpp:97-116)")
    ap.add_argument("--x64", action="store_true", default=True)
    ap.add_argument("--f32", action="store_true",
                    help="run f32 with full-precision f32 matmuls")
    ap.add_argument("--host_loop", action="store_true",
                    help="host-driven LM (default: whole LM compiled "
                         "on device as one program)")
    args = ap.parse_args()

    import jax

    from surikatoko_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if args.f32:
        jax.config.update("jax_default_matmul_precision", "highest")
    elif args.x64:
        jax.config.update("jax_enable_x64", True)

    from surikatoko_tpu.io import dino
    from surikatoko_tpu.models.ba import (
        BundleAdjustment, TermCriteria, reproj_error)
    from surikatoko_tpu.models.ba.problem import reproj_error_pix_per_point

    if args.synthesize_fullscale:
        import numpy as _np
        Ps, obs, mask, gt = dino.synthetic_dino_raw(
            n_frames=36, n_points=args.synthesize_fullscale,
            vary_track_len=True)
        keep = mask.sum(axis=1) >= 2     # match the loader's track filter
        pdir = dino.write_dino_files(args.testdata, Ps, obs[keep],
                                     mask[keep], gt_points=gt[keep])
        holes = int(_np.sum(~mask[keep]))
        print(f"wrote full-shape real-format synthetic to {pdir}: "
              f"{int(keep.sum())} tracks x 36 frames, {holes} -1 holes "
              f"in viff.xy")

    dino_file = os.path.join(args.testdata, "oxfvisgeom", "dinosaur",
                             "dinoPs_as_mat108x4.txt")
    gt_points = None
    if not args.synthetic and os.path.exists(dino_file):
        print(f"loading dino data from {args.testdata}")
        p = dino.load_dino_problem(args.testdata, args.f0, args.max_points)
        gt_points = dino.load_gt_points(args.testdata)
        if gt_points is not None and args.max_points is not None:
            gt_points = gt_points[:args.max_points]
    else:
        print("dino files not found -> synthetic dino stand-in "
              "(see testdata/oxfvisgeom/README.md for the real data)")
        p, gt_points = dino.synthetic_dino_problem(
            n_points=args.max_points or 1024, f0=args.f0)

    print(f"frames={p.n_frames} points={p.n_points}")
    err0 = float(reproj_error(p))
    print(f"initial reproj_err={err0:.6g} nodim "
          f"({float(reproj_error_pix_per_point(p, err0)):.4f} pix/point)")

    ba = BundleAdjustment(device_loop=not args.host_loop)
    t0 = time.time()
    ok, p_opt = ba.compute_inplace(
        p, TermCriteria(allowed_reproj_err_rel_change=args.allowed_repr_err))
    dt = time.time() - t0
    err1 = float(reproj_error(p_opt))
    print(f"BA finished ok={ok} reason='{ba.stop_reason}' iters={ba.iterations} "
          f"in {dt:.1f}s ({ba.iterations / max(dt, 1e-9):.2f} iters/s)")
    print(f"final reproj_err={err1:.6g} nodim "
          f"({float(reproj_error_pix_per_point(p_opt, err1)):.4f} pix/point)")

    # ATE RMSE (the BASELINE accuracy metric): camera-center trajectory vs
    # the input VGG calibration (real data has no GT beyond it), plus the
    # map vs GT points when the synthetic stand-in provides them
    import jax.numpy as jnp
    import numpy as np
    from surikatoko_tpu.geom.align import aligned_rmse
    c0 = -np.einsum("fji,fj->fi", np.asarray(p.cfw_R), np.asarray(p.cfw_t))
    c1 = -np.einsum("fji,fj->fi", np.asarray(p_opt.cfw_R),
                    np.asarray(p_opt.cfw_t))
    traj_ate = float(aligned_rmse(jnp.asarray(c1), jnp.asarray(c0)))
    line = f"traj_ate_rmse={traj_ate:.6f} (vs input calibration)"
    if gt_points is not None:
        map_ate = float(aligned_rmse(p_opt.points, jnp.asarray(gt_points)))
        line += f"  map_ate_rmse={map_ate:.6f} (vs GT points)"
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
