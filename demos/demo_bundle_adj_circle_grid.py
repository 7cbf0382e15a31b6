"""Circle-grid BA noise-recovery demo.

Equivalent of reference demos/demo-bundle-adj-circle-grid.cpp:
synthetic grid world viewed from a circular camera path; corrupt points and
rotations with noise; BA recovers; before/after stats.

Usage: python demos/demo_bundle_adj_circle_grid.py [--noise_pnt 0.03]
    [--noise_rot 0.01] [--allowed_repr_err 2.25e-12]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--noise_pnt", type=float, default=0.03)
    ap.add_argument("--noise_rot", type=float, default=0.01)
    ap.add_argument("--allowed_repr_err", type=float, default=2.25e-12,
                    help="stop criterion (flagfile-demo-circle-grid)")
    ap.add_argument("--frames", type=int, default=6)
    args = ap.parse_args()

    import jax

    from surikatoko_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    jax.config.update("jax_enable_x64", True)
    import numpy as np

    from test_ba import circle_grid_problem
    from surikatoko_tpu.models.ba import (
        BundleAdjustment, TermCriteria, reproj_error)
    from surikatoko_tpu.models.ba.problem import reproj_error_pix_per_point

    p, gt_points, gt_cfw = circle_grid_problem(
        noise_pnt=args.noise_pnt, noise_rot=args.noise_rot,
        n_angles=args.frames)
    print(f"frames={p.n_frames} points={p.n_points}")

    err0 = float(reproj_error(p))
    pnt_err0 = float(np.linalg.norm(np.asarray(p.points) - gt_points, axis=1).mean())
    print(f"before: reproj_err={err0:.6g} "
          f"({float(reproj_error_pix_per_point(p, err0)):.4f} pix/pnt), "
          f"mean point err={pnt_err0:.5f}")

    ba = BundleAdjustment()
    t0 = time.time()
    ok, p_opt = ba.compute_inplace(
        p, TermCriteria(allowed_reproj_err_rel_change=args.allowed_repr_err))
    dt = time.time() - t0
    err1 = float(reproj_error(p_opt))
    pnt_err1 = float(np.linalg.norm(np.asarray(p_opt.points) - gt_points, axis=1).mean())
    from surikatoko_tpu.geom.align import aligned_rmse
    import jax.numpy as jnp
    ate = float(aligned_rmse(jnp.asarray(p_opt.points), jnp.asarray(gt_points)))
    print(f"BA ok={ok} reason='{ba.stop_reason}' iters={ba.iterations} in {dt:.1f}s")
    print(f"after:  reproj_err={err1:.6g} "
          f"({float(reproj_error_pix_per_point(p_opt, err1)):.6f} pix/pnt), "
          f"mean point err={pnt_err1:.6f} "
          f"(similarity-aligned RMSE={ate:.6f} — the gauge-fair metric)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
