"""Batch bundle adjustment: vmap the compiled LM over MANY problems at once.

A capability with no reference equivalent (the C++ engine optimizes exactly
one world per call, demos/demo-bundle-adj-circle-grid.cpp): because the whole
LM damping schedule compiles as one jittable program (models/ba/lm_device.py),
it vmaps — B independently-corrupted circle-grid worlds are normalized,
optimized, and reverted as ONE device program. This is the natural shape of a
Monte-Carlo noise-sensitivity sweep or multi-hypothesis refinement on an
accelerator: the per-problem matrices are small, so batching is what fills
the device.

Usage: python demos/demo_batch_ba.py [--batch 32] [--noise_pnt 0.06]
    [--compare_sequential] [--f32]
"""

from __future__ import annotations

import argparse
import functools
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--noise_pnt", type=float, default=0.06)
    ap.add_argument("--noise_rot", type=float, default=0.01)
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--max_iters", type=int, default=25)
    ap.add_argument("--allowed_repr_err", type=float, default=1e-12)
    ap.add_argument("--compare_sequential", action="store_true",
                    help="also time solving the problems one at a time")
    ap.add_argument("--f32", action="store_true",
                    help="f32 with full-precision f32 matmuls")
    args = ap.parse_args()

    import jax

    from surikatoko_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if args.f32:
        jax.config.update("jax_default_matmul_precision", "highest")
    else:
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    from test_ba import circle_grid_problem
    from surikatoko_tpu.models.ba import (
        TermCriteria, derivs, lm_device, normalize, reproj_error, schur)

    dtype = jnp.float32 if args.f32 else jnp.float64

    def cast(p):
        return jax.tree.map(
            lambda x: x.astype(dtype) if jnp.issubdtype(x.dtype, jnp.floating)
            else x, p)

    rngs = [np.random.default_rng(s) for s in range(args.batch)]
    probs = [cast(circle_grid_problem(noise_pnt=args.noise_pnt,
                                      noise_rot=args.noise_rot,
                                      n_angles=args.frames, rng=r)[0])
             for r in rngs]
    print(f"batch={args.batch} problems, each {probs[0].n_frames} frames x "
          f"{probs[0].n_points} points, dtype={jnp.dtype(dtype).name}")
    batched = jax.tree.map(lambda *xs: jnp.stack(xs), *probs)

    term = TermCriteria(allowed_reproj_err_rel_change=args.allowed_repr_err,
                        max_iters=args.max_iters)
    blocks_fn = functools.partial(derivs.compute_blocks)
    solve_fn = lambda _p, blocks, factor: schur.solve_corrections_schur(  # noqa: E731
        blocks, factor)

    def run_one(p_raw):
        """normalize -> on-device LM -> revert, all traced (vmap-able)."""
        p_norm, ns = normalize.normalize_scene(p_raw)
        p_opt, code, iters, err, _trials = lm_device.run_lm_on_device(
            p_norm, blocks_fn=blocks_fn, solve_fn=solve_fn,
            apply_fn=derivs.apply_corrections, err_fn=reproj_error,
            err_thresh=term.allowed_reproj_err_rel_change,
            max_factor=term.max_hessian_factor, max_iters=term.max_iters)
        return normalize.revert_normalization(p_opt, ns), code, iters, err

    batch_run = jax.jit(jax.vmap(run_one))

    # warmup/compile
    out = batch_run(batched)
    jax.block_until_ready(out[3])
    t0 = time.perf_counter()
    p_out, code, iters, err = batch_run(batched)
    jax.block_until_ready(err)
    dt_batch = time.perf_counter() - t0

    e0 = np.array([float(reproj_error(pp)) for pp in probs])
    e1 = np.asarray(err)
    ok = e1 < 1e-4 * e0
    print(f"batched: {args.batch} BAs in {dt_batch*1e3:.1f} ms "
          f"({args.batch/dt_batch:.1f} problems/s); "
          f"converged {int(ok.sum())}/{args.batch}; "
          f"median err reduction {np.median(e0/np.maximum(e1,1e-300)):.3g}x; "
          f"iters min/med/max = {int(np.min(iters))}/"
          f"{int(np.median(iters))}/{int(np.max(iters))}")

    if args.compare_sequential:
        one = jax.jit(run_one)
        o = one(probs[0])
        jax.block_until_ready(o[3])           # compile once
        t0 = time.perf_counter()
        for pp in probs:
            o = one(pp)
            jax.block_until_ready(o[3])
        dt_seq = time.perf_counter() - t0
        print(f"sequential: {args.batch} BAs in {dt_seq*1e3:.1f} ms "
              f"({args.batch/dt_seq:.1f} problems/s) -> "
              f"batch speedup {dt_seq/dt_batch:.1f}x")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
