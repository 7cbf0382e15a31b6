"""Roofline measurement for the Schur-complement BA solve.

Methodology (one card; the distributed kernel is the same per-shard code
plus one psum of the [10F,10F] reduced system):

1. Measure the card's dense-matmul rate at the SAME matmul precision the
   solver runs under ("highest", full f32) — the ceiling this workload can
   reach at that precision; the bf16 data-sheet rate would not apply to an
   f32 solver.
2. Time the jitted sparse Schur solve (solve_corrections_schur_sparse) at the
   at-scale configuration (10k points x 500 frames, L=12), steady-state.
3. FLOPs for the solve are analytic (the Gram-form reduction matmuls + the
   reduced Cholesky; XLA's cost_analysis undercounts fori_loop bodies);
   FLOPs for the GN blocks come from XLA's cost model.
4. Report achieved TFLOP/s and % of the measured ceiling for both, i.e. how
   close the reference's "Ft.E.F is a hot spot"
   (bundle-adj-kanatani.cpp:1888) runs to the card's measured rate.

Run on the card:  python analysis/roofline_schur.py
CPU smoke:  JAX_PLATFORMS=cpu python analysis/roofline_schur.py --points 2048 --frames 64 --reps 2
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def _time_compiled(fn, args, reps: int) -> float:
    """Median wall-clock seconds of jitted ``fn(*args)`` after a warm-up
    call; every call is waited on with jax.block_until_ready."""
    import jax

    from surikatoko_tpu.utils.profiling import median_wall_time

    fn = jax.jit(fn)
    jax.block_until_ready(fn(*args))            # compile + warmup
    return median_wall_time(lambda: fn(*args), reps)


def _flops_of(fn, *args) -> float:
    """XLA cost-model FLOPs (valid only for loop-free programs)."""
    import jax
    compiled = jax.jit(fn).lower(*args).compile()
    ca = compiled.cost_analysis()
    if isinstance(ca, list):   # older jax returns [dict]
        ca = ca[0]
    return float(ca.get("flops", float("nan")))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=10_000)
    ap.add_argument("--frames", type=int, default=500)
    ap.add_argument("--track_len", type=int, default=12)
    ap.add_argument("--point_chunk", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--matmul_n", type=int, default=8192)
    ap.add_argument("--matmul_k", type=int, default=8,
                    help="chained matmuls per ceiling measurement")
    ap.add_argument("--band", action="store_true",
                    help="measure the banded reduction (sparse.plan_bands)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    jax.config.update("jax_default_matmul_precision", "highest")
    dtype = jnp.float32

    from surikatoko_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "demos"))
    from demo_ba_at_scale import build_problem
    from surikatoko_tpu.models.ba import sparse as sp

    dev = jax.devices()[0]
    print(f"device: {dev.device_kind} ({dev.platform})")

    # --- 1. empirical matmul ceiling at the solver's precision ---
    n, K = args.matmul_n, args.matmul_k
    b = jax.random.normal(jax.random.PRNGKey(1), (n, n), dtype)
    a0 = jax.random.normal(jax.random.PRNGKey(0), (n, n), dtype)

    def chain(x, y):
        def body(c, _):
            return y @ c * 1e-3, None   # scale keeps values finite
        out, _ = jax.lax.scan(body, x, None, length=K)
        return out

    t_mm = _time_compiled(chain, (a0, b), args.reps)
    ceiling = 2.0 * K * n ** 3 / t_mm
    print(f"matmul ceiling ({K}x {n}x{n} f32-acc): {ceiling/1e12:.2f} "
          f"TFLOP/s ({t_mm*1e3:.2f} ms)")

    # --- 2. the at-scale sparse Schur solve ---
    ps = build_problem(args.points, args.frames, args.track_len,
                       noise_pix=0.5, seed=0, dtype=dtype)
    blocks = jax.jit(sp.compute_blocks)(ps)
    jax.block_until_ready(blocks.E)
    hf = jnp.asarray(1e-4, dtype)

    if args.band:
        plan = sp.plan_bands(ps.frame_idx, ps.obs_mask,
                             args.point_chunk, ps.n_frames)
        assert plan is not None, "banding not applicable to this problem"
        Wb, nb = plan.band_width, plan.n_banded_chunks
        no = ((plan.ext_idx.shape[0] - nb * plan.point_chunk)
              // plan.overflow_chunk)
        print(f"banded: W={Wb} of {ps.n_frames} frames, {nb} banded + "
              f"{no} overflow chunks (pc_ovf={plan.overflow_chunk})")
        solve = functools.partial(
            sp.solve_corrections_schur_banded, plan=plan)
    else:
        solve = functools.partial(
            sp.solve_corrections_schur_sparse, point_chunk=args.point_chunk)
    t_solve = _time_compiled(solve, (ps, blocks, hf), args.reps)
    # analytic FLOPs (XLA's cost_analysis counts a fori_loop body once):
    # Gram reduction = n_chunks products [10W,3pc]@[3pc,10W] (W = band
    # width, or F unbanded), plus the reduced-system Cholesky (10F)^3/3;
    # everything else is O(Np L) small.
    Np, F, L = ps.n_points, ps.n_frames, ps.track_len
    pc = args.point_chunk
    n_chunks = -(-Np // pc)
    nF = 10 * F
    if args.band:
        gram = (nb * 2.0 * (3 * pc) * (10 * Wb) ** 2     # banded strips
                + no * 2.0 * (3 * plan.overflow_chunk) * nF ** 2)  # overflow
    else:
        gram = n_chunks * 2.0 * (3 * pc) * nF ** 2       # B^T B strips
    f_solve = (gram
               + nF ** 3 / 3.0                           # cho_factor
               + 2.0 * nF ** 2)                          # cho_solve

    # --- 3. GN blocks (derivative rebuild — the other per-iteration cost) ---
    t_blocks = _time_compiled(sp.compute_blocks, (ps,), args.reps)
    f_blocks = _flops_of(sp.compute_blocks, ps)

    eff_solve = f_solve / t_solve
    eff_blocks = f_blocks / t_blocks
    print(f"schur solve : {t_solve*1e3:8.2f} ms  {f_solve/1e9:8.2f} GFLOP  "
          f"-> {eff_solve/1e12:.2f} TFLOP/s  ({100*eff_solve/ceiling:.1f}% "
          f"of ceiling)")
    print(f"GN blocks   : {t_blocks*1e3:8.2f} ms  {f_blocks/1e9:8.2f} GFLOP  "
          f"-> {eff_blocks/1e12:.2f} TFLOP/s  ({100*eff_blocks/ceiling:.1f}% "
          f"of ceiling)")
    per_iter = t_solve + t_blocks
    print(f"LM iteration (blocks+solve): {per_iter*1e3:.2f} ms "
          f"-> {1.0/per_iter:.2f} iters/s")
    if args.band:
        # banding trades FLOPs for speed: %-of-ceiling is not the headline
        # metric here (fewer FLOPs at similar overheads), iteration rate is
        print(json.dumps({
            "metric": "sparse_schur_banded_lm_iters_per_sec",
            "value": round(1.0 / per_iter, 2),
            "unit": "iters/s",
            "vs_baseline": round((1.0 / per_iter) / 3.8, 2),
        }))
    else:
        print(json.dumps({
            "metric": "sparse_schur_pct_of_matmul_ceiling",
            "value": round(100 * eff_solve / ceiling, 1),
            "unit": "%",
            "vs_baseline": round((eff_solve / ceiling) / 0.60, 2),
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
