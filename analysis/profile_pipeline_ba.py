"""Decompose the MVF-pipeline final-BA iteration rate (VERDICT round 2,
weak #1 / next-round #1): the standalone banded kernel measures
1/(t_blocks + t_band) while the pipeline's device-LM pays
blocks + trials x (solve + reproj eval + apply) per iteration plus the LM
loop's own machinery — this script times every piece on the same
10240 x 512-shaped problem the at-scale demo emits, so the gap has numbers
instead of suspects.

    python analysis/profile_pipeline_ba.py
"""

from __future__ import annotations

import functools
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "demos"))


def main() -> None:
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_default_matmul_precision", "highest")

    from demo_ba_at_scale import build_problem
    from surikatoko_tpu.models.ba import (SparseBundleAdjustment,
                                          TermCriteria)
    from surikatoko_tpu.models.ba import sparse as sp
    from roofline_schur import _time_compiled
    from surikatoko_tpu.utils.profiling import median_wall_time

    dtype = jnp.float32
    NP_BA, F_BA, L_BA, PC = 10240, 512, 12, 2048
    print(f"problem {NP_BA} x {F_BA}, L={L_BA}, pc={PC}", flush=True)
    ps = build_problem(NP_BA, F_BA, L_BA, noise_pix=0.5, seed=0, dtype=dtype)
    reps = 3

    t_blocks = _time_compiled(sp.compute_blocks, (ps,), reps)
    print(f"compute_blocks                 {t_blocks * 1e3:8.2f} ms",
          flush=True)

    blocks = jax.jit(sp.compute_blocks)(ps)
    jax.block_until_ready(blocks.E)
    hf = jnp.asarray(1e-4, dtype)

    plan = sp.plan_bands(ps.frame_idx, ps.obs_mask, PC, ps.n_frames)
    n_ovf = (plan.ext_idx.shape[0]
             - plan.n_banded_chunks * plan.point_chunk) // plan.overflow_chunk
    print(f"plan: W={plan.band_width} nb={plan.n_banded_chunks} "
          f"ovf={n_ovf}x{plan.overflow_chunk}", flush=True)

    solve_static = functools.partial(sp.solve_corrections_schur_banded,
                                     plan=plan)
    t_band = _time_compiled(solve_static, (ps, blocks, hf), reps)
    print(f"banded solve (static ext)      {t_band * 1e3:8.2f} ms",
          flush=True)

    ext = jnp.asarray(plan.ext_idx)
    solve_traced = functools.partial(sp.solve_corrections_schur_banded,
                                     plan=plan)
    t_band_tr = _time_compiled(
        lambda p_, b_, h_, e_: solve_traced(p_, b_, h_, ext_idx=e_),
        (ps, blocks, hf, ext), reps)
    print(f"banded solve (traced ext)      {t_band_tr * 1e3:8.2f} ms",
          flush=True)

    t_err = _time_compiled(sp.reproj_error, (ps,), reps)
    print(f"reproj_error                   {t_err * 1e3:8.2f} ms", flush=True)

    dX, du, ok = jax.jit(solve_static)(ps, blocks, hf)
    jax.block_until_ready(dX)
    t_apply = _time_compiled(sp.apply_corrections, (ps, dX, du), reps)
    print(f"apply_corrections              {t_apply * 1e3:8.2f} ms",
          flush=True)

    # ---- the full device-LM, exactly as the pipeline drives it ----
    # perturb the problem away from its optimum so LM does real work (the
    # at-scale demo's problem arrives drifted from the pipeline)
    import numpy as np
    rng = np.random.default_rng(3)
    pts_pert = ps.points * jnp.asarray(
        1.0 + rng.normal(scale=2e-3, size=(NP_BA, 3)), dtype)
    term = TermCriteria(allowed_reproj_err_rel_change=None, max_iters=5)
    ba = SparseBundleAdjustment(optimize_intrinsics=False, point_chunk=PC,
                                device_loop=True)
    ba.set_plan_inputs(ps.frame_idx, ps.obs_mask)
    # ba.compute (not compute_inplace): the ring world's cam0->cam1 shift has
    # no y component, so the default unity_comp_ind=1 gauge refuses to
    # normalize — and the LM core is what's being timed here anyway
    pr = ps._replace(points=pts_pert)
    t0 = time.time()
    jax.block_until_ready(ba.compute(pr, term))
    print(f"device-LM compile+first        {time.time() - t0:8.2f} s "
          f"({ba.iterations} iters, {ba.trials} trials, "
          f"'{ba.stop_reason}')", flush=True)
    t_lm = median_wall_time(lambda: ba.compute(pr, term))
    print(f"device-LM 5 iters              {t_lm * 1e3:8.2f} ms "
          f"({ba.iterations} iters, {ba.trials} trials) = "
          f"{ba.iterations / t_lm:.2f} iters/s", flush=True)
    per_iter = t_blocks + (ba.trials / max(ba.iterations, 1)) * (
        t_band_tr + t_err + t_apply)
    print(f"sum-of-parts model             {per_iter * 1e3:8.2f} ms/iter = "
          f"{1.0 / per_iter:.2f} iters/s", flush=True)

    # ---- the full fused compute_inplace (gauge check + normalize + LM +
    # revert as ONE dispatch), exactly what demo_mvf_at_scale times ----
    # unity component: largest cam0->cam1 shift component (the ring world's
    # shift has no vertical part, so the default y gauge would refuse)
    R0, T0 = np.asarray(ps.cfw_R[0]), np.asarray(ps.cfw_t[0])
    R1, T1 = np.asarray(ps.cfw_R[1]), np.asarray(ps.cfw_t[1])
    uci = int(np.argmax(np.abs(T0 - R0 @ (R1.T @ T1))))
    ba2 = SparseBundleAdjustment(optimize_intrinsics=False, point_chunk=PC,
                                 unity_comp_ind=uci, device_loop=True)
    ba2.set_plan_inputs(ps.frame_idx, ps.obs_mask)
    t0 = time.time()
    jax.block_until_ready(ba2.compute_inplace(pr, term))
    print(f"fused inplace compile+first    {time.time() - t0:8.2f} s "
          f"({ba2.iterations} iters, {ba2.trials} trials, "
          f"'{ba2.stop_reason}')", flush=True)
    t_ip = median_wall_time(lambda: ba2.compute_inplace(pr, term))
    print(f"fused inplace 5 iters          {t_ip * 1e3:8.2f} ms "
          f"({ba2.iterations} iters, {ba2.trials} trials) = "
          f"{ba2.iterations / t_ip:.2f} iters/s", flush=True)


if __name__ == "__main__":
    main()
