"""Do recruited landmarks CONVERGE under repeated observation?

VERDICT r4 item 2 asked exactly this: the reference's recruits start from a
configured flat depth prior (GetNewSphericalSalientPointState,
davison-mono-slam.cpp:2398) and converge as the filter re-observes them —
measure whether ours do, per slot generation.

Method: run the K=768 churned imageseq loop (the bench config) in 10-frame
chunks; after each chunk fetch (x, lm_active, lm_generation) and compute
each active, currently-matched slot's distance to the NEAREST GT world
point (the world is 1024 isolated splats). Raw distances are dominated by
global monocular scale/pose drift (and a similarity re-alignment is
degenerate here — the oscillating trajectory is nearly 1-D, leaving one
rotation unconstrained), so each slot's error is NORMALIZED by the same
chunk's median error over ALL matched slots: the ratio is drift-invariant,
and a recruit has converged when its ratio reaches ~1 — it is as good as
the map it joined. Host bookkeeping turns generation bumps into per-slot
ages, and ratios aggregate into (generation, age-bucket) medians.

Bootstrap slots enter via add_landmarks (generation 1 at init); a slot whose
generation NEVER changes after init is the bootstrap bucket (ratio ~1 by
construction, printed as the sanity row), and any bump after init marks a
genuine recruit with its age reset.

Convergence = the median error RATIO of recruited slots falls toward 1 with
age. The same table contrasts recruit_depth priors: the flat 0.5 prior vs
the spatially-local neighbourhood median (--depth local).

Usage: python analysis/measure_recruit_convergence.py [--depth prior|local]
                                                      [--chunks 24]
"""

from __future__ import annotations

import argparse
import sys


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--depth", default="prior",
                    choices=("prior", "median", "local"))
    ap.add_argument("--chunks", type=int, default=24)
    ap.add_argument("--chunk-frames", type=int, default=10)
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    jax.config.update("jax_default_matmul_precision", "highest")

    from surikatoko_tpu.geom import camera
    from surikatoko_tpu.models.monoslam import make_params, init_state
    from surikatoko_tpu.models.monoslam.measure import landmark_world_pos
    from surikatoko_tpu.world.device_runner import (
        build_imageseq_scenario, init_imageseq, make_imageseq_scan_runner)

    dtype = jnp.float32
    K = 48 if args.smoke else 768
    cam = camera.make_intrinsics((640, 480), (320.0, 240.0), 1.95,
                                 (0.005, 0.005), dtype=dtype)
    params = make_params(cam, None, dt=1.0,
                         process_noise_lin_veloc_std=0.075,
                         process_noise_ang_veloc_std=0.01,
                         sal_pnt_init_inv_dist=0.5,
                         sal_pnt_init_inv_dist_std=0.5,
                         max_undetected_frames=30,
                         covar_diag_inflation=1e-6, dtype=dtype)
    sc = build_imageseq_scenario(capacity=K, dtype=dtype,
                                 image_size=(640, 480),
                                 n_points=64 if args.smoke else 1024,
                                 bg_cell=48, max_deviation=0.8, world="wide")
    st = init_state(K, dtype=dtype)
    st, templates = jax.jit(lambda s: init_imageseq(params, sc, s, 15))(st)
    run = make_imageseq_scan_runner(
        params, templ_width=15, recruit=True, recruit_max=12,
        detector_corners=64, recruit_depth=args.depth)

    @jax.jit
    def slot_errors(x):
        lm = x[13:].reshape(K, 6)
        pos = jax.vmap(landmark_world_pos)(lm)             # [K,3]
        d = jnp.linalg.norm(pos[:, None, :] - sc.gt_points[None], axis=-1)
        return jnp.min(d, axis=1)                          # [K]

    C = args.chunk_frames
    n_chunks = 4 if args.smoke else args.chunks
    age = np.full(K, -1)                # frames since recruit; -1 = bootstrap
    gen0 = np.asarray(st.lm_generation).copy()   # post-init baseline:
    # bootstrapped slots are generation 1 already (add_landmarks bumps)
    gen_prev = gen0.copy()
    # rows: (recruit_number = gen - gen0, age_frames, err_ratio)
    rows = []
    f0 = 1
    F = int(sc.gt_cfw_R.shape[0])
    for c in range(n_chunks):
        lo = f0 + (c * C) % (F - C - 1)
        st, templates, _ = run(st, templates, sc, jnp.arange(lo, lo + C))
        gen = np.asarray(st.lm_generation)
        act = np.asarray(st.lm_active)
        # matched-now proxy: the delete counter resets to 0 on every match,
        # so unobserved==0 slots were matched in the chunk's last frame —
        # out-of-view slots (whose depth CANNOT converge, they just await
        # deletion) would otherwise pollute the age curve
        obs_now = np.asarray(st.lm_unobserved) == 0
        err = np.asarray(slot_errors(st.x))
        sel_map = act & obs_now & np.isfinite(err)
        map_med = float(np.median(err[sel_map])) if np.any(sel_map) else 1.0
        err = err / max(map_med, 1e-12)      # drift-invariant ratio
        newly = gen != gen_prev
        age[newly] = 0
        age[(age >= 0) & ~newly] += C
        gen_prev = gen
        for k in range(K):
            if act[k] and obs_now[k] and np.isfinite(err[k]):
                rows.append((int(gen[k] - gen0[k]), int(age[k]),
                             float(err[k])))
    rows = np.asarray(rows)
    if rows.size == 0:
        print(f"depth={args.depth}  samples=0 — no active+matched slots "
              f"recorded (tracking collapsed or chunk boundaries never "
              f"caught a match)")
        return

    def med(sel):
        if not np.any(sel):
            return (float("nan"), 0)
        return (float(np.median(rows[sel, 2])), int(np.sum(sel)))

    print(f"depth={args.depth}  samples={len(rows)}  "
          f"(chunks={n_chunks} x {C} frames)")
    boot = rows[:, 1] < 0
    m, n = med(boot)
    print(f"  bootstrap slots (gen unchanged): median err ratio {m:.4f}  "
          f"(n={n})")
    buckets = [(0, 10), (10, 20), (20, 40), (40, 80), (80, 10_000)]
    for g in (1, 2, 3):
        gsel = (rows[:, 0] == g) if g < 3 else (rows[:, 0] >= 3)
        tag = f"recruit#{'>=' if g == 3 else ''}{g}"
        if not np.any(gsel):
            continue
        parts = []
        for a0, a1 in buckets:
            sel = gsel & (rows[:, 1] >= a0) & (rows[:, 1] < a1)
            if np.any(sel):
                m, n = med(sel)
                parts.append(f"age {a0:>3}-{a1:<4}: {m:.4f} (n={n})")
        print(f"  {tag:8s} " + "  ".join(parts))


if __name__ == "__main__":
    sys.exit(main())
