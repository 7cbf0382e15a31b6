"""Quantify the f32 accuracy penalty of the large-K EKF (VERDICT round 2,
weak #2): run the SAME K-landmark imageseq scenario (render -> NCC search
-> fused EKF) in f32 (with its conditioning mitigations: covar_diag_inflation
+ delete-unobserved) and in f64 (clean, the reference's configuration —
davison-mono-slam.cpp runs f64 with neither mitigation), and report the
trajectory ATE of each.

The reference never faced this tradeoff (host f64 throughout, rt-config.h:42);
the benchmarks run the filter in f32, so the question "how much accuracy
does f32 + its conditioning mitigations cost?" must be answered by
measurement, not hope.

One configuration per invocation (dtype selection must happen before JAX
initializes x64 state, and mixing x64-enabled and -disabled runs in one
process risks silent promotion of the "f32" run):

  JAX_PLATFORMS=cpu python analysis/precision_large_k.py \
      --dtype f64 --capacity 768 --frames 120
  JAX_PLATFORMS=cpu python analysis/precision_large_k.py \
      --dtype f32 --capacity 768 --frames 120 --mitigations

``--mode ekf`` drops the imagery (render + NCC template search — whose CPU
conv path dominates the runtime of a CPU run at 640x480 x K=768 — and whose
math is dtype-trivial) and drives the same K=768 fused EKF through the
GT-projecting matcher loop instead: the chained covariance
downdate/congruence at D=4621 is exactly the computation whose f32 behavior
is in question. Used by tests/test_precision_large_k.py to keep the pin
affordable in the suite.

Emits one JSON line: {"dtype", "mitigations", "capacity", "frames",
"ate_rmse", "matched_med", "finite"}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", choices=["f32", "f64"], required=True)
    ap.add_argument("--mitigations", action="store_true",
                    help="covar_diag_inflation=1e-6 + max_undetected_frames="
                         "60 (the f32 conditioning policy)")
    ap.add_argument("--capacity", type=int, default=768)
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--chunk", type=int, default=40)
    ap.add_argument("--mode", choices=["imageseq", "ekf"], default="imageseq")
    args = ap.parse_args()

    import jax

    if args.dtype == "f64":
        jax.config.update("jax_enable_x64", True)
    jax.config.update("jax_default_matmul_precision", "highest")

    import jax.numpy as jnp

    from surikatoko_tpu.geom import camera
    from surikatoko_tpu.geom.align import aligned_rmse
    from surikatoko_tpu.models.monoslam import make_params, init_state
    from surikatoko_tpu.world.device_runner import (
        build_imageseq_scenario, build_oscillating_scenario, init_imageseq,
        init_with_gt_landmarks, make_imageseq_scan_runner, make_scan_runner)

    dtype = jnp.float64 if args.dtype == "f64" else jnp.float32
    K = args.capacity
    img_size = (640, 480) if args.mode == "imageseq" else (320, 240)
    cc = (320.0, 240.0) if args.mode == "imageseq" else (160.0, 120.0)
    kk = (0.005, 0.005) if args.mode == "imageseq" else (0.01, 0.01)
    cam = camera.make_intrinsics(img_size, cc, 1.95, kk, dtype=dtype)
    mit = dict(max_undetected_frames=60, covar_diag_inflation=1e-6)
    params = make_params(cam, None, dt=1.0,
                         process_noise_lin_veloc_std=0.075,
                         process_noise_ang_veloc_std=0.01,
                         dtype=dtype, **(mit if args.mitigations else {}))
    if args.mode == "imageseq":
        sc = build_imageseq_scenario(capacity=K, dtype=dtype,
                                     image_size=(640, 480))
        st = init_state(K, dtype=dtype)
        st, templates = jax.jit(lambda s: init_imageseq(params, sc, s, 15))(st)
        run_img = make_imageseq_scan_runner(params, templ_width=15)
        run = lambda st_, fr: run_img(st_, templates, sc, fr)  # noqa: E731
    else:
        sc = build_oscillating_scenario(capacity=K, dtype=dtype)
        st = init_state(K, dtype=dtype)
        st = jax.jit(lambda s, k: init_with_gt_landmarks(params, sc, s, k))(
            st, jax.random.PRNGKey(0))
        run_osc = make_scan_runner(params, update_impl=1)

        def run(st_, fr):
            # n is the PER-FRAME accepted-match count from the runner (the
            # round-3 advisor flagged the old end-of-chunk active-count
            # broadcast: it made the suite's tracking guard vacuous)
            st2, errs, n, pos = run_osc(st_, sc, fr,
                                        jax.random.PRNGKey(int(fr[0])))
            return st2, (errs, n, pos)

    F = int(sc.gt_cfw_R.shape[0])
    pos_chunks, n_chunks_l = [], []
    done = 0
    while done < args.frames:
        n = min(args.chunk, args.frames - done)
        fr = jnp.arange(1 + done, 1 + done + n)
        assert int(fr[-1]) < F, "scenario too short for --frames"
        st, (err, n_m, pos) = run(st, fr)
        pos_chunks.append(pos)
        n_chunks_l.append(n_m)
        done += n
        print(f"[{args.dtype}] frames {done}/{args.frames} "
              f"matched_med={int(jnp.median(n_m))}", file=sys.stderr,
              flush=True)

    pos = jnp.concatenate(pos_chunks)
    n_m = jnp.concatenate(n_chunks_l)
    fr_all = jnp.arange(1, 1 + args.frames)
    gt_pos = -jnp.einsum("fji,fj->fi", sc.gt_cfw_R[fr_all],
                         sc.gt_cfw_t[fr_all])
    finite = bool(jnp.all(jnp.isfinite(st.x)) & jnp.all(jnp.isfinite(pos)))
    ate = float(aligned_rmse(pos, gt_pos)) if finite else float("nan")
    # degradation indicators for the unmitigated-f32 control: WHERE the run
    # failed (first frame with a non-finite camera position) and how
    # indefinite the final covariance is (most-negative diagonal entry, a
    # proxy for the innovation losing positive-definiteness)
    bad = jnp.logical_not(jnp.all(jnp.isfinite(pos), axis=-1))
    first_bad = int(jnp.argmax(bad)) if bool(jnp.any(bad)) else -1
    dg = jnp.diag(st.P)
    min_diag = float(jnp.min(jnp.where(jnp.isfinite(dg), dg, -jnp.inf)))
    print(json.dumps({
        "dtype": args.dtype,
        "mitigations": bool(args.mitigations),
        "capacity": K,
        "frames": args.frames,
        "ate_rmse": round(ate, 6),
        "matched_med": int(jnp.median(n_m)),
        "finite": finite,
        "first_bad_frame": first_bad,
        "min_diag_P": min_diag,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
