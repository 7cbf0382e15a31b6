"""Stage profile of the churned K-landmark imageseq frame (bench.py's
`imageseq_fps_k768` loop, world/bench_configs.churned_imageseq).

Two views of the same frame:

- the full frame (render -> Jacobians + search ellipse -> NCC search ->
  Shi-Tomasi recruitment -> fused update+health+recruit+predict) timed as
  one lax.scan, and each stage alone in a lax.scan of its own on frozen
  inputs, with jax.block_until_ready;
- with ``--trace DIR``: a jax.profiler trace of the warmed full-frame scan,
  reduced to device time per named stage (utils.profiling.
  device_time_by_scope) and the device idle share; the reduction is printed
  as one JSON line and written to DIR/summary.json.

    python analysis/profile_imageseq_frame.py [--capacity 768]
        [--points 1024] [--iters 60] [--trace DIR]

XLA:GPU wraps runs of kernels into command buffers (CUDA graphs), which the
trace shows as single "command_buffer" events with no scope; for a trace
that attributes every kernel, run with
XLA_FLAGS=--xla_gpu_enable_command_buffer= (the frame time printed beside it
is then the one without command buffers).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

SCOPES = ("render", "predict_ellipse", "ncc_search", "detect_corners",
          "fused_update")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--capacity", type=int, default=768)
    ap.add_argument("--points", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=60)
    ap.add_argument("--trace", default=None,
                    help="directory for a profiler trace of the full frame")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    jax.config.update("jax_default_matmul_precision", "highest")

    from surikatoko_tpu.models.monoslam import fused_step, measure, update
    from surikatoko_tpu.ops.ncc import ncc_search
    from surikatoko_tpu.utils.compile_cache import enable_compile_cache
    from surikatoko_tpu.utils.profiling import (device_time_by_scope,
                                                median_wall_time)
    from surikatoko_tpu.vision import features
    from surikatoko_tpu.world import bench_configs as cfgs
    from surikatoko_tpu.world.device_runner import (
        make_imageseq_scan_runner, render_frame)

    enable_compile_cache()
    dev = jax.devices()[0]
    Kcap, N = args.capacity, args.iters
    params, sc, state, templates = cfgs.churned_imageseq(Kcap, args.points)
    dtype = state.x.dtype
    print(f"device {dev.platform} {dev.device_kind}; K={Kcap} "
          f"D={state.x.shape[0]} N={N} iters/scan", flush=True)

    def median_time(fn, *a):
        jax.block_until_ready(fn(*a))               # compile + warm
        return median_wall_time(lambda: fn(*a))

    def timed(name, body, init):
        run = jax.jit(lambda c: jax.lax.scan(
            lambda c, _: (body(c), None), c, None, length=N)[0])
        dt = median_time(run, init) / N
        print(f"{name:36s} {dt * 1e3:9.3f} ms/iter", flush=True)
        return dt

    # ---- full frame, warmed into the churn regime ----
    run_full = make_imageseq_scan_runner(params, **cfgs.CHURN_RUNNER)
    frames = jnp.arange(1, 1 + N)
    st_w, tm_w, _ = jax.block_until_ready(
        run_full(state, templates, sc, frames))
    full = median_time(run_full, st_w, tm_w, sc, frames) / N
    print(f"{'FULL churned frame_body':36s} {full * 1e3:9.3f} ms/iter",
          flush=True)

    if args.trace:
        compiled = run_full.lower(st_w, tm_w, sc, frames).compile()
        jax.block_until_ready(compiled(st_w, tm_w, sc, frames))
        with jax.profiler.trace(args.trace):
            jax.block_until_ready(compiled(st_w, tm_w, sc, frames))
        xplane = sorted(glob.glob(os.path.join(
            args.trace, "**", "*.xplane.pb"), recursive=True))[-1]
        prefix = "/device:GPU" if dev.platform == "gpu" else "/host:CPU"
        red = device_time_by_scope(xplane, compiled.as_text(), SCOPES,
                                   plane_prefix=prefix)
        busy = red["busy_ns"] or 1.0
        summary = {"device": dev.device_kind, "capacity": Kcap,
                   "frames": N, "frame_ms_wall": full * 1e3,
                   "window_ms": red["window_ns"] / 1e6,
                   "busy_ms": red["busy_ns"] / 1e6,
                   "idle_share": red["idle_share"],
                   "stage_ms_per_frame": {
                       k: v / 1e6 / N for k, v in red["by_scope"].items()},
                   "stage_share_of_busy": {
                       k: v / busy for k, v in red["by_scope"].items()},
                   "n_events": red["n_events"],
                   "top_unscoped": red["top_unscoped"],
                   "lines": red["lines"][:12]}
        with open(os.path.join(args.trace, "summary.json"), "w") as f:
            json.dump(summary, f, indent=1)
        print(json.dumps(summary), flush=True)

    # ---- each stage alone, on frozen inputs from the warmed state ----
    x, P = st_w.x, st_w.P
    f1 = jnp.asarray(1)
    img0 = jax.jit(lambda: render_frame(params, sc, f1))()
    h0, Hcam0, Hlm0 = jax.jit(
        lambda xx: measure.measurement_jacobians(params, xx))(x)
    A0 = jax.jit(lambda PP: update.hp_auto(Hcam0, Hlm0, PP))(P)
    T0 = jax.jit(lambda: update.aht_auto(A0, Hcam0, Hlm0))()
    eye2 = jnp.eye(2, dtype=dtype)

    timed("scan floor (P pass-through)",
          lambda c: (c[0] + 1e-30, c[1] * 1.0), (x, P))

    def render_only(c):
        img = render_frame(params, sc, f1)
        return c[0].at[0].add(img[0, 0] * 1e-20), c[1]
    timed("  render_frame 640x480", render_only, (x, P))

    def jac_only(c):
        h, Hcam, Hlm = measure.measurement_jacobians(params, c[0])
        return c[0] + (h.sum() + Hcam.sum() + Hlm.sum()) * 1e-20, c[1]
    timed("  jacobians", jac_only, (x, P))

    def a_only(c):
        A = update.hp_auto(Hcam0, Hlm0, c[1])
        return c[0].at[:13].add(A[0, :13] * 1e-20), c[1]
    timed("  A = H P", a_only, (x, P))

    def t_only(c):
        T = update.aht_auto(A0 + c[0][0] * 1e-30, Hcam0, Hlm0)
        return c[0].at[:13].add(T[0, :13] * 1e-20), c[1]
    timed("  T = A H^T", t_only, (x, P))

    T_blocks = T0.reshape(Kcap, 2, Kcap, 2)
    S2 = jnp.einsum("kikj->kij", T_blocks) + params.measurm_noise_var * eye2
    sigma_inv0 = jax.jit(jnp.linalg.inv)(S2)

    def ncc_only(c):
        res = ncc_search(
            img0 + c[0][0] * 1e-30, h0, tm_w, st_w.lm_active,
            search_radius=7, min_corr_coeff=0.6, sigma_inv=sigma_inv0,
            chi2_gate=5.99146)
        return c[0].at[:2].add(res.best_center[0] * 1e-20), c[1]
    t_ncc = timed("  ncc_search", ncc_only, (x, P))
    print(f"ncc_search alone / full frame: {t_ncc / full:.4f}", flush=True)

    def detect_only(c):
        xy, ok = features.detect_corners(
            img0 + c[0][0] * 1e-30, max_corners=64, nms_radius=5,
            border=15, quality_level=0.05)
        return c[0].at[:2].add(xy[0] * 1e-20), c[1]
    timed("  detect_corners (recruit)", detect_only, (x, P))

    cand0 = jnp.broadcast_to(jnp.asarray([50.0, 50.0], dtype), (12, 2))
    valid0 = jnp.ones((12,), bool)
    free0 = ~st_w.lm_active

    def recruit_only(c):
        x2, P2, resid, _, slots = (
            fused_step.fused_update_health_recruit_predict(
                params, c[0], c[1], h0, st_w.lm_active, cand0, valid0, free0,
                precomputed=(h0, A0, T0),
                deactivate_mask=jnp.zeros((Kcap,), bool)))
        return x2, P2 * 0 + c[1]
    timed("  fused update + RECRUIT(12) + predict", recruit_only, (x, P))


if __name__ == "__main__":
    main()
