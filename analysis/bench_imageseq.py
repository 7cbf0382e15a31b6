"""On-device imageseq closed-loop throughput (render + NCC search + EKF),
without recruitment, at a chosen capacity.

    python analysis/bench_imageseq.py [--capacity 96]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--capacity", type=int, default=96)
    ap.add_argument("--chunk", type=int, default=300)
    ap.add_argument("--chunks", type=int, default=6)
    ap.add_argument("--big_image", action="store_true",
                    help="640x480 imagery (use for capacity >= ~384)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    jax.config.update("jax_default_matmul_precision", "highest")

    from surikatoko_tpu.geom import camera
    from surikatoko_tpu.models.monoslam import make_params, init_state
    from surikatoko_tpu.utils.profiling import median_wall_time
    from surikatoko_tpu.world.device_runner import (
        build_imageseq_scenario, init_imageseq, make_imageseq_scan_runner)

    dtype = jnp.float32
    big = args.big_image or args.capacity >= 384
    img_size = (640, 480) if big else (320, 240)
    sc = build_imageseq_scenario(capacity=args.capacity, dtype=dtype,
                                 image_size=img_size)
    cam = camera.make_intrinsics(
        img_size, (img_size[0] / 2.0, img_size[1] / 2.0), 1.95,
        (0.005, 0.005) if big else (0.01, 0.01), dtype=dtype)
    # large-K f32 conditioning (see CLAUDE.md / fused_step.py): delete
    # long-unobserved landmarks + tiny live-diagonal inflation
    cond = (dict(max_undetected_frames=60, covar_diag_inflation=1e-6)
            if args.capacity >= 384 else {})
    params = make_params(cam, None, dt=1.0,
                         process_noise_lin_veloc_std=0.075,
                         process_noise_ang_veloc_std=0.01, dtype=dtype,
                         **cond)
    state = init_state(args.capacity, dtype=dtype)
    templ_width = 15
    state, templates = jax.jit(
        lambda st: init_imageseq(params, sc, st, templ_width))(state)
    run = make_imageseq_scan_runner(params, templ_width=templ_width)

    F = int(sc.gt_cfw_R.shape[0])
    fr0 = jnp.arange(1, 1 + args.chunk)
    st, (err, n, pos) = run(state, templates, sc, fr0)
    jax.block_until_ready(st)
    assert bool(jnp.all(jnp.isfinite(err))), "non-finite residuals"
    from surikatoko_tpu.geom.align import aligned_rmse
    gt_pos = -jnp.einsum("fji,fj->fi", sc.gt_cfw_R[fr0], sc.gt_cfw_t[fr0])
    ate = float(aligned_rmse(pos, gt_pos))
    print(f"warmup: matched min={int(jnp.min(n))} max={int(jnp.max(n))} "
          f"err last={float(err[-1]):.3f}px ate_rmse={ate:.4f}")

    windows = [jnp.arange(lo, lo + args.chunk) for lo in
               (1 + ((c + 1) * args.chunk) % (F - args.chunk - 1)
                for c in range(args.chunks))]

    def chained():
        cur = st
        for fr in windows:
            cur, _out = run(cur, templates, sc, fr)
        return cur

    jax.block_until_ready(chained())
    dt = median_wall_time(chained)
    fps = args.chunks * args.chunk / dt
    print(f"imageseq on-device loop: {fps:.1f} frames/s "
          f"(K={args.capacity}) on {jax.devices()[0].device_kind}")


if __name__ == "__main__":
    main()
