"""Measure churned-imageseq accuracy (K=768 bench config) across recruit
options: flat-prior depth vs median-tracked depth x subpixel NCC on/off.

Each variant runs the bench's exact warm+measure windows and reports ATE
over the measured window plus churn stats: it decides whether the bench
runner should enable subpixel NCC and which recruit depth prior it uses.

Usage: python analysis/measure_churn_accuracy.py [--variants a,b,c,d]
  a = prior depth, no subpixel   (round-4 bench behavior)
  b = prior depth, subpixel
  c = median depth, no subpixel
  d = median depth, subpixel
"""

from __future__ import annotations

import argparse
import sys
import time


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--variants", default="a,b,c,d")
    p.add_argument("--smoke", action="store_true")
    args = p.parse_args()

    import jax
    import jax.numpy as jnp

    jax.config.update("jax_default_matmul_precision", "highest")

    from surikatoko_tpu.geom import camera
    from surikatoko_tpu.geom.align import aligned_rmse
    from surikatoko_tpu.models.monoslam import make_params, init_state
    from surikatoko_tpu.world.device_runner import (
        build_imageseq_scenario, init_imageseq, make_imageseq_scan_runner)

    dtype = jnp.float32
    K_big = 48 if args.smoke else 768
    cam_big = camera.make_intrinsics((640, 480), (320.0, 240.0), 1.95,
                                     (0.005, 0.005), dtype=dtype)

    def mk_params(max_undet=30):
        return make_params(cam_big, None, dt=1.0,
                           process_noise_lin_veloc_std=0.075,
                           process_noise_ang_veloc_std=0.01,
                           sal_pnt_init_inv_dist=0.5,
                           sal_pnt_init_inv_dist_std=0.5,
                           max_undetected_frames=max_undet,
                           covar_diag_inflation=1e-6, dtype=dtype)

    params_big = mk_params()
    sc_big = build_imageseq_scenario(capacity=K_big, dtype=dtype,
                                     image_size=(640, 480),
                                     n_points=64 if args.smoke else 1024,
                                     bg_cell=48, max_deviation=0.8,
                                     world="wide")
    CH = 20 if args.smoke else 120
    fr_warm = jnp.arange(1, 1 + CH)
    fr_timed = jnp.arange(1 + CH, 1 + 2 * CH)
    gt_pos = -jnp.einsum("fji,fj->fi", sc_big.gt_cfw_R[fr_timed],
                         sc_big.gt_cfw_t[fr_timed])

    # runner-kwargs overrides + (max_undet, recruit_max) per variant
    cfgs = {
        "a": (dict(recruit_depth="prior", subpixel=False), 30, 12),
        "b": (dict(recruit_depth="prior", subpixel=True), 30, 12),
        "c": (dict(recruit_depth="median", subpixel=False), 30, 12),
        "d": (dict(recruit_depth="median", subpixel=True), 30, 12),
        # retention ladder: GT-bootstrapped anchors leaving the FOV get
        # deleted after max_undet frames and re-recruited at prior depth —
        # longer retention should cut the scale drift that churn adds
        "e": (dict(recruit_depth="prior", subpixel=False), 60, 12),
        "f": (dict(recruit_depth="prior", subpixel=False), 120, 12),
        "g": (dict(recruit_depth="prior", subpixel=True), 120, 12),
        # churn-rate ladder: fewer recruits/frame = better-observed ones
        "h": (dict(recruit_depth="prior", subpixel=False), 30, 6),
        # spatially-local depth prior (median rho of the 8 nearest tracked
        # slots in pixel space): the global median fails because one number
        # can't represent a strip whose depth varies; the local field can
        "k": (dict(recruit_depth="local", subpixel=False), 30, 12),
        "l": (dict(recruit_depth="local", subpixel=True), 30, 12),
        # controls: is the ATE churn-caused at all, or is the wide world
        # just harder? i = stranded (delete on, no recruit); j = frozen
        # set (no delete, no recruit — the unmitigated control + inflation)
        "i": (dict(recruit=False), 30, 0),
        "j": (dict(recruit=False), 0, 0),
    }
    for v in args.variants.split(","):
        cfg, max_undet, rec_max = cfgs[v]
        params_v = mk_params(max_undet)
        st = init_state(K_big, dtype=dtype)
        st, templates = jax.jit(lambda s: init_imageseq(
            params_v, sc_big, s, 15))(st)
        kw = dict(recruit=True, recruit_max=max(rec_max, 1),
                  detector_corners=64)
        kw.update(cfg)
        recruiting = kw["recruit"]
        run = make_imageseq_scan_runner(
            params_v, templ_width=15, **kw)
        t0 = time.time()
        if recruiting:
            st_w, tm_w, _ = run(st, templates, sc_big, fr_warm)
        else:
            st_w, _ = run(st, templates, sc_big, fr_warm)
            tm_w = templates
        jax.block_until_ready(st_w)
        t_warm = time.time() - t0
        t0 = time.time()
        if recruiting:
            st2, _, (err, n, pos, nrec, nact) = run(st_w, tm_w, sc_big,
                                                    fr_timed)
        else:
            st2, (err, n, pos) = run(st_w, tm_w, sc_big, fr_timed)
            nrec = jnp.zeros((1,), jnp.int32)
            nact = jnp.sum(st2.lm_active.astype(jnp.int32))[None]
        jax.block_until_ready(st2)
        t_run = time.time() - t0
        ate = float(aligned_rmse(pos, gt_pos))
        print(f"variant {v} mu={max_undet} rm={rec_max} {cfg}: "
              f"ate={ate:.4f} "
              f"matched_med={int(jnp.median(n))} "
              f"recruits={int(jnp.sum(nrec))} "
              f"active_med={int(jnp.median(nact))} "
              f"gen_max={int(jnp.max(st2.lm_generation))} "
              f"fps={CH / t_run:.1f} (warm+compile {t_warm:.0f}s)",
              flush=True)


if __name__ == "__main__":
    sys.exit(main())
