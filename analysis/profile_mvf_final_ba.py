"""Why does the MVF in-pipeline/final BA run 0.48 iters/s when the 10k x 500
synthetic runs 16.8 (VERDICT r4 item 3)?

Reconstructs the final-BA shape of the bench MVF run (2048+revisit points
bucket-padded to 4096, 140 frames, track L<=16, frame-local arcs) and times
SparseBundleAdjustment(device_loop=True) across solver configs:

  pc2048-band   the round-4 bench configuration (degenerate band: 2 chunks
                of 2048 -> each spans nearly all frames, W~139)
  pc2048-noband full-width solver, same chunking
  pc256-band    chunks small enough for banding to engage
  pc256-noband  full-width with small chunks

Usage: python analysis/profile_mvf_final_ba.py [--smoke]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "demos"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()

    import numpy as np
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_default_matmul_precision", "highest")

    from demo_ba_at_scale import build_problem
    from surikatoko_tpu.models.ba import SparseBundleAdjustment, TermCriteria

    dtype = jnp.float32
    NP_, F_, L_ = (256, 40, 8) if args.smoke else (2240, 140, 12)
    ps, fidx, mask = build_problem(NP_, F_, L_, noise_pix=0.5, seed=0,
                                   dtype=dtype, return_host_inputs=True)
    # bucket-pad points 2240 -> 4096 like the MVF final BA (masked rows)
    pad = (4096 if not args.smoke else 512) - NP_
    ps = ps._replace(
        points=jnp.concatenate([ps.points,
                                jnp.zeros((pad, 3), dtype)]),
        obs=jnp.concatenate([ps.obs, jnp.zeros((pad, L_, 2), dtype)]),
        frame_idx=jnp.concatenate([ps.frame_idx,
                                   jnp.zeros((pad, L_), jnp.int32)]),
        obs_mask=jnp.concatenate([ps.obs_mask,
                                  jnp.zeros((pad, L_), bool)]))
    fidx = np.concatenate([fidx, np.zeros((pad, L_), np.int32)])
    mask = np.concatenate([mask, np.zeros((pad, L_), bool)])

    # perturb so the LM has real work (the synthetic starts near-converged)
    rng = np.random.default_rng(1)
    ps = ps._replace(points=ps.points + jnp.asarray(
        rng.normal(scale=0.02, size=(ps.points.shape[0], 3)), dtype))

    from surikatoko_tpu.models.ba import normalize
    uci = next(c for c in (1, 0, 2) if normalize.can_normalize(ps, c))

    term = TermCriteria(allowed_reproj_err_rel_change=None,
                        max_iters=args.iters)
    for name, pc, band in (("pc2048-band", 2048, True),
                           ("pc2048-noband", 2048, False),
                           ("pc256-band", 256, True),
                           ("pc256-noband", 256, False)):
        ba = SparseBundleAdjustment(optimize_intrinsics=False,
                                    point_chunk=pc, band=band,
                                    unity_comp_ind=uci,
                                    device_loop=True)
        ba.set_plan_inputs(fidx, mask)
        t0 = time.time()
        jax.block_until_ready(ba.compute_inplace(ps, term))
        t_first = time.time() - t0
        sig = getattr(ba, "_band_sig", None)
        t0 = time.time()
        jax.block_until_ready(ba.compute_inplace(ps, term))
        t_warm = time.time() - t0
        print(f"{name}: warm {t_warm:.2f}s = "
              f"{ba.iterations / max(t_warm, 1e-9):.2f} iters/s "
              f"({ba.iterations} it, {ba.trials} trials, "
              f"stop='{ba.stop_reason}'; "
              f"first+compile {t_first:.1f}s; plan {sig})", flush=True)


if __name__ == "__main__":
    main()
