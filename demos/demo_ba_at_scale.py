"""At-scale sparse bundle adjustment: the BASELINE "multi-view-factorization
at scale" configuration (10k+ landmarks, 500+ keyframes).

Builds a synthetic ring-of-cameras world with turntable-style visibility
(padded track length L per point), runs LM iterations of the sparse
scatter-add Schur solve, and reports iters/sec + error trajectory.

Usage: python demos/demo_ba_at_scale.py [--points 10000] [--frames 500]
    [--track_len 12] [--iters 5] [--f32]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def build_problem(n_points, n_frames, L, noise_pix, seed, dtype,
                  return_host_inputs=False):
    import numpy as np
    import jax.numpy as jnp
    from surikatoko_tpu.models.ba import sparse

    rng = np.random.default_rng(seed)
    # points on a noisy cylinder, cameras on a surrounding ring
    ang = rng.uniform(0, 2 * np.pi, n_points)
    rad = 2.0 + rng.normal(scale=0.3, size=n_points)
    z = rng.uniform(0, 3.0, n_points)
    pts = np.stack([rad * np.cos(ang), rad * np.sin(ang), z], axis=1)

    K = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1.0]])
    cam_angle = np.linspace(0, 2 * np.pi, n_frames, endpoint=False)
    from surikatoko_tpu.geom import se3 as se3_mod
    Rs, ts = [], []
    for a in cam_angle:
        eye = np.array([8.0 * np.cos(a), 8.0 * np.sin(a), 1.5])
        wfc = se3_mod.look_at_luf_wfc(
            jnp.asarray(eye), jnp.asarray([0.0, 0, 1.5]),
            jnp.asarray([0.0, 0, 1]))
        cfw = wfc.inv()
        Rs.append(np.asarray(cfw.R))
        ts.append(np.asarray(cfw.t))
    Rs, ts = np.stack(Rs), np.stack(ts)

    # visibility: each point seen from a contiguous arc of L cameras facing it
    obs = np.zeros((n_points, L, 2))
    fidx = np.zeros((n_points, L), np.int32)
    mask = np.zeros((n_points, L), bool)
    facing = (np.arctan2(pts[:, 1], pts[:, 0]) / (2 * np.pi) * n_frames).astype(int)
    for l in range(L):
        f = (facing + l) % n_frames
        xc = np.einsum("fij,fj->fi", Rs[f], pts) + ts[f]
        ph = xc @ K.T
        pix = ph[:, :2] / ph[:, 2:3]
        ok = xc[:, 2] > 0.5
        obs[:, l] = pix + rng.normal(scale=noise_pix, size=pix.shape)
        fidx[:, l] = f
        mask[:, l] = ok

    ps = sparse.BAProblemSparse(
        points=jnp.asarray(pts + rng.normal(scale=0.01, size=pts.shape), dtype),
        cfw_R=jnp.asarray(Rs, dtype), cfw_t=jnp.asarray(ts, dtype),
        K=jnp.broadcast_to(jnp.asarray(K, dtype), (n_frames, 3, 3)),
        obs=jnp.asarray(obs, dtype), frame_idx=jnp.asarray(fidx),
        obs_mask=jnp.asarray(mask), f0=jnp.asarray(1.0, dtype))
    if return_host_inputs:
        # host copies of (frame_idx, obs_mask) for
        # SparseBundleAdjustment.set_plan_inputs: the banding plan is built
        # on the host, so it needs no fetch of the device arrays
        return ps, fidx, mask
    return ps


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=10_000)
    ap.add_argument("--frames", type=int, default=500)
    ap.add_argument("--track_len", type=int, default=12)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--noise_pix", type=float, default=0.5)
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--device_loop", action="store_true",
                    help="run the WHOLE LM compiled on device (one dispatch;"
                         " no per-iteration host round-trips)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from surikatoko_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if args.f32:
        jax.config.update("jax_default_matmul_precision", "highest")
        dtype = jnp.float32
    else:
        jax.config.update("jax_enable_x64", True)
        dtype = jnp.float64
    from surikatoko_tpu.models.ba import sparse

    ps = build_problem(args.points, args.frames, args.track_len,
                       args.noise_pix, 0, dtype)
    n_obs = int(jnp.sum(ps.obs_mask))
    print(f"points={ps.n_points} frames={ps.n_frames} obs={n_obs} "
          f"reduced system={10*ps.n_frames}x{10*ps.n_frames} dtype={dtype.__name__}")

    err_fn = jax.jit(sparse.reproj_error)
    blocks_fn = jax.jit(sparse.compute_blocks)

    # banded Gram reduction when the track structure is mostly frame-local
    plan = sparse.plan_bands(ps.frame_idx, ps.obs_mask,
                             point_chunk=2048, n_frames=ps.n_frames)
    if plan is not None:
        print(f"banded Schur: band width {plan.band_width} of "
              f"{ps.n_frames} frames, {plan.n_banded_chunks} banded + "
              f"{(plan.ext_idx.shape[0] - plan.n_banded_chunks * plan.point_chunk) // plan.overflow_chunk} overflow chunks")

    @jax.jit
    def lm_iter(p, factor):
        b = sparse.compute_blocks(p)
        if plan is not None:
            dX, du, ok = sparse.solve_corrections_schur_banded(
                p, b, factor, plan)
        else:
            dX, du, ok = sparse.solve_corrections_schur_sparse(p, b, factor)
        return sparse.apply_corrections(p, dX, du), ok

    err0 = float(err_fn(ps))
    print(f"initial err={err0:.6g} ({(err0/max(n_obs,1))**0.5:.3f} pix/obs rms)")

    if args.device_loop:
        from surikatoko_tpu.models.ba import SparseBundleAdjustment, TermCriteria
        ba = SparseBundleAdjustment(device_loop=True)
        term = TermCriteria(allowed_reproj_err_rel_change=None,
                            max_iters=args.iters)
        t0 = time.time()
        jax.block_until_ready(ba.compute(ps, term))     # compile + run
        print(f"compile+full LM: {time.time()-t0:.1f}s "
              f"iters={ba.iterations} reason='{ba.stop_reason}'")
        t0 = time.time()
        ok, ps1 = jax.block_until_ready(ba.compute(ps, term))
        dt = time.time() - t0
        e1 = float(err_fn(ps1))
        print(f"{ba.iterations} LM iters in ONE dispatch: {dt:.2f}s = "
              f"{ba.iterations/dt:.2f} iters/s "
              f"(final rms {(e1/max(n_obs,1))**0.5:.4f} pix)")
        return 0

    # warmup/compile
    t0 = time.time()
    ps_try, ok = lm_iter(ps, 1e-4)
    jax.block_until_ready(ps_try.points)
    print(f"compile+first iter: {time.time()-t0:.1f}s ok={bool(ok)}")

    factor = 1e-4
    err = err0
    t0 = time.time()
    done = 0
    for it in range(args.iters):
        ps_try, ok = lm_iter(ps, factor)
        e = float(err_fn(ps_try))
        if e < err:
            ps, err, factor = ps_try, e, factor / 10
        else:
            factor *= 10
        done += 1
        print(f"iter {it}: err={err:.6g} ({(err/max(n_obs,1))**0.5:.4f} pix rms) "
              f"factor={factor:.1e}")
    dt = time.time() - t0
    print(f"{done} LM iters in {dt:.2f}s = {done/dt:.2f} iters/s "
          f"(final rms {(err/max(n_obs,1))**0.5:.4f} pix)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
