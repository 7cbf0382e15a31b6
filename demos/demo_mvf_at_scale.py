"""At-scale incremental multi-view factorization: the BASELINE configs[4]
"multi-view-factorization at scale" run — 10k+ landmarks, 500+ keyframes,
driven through MultiViewIterativeFactorizer's per-frame pipeline (reference
multi-view-factorization.cpp:255-397) with the banded distributed-capable
sparse Schur BA (models/ba/sparse.py) instead of a dense observation grid.

The synthetic world is a ring of landmarks orbited once by the camera,
tracks frame-local (the banding-friendly structure real turntable/corridor
sequences have) and NON-wrapping — the chain stays open and visual-odometry
drift accumulates, exactly like a real monocular run. A short REVISIT
segment then re-enters the start region, re-detecting the head landmarks as
new tracks; place recognition pairs them with the originals — by default
APPEARANCE-BASED (steered-BRIEF over rendered frames, mutual-NN hamming,
similarity-RANSAC on the drifted map; vision/place_recognition.py), with
--oracle_pairs falling back to the GT oracle — and the accumulated Sim(3)
loop error closes through the pose graph
(MultiViewFactorizer.close_loop_sim3) before the final global BA.

Per frame: matcher writes corners -> anchor selection -> SVD-12 relative
motion + GN-PnP polish -> batched MASKS-8.44 triangulation of new tracks.
Sliding-window local BA runs every --window_ba_every frames; bucket-padded
global BA every --global_ba_every frames.

Usage: python demos/demo_mvf_at_scale.py [--points 10000] [--frames 500]
    [--track_len 12] [--f32]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=10_000)
    ap.add_argument("--frames", type=int, default=500)
    ap.add_argument("--track_len", type=int, default=12)
    ap.add_argument("--noise_pix", type=float, default=0.5)
    ap.add_argument("--window_ba_every", type=int, default=5,
                    help="sliding-window local BA cadence (frames)")
    ap.add_argument("--window", type=int, default=25)
    ap.add_argument("--global_ba_every", type=int, default=25,
                    help="periodic global sparse BA cadence (frames); "
                         "shapes are bucket-padded so reruns hit the jit "
                         "cache")
    ap.add_argument("--global_ba_iters", type=int, default=10)
    ap.add_argument("--final_polish_iters", type=int, default=40,
                    help="LM budget of the final convergence polish "
                         "(reported ATE comes from this state)")
    ap.add_argument("--revisit_frames", type=int, default=12,
                    help="frames of the loop-closure revisit segment")
    ap.add_argument("--oracle_pairs", action="store_true",
                    help="use the GT place-recognition oracle for closure "
                         "pairs (default: appearance-based steered-BRIEF + "
                         "similarity-RANSAC, vision/place_recognition.py)")
    ap.add_argument("--pr_ransac_thresh", type=float, default=0.25,
                    help="similarity-RANSAC inlier threshold (map units) "
                         "for appearance-based closure pairs")
    ap.add_argument("--ba_iters", type=int, default=5,
                    help="LM iterations of the timed final global BA")
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import jax

    from surikatoko_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if args.f32:
        jax.config.update("jax_default_matmul_precision", "highest")
    else:
        jax.config.update("jax_enable_x64", True)

    import json
    res = run_at_scale(args)
    print(json.dumps(res))
    return 0


def make_args(**overrides) -> argparse.Namespace:
    """Default parameter set of the at-scale run as a namespace —
    bench.py calls run_at_scale(make_args(points=..., frames=..., f32=True))
    in-process, so one process holds the card."""
    base = dict(points=10_000, frames=500, track_len=12, noise_pix=0.5,
                window_ba_every=5, window=25, global_ba_every=25,
                global_ba_iters=10, final_polish_iters=40,
                revisit_frames=12, oracle_pairs=False,
                pr_ransac_thresh=0.25, ba_iters=5, f32=False, seed=0)
    base.update(overrides)
    return argparse.Namespace(**base)


def run_at_scale(args: argparse.Namespace) -> dict:
    """The at-scale incremental MVF pipeline; returns the metrics dict
    (see module docstring). Caller owns jax precision/x64 configuration."""
    import numpy as np
    import jax
    import jax.numpy as jnp

    from surikatoko_tpu.geom import se3 as se3_mod
    from surikatoko_tpu.geom.align import aligned_rmse
    from surikatoko_tpu.geom.se3 import SE3
    from surikatoko_tpu.models.ba import TermCriteria
    from surikatoko_tpu.models.mvf import MultiViewFactorizer, TrackStore

    rng = np.random.default_rng(args.seed)
    n_pts, n_frames, L = args.points, args.frames, args.track_len

    # ---- world: noisy cylinder of points, camera ring facing inward ----
    ang = rng.uniform(0, 2 * np.pi, n_pts)
    rad = 2.0 + rng.normal(scale=0.3, size=n_pts)
    z = rng.uniform(0, 3.0, n_pts)
    pts_gt = np.stack([rad * np.cos(ang), rad * np.sin(ang), z], axis=1)
    K = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1.0]])
    K_inv = np.linalg.inv(K)
    n_base = n_frames
    n_total = n_base + args.revisit_frames
    Rs, ts_gt = [], []
    for k in range(n_total):
        a = 2 * np.pi * (k % n_base) / n_base  # revisit repeats the start
        eye = np.array([8.0 * np.cos(a), 8.0 * np.sin(a), 1.5])
        wfc = se3_mod.look_at_luf_wfc(
            jnp.asarray(eye), jnp.asarray([0.0, 0, 1.5]),
            jnp.asarray([0.0, 0, 1]))
        cfw = wfc.inv()
        Rs.append(np.asarray(cfw.R))
        ts_gt.append(np.asarray(cfw.t))
    Rs, ts_gt = np.stack(Rs), np.stack(ts_gt)
    # base orbit: point i seen in frames facing[i]..facing[i]+L-1, NO wrap
    # (the chain stays open; drift accumulates like a real monocular run);
    # the revisit re-detects head landmarks as NEW track ids
    facing = (ang / (2 * np.pi) * n_base).astype(int)
    frame_pts = [[] for _ in range(n_total)]
    for i in range(n_pts):
        for l in range(L):
            f = facing[i] + l
            if f < n_base:
                frame_pts[f].append(i)
    for f in range(n_base, n_total):
        fm = f % n_base
        for i in np.nonzero((fm - facing) % n_base < L)[0]:
            frame_pts[f].append(int(i))

    ts = TrackStore(max_tracks=2 * n_pts, max_frames=n_total,
                    max_track_len=2 * L)
    mvf = MultiViewFactorizer(
        track_store=ts, K=K, use_sparse_ba=True,
        ba_trigger_reproj_err=float("inf"),   # BA on our own schedule
        ba_term_rel_change=None, ba_max_iters=args.global_ba_iters,
        ba_point_bucket=2048, ba_frame_bucket=100)
    obs_bytes = ts.pixels.nbytes + ts.coords.nbytes + ts.fidx.nbytes
    dense_bytes = n_pts * n_total * (2 * 8 + 1)
    print(f"points={n_pts} frames={n_total} (base {n_base} + revisit "
          f"{args.revisit_frames}) L={L} store={obs_bytes/1e6:.0f}MB "
          f"(dense grid would be {dense_bytes/1e6:.0f}MB, "
          f"{100.0*L/n_base:.2f}% occupied)", flush=True)

    # ---- world appearance (for appearance-based place recognition):
    # every landmark has its own splat brightness/width — world content,
    # not track identity; the closure pairs must be recovered from rendered
    # pixels by the descriptor pipeline, not read from an oracle ----
    amps = rng.uniform(80.0, 200.0, n_pts)
    sigmas = rng.uniform(1.6, 2.6, n_pts)
    bg_img = rng.uniform(20.0, 60.0, size=(480, 640))
    bg_img = (bg_img + np.roll(bg_img, 1, 0) + np.roll(bg_img, 1, 1)
              + np.roll(bg_img, -1, 0) + np.roll(bg_img, -1, 1)) / 5.0

    def render_frame_np(f, ids, pix_true, ok):
        """640x480 frame: textured background + per-landmark splats at the
        TRUE projections (detection noise perturbs keypoints, not photons).
        Separable contraction Ey^T diag(a) Ex — one [H,K]@[K,W] matmul over
        all splats (the device renderer's formulation); the per-landmark
        outer-product loop this replaces cost ~minutes of the closure
        phase at the 10k scale."""
        H, W = bg_img.shape
        ids = np.asarray(ids, int)
        vis = (np.asarray(ok, bool)
               & (pix_true[:, 0] >= 0) & (pix_true[:, 0] < W)
               & (pix_true[:, 1] >= 0) & (pix_true[:, 1] < H))
        s2 = 2.0 * sigmas[ids % n_pts] ** 2                     # [K]
        xs = np.arange(W)[None, :]
        ys = np.arange(H)[None, :]
        ex = np.exp(-(xs - pix_true[:, 0:1]) ** 2 / s2[:, None])  # [K,W]
        ey = np.exp(-(ys - pix_true[:, 1:2]) ** 2 / s2[:, None])  # [K,H]
        a = amps[ids % n_pts] * vis
        img = bg_img + (ey * a[:, None]).T @ ex
        return np.clip(img, 0, 255)

    pr_head_obs: list = []      # (image, keypoints, tids) for head frames
    pr_tail_obs: list = []      # ... for revisit re-detections
    collect_pr = args.revisit_frames and not args.oracle_pairs
    n_head_frames = min(12, max(6, args.revisit_frames))

    def write_corners(f):
        Rf, tf = Rs[f], ts_gt[f]
        ids = np.asarray(frame_pts[f], int)
        xc = pts_gt[ids] @ Rf.T + tf
        ok = xc[:, 2] > 0.5
        ph = xc @ K.T
        pix_true = ph[:, :2] / ph[:, 2:3]
        pix = pix_true + rng.normal(
            scale=args.noise_pix, size=(len(ids), 2))
        head = facing[ids] < n_base // 2
        kept = []           # (tid_w, noisy pixel) of every written corner
        for tid, p, o, hd in zip(ids, pix, ok, head):
            if o:
                # revisit: head-region landmarks re-detected as new tracks
                tid_w = int(tid) + n_pts if (f >= n_base and hd) else int(tid)
                ts.add_corner(tid_w, f, p, K_inv)
                kept.append((tid_w, p))
        if collect_pr and (f < n_head_frames or f >= n_base):
            if f >= n_base:     # tail group: only the re-detections
                kept = [(t, p) for t, p in kept if t >= n_pts]
            if kept:
                img = render_frame_np(f, ids, pix_true, ok)
                (pr_tail_obs if f >= n_base else pr_head_obs).append(
                    (img, np.stack([p for _, p in kept]),
                     [t for t, _ in kept]))

    n_frames = n_total
    t_int0 = time.time()
    ba_time = 0.0
    n_fail = 0
    for f in range(n_frames):
        write_corners(f)
        if f < 2:
            mvf.add_known_frame(SE3(jnp.asarray(Rs[f]), jnp.asarray(ts_gt[f])))
            for tid in ts.tracks_in_frame(f):
                mvf.set_known_point(int(tid), pts_gt[tid])
            continue
        ok = mvf.integrate_new_frame_corners()
        if not ok:
            # keep frame/pose indices aligned: constant-position fallback
            n_fail += 1
            mvf.add_known_frame(SE3(jnp.asarray(mvf.cam_cfw_R[-1]),
                                    jnp.asarray(mvf.cam_cfw_t[-1])))
        if args.window_ba_every and (f + 1) % args.window_ba_every == 0:
            tb = time.time()
            mvf.run_windowed_ba(window=args.window)
            ba_time += time.time() - tb
        if args.global_ba_every and (f + 1) % args.global_ba_every == 0:
            tb = time.time()
            mvf._run_ba()     # bucket-padded: reruns hit the jit cache
            ba_time += time.time() - tb
        if (f + 1) % 100 == 0:
            print(f"frame {f}: map={len(mvf.point_coords)} "
                  f"ba_runs={mvf.ba_runs} fails={n_fail} "
                  f"ba_time={ba_time:.0f}s", flush=True)
    t_integrate = time.time() - t_int0 - ba_time
    fps = (n_frames - 2) / t_integrate

    # ---- Sim(3) loop closure from the revisit's re-detected landmarks ----
    pos_gt_all = np.stack([-R.T @ t for R, t in zip(Rs, ts_gt)])

    def _traj_ate():
        pos = np.stack([-R.T @ t
                        for R, t in zip(mvf.cam_cfw_R, mvf.cam_cfw_t)])
        return float(aligned_rmse(jnp.asarray(pos), jnp.asarray(pos_gt_all)))

    ate_pre_closure = _traj_ate()
    closed = False
    n_pr_cand = 0
    n_pairs = 0
    n_correct = -1           # -1 = oracle pairs (correctness not measured)
    if args.revisit_frames:
        tb = time.time()
        if args.oracle_pairs:
            pairs = [(n_pts + i, i) for i in range(n_pts)]
        else:
            # appearance-based place recognition: steered-BRIEF over the
            # rendered head/revisit frames -> mutual-NN hamming -> similarity
            # RANSAC over the drifted map positions (no GT oracle)
            from surikatoko_tpu.vision import place_recognition as pr
            head_td = pr.describe_tracks(pr_head_obs)
            tail_td = pr.describe_tracks(pr_tail_obs)
            cand = pr.match_track_groups(tail_td, head_td)
            n_pr_cand = len(cand)
            positions = {t: np.asarray(c)
                         for t, c in mvf.point_coords.items()}
            pairs = pr.find_loop_pairs(
                tail_td, head_td, positions,
                ransac_threshold=args.pr_ransac_thresh)
            n_correct = sum(1 for a, b in pairs if a - n_pts == b)
            print(f"place recognition: {tail_td.tids.size} revisit x "
                  f"{head_td.tids.size} head tracks -> {n_pr_cand} "
                  f"appearance candidates -> {len(pairs)} RANSAC-verified "
                  f"pairs ({n_correct} correct)", flush=True)
        n_pairs = len(pairs)
        closed, n_common = mvf.close_loop_sim3(
            tail_frames=range(n_base, n_frames), head_frames=range(6),
            pairs=pairs, run_ba=False)
        print(f"sim3 loop closure: ok={closed} pairs={n_common} "
              f"traj_ate {ate_pre_closure:.3f} -> {_traj_ate():.3f} "
              f"({time.time()-tb:.1f}s)", flush=True)

    # timed final BA with a fixed iteration budget (the iters/s headline).
    # device_loop: the whole LM (incl. damping retries) is ONE device
    # dispatch — the host-driven loop pays 2 blocking host syncs per
    # damped trial
    term = TermCriteria(allowed_reproj_err_rel_change=None,
                        max_iters=args.ba_iters)
    tids, p = mvf._sparse_problem(pad_points=8)
    from surikatoko_tpu.models.ba import SparseBundleAdjustment
    ba = SparseBundleAdjustment(optimize_intrinsics=False,
                                point_chunk=mvf.ba_point_chunk,
                                unity_comp_ind=mvf._unity_comp_ind(),
                                device_loop=True)
    # band planning from the host-side observation structure (no fetch of
    # the device arrays)
    ba.set_plan_inputs(*mvf._last_sparse_inputs)
    t0 = time.time()
    ok, p_opt = jax.block_until_ready(
        ba.compute_inplace(p, term))            # includes compile
    t_compile = time.time() - t0
    plan = getattr(ba, "_band_sig", None)
    print(f"final BA band plan (W, banded chunks, ovf chunk, pc, ext): "
          f"{plan}", flush=True)
    # two warm reps, keep the best
    t_reps = []
    for _ in (1, 2):
        t0 = time.time()
        ok, p_opt = jax.block_until_ready(ba.compute_inplace(p, term))
        t_reps.append(time.time() - t0)
    t_ba = min(t_reps)
    print(f"final BA warm reps: {[f'{t:.2f}s' for t in t_reps]}", flush=True)
    n_timed = ba.iterations
    n_trials = ba.trials
    iters_per_s = n_timed / max(t_ba, 1e-9)

    # convergence polish for the reported accuracy (not timed as headline)
    if args.final_polish_iters:
        ok, p_opt = ba.compute_inplace(p_opt, TermCriteria(
            allowed_reproj_err_rel_change=None,
            max_iters=args.final_polish_iters))
        print(f"final polish: {ba.iterations} iters "
              f"reason='{ba.stop_reason}'")

    # read back + report
    pts_np, R_o, t_o = jax.device_get(
        (p_opt.points, p_opt.cfw_R, p_opt.cfw_t))
    for i, t in enumerate(tids):
        mvf.point_coords[t] = pts_np[i]
    for f in range(n_frames):
        mvf.cam_cfw_R[f], mvf.cam_cfw_t[f] = R_o[f], t_o[f]

    tids_m = sorted(mvf.point_coords)
    est = np.stack([mvf.point_coords[t] for t in tids_m])
    phys = np.asarray(tids_m) % n_pts       # revisit re-detections alias
    map_ate = float(aligned_rmse(jnp.asarray(est), jnp.asarray(pts_gt[phys])))
    pos_est = np.stack([-R.T @ t for R, t in zip(mvf.cam_cfw_R, mvf.cam_cfw_t)])
    pos_gt = np.stack([-R.T @ t for R, t in zip(Rs, ts_gt)])
    traj_ate = float(aligned_rmse(jnp.asarray(pos_est), jnp.asarray(pos_gt)))

    # end-to-end throughput: denominator = TOTAL pipeline wall-clock incl.
    # the triggered windowed/global BA (the reference's per-frame cost
    # includes its triggered BA, multi-view-factorization.cpp:378-394 —
    # VERDICT r4 item 4). The steady-state variant replaces each BA run's
    # cost with the run-cost median: at this reduced size 2-3 one-off jit
    # compiles (bucket-shape growth) dominate ba_time and amortize away on
    # longer runs — the per-run profile printed below is the evidence.
    fps_e2e = (n_frames - 2) / (t_integrate + ba_time)
    ba_steady = 0.0
    profiled = 0.0
    for nm in ("window_ba", "global_ba"):
        pr = mvf.profile.get(nm, {}).get("per_run")
        if pr:
            per = sorted(sum(t[:3]) for t in pr)
            ba_steady += per[len(per) // 2] * len(pr)
            profiled += sum(per)
    # FAILED BA runs never reach per_run (the factorizer returns before
    # profiling when the LM rejects every step) but their wall-clock is in
    # ba_time — carry the unprofiled remainder at face value so the steady
    # key never overstates throughput on runs with failures
    ba_steady += max(ba_time - profiled, 0.0)
    fps_e2e_steady = (n_frames - 2) / (t_integrate + ba_steady)
    print(f"integration: {n_frames - 2} frames in {t_integrate:.1f}s = "
          f"{fps:.1f} frames/s (windowed BA time {ba_time:.1f}s, "
          f"{mvf.ba_runs} runs; {n_fail} fallback frames)")
    print(f"end-to-end: {fps_e2e:.2f} frames/s "
          f"(steady-state {fps_e2e_steady:.2f} with BA at per-run medians "
          f"= {ba_steady:.1f}s; compile spikes account for the rest)")
    for nm in ("window_ba", "global_ba"):
        wprof = mvf.profile.get(nm)
        if wprof:
            print(f"{nm} phases: build {wprof['build']:.1f}s "
                  f"compute {wprof['compute']:.1f}s "
                  f"readback {wprof['readback']:.1f}s "
                  f"over {wprof['runs']} runs")
            print(f"{nm} per-run (build,compute,readback,Np,F/L): "
                  f"{wprof['per_run']}")
    print(f"final BA: {n_timed} LM iters ({n_trials} damped solves) in "
          f"{t_ba:.2f}s = {iters_per_s:.2f} iters/s (banded={plan is not None};"
          f" one dispatch; compile+first {t_compile:.1f}s)")
    print(f"map={len(tids_m)} points  map_ate_rmse={map_ate:.4f}  "
          f"traj_ate_rmse={traj_ate:.4f}")
    return {
        "metric": "mvf_at_scale_ba_iters_per_s", "value": round(iters_per_s, 3),
        "unit": "iters/s",
        "frames_per_s_integration": round(fps, 2),
        "frames_per_s_end_to_end": round(fps_e2e, 2),
        "frames_per_s_end_to_end_steady": round(fps_e2e_steady, 2),
        "ba_time_s": round(ba_time, 1),
        "ba_steady_s": round(ba_steady, 1),
        "ba_trials_timed": int(n_trials),
        "ba_trials_per_s": round(n_trials / max(t_ba, 1e-9), 3),
        "map_ate_rmse": round(map_ate, 5),
        "traj_ate_rmse": round(traj_ate, 5),
        "traj_ate_pre_closure": round(ate_pre_closure, 5),
        "loop_closed": bool(closed),
        "closure_pairs_total": int(n_pairs),
        "closure_pairs_correct": int(n_correct),
        "closure_inliers": int(getattr(mvf, "last_closure_inliers", 0)),
        "closure_oracle_free": bool(args.revisit_frames
                                    and not args.oracle_pairs),
        "localization_failures": int(n_fail),
        "points": len(tids_m), "frames": n_frames}


if __name__ == "__main__":
    raise SystemExit(main())
