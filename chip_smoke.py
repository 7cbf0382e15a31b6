"""Bring-up check: the tracker and bundle adjustment, end to end on one GPU.

Drives the main paths once through their normal entry points at the sizes
bench.py uses, compares each with a float64 CPU run of the same call, and
fails (non-zero exit, no result line) on any failed check:

  1. device     platform, device kind and count, card name and power limit
  2. ncc        ops.ncc.ncc_search on a 640x480 churned frame, K=768 (f32 on
                the card vs f64 on the CPU), with and without subpixel
  3. ekf        one fused update+health+recruit+predict frame at K=768
                (D=4621): card f32 vs CPU f64, bounded by 2x the CPU-f32 error
  4. tracker    scenario03 closed loop, K=96, 300 frames, ATE < 0.05
  5. churn      churned real-perception loop, K=768, 640x480: 120 frames to
                warm, 120 timed, ATE < 0.25
  6. ba         sparse LM at 10k points x 500 frames (3 iterations), then
                dino 36x4983 in f32 (bench.py's dtype) and f64 on the card,
                each within 1% of the f64 CPU error; the f64 runs stop on
                the reference criterion |d err| < 4.56e-8
  7. hostloop   200 decoded 320x240 PGM frames through the frame loader, the
                NCC matcher and the pipelined host loop

Usage:

  python chip_smoke.py              one card, phases 1-7 at full size
  python chip_smoke.py --four       four cards: the landmark-sharded churned
                                    loop and the sharded Schur solve against
                                    the one-card paths, nothing else
  JAX_PLATFORMS=cpu python chip_smoke.py --rehearse [--four]
                                    the same phases at tiny shapes on the CPU

Times, rates and memory are printed with the card's name and power limit.
The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple

REPO = os.path.dirname(os.path.abspath(__file__))


class Sizes(NamedTuple):
    track_k: int          # scenario03 tracker capacity
    track_frames: int
    churn_k: int          # churned-loop capacity
    churn_points: int     # splats in the churned world
    churn_frames: int     # warm window and timed window, each
    ba_points: int
    ba_frames: int
    ba_track_len: int
    ba_chunk: int
    dino_points: int
    host_frames: int
    four_frames: int      # sharded churned loop under --four


FULL = Sizes(track_k=96, track_frames=300, churn_k=768, churn_points=1024,
             churn_frames=120, ba_points=10_000, ba_frames=500,
             ba_track_len=12, ba_chunk=2048, dino_points=4983,
             host_frames=200, four_frames=8)
# rehearsal: every shape small, but the same code paths (chunked and padded
# point shards included: 2000 points over 4 shards of 256-point chunks)
REHEARSE = Sizes(track_k=32, track_frames=30, churn_k=48, churn_points=64,
                 churn_frames=20, ba_points=2000, ba_frames=48,
                 ba_track_len=8, ba_chunk=256, dino_points=300,
                 host_frames=24, four_frames=4)

# pass conditions
NCC_CORR_TOL = 1e-4         # |d best_corr| over slots both runs matched
NCC_CENTER_AGREE = 0.99     # share of those slots with the same best cell
NCC_SUBPIX_TOL = 1e-3       # px: subpixel centres that count as the same
EKF_ERR_FACTOR = 2.0        # card-f32 error vs CPU-f32 error, both vs f64
TRACK_ATE = 0.05
CHURN_ATE = 0.25
DINO_REL_CHANGE = 4.56e-8   # reference stop criterion
DINO_ERR_REL = 0.01         # card vs f64 CPU final reprojection error
DINO_MAP_ATE = 0.01
HOST_ATE = 0.05
FOUR_MATCHED = 5            # sharded vs one card, matched count per frame
FOUR_POS = 1e-4             # sharded vs one card, camera position
SCHUR_REL = 1e-4            # sharded vs one card, f64 Schur corrections
SCHUR_F32_FACTOR = 2.0      # sharded-f32 error vs one-card-f32 error


class CheckFailed(Exception):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def card_line() -> str:
    """`nvidia-smi` name and power limit of the card; run as a child that
    never touches JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"not available ({type(e).__name__})"
    return out.strip().splitlines()[0] if out.strip() else "not available"


class Smoke:
    """Run state shared by the phases: sizes, devices, the card line and the
    churned world (built once, used by the ncc, ekf and churn phases)."""

    def __init__(self, sizes: Sizes, card: str):
        import jax

        self.sizes = sizes
        self.card = card
        self.dev = jax.devices()[0]
        self.cpu = jax.devices("cpu")[0]
        self._world = None

    def say(self, msg: str) -> None:
        print(msg, flush=True)

    def measured(self, msg: str) -> None:
        """A time, rate or memory figure, named with the card."""
        print(f"{msg}  [{self.dev.device_kind}; {self.card}]", flush=True)

    def world(self):
        if self._world is None:
            from surikatoko_tpu.world import bench_configs as cfgs

            s = self.sizes
            self._world = cfgs.churned_imageseq(s.churn_k, s.churn_points)
        return self._world


def _on_cpu(tree, dtype):
    """Copy the array leaves of ``tree`` to the CPU, floats cast to
    ``dtype``; static leaves (Python bools and ints) pass through."""
    import jax
    import numpy as np

    cpu = jax.devices("cpu")[0]

    def one(a):
        if not isinstance(a, (jax.Array, np.ndarray)):
            return a
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.floating):
            a = a.astype(dtype)
        return jax.device_put(a, cpu)

    return jax.tree.map(one, tree)


def _rel_err(a, ref) -> float:
    import numpy as np

    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(a - ref) / max(np.linalg.norm(ref), 1e-300))


# ---------------------------------------------------------------- phases


def phase_device(sm: Smoke, rehearse: bool) -> None:
    import jax

    devs = jax.devices()
    sm.say(f"device: platform={sm.dev.platform} kind={sm.dev.device_kind} "
           f"count={len(devs)}")
    sm.say(f"card: {sm.card}")
    env = os.environ
    sm.say(f"jax {jax.__version__}; XLA_FLAGS={env.get('XLA_FLAGS', '')!r}; "
           f"JAX_PLATFORMS={env.get('JAX_PLATFORMS', '')!r}")
    if sm.dev.platform != "gpu" and not rehearse:
        raise CheckFailed(
            f"no GPU: JAX found platform {sm.dev.platform!r} "
            f"({sm.dev.device_kind}); run on the card, or pass --rehearse "
            f"with JAX_PLATFORMS=cpu for the tiny CPU rehearsal")


def _ncc_inputs(sm: Smoke):
    import jax

    from surikatoko_tpu.models.monoslam import measure
    from surikatoko_tpu.world.device_runner import render_frame

    params, sc, st, templates = sm.world()
    img = jax.jit(lambda f: render_frame(params, sc, f))(1)
    h = jax.jit(lambda x: measure.measurement_jacobians(params, x)[0])(st.x)
    return img, h, templates, st.lm_active


def _ncc_on_cpu_f64(search, img, h, templates, active, slots: int = 16):
    """``search`` on the CPU in f64, ``slots`` landmarks per call. Slots are
    independent, and XLA:CPU's time for the grouped convolutions grows with
    the square of the slot count (K=768 in one call took ~8 minutes)."""
    import jax
    import numpy as np

    from surikatoko_tpu.ops.ncc import NccSearchResult

    K = h.shape[0]
    with jax.enable_x64(True), jax.default_device(jax.devices("cpu")[0]):
        parts = [jax.device_get(search(*_on_cpu(
            (img, h[lo:lo + slots], templates[lo:lo + slots],
             active[lo:lo + slots]), np.float64)))
            for lo in range(0, K, slots)]
    return NccSearchResult(*(np.concatenate(f) for f in zip(*parts)))


def phase_ncc(sm: Smoke) -> None:
    import functools

    import jax
    import numpy as np

    from surikatoko_tpu.ops.ncc import ncc_search

    args = _ncc_inputs(sm)

    def search(subpixel):
        return jax.jit(functools.partial(
            ncc_search, search_radius=7, min_corr_coeff=0.6,
            subpixel=subpixel))

    for subpixel in (False, True):
        got = jax.device_get(search(subpixel)(*args))
        ref = _ncc_on_cpu_f64(search(subpixel), *args)
        both = got.matched & ref.matched
        check(both.sum() > 0, "ncc: no slot matched in both runs")
        dcorr = np.abs(got.best_corr.astype(np.float64) - ref.best_corr)[both]
        dcen = np.max(np.abs(got.best_center - ref.best_center), axis=1)[both]
        same = dcen <= (NCC_SUBPIX_TOL if subpixel else 0.0)
        agree = float(np.mean(same))
        sm.say(f"ncc subpixel={subpixel}: {int(both.sum())} slots matched in "
               f"both; max|d corr| {dcorr.max():.3e} (tol {NCC_CORR_TOL}); "
               f"same centre {agree:.4f} (need >= {NCC_CENTER_AGREE}); "
               f"differing centres {int((~same).sum())}, max|d corr| there "
               f"{(dcorr[~same].max() if (~same).any() else 0.0):.3e}")
        check(dcorr.max() <= NCC_CORR_TOL, "ncc: best_corr differs")
        check(agree >= NCC_CENTER_AGREE, "ncc: best_center differs")
        check(int(np.sum(got.matched != ref.matched)) <= max(
            1, int((1.0 - NCC_CENTER_AGREE) * ref.matched.sum())),
            "ncc: matched sets differ")
    # information only: the convolutions at the default precision (TF32 on
    # the card's tensor cores)
    with jax.default_matmul_precision("default"):
        dflt = jax.device_get(search(False)(*args))
    both = dflt.matched & ref.matched
    d = np.abs(dflt.best_corr.astype(np.float64) - ref.best_corr)[both]
    sm.say(f"ncc at default matmul precision (info): max|d corr| "
           f"{d.max() if d.size else 0.0:.3e} over {int(both.sum())} slots")


def phase_ekf(sm: Smoke) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from surikatoko_tpu.models.monoslam import fused_step
    from surikatoko_tpu.ops.ncc import ncc_search
    from surikatoko_tpu.vision import features

    params, sc, st, templates = sm.world()
    img, h, _, active = _ncc_inputs(sm)
    res = jax.jit(lambda *a: ncc_search(*a, search_radius=7,
                                        min_corr_coeff=0.6))(
        img, h, templates, active)
    cand, cand_ok = jax.jit(lambda im: features.detect_corners(
        im, max_corners=64, nms_radius=5, border=15,
        quality_level=0.05))(img)
    K = st.capacity
    # retire the first 8 live slots this frame, so the recruits have slots
    # to claim, as the delete policy frees them in the loop
    drop = active & (jnp.cumsum(active) <= 8)
    free = ~active | drop
    obs_mask = res.matched & active & ~drop
    inputs = (st.x, st.P, res.best_center, obs_mask, cand[:12], cand_ok[:12],
              free, drop)

    def step(params):
        def f(x, P, obs, mask, new_pix, new_valid, free, drop):
            out = fused_step.fused_update_health_recruit_predict(
                params, x, P, obs, mask, new_pix, new_valid, free,
                deactivate_mask=drop)
            return out[0], out[1]
        return jax.jit(f)

    x_g, P_g = jax.device_get(step(params)(*inputs))
    with jax.default_device(sm.cpu):
        x_c, P_c = jax.device_get(step(_on_cpu(params, np.float32))(
            *_on_cpu(inputs, np.float32)))
        with jax.enable_x64(True):
            x_r, P_r = jax.device_get(step(_on_cpu(params, np.float64))(
                *_on_cpu(inputs, np.float64)))
    ex_g, eP_g = _rel_err(x_g, x_r), _rel_err(P_g, P_r)
    ex_c, eP_c = _rel_err(x_c, x_r), _rel_err(P_c, P_r)
    sm.say(f"ekf K={K} D={x_r.shape[0]}: rel Frobenius error vs CPU f64 — "
           f"card f32 x {ex_g:.3e} P {eP_g:.3e}; CPU f32 x {ex_c:.3e} "
           f"P {eP_c:.3e}; bound {EKF_ERR_FACTOR}x the CPU f32 error")
    check(np.all(np.isfinite(x_g)) and np.all(np.isfinite(P_g)),
          "ekf: non-finite state on the card")
    check(ex_g <= EKF_ERR_FACTOR * ex_c, "ekf: x error above bound")
    check(eP_g <= EKF_ERR_FACTOR * eP_c, "ekf: P error above bound")


def phase_tracker(sm: Smoke) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from surikatoko_tpu.geom.align import aligned_rmse
    from surikatoko_tpu.utils.profiling import median_wall_time
    from surikatoko_tpu.world import bench_configs as cfgs
    from surikatoko_tpu.world.device_runner import make_scan_runner

    s = sm.sizes
    params, sc, state = cfgs.scenario03(s.track_k)
    run = make_scan_runner(params, update_impl=1)
    frames = jnp.arange(1, 1 + s.track_frames)
    key = jax.random.PRNGKey(1)
    t0 = time.perf_counter()
    _st, errs, _n, pos = jax.block_until_ready(run(state, sc, frames, key))
    t_compile = time.perf_counter() - t0
    dt = median_wall_time(lambda: run(state, sc, frames, key))
    ate = float(aligned_rmse(pos, cfgs.gt_positions(
        sc.gt_cfw_R[frames], sc.gt_cfw_t[frames])))
    sm.say(f"tracker scenario03 K={s.track_k}: {s.track_frames} frames, "
           f"ATE {ate:.6f} (bound {TRACK_ATE})")
    sm.measured(f"tracker: {s.track_frames / dt:.2f} frames/s "
                f"({dt * 1e3:.3f} ms per {s.track_frames}-frame scan, "
                f"first call {t_compile:.2f} s)")
    check(bool(np.all(np.isfinite(np.asarray(errs)))),
          "tracker: non-finite residuals")
    check(ate < TRACK_ATE, f"tracker: ATE {ate} >= {TRACK_ATE}")


def _fmt_bytes(n) -> str:
    return "n/a" if n is None else f"{n / 2**20:.1f} MiB"


def phase_churn(sm: Smoke) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from surikatoko_tpu.geom.align import aligned_rmse
    from surikatoko_tpu.utils.profiling import median_wall_time
    from surikatoko_tpu.world import bench_configs as cfgs
    from surikatoko_tpu.world.device_runner import make_imageseq_scan_runner

    s = sm.sizes
    params, sc, st, templates = sm.world()
    run = make_imageseq_scan_runner(params, **cfgs.CHURN_RUNNER)
    n = s.churn_frames
    fr_warm = jnp.arange(1, 1 + n)
    fr_timed = jnp.arange(1 + n, 1 + 2 * n)
    t0 = time.perf_counter()
    compiled = run.lower(st, templates, sc, fr_warm).compile()
    t_compile = time.perf_counter() - t0
    ma = compiled.memory_analysis()
    st_w, tm_w, _ = jax.block_until_ready(compiled(st, templates, sc, fr_warm))
    dt = median_wall_time(lambda: compiled(st_w, tm_w, sc, fr_timed))
    _st, _tm, (err, n_m, pos, n_rec, n_act) = jax.device_get(
        compiled(st_w, tm_w, sc, fr_timed))
    ate = float(aligned_rmse(jnp.asarray(pos), cfgs.gt_positions(
        sc.gt_cfw_R[fr_timed], sc.gt_cfw_t[fr_timed])))
    sm.say(f"churn K={s.churn_k} 640x480: ATE {ate:.6f} (bound {CHURN_ATE}); "
           f"matched median {int(np.median(n_m))}, recruited "
           f"{int(np.sum(n_rec))}, active median {int(np.median(n_act))}")
    sm.measured(f"churn: {n / dt:.2f} frames/s ({dt / n * 1e3:.3f} ms/frame "
                f"over {n} frames; compile {t_compile:.2f} s)")
    if ma is not None:
        sm.measured(
            "churn runner memory_analysis: arguments "
            f"{_fmt_bytes(ma.argument_size_in_bytes)}, outputs "
            f"{_fmt_bytes(ma.output_size_in_bytes)}, temp "
            f"{_fmt_bytes(ma.temp_size_in_bytes)}, code "
            f"{_fmt_bytes(ma.generated_code_size_in_bytes)}")
    stats = sm.dev.memory_stats()
    sm.measured("peak_bytes_in_use after churn: "
                + _fmt_bytes(stats.get("peak_bytes_in_use") if stats
                             else None))
    check(bool(np.all(np.isfinite(err))), "churn: non-finite residuals")
    check(ate < CHURN_ATE, f"churn: ATE {ate} >= {CHURN_ATE}")


def _ba_problem(s: Sizes, dtype, return_host_inputs: bool = False):
    """The at-scale sparse BA problem (demos/demo_ba_at_scale.py)."""
    sys.path.insert(0, os.path.join(REPO, "demos"))
    from demo_ba_at_scale import build_problem

    return build_problem(s.ba_points, s.ba_frames, s.ba_track_len,
                         noise_pix=0.5, seed=0, dtype=dtype,
                         return_host_inputs=return_host_inputs)


def phase_ba(sm: Smoke) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from surikatoko_tpu.geom.align import aligned_rmse
    from surikatoko_tpu.io import dino as dino_mod
    from surikatoko_tpu.models.ba import (SparseBundleAdjustment,
                                          TermCriteria, sparse)

    s = sm.sizes
    ps, fidx, mask = _ba_problem(s, jnp.float32, return_host_inputs=True)
    err_fn = jax.jit(sparse.reproj_error)
    err0 = float(err_fn(ps))
    ba = SparseBundleAdjustment(optimize_intrinsics=False,
                                point_chunk=s.ba_chunk, device_loop=True)
    ba.set_plan_inputs(fidx, mask)
    term = TermCriteria(allowed_reproj_err_rel_change=None, max_iters=3)
    t0 = time.perf_counter()
    jax.block_until_ready(ba.compute(ps, term))
    t_compile = time.perf_counter() - t0
    t0 = time.perf_counter()
    ok, p1 = jax.block_until_ready(ba.compute(ps, term))
    dt = time.perf_counter() - t0
    err1 = float(err_fn(p1))
    sm.say(f"ba {s.ba_points}x{s.ba_frames}: err {err0:.6g} -> {err1:.6g} "
           f"in {ba.iterations} iterations ({ba.trials} trials), "
           f"stop '{ba.stop_reason}'")
    sm.measured(f"ba: {ba.iterations / dt:.2f} LM iterations/s "
                f"({dt:.3f} s for {ba.iterations}; first call "
                f"{t_compile:.2f} s)")
    check(bool(ok) and np.isfinite(err1), "ba: LM failed or non-finite")
    check(err1 < err0, "ba: error did not decrease")

    # dino at the reference's full shape through the real parse path
    Ps, obs, dmask, gt = dino_mod.synthetic_dino_raw(
        n_frames=36, n_points=s.dino_points, vary_track_len=True)
    keep = dmask.sum(axis=1) >= 2
    term_d = TermCriteria(allowed_reproj_err_rel_change=DINO_REL_CHANGE,
                          max_iters=300)

    def solve_dino(td):
        p, fi, tm = dino_mod.load_dino_problem_sparse(td, f0=600.0)
        b = SparseBundleAdjustment(device_loop=True, band=False,
                                   point_chunk=1024)
        b.set_plan_inputs(fi, tm)
        ok, q = jax.block_until_ready(b.compute_inplace(p, term_d))
        check(bool(ok), f"dino: LM failed ({b.stop_reason})")
        return b, p, q, float(jax.jit(sparse.reproj_error)(q)) / q.n_points

    with tempfile.TemporaryDirectory() as td:
        dino_mod.write_dino_files(td, Ps, obs[keep], dmask[keep],
                                  gt_points=gt[keep])
        gt_d = dino_mod.load_gt_points(td)
        t0 = time.perf_counter()
        ba_d, p_d, q_d, e_d = solve_dino(td)                # f32, the card
        t_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        jax.block_until_ready(ba_d.compute_inplace(p_d, term_d))
        t_conv = time.perf_counter() - t0
        with jax.enable_x64(True):
            ba_64, _, _, e_64 = solve_dino(td)               # f64, the card
            with jax.default_device(sm.cpu):
                ba_r, _, _, e_r = solve_dino(td)             # f64, the CPU
    rel = abs(e_d - e_r) / e_r
    rel_64 = abs(e_64 - e_r) / e_r
    ate = float(aligned_rmse(q_d.points, jnp.asarray(gt_d, q_d.points.dtype)))
    sm.say(f"dino 36x{int(keep.sum())}: card f32 stop '{ba_d.stop_reason}' "
           f"after {ba_d.iterations} iterations, err/point {e_d:.6e}; card "
           f"f64 stop '{ba_64.stop_reason}' after {ba_64.iterations}, "
           f"err/point {e_64:.6e}; CPU f64 stop '{ba_r.stop_reason}' after "
           f"{ba_r.iterations}, err/point {e_r:.6e}; rel diff vs CPU f64: "
           f"f32 {rel:.3e}, f64 {rel_64:.3e} (bound {DINO_ERR_REL}); f32 "
           f"map ATE {ate:.3e} (bound {DINO_MAP_ATE})")
    sm.measured(f"dino f32: {t_conv:.3f} s to its stop "
                f"({ba_d.iterations / t_conv:.2f} iterations/s; first call "
                f"{t_first:.2f} s)")
    # the reference criterion |d err| < 4.56e-8 is ~12 ulps of the f32
    # error here, finer than the 32-ulp floor at which the f32 LM stops as
    # "converged at dtype precision"; in f64 it must stop on the criterion
    for name, b in (("card f64", ba_64), ("CPU f64", ba_r)):
        check(b.stop_reason == "small relative err change",
              f"dino {name}: stopped on '{b.stop_reason}', not on "
              f"d err < {DINO_REL_CHANGE}")
    check(ba_d.stop_reason in ("small relative err change",
                               "converged at dtype precision"),
          f"dino card f32: stopped on '{ba_d.stop_reason}'")
    check(rel <= DINO_ERR_REL and rel_64 <= DINO_ERR_REL,
          f"dino: error off the CPU f64 run (f32 {rel:.3e}, f64 {rel_64:.3e})")
    check(ate < DINO_MAP_ATE, f"dino: map ATE {ate}")


def phase_hostloop(sm: Smoke) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from surikatoko_tpu.geom.align import aligned_rmse
    from surikatoko_tpu.io.frame_loader import FrameLoader
    from surikatoko_tpu.models.monoslam import MonoSlamFilter
    from surikatoko_tpu.vision.matcher import ImageTemplCornersMatcher
    from surikatoko_tpu.vision.picture import save_picture
    from surikatoko_tpu.world import bench_configs as cfgs
    from surikatoko_tpu.world.runner import (init_tracker_state_from_gt,
                                             run_image_sequence_pipelined)

    n = sm.sizes.host_frames
    seq = cfgs.host_sequence()

    def run_once(td):
        tracker = MonoSlamFilter(seq.params, capacity=48, update_impl=1)
        matcher = ImageTemplCornersMatcher(
            tracker, templ_width=15, search_radius=10, min_corr_coeff=0.6,
            detector_max_corners=48, min_distance_new_to_tracked=15.0)
        st0 = init_tracker_state_from_gt(tracker, seq.gt_cfw)
        with FrameLoader(td, prefetch_depth=4) as fl:
            native = fl.native
            st, stats = run_image_sequence_pipelined(
                tracker, matcher,
                (np.asarray(img, np.float32) for _, img in fl), st0)
        jax.block_until_ready(st)
        return stats, native

    with tempfile.TemporaryDirectory() as td:
        for f in range(n):
            save_picture(os.path.join(td, f"{f:06d}.pgm"),
                         cfgs.render_host_frame(seq, f))
        t0 = time.perf_counter()
        run_once(td)
        t_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        stats, native = run_once(td)
        dt = time.perf_counter() - t0
    pos = np.stack([np.asarray(s.cam_state[:3]) for s in stats])
    gt = np.asarray(cfgs.gt_positions(jnp.asarray(seq.gt_cfw.R),
                                      jnp.asarray(seq.gt_cfw.t)))[:n]
    ate = float(aligned_rmse(jnp.asarray(pos), jnp.asarray(gt)))
    matched = int(np.median([int(np.asarray(s.obs_count)) for s in stats]))
    sm.say(f"hostloop {n} frames 320x240: decoded by the "
           f"{'native loader' if native else 'Python fallback'}; ATE "
           f"{ate:.6f} (bound {HOST_ATE}); matched median {matched}")
    sm.measured(f"hostloop: {n / dt:.2f} frames/s (first run {t_first:.2f} s)")
    check(bool(np.all(np.isfinite(pos))), "hostloop: non-finite camera")
    check(ate < HOST_ATE, f"hostloop: ATE {ate} >= {HOST_ATE}")


def phase_four(sm: Smoke) -> None:
    """The landmark-sharded churned loop and the sharded sparse Schur solve
    on a 4-device mesh, each against the one-card path on the same input."""
    import functools

    import jax
    import jax.numpy as jnp
    import numpy as np

    from surikatoko_tpu.models.ba import sparse
    from surikatoko_tpu.parallel import landmark_mesh
    from surikatoko_tpu.parallel.sharded_imageseq import (
        make_sharded_imageseq_runner)
    from surikatoko_tpu.parallel.sharded_schur import (
        make_sharded_sparse_schur_solver)
    from surikatoko_tpu.utils.profiling import median_wall_time
    from surikatoko_tpu.world import bench_configs as cfgs
    from surikatoko_tpu.world.device_runner import make_imageseq_scan_runner

    n_dev = 4
    check(len(jax.devices()) >= n_dev,
          f"--four needs {n_dev} devices, JAX has {len(jax.devices())}")
    mesh = landmark_mesh(n_dev)
    s = sm.sizes
    params, sc, st, templates = sm.world()
    fr = jnp.arange(1, 1 + s.four_frames)
    run_sh = make_sharded_imageseq_runner(params, st.capacity, mesh,
                                          **cfgs.CHURN_RUNNER)
    sh_args = (st.x, st.P, templates, st.lm_active, st.lm_unobserved,
               st.lm_generation, sc, fr)
    t0 = time.perf_counter()
    out_sh = jax.block_until_ready(run_sh(*sh_args))
    t_sh_first = time.perf_counter() - t0
    dt_sh = median_wall_time(lambda: run_sh(*sh_args))
    err_sh, n_sh, pos_sh = (np.asarray(a) for a in out_sh[-1][:3])
    run_1 = make_imageseq_scan_runner(params, **cfgs.CHURN_RUNNER)
    _st1, _tm1, out_1 = jax.block_until_ready(run_1(st, templates, sc, fr))
    dt_1 = median_wall_time(lambda: run_1(st, templates, sc, fr))
    n_1, pos_1 = np.asarray(out_1[1]), np.asarray(out_1[2])
    d_matched = int(np.max(np.abs(n_sh - n_1)))
    d_pos = float(np.max(np.abs(pos_sh - pos_1)))
    sm.say(f"four: sharded churned loop K={st.capacity} x{s.four_frames} "
           f"frames on {n_dev} devices vs one: max|d matched| {d_matched} "
           f"(bound {FOUR_MATCHED}), max|d cam pos| {d_pos:.3e} "
           f"(bound {FOUR_POS})")
    sm.measured(f"four: churned loop {s.four_frames / dt_sh:.2f} frames/s on "
                f"{n_dev} devices (first call {t_sh_first:.2f} s) vs "
                f"{s.four_frames / dt_1:.2f} frames/s on one")
    check(bool(np.all(np.isfinite(err_sh))), "four: sharded loop diverged")
    check(d_matched <= FOUR_MATCHED, "four: matched counts differ")
    check(d_pos <= FOUR_POS, "four: camera positions differ")

    # the Schur solve in f64 (where sharded and one-card agree to rounding,
    # so the bound tests the sharding) and in f32 (where two summation
    # orders differ by what f32 loses on this system: the bound is 2x the
    # one-card f32 error against f64)
    def schur_pair(dtype):
        ps = _ba_problem(s, dtype)
        blocks = jax.jit(sparse.compute_blocks)(ps)
        hf = jnp.asarray(1e-4, dtype)
        one = jax.jit(functools.partial(
            sparse.solve_corrections_schur_sparse, point_chunk=s.ba_chunk))
        sharded = make_sharded_sparse_schur_solver(
            ps.n_points, ps.n_frames, ps.track_len, mesh,
            point_chunk=s.ba_chunk)
        out = []
        for solve in (one, sharded):
            dX, du, ok = jax.block_until_ready(solve(ps, blocks, hf))
            check(bool(ok), "four: Schur solve not finite")
            out.append((np.asarray(dX, np.float64), np.asarray(du, np.float64),
                        median_wall_time(lambda: solve(ps, blocks, hf))))
        return out

    (dX1, du1, t1), (dXs, dus, ts) = schur_pair(jnp.float32)
    with jax.enable_x64(True):
        (dX1r, du1r, t1r), (dXsr, dusr, tsr) = schur_pair(jnp.float64)
    r64 = max(_rel_err(dXsr, dX1r), _rel_err(dusr, du1r))
    r32 = max(_rel_err(dXs, dX1), _rel_err(dus, du1))
    e1 = max(_rel_err(dX1, dX1r), _rel_err(du1, du1r))
    es = max(_rel_err(dXs, dX1r), _rel_err(dus, du1r))
    sm.say(f"four: sharded sparse Schur {s.ba_points}x{s.ba_frames} vs one "
           f"card: f64 rel diff {r64:.3e} (bound {SCHUR_REL}); f32 rel diff "
           f"{r32:.3e}; f32 error vs f64: sharded {es:.3e}, one card "
           f"{e1:.3e} (bound {SCHUR_F32_FACTOR}x)")
    sm.measured(f"four: Schur solve f32 {ts * 1e3:.3f} ms on {n_dev} devices "
                f"vs {t1 * 1e3:.3f} ms on one; f64 {tsr * 1e3:.3f} ms vs "
                f"{t1r * 1e3:.3f} ms")
    check(r64 <= SCHUR_REL, "four: sharded f64 Schur corrections differ")
    check(es <= SCHUR_F32_FACTOR * e1, "four: sharded f32 Schur error above "
          "bound")


ONE_CARD = (("ncc", phase_ncc), ("ekf", phase_ekf),
            ("tracker", phase_tracker), ("churn", phase_churn),
            ("ba", phase_ba), ("hostloop", phase_hostloop))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-device sharded paths")
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny shapes on the CPU (sets JAX_PLATFORMS=cpu)")
    args = ap.parse_args(argv)

    if args.rehearse:
        os.environ["JAX_PLATFORMS"] = "cpu"
        if args.four and "xla_force_host_platform_device_count" not in \
                os.environ.get("XLA_FLAGS", ""):
            os.environ["XLA_FLAGS"] = (
                os.environ.get("XLA_FLAGS", "")
                + " --xla_force_host_platform_device_count=4").strip()
    else:
        # the f64 references run on the CPU backend beside the card
        plats = os.environ.get("JAX_PLATFORMS", "")
        if plats and "cpu" not in plats.split(","):
            os.environ["JAX_PLATFORMS"] = plats + ",cpu"

    import jax

    from surikatoko_tpu.utils.compile_cache import enable_compile_cache

    jax.config.update("jax_default_matmul_precision", "highest")
    cache = enable_compile_cache()
    sm = Smoke(REHEARSE if args.rehearse else FULL, card_line())
    phases = (("four", phase_four),) if args.four else ONE_CARD
    t_all = time.perf_counter()
    name = "device"
    try:
        phase_device(sm, args.rehearse)
        sm.say(f"compile cache: {cache}")
        for name, fn in phases:
            sm.say(f"== {name}")
            t0 = time.perf_counter()
            fn(sm)
            sm.measured(f"{name}: phase wall time "
                        f"{time.perf_counter() - t0:.2f} s")
    except CheckFailed as e:
        print(f"chip_smoke FAILED in phase {name}: {e}", file=sys.stderr,
              flush=True)
        return 1
    sm.measured(f"all phases: {time.perf_counter() - t_all:.2f} s")
    sm.say(f"card: {sm.card}")
    print(json.dumps({"ok": True, "device": {
        "platform": sm.dev.platform, "kind": sm.dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
