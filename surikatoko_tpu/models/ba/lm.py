"""Levenberg-Marquardt driver with the reference's damping schedule.

Reference ComputeOnNormalizedWorld (bundle-adj-kanatani.cpp:720-893):
  hessian_factor starts at 1e-4; on a successful decrease it divides by 10
  (toward Gauss-Newton), on failure multiplies by 10 (toward gradient
  descent) and retries from the snapshot; stops on small |err change|
  ("small relative err change"), damping overflow ("hessian overflow"), or
  error converging to a limit ("err converged to limit value").

The outer loop runs on host (a handful of iterations, each a jitted device
program: derivative blocks + Schur solve + trial apply); rollback is a free
pytree swap. `compute_inplace` mirrors the reference entry point:
normalize -> optimize -> revert.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Optional

import jax
import jax.numpy as jnp

from surikatoko_tpu.models.ba import derivs, normalize, schur
from surikatoko_tpu.models.ba.problem import BAProblem, reproj_error


@dataclass
class TermCriteria:
    """Reference BundleAdjustmentKanataniTermCriteria (h:68-96)."""

    allowed_reproj_err_rel_change: Optional[float] = None
    max_hessian_factor: Optional[float] = 1e12
    max_iters: int = 300


def _run_device_loop(driver, p, term_crit: TermCriteria, blocks_fn, solve_fn,
                     apply_fn, err_fn, solve_extra=None, normalize_cfg=None):
    """Run the whole LM as one compiled program (models/ba/lm_device.py) and
    map its stop code back onto the host driver's (ok, stop_reason,
    iterations) reporting. One device dispatch per BA instead of ~4 calls +
    2 blocking host syncs per iteration.

    ``solve_extra`` (optional) is a TRACED argument forwarded to solve_fn as
    its 4th parameter — the banded Schur point permutation rides here, so a
    re-planned (grown) problem with unchanged band geometry reuses the
    compiled program instead of baking the permutation in as a constant.

    ``normalize_cfg`` (optional, (t1y, unity_comp_ind, atol)) fuses the
    SceneNormalizer gauge transform INTO the program: validity check ->
    normalize -> LM -> revert as one dispatch + one packed fetch, instead of
    a blocking can_normalize fetch plus separate normalize/revert dispatches
    per BA call (fewer host syncs per BA). A degenerate gauge comes back
    untouched with stop code "cannot normalize"."""
    from surikatoko_tpu.models.ba import lm_device

    # max_iters rides as a TRACED scalar (only ever compared against the
    # iteration counter): a follow-up run with a different budget — e.g. the
    # final-polish pattern — reuses the compiled program
    key = (term_crit.allowed_reproj_err_rel_change,
           term_crit.max_hessian_factor, solve_extra is not None,
           normalize_cfg)
    if driver._dev_run is None or driver._dev_key != key:
        def runner(p0, max_iters, *extra):
            sf = (solve_fn if not extra
                  else lambda pp, b, f: solve_fn(pp, b, f, extra[0]))
            if normalize_cfg is None:
                p_in, valid, ns = p0, None, None
            else:
                t1y, uci, atol = normalize_cfg
                T01 = p0.cfw_t[0] - p0.cfw_R[0] @ (
                    p0.cfw_R[1].T @ p0.cfw_t[1])
                valid = jnp.abs(T01[uci]) > atol
                p_in, ns = normalize.normalize_scene(
                    p0, t1y=t1y, unity_comp_ind=uci, min_shift=atol)
            p_out, code, iters, err, trials = lm_device.run_lm_on_device(
                p_in, blocks_fn=blocks_fn, solve_fn=sf,
                apply_fn=apply_fn, err_fn=err_fn,
                err_thresh=term_crit.allowed_reproj_err_rel_change,
                max_factor=term_crit.max_hessian_factor,
                max_iters=max_iters, valid=valid)
            if normalize_cfg is not None:
                p_rev = normalize.revert_normalization(p_out, ns)
                p_out = jax.tree.map(
                    lambda a, b: jnp.where(valid, a, b), p_rev, p0)
            # pack the scalars: ONE device->host fetch instead of four
            # (the counts are < 2^24 so f32 carries them exactly)
            stats = jnp.stack([code.astype(jnp.float32),
                               iters.astype(jnp.float32),
                               trials.astype(jnp.float32),
                               err.astype(jnp.float32)])
            return p_out, stats
        driver._dev_run = jax.jit(runner)
        driver._dev_key = key
        driver._mi_cache = {}
    mi = driver._mi_cache.get(term_crit.max_iters)
    if mi is None:      # cache the pushed scalar: one h2d per budget value
        mi = jnp.asarray(term_crit.max_iters, jnp.int32)
        driver._mi_cache[term_crit.max_iters] = mi
    args = (p, mi) if solve_extra is None else (p, mi, solve_extra)
    p_out, stats = driver._dev_run(*args)
    import numpy as np
    stats = np.asarray(stats)
    code = int(stats[0])
    driver.iterations = int(stats[1])
    driver.trials = int(stats[2])
    driver.stop_reason = lm_device.STOP_REASON_STR.get(code, "")
    return lm_device.STOP_OK.get(code, True), p_out


@dataclass
class BundleAdjustment:
    unity_comp_ind: int = 1
    t1y: float = 1.0
    optimize_intrinsics: bool = True
    pin_frames: tuple = ()      # fixed-keyframe BA: these poses never move
    device_loop: bool = False   # run the WHOLE LM as one compiled program
    stop_reason: str = field(default="", init=False)
    iterations: int = field(default=0, init=False)
    trials: int = field(default=0, init=False)   # damped solves incl. rejected

    def __post_init__(self):
        pins = tuple(int(f) for f in self.pin_frames)
        self._compute_blocks = jax.jit(functools.partial(
            derivs.compute_blocks, unity_comp_ind=self.unity_comp_ind,
            optimize_intrinsics=self.optimize_intrinsics, pin_frames=pins))
        self._solve = jax.jit(functools.partial(
            schur.solve_corrections_schur, unity_comp_ind=self.unity_comp_ind,
            optimize_intrinsics=self.optimize_intrinsics, pin_frames=pins))
        self._apply = jax.jit(derivs.apply_corrections)
        self._err = jax.jit(reproj_error)
        # jitted gauge transforms: one dispatch each instead of one per
        # eager op
        self._normalize = jax.jit(functools.partial(
            normalize.normalize_scene, t1y=self.t1y,
            unity_comp_ind=self.unity_comp_ind))
        self._revert = jax.jit(normalize.revert_normalization)
        self._dev_run = None
        self._dev_key = None

    def compute_inplace(self, p: BAProblem,
                        term_crit: TermCriteria | None = None
                        ) -> tuple[bool, BAProblem]:
        """Full pipeline: normalize gauge, optimize, revert. Returns
        (converged, optimized problem in the original gauge).

        With device_loop the gauge check/transform/revert are FUSED into the
        LM program: one dispatch + one packed fetch per BA call (the
        host-sequenced form pays a blocking can_normalize fetch plus two
        extra dispatches)."""
        term_crit = term_crit or TermCriteria()
        if self.device_loop:
            pins = tuple(int(f) for f in self.pin_frames)
            blocks_fn = functools.partial(
                derivs.compute_blocks, unity_comp_ind=self.unity_comp_ind,
                optimize_intrinsics=self.optimize_intrinsics,
                pin_frames=pins)
            solve_fn = lambda _p, blocks, factor: schur.solve_corrections_schur(  # noqa: E731
                blocks, factor, unity_comp_ind=self.unity_comp_ind,
                optimize_intrinsics=self.optimize_intrinsics,
                pin_frames=pins)
            return _run_device_loop(
                self, p, term_crit, blocks_fn, solve_fn,
                derivs.apply_corrections, reproj_error,
                normalize_cfg=(self.t1y, self.unity_comp_ind, 1e-5))
        if not normalize.can_normalize(p, self.unity_comp_ind):
            self.stop_reason = "cannot normalize (zero cam0-cam1 shift)"
            return False, p
        p_norm, ns = self._normalize(p)
        ok, p_opt = self.compute_on_normalized_world(p_norm, term_crit)
        return ok, self._revert(p_opt, ns)

    def compute_on_normalized_world(self, p: BAProblem,
                                    term_crit: TermCriteria
                                    ) -> tuple[bool, BAProblem]:
        if self.device_loop:
            pins = tuple(int(f) for f in self.pin_frames)
            blocks_fn = functools.partial(
                derivs.compute_blocks, unity_comp_ind=self.unity_comp_ind,
                optimize_intrinsics=self.optimize_intrinsics, pin_frames=pins)
            solve_fn = lambda _p, blocks, factor: schur.solve_corrections_schur(  # noqa: E731
                blocks, factor, unity_comp_ind=self.unity_comp_ind,
                optimize_intrinsics=self.optimize_intrinsics, pin_frames=pins)
            return _run_device_loop(
                self, p, term_crit, blocks_fn, solve_fn,
                derivs.apply_corrections, reproj_error)
        hessian_factor = 1e-4
        err_value = float(self._err(p))
        err_thresh = term_crit.allowed_reproj_err_rel_change
        # dtype-aware convergence floor: once a (damped) trial step changes
        # the error by less than a few ulps of the error itself, no further
        # progress is representable — declare convergence instead of damping
        # up to "hessian overflow". The reference never needed this (always
        # f64, rt-config.h:42); in f32 the configured thresholds
        # (e.g. dino 4.56e-8 rel) sit below the f32 resolution of the error.
        eps_floor = 32.0 * float(jnp.finfo(p.points.dtype).eps)
        self.iterations = 0
        self.trials = 0

        for _ in range(term_crit.max_iters):
            blocks = self._compute_blocks(p)
            # inner damping loop: find a factor that decreases the error
            err_new_prev = None
            while True:
                dX, du, ok = self._solve(blocks, hessian_factor)
                self.trials += 1
                if bool(ok):
                    p_try = self._apply(p, dX, du)
                    err_new = float(self._err(p_try))
                    if err_new < err_value:
                        p = p_try
                        break
                    if 0.0 <= err_new - err_value <= eps_floor * err_value:
                        self.stop_reason = "converged at dtype precision"
                        return True, p
                    if (err_new_prev is not None and err_thresh is not None
                            and abs(err_new - err_new_prev) < err_thresh):
                        self.stop_reason = "err converged to limit value"
                        return False, p
                    err_new_prev = err_new
                # non-finite solve (indefinite damped system) or no decrease:
                # more damping — only a factor beyond the cap is fatal
                hessian_factor *= 10.0
                if (term_crit.max_hessian_factor is not None
                        and hessian_factor > term_crit.max_hessian_factor):
                    self.stop_reason = "hessian overflow"
                    return False, p

            self.iterations += 1
            err_change = err_new - err_value
            if err_thresh is not None and abs(err_change) < err_thresh:
                self.stop_reason = "small relative err change"
                return True, p
            err_value = err_new
            hessian_factor /= 10.0

        self.stop_reason = "max iterations"
        return True, p


@dataclass
class SparseBundleAdjustment:
    """LM driver over the padded-track sparse problem (models/ba/sparse.py)
    with the same damping schedule/termination as :class:`BundleAdjustment`.
    Used for the at-scale configuration; optionally distributed by passing a
    mesh (point-sharded Schur with psum reduction)."""

    unity_comp_ind: int = 1
    optimize_intrinsics: bool = True
    point_chunk: int = 2048
    mesh: object = None          # jax.sharding.Mesh -> distributed solve
    pin_frames: tuple = ()       # fixed-keyframe BA
    device_loop: bool = False    # run the WHOLE LM as one compiled program
    band: bool = True            # banded Schur reduction when the
                                 # observation graph is frame-local
                                 # (sparse.plan_bands; auto-fallback)
    stop_reason: str = field(default="", init=False)
    iterations: int = field(default=0, init=False)
    trials: int = field(default=0, init=False)   # damped solves incl. rejected

    def __post_init__(self):
        from surikatoko_tpu.models.ba import sparse as sp

        self._sp = sp
        self._err = jax.jit(sp.reproj_error)
        self._blocks = jax.jit(functools.partial(
            sp.compute_blocks, unity_comp_ind=self.unity_comp_ind,
            optimize_intrinsics=self.optimize_intrinsics,
            pin_frames=tuple(int(f) for f in self.pin_frames)))
        self._apply = jax.jit(sp.apply_corrections)
        self._normalize = jax.jit(functools.partial(
            normalize.normalize_scene, unity_comp_ind=self.unity_comp_ind))
        self._revert = jax.jit(normalize.revert_normalization)
        self._solver = None
        self._dev_run = None
        self._dev_key = None

    def set_plan_inputs(self, frame_idx, obs_mask) -> None:
        """Host-side numpy (frame_idx, obs_mask) for the banding plan.

        plan_bands is pure numpy; without these it np.asarray's the
        problem's DEVICE arrays — a bulk device->host fetch that a host copy
        avoids. Callers that build the problem from host data (the MVF
        pipeline, the demos) should hand the originals over."""
        import numpy as np
        self._plan_inputs = (np.asarray(frame_idx), np.asarray(obs_mask))

    def _plan_src(self, p):
        fi_om = getattr(self, "_plan_inputs", None)
        if fi_om is not None and fi_om[0].shape == p.frame_idx.shape:
            return fi_om
        return p.frame_idx, p.obs_mask

    def _plan_band(self, p):
        """Host-side banding plan + jitted local solver. The compiled solver
        depends only on the band GEOMETRY (W, chunk counts/sizes) — the
        point permutation ext_idx is a traced argument, so re-planning a
        grown problem with the same geometry reuses the compiled program
        (the MVF's periodic global BA re-plans every run)."""
        if p.frame_idx is getattr(self, "_planned_fi", None):
            return          # same observation structure object: plan holds
        self._planned_fi = p.frame_idx
        fi_plan, om_plan = self._plan_src(p)
        pins = tuple(int(f) for f in self.pin_frames)
        plan = None
        if self.band and self.mesh is not None:
            plan = self._sp.plan_bands_sharded(
                fi_plan, om_plan, self.mesh.devices.size,
                self.point_chunk, p.n_frames)
            sig = None if plan is None else (
                plan.band_width, plan.n_banded_chunks, plan.overflow_chunk,
                plan.point_chunk, plan.ext_idx.shape)
            self._mesh_band_plan = plan
            self._band_ext = (None if plan is None
                              else jnp.asarray(plan.ext_idx))
            # ext_idx is a TRACED argument everywhere (incl. the device
            # loop via solve_extra): only a band GEOMETRY change recompiles
            if getattr(self, "_band_sig", ...) != sig:
                self._band_sig = sig
                self._dev_run = None
                self._solver = None          # rebuild with the new geometry
            return
        if self.band and self.mesh is None:
            plan = self._sp.plan_bands(
                fi_plan, om_plan, self.point_chunk, p.n_frames)
        sig = None if plan is None else (
            plan.band_width, plan.n_banded_chunks, plan.overflow_chunk,
            plan.point_chunk, plan.ext_idx.shape)
        self._band_ext = None if plan is None else jnp.asarray(plan.ext_idx)
        if getattr(self, "_band_sig", ...) == sig:
            return
        self._band_sig = sig
        self._dev_run = None     # the compiled device loop bakes the solver in
        if plan is not None:
            self._local_solver = jax.jit(functools.partial(
                self._sp.solve_corrections_schur_banded, plan=plan,
                unity_comp_ind=self.unity_comp_ind,
                optimize_intrinsics=self.optimize_intrinsics,
                pin_frames=pins))
        else:
            self._local_solver = jax.jit(functools.partial(
                self._sp.solve_corrections_schur_sparse,
                unity_comp_ind=self.unity_comp_ind,
                optimize_intrinsics=self.optimize_intrinsics,
                point_chunk=self.point_chunk, pin_frames=pins))

    def _solve(self, p, blocks, factor, ext=None):
        if ext is None:
            ext = self._band_ext
        if self.mesh is not None:
            if self._solver is None:
                from surikatoko_tpu.parallel.sharded_schur import (
                    make_sharded_sparse_schur_solver)

                self._solver = make_sharded_sparse_schur_solver(
                    p.n_points, p.n_frames, p.track_len, self.mesh,
                    self.unity_comp_ind, self.optimize_intrinsics,
                    self.point_chunk,
                    tuple(int(f) for f in self.pin_frames),
                    band_plan=getattr(self, "_mesh_band_plan", None))
            if getattr(self, "_mesh_band_plan", None) is not None:
                return self._solver(p, blocks, factor, ext)
            return self._solver(p, blocks, factor)
        if not hasattr(self, "_local_solver"):
            self._plan_band(p)
        if ext is not None:
            return self._local_solver(p, blocks, factor, ext_idx=ext)
        return self._local_solver(p, blocks, factor)

    def compute_inplace(self, p, term_crit: TermCriteria | None = None):
        """Full pipeline mirroring :meth:`BundleAdjustment.compute_inplace`:
        normalize gauge, optimize, revert. The normalization functions only
        touch points/cfw_R/cfw_t, so they apply to BAProblemSparse
        unchanged (reference SceneNormalizer, bundle-adj-kanatani.cpp:123).
        With device_loop the gauge check/transform/revert are fused into the
        one-dispatch LM program (see BundleAdjustment.compute_inplace)."""
        term_crit = term_crit or TermCriteria()
        if self.device_loop:
            self._plan_band(p)
            pins = tuple(int(f) for f in self.pin_frames)
            blocks_fn = functools.partial(
                self._sp.compute_blocks, unity_comp_ind=self.unity_comp_ind,
                optimize_intrinsics=self.optimize_intrinsics,
                pin_frames=pins)
            return _run_device_loop(
                self, p, term_crit, blocks_fn, self._solve,
                self._sp.apply_corrections, self._sp.reproj_error,
                solve_extra=self._band_ext,
                normalize_cfg=(1.0, self.unity_comp_ind, 1e-5))
        if not normalize.can_normalize(p, self.unity_comp_ind):
            self.stop_reason = "cannot normalize (zero cam0-cam1 shift)"
            return False, p
        p_norm, ns = self._normalize(p)
        ok, p_opt = self.compute(p_norm, term_crit)
        return ok, self._revert(p_opt, ns)

    def compute(self, p, term_crit: TermCriteria | None = None):
        term_crit = term_crit or TermCriteria()
        self._plan_band(p)
        if self.device_loop:
            pins = tuple(int(f) for f in self.pin_frames)
            blocks_fn = functools.partial(
                self._sp.compute_blocks, unity_comp_ind=self.unity_comp_ind,
                optimize_intrinsics=self.optimize_intrinsics,
                pin_frames=pins)
            # banded: the point permutation rides as a traced argument so a
            # grown problem with unchanged band geometry reuses the program
            return _run_device_loop(
                self, p, term_crit, blocks_fn, self._solve,
                self._sp.apply_corrections, self._sp.reproj_error,
                solve_extra=self._band_ext)
        hessian_factor = 1e-4
        err_value = float(self._err(p))
        err_thresh = term_crit.allowed_reproj_err_rel_change
        eps_floor = 32.0 * float(jnp.finfo(p.points.dtype).eps)  # see above
        self.iterations = 0
        self.trials = 0
        for _ in range(term_crit.max_iters):
            blocks = self._blocks(p)
            err_new_prev = None
            while True:
                dX, du, ok = self._solve(p, blocks, hessian_factor)
                self.trials += 1
                if bool(ok):
                    p_try = self._apply(p, dX, du)
                    err_new = float(self._err(p_try))
                    if err_new < err_value:
                        p = p_try
                        break
                    if 0.0 <= err_new - err_value <= eps_floor * err_value:
                        self.stop_reason = "converged at dtype precision"
                        return True, p
                    if (err_new_prev is not None and err_thresh is not None
                            and abs(err_new - err_new_prev) < err_thresh):
                        self.stop_reason = "err converged to limit value"
                        return False, p
                    err_new_prev = err_new
                hessian_factor *= 10.0
                if (term_crit.max_hessian_factor is not None
                        and hessian_factor > term_crit.max_hessian_factor):
                    self.stop_reason = "hessian overflow"
                    return False, p
            self.iterations += 1
            if err_thresh is not None and abs(err_new - err_value) < err_thresh:
                self.stop_reason = "small relative err change"
                return True, p
            err_value = err_new
            hessian_factor /= 10.0
        self.stop_reason = "max iterations"
        return True, p
