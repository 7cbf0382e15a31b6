"""Fully on-device LM loop: the reference's damping schedule as ONE compiled
program (nested lax.while_loop), so a whole bundle adjustment is a single
device dispatch.

The host-driven driver (lm.py) mirrors the reference's control flow
(ComputeOnNormalizedWorld, bundle-adj-kanatani.cpp:720-893) with 4 device
calls and 2+ blocking host syncs per iteration, and each sync serializes
host and device. This module compiles the identical control flow on device:

  outer while (running & iters < max):   recompute GN blocks at current p
    inner while (no accept/stop yet):    solve damped system at `factor`
      accept if err decreased            (rollback = carry the old pytree)
      else damp x10, with the dtype-precision / err-limit / overflow exits

Semantics match lm.py exactly (tests/test_lm_device.py checks identical
iteration counts, stop reasons, and final errors) — the functional-state
snapshot/rollback the reference does with explicit map/camera backups
(:767-771, :823-826) is a lax.select over the problem pytree here.

Works for the dense (schur.py) and sparse (sparse.py) problems alike: the
caller injects blocks/solve/apply/err callables. Being one jittable function
it also vmaps — batch BA over many problems, which the reference (and the
host driver) cannot do.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp

STOP_RUNNING = 0
STOP_SMALL_REL_CHANGE = 1    # "small relative err change"        (ok=True)
STOP_DTYPE_PRECISION = 2     # "converged at dtype precision"     (ok=True)
STOP_ERR_LIMIT = 3           # "err converged to limit value"     (ok=False)
STOP_HESSIAN_OVERFLOW = 4    # "hessian overflow"                 (ok=False)
STOP_MAX_ITERS = 5           # "max iterations"                   (ok=True)
STOP_CANNOT_NORMALIZE = 6    # "cannot normalize ..."             (ok=False)

STOP_REASON_STR = {
    STOP_SMALL_REL_CHANGE: "small relative err change",
    STOP_DTYPE_PRECISION: "converged at dtype precision",
    STOP_ERR_LIMIT: "err converged to limit value",
    STOP_HESSIAN_OVERFLOW: "hessian overflow",
    STOP_MAX_ITERS: "max iterations",
    STOP_CANNOT_NORMALIZE: "cannot normalize (zero cam0-cam1 shift)",
}
STOP_OK = {
    STOP_SMALL_REL_CHANGE: True,
    STOP_DTYPE_PRECISION: True,
    STOP_ERR_LIMIT: False,
    STOP_HESSIAN_OVERFLOW: False,
    STOP_MAX_ITERS: True,
    STOP_CANNOT_NORMALIZE: False,
}


class _Outer(NamedTuple):
    p: Any
    err: jnp.ndarray
    factor: jnp.ndarray
    iters: jnp.ndarray
    code: jnp.ndarray
    trials: jnp.ndarray   # total damped solves (incl. rejected trials)


class _Inner(NamedTuple):
    factor: jnp.ndarray
    err_prev: jnp.ndarray
    has_prev: jnp.ndarray
    p_try: Any
    err_try: jnp.ndarray
    status: jnp.ndarray   # 0 keep damping, 1 accepted, else a STOP_* code
    trials: jnp.ndarray


def _select_tree(pred, a, b):
    return jax.tree.map(lambda x, y: jnp.where(pred, x, y), a, b)


def run_lm_on_device(
    p0: Any,
    *,
    blocks_fn: Callable[[Any], Any],
    solve_fn: Callable[[Any, Any, jnp.ndarray], tuple],
    apply_fn: Callable[[Any, jnp.ndarray, jnp.ndarray], Any],
    err_fn: Callable[[Any], jnp.ndarray],
    err_thresh: float | None,
    max_factor: float | None,
    max_iters: int,
    initial_factor: float = 1e-4,
    eps_floor_mult: float = 32.0,
    valid: jnp.ndarray | None = None,
) -> tuple[Any, jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Returns (p_final, stop_code, iterations, final_err, trials) where
    ``trials`` counts every damped solve including rejected damping retries
    (``iterations`` counts only accepted steps — on a near-converged problem
    the two diverge, and trials is what wall-clock scales with).
    Trace-friendly: call under jax.jit (or vmap for batch BA).

    ``valid`` (optional traced bool) gates the whole loop: when False the
    LM never runs and the stop code is STOP_CANNOT_NORMALIZE — the fused
    normalize->LM->revert program (lm._run_device_loop) rides the gauge
    validity check here instead of a separate blocking host fetch."""
    err0 = err_fn(p0)
    dtype = err0.dtype
    eps_floor = eps_floor_mult * float(jnp.finfo(dtype).eps)

    def inner_cond(t: _Inner):
        return t.status == 0

    def outer_cond(c: _Outer):
        return c.code == STOP_RUNNING

    def outer_body(c: _Outer):
        blocks = blocks_fn(c.p)

        def inner_body(t: _Inner):
            dX, du, ok = solve_fn(c.p, blocks, t.factor)
            p_try = apply_fn(c.p, dX, du)
            err_new = err_fn(p_try)
            ok = jnp.logical_and(ok, jnp.isfinite(err_new))
            decreased = jnp.logical_and(ok, err_new < c.err)
            # host loop order (lm.py): decrease -> dtype floor -> err limit ->
            # damp (overflow check after damping)
            diff = err_new - c.err
            dtype_conv = (ok & ~decreased & (diff >= 0)
                          & (diff <= eps_floor * c.err))
            if err_thresh is not None:
                limit = (ok & ~decreased & ~dtype_conv & t.has_prev
                         & (jnp.abs(err_new - t.err_prev) < err_thresh))
            else:
                limit = jnp.asarray(False)
            next_factor = t.factor * 10.0
            stop_damping = decreased | dtype_conv | limit
            if max_factor is not None:
                overflow = ~stop_damping & (next_factor > max_factor)
            else:
                overflow = jnp.asarray(False)
            status = jnp.where(
                decreased, 1,
                jnp.where(dtype_conv, STOP_DTYPE_PRECISION,
                          jnp.where(limit, STOP_ERR_LIMIT,
                                    jnp.where(overflow, STOP_HESSIAN_OVERFLOW,
                                              0)))).astype(jnp.int32)
            return _Inner(
                factor=jnp.where(decreased, t.factor, next_factor),
                err_prev=jnp.where(ok, err_new, t.err_prev),
                has_prev=jnp.logical_or(t.has_prev, ok),
                p_try=p_try,
                err_try=err_new,
                status=status,
                trials=t.trials + 1)

        t0 = _Inner(factor=c.factor,
                    err_prev=jnp.zeros((), dtype),
                    has_prev=jnp.asarray(False),
                    p_try=c.p,
                    err_try=c.err,
                    status=jnp.asarray(0, jnp.int32),
                    trials=jnp.zeros((), jnp.int32))
        t = jax.lax.while_loop(inner_cond, inner_body, t0)

        accepted = t.status == 1
        p_new = _select_tree(accepted, t.p_try, c.p)
        err_new = jnp.where(accepted, t.err_try, c.err)
        iters = c.iters + accepted.astype(jnp.int32)
        if err_thresh is not None:
            small_rel = accepted & (jnp.abs(err_new - c.err) < err_thresh)
        else:
            small_rel = jnp.asarray(False)
        code = jnp.where(
            ~accepted, t.status,
            jnp.where(small_rel, STOP_SMALL_REL_CHANGE,
                      jnp.where(iters >= max_iters, STOP_MAX_ITERS,
                                STOP_RUNNING))).astype(jnp.int32)
        return _Outer(p=p_new, err=err_new,
                      factor=jnp.where(accepted, t.factor / 10.0, t.factor),
                      iters=iters, code=code, trials=c.trials + t.trials)

    code0 = jnp.asarray(STOP_RUNNING, jnp.int32)
    if valid is not None:
        code0 = jnp.where(valid, code0, STOP_CANNOT_NORMALIZE).astype(
            jnp.int32)
    c0 = _Outer(p=p0, err=err0,
                factor=jnp.asarray(initial_factor, dtype),
                iters=jnp.zeros((), jnp.int32),
                code=code0,
                trials=jnp.zeros((), jnp.int32))
    c = jax.lax.while_loop(outer_cond, outer_body, c0)
    return c.p, c.code, c.iters, c.err, c.trials
