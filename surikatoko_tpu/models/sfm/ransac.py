"""Batched RANSAC: all hypotheses evaluated in one vmap.

Reference: the prototype's sequential loop (py_proto/suriko/mvg.py:1879-1921,
``RansacIterationsCount`` / ``GetMaxSubsetInConsensus``). Batched design:
draw every minimal sample up front with jax.random, fit all models with one
vmap of the estimator, score all inlier masks as one [M, N] reduction, and
argmax — no data-dependent trip count (the classic adaptive-exit loop is
replaced by a generous static M, which on an accelerator costs less than the serial
dependency it removes).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


def ransac_iterations_count(success_prob: float, outlier_ratio: float,
                            sample_size: int) -> int:
    """Standard N = log(1-p) / log(1 - (1-eps)^s) (reference :1879)."""
    w = (1.0 - outlier_ratio) ** sample_size
    if w <= 0:
        return 10**6
    denom = np.log(max(1.0 - w, 1e-15))
    return max(1, int(np.ceil(np.log(max(1.0 - success_prob, 1e-15)) / denom)))


class RansacResult(NamedTuple):
    model: jnp.ndarray         # best model parameters
    inliers: jnp.ndarray       # [N] bool
    inlier_count: jnp.ndarray
    best_iter: jnp.ndarray


def ransac(
    key: jax.Array,
    data_size: int,
    sample_size: int,
    fit_fn: Callable[[jnp.ndarray], jnp.ndarray],
    # fit_fn(sample_idx [s]) -> model (pytree leaf array, or [C, ...] stack
    # of candidate models with candidates_axis=True)
    residual_fn: Callable[[jnp.ndarray], jnp.ndarray],
    # residual_fn(model) -> [N] squared residuals over the full data
    threshold: float,
    iterations: int,
    data_mask: jnp.ndarray | None = None,
    candidates_axis: bool = False,
) -> RansacResult:
    keys = jax.random.split(key, iterations)
    mask = (jnp.ones(data_size, bool) if data_mask is None else data_mask)

    def one(k):
        idx = jax.random.choice(k, data_size, shape=(sample_size,),
                                replace=False)
        model = fit_fn(idx)
        if candidates_axis:
            res = jax.vmap(residual_fn)(model)              # [C, N]
            ok = jnp.logical_and(res < threshold, mask[None, :])
            counts = jnp.sum(ok, axis=1)
            c = jnp.argmax(counts)
            return jax.tree.map(lambda m: m[c], model), counts[c]
        res = residual_fn(model)
        ok = jnp.logical_and(res < threshold, mask)
        return model, jnp.sum(ok)

    models, counts = jax.vmap(one)(keys)
    best = jnp.argmax(counts)
    model = jax.tree.map(lambda m: m[best], models)
    res = residual_fn(model)
    inliers = jnp.logical_and(res < threshold, mask)
    return RansacResult(model=model, inliers=inliers,
                        inlier_count=counts[best], best_iter=best)
