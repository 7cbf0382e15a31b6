"""EKF measurement updates: the four strategies of the reference engine, all
masked/batched so they jit with a fixed landmark capacity.

Reference mapping (davison-mono-slam.cpp):
  1. stacked_update       <- ProcessFrame_StackedObservationsPerUpdateCore :977
  2. one_obs_update       <- ProcessFrame_OneObservationPerUpdate :1153
  3. one_component_update <- ProcessFrame_OneComponentOfOneObservationPerUpdate :1525
  4. one_point_ransac_update <- ProcessFrame_OnePointRansacUpdateCore :1393

The dense observation matrix H[2m, D] is never materialized: H is block-sparse
(camera block + per-landmark diagonal), so every product is an einsum over the
per-slot blocks Hcam [K,2,13] / Hlm [K,2,6]. Unobserved slots contribute zero
rows; the innovation covariance stays invertible because R occupies their
diagonal. Gains for those rows are exactly zero, so masking is free — no
gather/scatter, no shape changes (this replaces the reference's building of
compressed H for the observed subset).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.scipy.linalg import cho_factor, cho_solve, solve_triangular

from surikatoko_tpu.models.monoslam import measure
from surikatoko_tpu.models.monoslam.state import CAM_STATE_COMPS, MonoSlamParams

_N = CAM_STATE_COMPS


class UpdateInfo(NamedTuple):
    resid_before: jnp.ndarray   # [K,2] masked innovation before update
    obs_count: jnp.ndarray      # number of observations used
    low_innov_count: jnp.ndarray   # RANSAC stage-1 size (0 for other impls)
    high_innov_count: jnp.ndarray  # RANSAC stage-2 size


def _masked_jacobians(params: MonoSlamParams, x: jnp.ndarray, obs_mask: jnp.ndarray):
    h, Hcam, Hlm = measure.measurement_jacobians(params, x)
    m = obs_mask[:, None, None].astype(x.dtype)
    return h, Hcam * m, Hlm * m


def _dense_h(Hcam: jnp.ndarray, Hlm: jnp.ndarray) -> jnp.ndarray:
    """Materialize H [2K, 13+6K] from the per-slot blocks.

    The reference never builds H either (it compresses the observed subset);
    an earlier revision here kept H implicit and computed A = H P with
    per-slot [2,6]x[6,D] einsums, which never form a big contraction. One
    2K x D dense matmul replaces them despite doing ~40x the FLOPs.
    """
    K = Hcam.shape[0]
    eye = jnp.eye(K, dtype=Hcam.dtype)
    lm_block = jnp.einsum("kij,kl->kilj", Hlm, eye).reshape(2 * K, 6 * K)
    return jnp.concatenate([Hcam.reshape(2 * K, _N), lm_block], axis=1)


def _hp(Hcam: jnp.ndarray, Hlm: jnp.ndarray, P: jnp.ndarray) -> jnp.ndarray:
    """A = H P as [K,2,D] (dense matmul at small K, blocked at large K)."""
    K = Hcam.shape[0]
    return hp_auto(Hcam, Hlm, P).reshape(K, 2, P.shape[-1])


def _h_group(K: int) -> int:
    """Landmark-group size for the blocked H application: the first of
    64/128/32 slots that divides K (so no padding logic), or 0 to use the
    dense path. Dense is used at small K (the [2K,D] matmul is latency-bound
    there and grouping only adds dispatches)."""
    if K < 256:
        return 0
    for g in (64, 128, 32):     # 6g = 384 / 768 / 192 contraction widths
        if K % g == 0:
            return g
    return 0


def hp_blocked(Hcam: jnp.ndarray, Hlm: jnp.ndarray, P: jnp.ndarray,
               group: int) -> jnp.ndarray:
    """A = H P [2K, D] without materializing the [2K, 6K] zero-block sea.

    H's landmark half is block-diagonal ([2,6] per slot). Grouping g slots
    gives a batched [K/g, 2g, 6g] @ [K/g, 6g, D] matmul with K/g = ~12x
    fewer FLOPs than the dense product at the ~1k-landmark regime (where H@P
    is the single largest matmul of the frame: 2K x D x D). Identical
    numerics up to matmul reassociation."""
    K, D = Hcam.shape[0], P.shape[-1]
    g = group
    G = K // g
    blk = jnp.einsum("maij,ab->maibj", Hlm.reshape(G, g, 2, 6),
                     jnp.eye(g, dtype=Hlm.dtype)).reshape(G, 2 * g, 6 * g)
    P_lm = P[_N:, :].reshape(G, 6 * g, D)
    A_lm = jnp.einsum("mrc,mcd->mrd", blk, P_lm).reshape(2 * K, D)
    return Hcam.reshape(2 * K, _N) @ P[:_N, :] + A_lm


def aht_blocked(A2: jnp.ndarray, Hcam: jnp.ndarray, Hlm: jnp.ndarray,
                group: int) -> jnp.ndarray:
    """T = A H^T [2K, 2K] with the same grouped block-diagonal structure
    (columns of H^T = rows of H touch 13 camera + 6 own-slot entries)."""
    K = Hcam.shape[0]
    g = group
    G = K // g
    blk = jnp.einsum("maij,ab->maibj", Hlm.reshape(G, g, 2, 6),
                     jnp.eye(g, dtype=Hlm.dtype)).reshape(G, 2 * g, 6 * g)
    A_lm = A2[:, _N:].reshape(2 * K, G, 6 * g)
    T_lm = jnp.einsum("nmc,mrc->nmr", A_lm, blk).reshape(2 * K, 2 * K)
    return A2[:, :_N] @ Hcam.reshape(2 * K, _N).T + T_lm


def hp_auto(Hcam: jnp.ndarray, Hlm: jnp.ndarray, P: jnp.ndarray
            ) -> jnp.ndarray:
    """A = H P [2K, D]: blocked at large K, dense otherwise."""
    g = _h_group(Hcam.shape[0])
    if g:
        return hp_blocked(Hcam, Hlm, P, g)
    return _dense_h(Hcam, Hlm) @ P


def aht_auto(A2: jnp.ndarray, Hcam: jnp.ndarray, Hlm: jnp.ndarray
             ) -> jnp.ndarray:
    """T = A H^T [2K, 2K]: blocked at large K, dense otherwise."""
    g = _h_group(Hcam.shape[0])
    if g:
        return aht_blocked(A2, Hcam, Hlm, g)
    return A2 @ _dense_h(Hcam, Hlm).T


def stacked_update(params: MonoSlamParams, x: jnp.ndarray, P: jnp.ndarray,
                   obs: jnp.ndarray, obs_mask: jnp.ndarray
                   ) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """One stacked EKF update over all observed slots.

    Returns (x', P', masked residual [K,2]). Hot path: three dense
    matmuls A = H P, S = A H^T + R, P -= B^T B (reference :1004-1114), where
    B = C^-1 A for the innovation Cholesky factor S = C C^T. Writing the
    downdate as the Gram product B^T B (instead of K S K^T with the explicit
    gain) needs ONE [2K]-wide triangular solve over the D columns and is
    exactly symmetric element-by-element — no 0.5 (P + P^T) repair pass over
    the [D,D] covariance afterwards (the reference's FixSymmetricMat :4308
    becomes unnecessary on this path by construction).
    """
    Kcap = obs_mask.shape[0]
    h, Hcam, Hlm = _masked_jacobians(params, x, obs_mask)
    resid = (obs - h) * obs_mask[:, None].astype(x.dtype)

    A2 = hp_auto(Hcam, Hlm, P)                     # [2K, D] = H P
    r_var = params.measurm_noise_var.astype(x.dtype)
    S2 = aht_auto(A2, Hcam, Hlm) + r_var * jnp.eye(2 * Kcap, dtype=x.dtype)
    r2 = resid.reshape(2 * Kcap)

    C = jnp.linalg.cholesky(S2)                    # S = C C^T
    B = solve_triangular(C, A2, lower=True)        # [2K, D] = C^-1 H P
    y = solve_triangular(C, r2, lower=True)        # whitened innovation
    x_new = x + B.T @ y                            # = P H^T S^-1 r
    P_new = P - B.T @ B                            # = P - K S K^T, symmetric
    return x_new, P_new, resid


def _slot_jacobian(params: MonoSlamParams, x: jnp.ndarray, slot: jnp.ndarray):
    """(h [2], Hcam [2,13], Hlm [2,6]) for one (dynamically indexed) slot."""
    cam13 = x[:_N]
    lm = jax.lax.dynamic_slice(x, (_N + slot * 6,), (6,))
    h_fn = lambda c, l: measure.project_landmark(params, c, l)
    h = h_fn(cam13, lm)
    Hcam, Hlm = jax.jacfwd(h_fn, argnums=(0, 1))(cam13, lm)
    return h, Hcam, Hlm, lm


def _rank2_gain(P: jnp.ndarray, slot: jnp.ndarray, Hcam: jnp.ndarray,
                Hlm: jnp.ndarray, r_var: jnp.ndarray):
    """P H_k^T [D,m] and S_k [m,m] for a single observation block k
    (m = number of measurement rows: 2 for a pixel, 1 for one component)."""
    D = P.shape[0]
    m = Hcam.shape[0]
    P_cam_cols = P[:, :_N]                                     # [D,13]
    P_lm_cols = jax.lax.dynamic_slice(P, (0, _N + slot * 6), (D, 6))
    PHt = P_cam_cols @ Hcam.T + P_lm_cols @ Hlm.T              # [D,m]
    # S = H (P H^T) + R: take rows 0:13 and the slot rows of PHt
    S = Hcam @ PHt[:_N, :] + Hlm @ jax.lax.dynamic_slice(PHt, (_N + slot * 6, 0), (6, m))
    S = S + r_var * jnp.eye(m, dtype=P.dtype)
    return PHt, S


def one_obs_update(params: MonoSlamParams, x: jnp.ndarray, P: jnp.ndarray,
                   obs: jnp.ndarray, obs_mask: jnp.ndarray
                   ) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Sequential rank-2 updates, one observation at a time, recomputing the
    Jacobian at the running state (reference :1153-1523). lax.scan over slots;
    masked slots are no-ops.

    SCALING NOTE: each scan step writes a full [D,D] covariance, so a frame
    costs K full HBM passes over P (one_component_update: 2K) — faithful to
    the reference's semantics and fine at test sizes, but O(K) worse than
    the stacked/fused update at the ~1k-landmark regime. Use update_impl=1
    (or the fused step) for large-K runs; these exist for parity and for
    their stronger per-observation relinearization."""
    Kcap = obs_mask.shape[0]
    r_var = params.measurm_noise_var.astype(x.dtype)
    h0, _, _ = measure.measurement_jacobians(params, x)
    resid0 = (obs - h0) * obs_mask[:, None].astype(x.dtype)

    def body(carry, slot):
        x_c, P_c = carry
        h, Hcam, Hlm, _ = _slot_jacobian(params, x_c, slot)
        PHt, S = _rank2_gain(P_c, slot, Hcam, Hlm, r_var)
        Kg = PHt @ jnp.linalg.inv(S)                          # [D,2]
        dx = Kg @ (obs[slot] - h)
        dP = -Kg @ S @ Kg.T
        use = obs_mask[slot].astype(x.dtype)
        x_n = x_c + use * dx
        P_n = P_c + use * dP
        P_n = 0.5 * (P_n + P_n.T)
        return (x_n, P_n), None

    (x_new, P_new), _ = jax.lax.scan(body, (x, P), jnp.arange(Kcap))
    return x_new, P_new, resid0


def one_component_update(params: MonoSlamParams, x: jnp.ndarray, P: jnp.ndarray,
                         obs: jnp.ndarray, obs_mask: jnp.ndarray
                         ) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Sequential scalar (rank-1) updates: each pixel coordinate separately
    (reference :1525-1649)."""
    Kcap = obs_mask.shape[0]
    r_var = params.measurm_noise_var.astype(x.dtype)
    h0, _, _ = measure.measurement_jacobians(params, x)
    resid0 = (obs - h0) * obs_mask[:, None].astype(x.dtype)

    def body(carry, idx):
        x_c, P_c = carry
        slot = idx // 2
        comp = idx % 2
        h, Hcam, Hlm, _ = _slot_jacobian(params, x_c, slot)
        Hcam1 = jax.lax.dynamic_slice(Hcam, (comp, 0), (1, _N))
        Hlm1 = jax.lax.dynamic_slice(Hlm, (comp, 0), (1, 6))
        PHt, S = _rank2_gain(P_c, slot, Hcam1, Hlm1, r_var)   # [D,1],[1,1]
        Kg = PHt / S[0, 0]
        innov = jax.lax.dynamic_slice(obs[slot] - h, (comp,), (1,))
        use = obs_mask[slot].astype(x.dtype)
        x_n = x_c + use * (Kg @ innov)
        P_n = P_c - use * (S[0, 0] * (Kg @ Kg.T))
        P_n = 0.5 * (P_n + P_n.T)
        return (x_n, P_n), None

    (x_new, P_new), _ = jax.lax.scan(body, (x, P), jnp.arange(2 * Kcap))
    return x_new, P_new, resid0


def one_point_ransac_update(
    params: MonoSlamParams, x: jnp.ndarray, P: jnp.ndarray,
    obs: jnp.ndarray, obs_mask: jnp.ndarray,
    *,
    corner_max_divergence_pix: jnp.ndarray | None = None,
    high_innov_chi_square_thresh: jnp.ndarray | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Civera 1-Point RANSAC (SfM_EKF_Civera ch.5; reference :1271-1523).

    Stage 1: every matched observation is a hypothesis — apply its rank-2
    state-only update, project all landmarks through the hypothesis state, and
    count matches within ``corner_max_divergence_pix``; the winner's support
    set (low-innovation inliers, typically distant points) drives a stacked
    update. Stage 2: surviving matches within the chi-square gate of the
    *updated* prediction (high-innovation, typically close points) are rescued
    with a second stacked update. Hypotheses run as one vmap, not a loop.

    Returns (x', P', resid_before, low_count, high_count).
    """
    Kcap = obs_mask.shape[0]
    dtype = x.dtype
    r_var = params.measurm_noise_var.astype(dtype)
    if corner_max_divergence_pix is None:
        corner_max_divergence_pix = params.ransac_corner_max_divergence_pix
    if high_innov_chi_square_thresh is None:
        high_innov_chi_square_thresh = (
            params.ransac_high_innov_chi_square_thresh
            if params.ransac_high_innov_chi_square_thresh is not None
            else 9.21034)
    thr = (jnp.sqrt(params.measurm_noise_var)
           if corner_max_divergence_pix is None
           else jnp.asarray(corner_max_divergence_pix)).astype(dtype)

    h0, Hcam0, Hlm0 = measure.measurement_jacobians(params, x)
    resid0 = (obs - h0) * obs_mask[:, None].astype(dtype)

    def hypothesis_support(slot):
        _, Hcam, Hlm, _ = _slot_jacobian(params, x, slot)
        PHt, S = _rank2_gain(P, slot, Hcam, Hlm, r_var)
        Kg = PHt @ jnp.linalg.inv(S)
        x_hyp = x + Kg @ (obs[slot] - h0[slot])
        h_hyp = measure.project_all(params, x_hyp)
        dist = jnp.linalg.norm(obs - h_hyp, axis=-1)
        support = jnp.logical_and(obs_mask, dist < thr)
        return support, jnp.sum(support.astype(jnp.int32))

    supports, counts = jax.vmap(hypothesis_support)(jnp.arange(Kcap))
    counts = jnp.where(obs_mask, counts, -1)      # only matched slots hypothesize
    best = jnp.argmax(counts)
    low_mask = jnp.logical_and(supports[best], obs_mask)
    any_low = jnp.any(low_mask)

    x1, P1, _ = stacked_update(params, x, P, obs, low_mask)
    x1 = jnp.where(any_low, x1, x)
    P1 = jnp.where(any_low, P1, P)

    # Stage 2: chi-square gate on the updated state
    h1, Hcam1, Hlm1 = measure.measurement_jacobians(params, x1)
    m1 = obs_mask[:, None, None].astype(dtype)
    A1 = _hp(Hcam1 * m1, Hlm1 * m1, P1)
    # per-slot 2x2 innovation covariance: rows of A1 against own H blocks
    A1_lm = A1[:, :, _N:].reshape(Kcap, 2, Kcap, 6)
    own = jnp.einsum("kikd->kid", A1_lm)          # [K,2,6] slot-own columns
    S1 = (jnp.einsum("kid,kjd->kij", A1[:, :, :_N], Hcam1 * m1)
          + jnp.einsum("kid,kjd->kij", own, Hlm1 * m1)
          + r_var * jnp.eye(2, dtype=dtype))
    diff = obs - h1
    chi2 = jnp.einsum("ki,kij,kj->k", diff, jnp.linalg.inv(S1), diff)
    high_mask = jnp.logical_and(obs_mask, jnp.logical_not(low_mask))
    high_mask = jnp.logical_and(high_mask, chi2 < high_innov_chi_square_thresh)
    any_high = jnp.any(high_mask)

    x2, P2, _ = stacked_update(params, x1, P1, obs, high_mask)
    x2 = jnp.where(any_high, x2, x1)
    P2 = jnp.where(any_high, P2, P1)

    return x2, P2, resid0, jnp.sum(low_mask.astype(jnp.int32)), jnp.sum(high_mask.astype(jnp.int32))
