"""Fused EKF frame step: stacked update + variance clamp + quaternion
renormalization + kinematic predict as ONE covariance transform.

The sequential pipeline (device_runner.frame_body) materializes the [D,D]
covariance four times per frame:

  P1 = P - B^T B                      (stacked_update downdate)
  P2 = P1 * keep keep^T               (health.ensure_nonneg_variance)
  P3 = W P2 W^T + G Q G^T             (predict.normalize_and_predict)

All three are congruences: the nonneg mask is a *diagonal* congruence
(P * k k^T == diag(k) P diag(k) elementwise-exactly), so the composition
collapses algebraically with V = W diag(keep):

  P+ = V (P - B^T B) V^T + GQG = V P V^T - (B V^T)^T (B V^T) + GQG

and keep itself needs only diag(P1) = diag(P) - colsum(B^2) — no P1.
V differs from identity only on the 13 camera rows (W's predict/renorm block)
and the diagonal (keep), so V P V^T is one elementwise mask pass plus a
[13,D] stripe matmul, and the final downdate-with-epilogue writes P+ once:
~2 HBM passes over P instead of ~4. Numerically identical to the sequential
pipeline up to matmul reassociation (tests/test_fused_step.py checks 1e-12 on f64).

Reference mapping (davison-mono-slam.cpp): this one function covers the
per-frame sequence :1114 (P -= K S K^T), :1739 (EnsureNonnegativeStateVariance),
:1652 (NormalizeCameraOrientationQuaternionAndCovariances), :1713 (negative
inverse-depth substitution) and :639 (PredictEstimVars) — fused, not skipped.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

from surikatoko_tpu.models.monoslam import predict as predict_mod
from surikatoko_tpu.models.monoslam import update as update_mod
from surikatoko_tpu.models.monoslam.state import (
    CAM_STATE_COMPS,
    REPRES_SPHERICAL,
    MonoSlamParams,
)

_N = CAM_STATE_COMPS


class EpilogueResult(NamedTuple):
    x_next: jnp.ndarray   # [D] predicted state for the next frame
    Cp: jnp.ndarray       # [13,13] = F @ embed(Jq): predict+renorm cam block
    G: jnp.ndarray        # [13,6] process-noise injector
    x2: jnp.ndarray       # [D] post-health, post-renorm, PRE-predict state
    Jq: jnp.ndarray       # [4,4] quaternion-renorm Jacobian
    F: jnp.ndarray        # [13,13] plain kinematic transition Jacobian


def camera_epilogue(params: MonoSlamParams, x1: jnp.ndarray, Kcap: int
                    ) -> EpilogueResult:
    """State-side epilogue of a frame: negative-inverse-depth substitution
    (davison-mono-slam.cpp:1713), quaternion renormalization with its
    covariance Jacobian folded in (:1652), and the kinematic predict (:583).
    ``Cp`` is W's 13x13 camera block (transition Jacobian with the renorm
    Jacobian folded) and ``G`` the noise injector; ``x2``/``Jq``/``F`` expose
    the pre-predict state and the individual Jacobian factors for callers
    that splice work between renorm and predict (landmark recruitment).
    Shared by the single-chip fused step and the landmark-sharded one
    (parallel/sharded_ekf.make_sharded_fused_step)."""
    dtype = x1.dtype
    if params.sal_pnt_repres == REPRES_SPHERICAL:
        from surikatoko_tpu.models.monoslam import health as health_mod
        x1s, _ = health_mod.substitute_negative_inv_rho(
            x1, params.sal_pnt_negative_inv_rho_substitute, Kcap)
    else:
        x1s = x1
    q = x1s[3:7]
    qn = jnp.linalg.norm(q)
    nq = q / qn
    Jq = (jnp.eye(4, dtype=dtype) - jnp.outer(nq, nq)) / qn
    x2 = x1s.at[3:7].set(nq)
    cam13 = x2[:_N]
    new_cam = predict_mod.predict_camera(params, cam13)
    F, G = predict_mod.camera_transition_jacobians(params, cam13)
    Cp = F.at[:, 3:7].set(F[:, 3:7] @ Jq)               # W's 13x13 block
    x_next = x2.at[:_N].set(new_cam)
    return EpilogueResult(x_next, Cp, G, x2, Jq, F)


def fused_update_health_predict(
    params: MonoSlamParams, x: jnp.ndarray, P: jnp.ndarray,
    obs: jnp.ndarray, obs_mask: jnp.ndarray,
    *, precomputed: tuple | None = None,
    deactivate_mask: jnp.ndarray | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """One frame of the closed loop with update_impl=1.

    Returns (x_next, P_next, resid [K,2], x_post_update [D]) where
    (x_next, P_next) are *predicted* for the next frame and x_post_update is
    the updated-but-not-yet-predicted state (what the sequential pipeline
    reports per frame).

    ``precomputed`` optionally carries (h [K,2], A_un [2K,D], T_un [2K,2K])
    — the UNMASKED predicted pixels, A_un = H P and T_un = H P H^T evaluated
    at this same ``x``. The imageseq loop already builds these for the
    NCC search-ellipse prediction (reference
    GetSalientPointProjected2DPosWithUncertainty :3901), and masking is a
    row/col scaling: masked A2 = M A_un, masked S2 = M T_un M + R. Passing
    them in removes a duplicate Jacobian evaluation and a duplicate
    [2K,D]@[D,D] matmul per frame (identical numerics: masked rows of A_un
    are exact zeros either way).
    """
    Kcap = obs_mask.shape[0]
    x1, B, keep, resid = _fused_update_core(
        params, x, P, obs, obs_mask, precomputed, deactivate_mask)
    x_next, Cp, G = camera_epilogue(params, x1, Kcap)[:3]
    return _fused_covariance_predict(params, x, P, B, keep, x_next, Cp, G,
                                     resid, x1)


def _fused_update_core(params, x, P, obs, obs_mask, precomputed,
                       deactivate_mask):
    """Stacked update + keep-mask head of the fused frame step. Returns
    (x1 post-update state, B whitened gain precursor [2K,D], keep [D]
    diagonal congruence mask, resid [K,2])."""
    dtype = x.dtype
    Kcap = obs_mask.shape[0]
    r_var = params.measurm_noise_var.astype(dtype)

    if precomputed is None:
        # --- stacked update pieces (update.stacked_update :977-1114) ---
        h, Hcam, Hlm = update_mod._masked_jacobians(params, x, obs_mask)
        resid = (obs - h) * obs_mask[:, None].astype(dtype)
        A2 = update_mod.hp_auto(Hcam, Hlm, P)           # [2K, D] = H P
        S2 = (update_mod.aht_auto(A2, Hcam, Hlm)
              + r_var * jnp.eye(2 * Kcap, dtype=dtype))
    else:
        h, A_un, T_un = precomputed
        resid = (obs - h) * obs_mask[:, None].astype(dtype)
        m2 = jnp.repeat(obs_mask, 2).astype(dtype)      # [2K] row mask
        A2 = A_un * m2[:, None]
        S2 = (T_un * (m2[:, None] * m2[None, :])
              + r_var * jnp.eye(2 * Kcap, dtype=dtype))
    C = jnp.linalg.cholesky(S2)
    # one trsm for both the whitened gain and the whitened residual (the
    # 2Kx2K triangular solve is latency-bound; batching the RHS is free)
    By = solve_triangular(
        C, jnp.concatenate([A2, resid.reshape(2 * Kcap, 1)], axis=1),
        lower=True)
    B, y = By[:, :-1], By[:, -1]                        # [2K,D], [2K]
    x1 = x + B.T @ y

    # --- keep mask from diag(P - B^T B), no P1 materialization.
    # deactivate_mask (optional, [K] bool) folds landmark REMOVAL (the
    # reference's delete-unobserved policy, davison-mono-slam.cpp:799-840)
    # into the same diagonal congruence — removal costs nothing extra. ---
    keep = ((jnp.diag(P) - jnp.sum(B * B, axis=0)) >= 0).astype(dtype)
    if deactivate_mask is not None:
        keep_lm = jnp.repeat(jnp.logical_not(deactivate_mask), 6).astype(dtype)
        keep = keep.at[_N:].mul(keep_lm)
        lm_zero = jnp.repeat(deactivate_mask, 6)
        x1 = jnp.where(jnp.concatenate(
            [jnp.zeros((_N,), bool), lm_zero]), 0.0, x1)
    return x1, B, keep, resid


def _fused_covariance_predict(params, x, P, B, keep, x_next, Cp, G,
                              resid, x1):
    """Shared tail of the fused frame step: the one-write covariance
    congruence P+ = V P V^T - (B V^T)^T (B V^T) + GQG plus the optional
    diagonal inflation. Split out so the recruit-fused variant
    (fused_update_health_recruit_predict) can reuse it verbatim.

    Formulation (round 5): V = blockdiag(Cp, I) diag(keep), so the whole
    landmark block is one fused masked downdate

        D1 = P * keep keep^T - (B diag(keep))^T (B diag(keep))

    (XLA fuses the mask and subtraction into the GEMM epilogue — ONE pass
    over the [D,D] matrix) and only the 13 camera rows/cols need the
    Cp congruence, applied as stripe overwrites with the column stripe
    COPIED from the row stripe's transpose (keeps P == P^T to GEMM
    tiling determinism, same as the concat-built predecessor, which
    materialized top/bottom/Pw separately). Algebraically identical; float-level differences are mask/Cp
    reassociation only (f64 parity tests unaffected)."""
    dtype = x.dtype
    Q = params.process_noise_cov.astype(dtype)

    Bk = B * keep[None, :]
    # fused masked downdate; cam stripes below overwrite rows/cols :13
    D1 = P * (keep[:, None] * keep[None, :]) - Bk.T @ Bk
    top = Cp @ D1[:_N, :]                               # [13,D] cam rows
    corner = top[:, :_N] @ Cp.T + G @ Q @ G.T
    corner = 0.5 * (corner + corner.T)
    top = top.at[:, :_N].set(corner)
    P_next = D1.at[:_N, :].set(top)
    P_next = P_next.at[:, :_N].set(top.T)               # symmetry by copy
    if params.covar_diag_inflation is not None:
        # per-frame diagonal inflation: insurance against slow PSD loss of
        # f32 downdates (2026-08-19 code measured the 1536-dim innovation
        # indefinite by ~2e-5 of its scale after ~120 chained K=768 frames;
        # the unmitigated failure MODE is chaotic across code revisions —
        # see bench unmitigated_f32_* keys, re-measured every round).
        # Statistically a tiny extra process noise on every variable; the
        # reference's f64 never needed it. Only variables with live (positive) variance
        # inflate — deactivated slots and the zero-covariance gauge anchor
        # stay exactly zero.
        infl = params.covar_diag_inflation.astype(dtype)
        d = jnp.arange(P_next.shape[0])
        dg = jnp.diag(P_next)
        P_next = P_next.at[d, d].add(jnp.where(dg > 0, infl * keep, 0.0))

    return x_next, P_next, resid, x1


def median_tracked_inv_depth(params: MonoSlamParams, x: jnp.ndarray,
                             active: jnp.ndarray, Kcap: int) -> jnp.ndarray:
    """Scene-adaptive recruit depth: the (lower) median inverse depth of the
    currently-ACTIVE landmarks, clipped around the configured prior, falling
    back to the prior when nothing is tracked or the median is unusable.

    The reference initializes recruits from a flat configured prior
    (GetNewSphericalSalientPointState :2398) and relies on repeated
    observation to converge the depth; with a wide-sweep world the flat 0.5
    prior can sit far from the true scene depth, and every recruit starts
    with a large depth error that the filter must burn frames correcting
    (measured ATE 0.216 vs 0.087 no-churn at K=768, VERDICT r4 item 2). The
    tracked slots already KNOW the scene's depth scale — their median is a
    far better prior and costs one masked sort. Spherical representation
    only (rho is state component 5); XYZ falls back to the prior."""
    prior = params.sal_pnt_init_inv_dist.astype(x.dtype)
    if params.sal_pnt_repres != REPRES_SPHERICAL:
        return prior
    rho = x[_N:].reshape(Kcap, 6)[:, 5]
    usable = active & (rho > 0) & jnp.isfinite(rho)
    return _clipped_median_or_prior(rho, usable, prior)


def _clipped_median_or_prior(vals: jnp.ndarray, ok: jnp.ndarray,
                             prior: jnp.ndarray) -> jnp.ndarray:
    """Masked lower median over the last axis, clipped to [0.05, 20]x the
    prior, falling back to the prior when nothing is usable — the shared
    convention of BOTH scene-adaptive depth priors (global median and the
    per-candidate local one)."""
    masked = jnp.where(ok, vals, jnp.inf)
    srt = jnp.sort(masked, axis=-1)
    n_ok = jnp.sum(ok.astype(jnp.int32), axis=-1)
    med = jnp.take_along_axis(
        srt, jnp.maximum((n_ok - 1) // 2, 0)[..., None], axis=-1)[..., 0]
    good = (n_ok > 0) & jnp.isfinite(med)
    return jnp.where(good, jnp.clip(med, 0.05 * prior, 20.0 * prior), prior)


def local_tracked_inv_depth(params: MonoSlamParams, x: jnp.ndarray,
                            active: jnp.ndarray, Kcap: int,
                            cand_pix: jnp.ndarray,   # [M,2] candidate pixels
                            slot_pix: jnp.ndarray,   # [K,2] tracked pixels
                            k_nearest: int = 8) -> jnp.ndarray:
    """Spatially-LOCAL scene-adaptive recruit depth: for each candidate, the
    median inverse depth of its ``k_nearest`` nearest ACTIVE landmarks in
    pixel space, clipped around the configured prior, with per-candidate
    fallback to the prior when nothing usable is nearby.

    The global median (``median_tracked_inv_depth``) measured WORSE than the
    flat prior on the wide-sweep K=768 world (ATE 0.233 vs 0.216, r5): one
    number cannot represent a scene whose depth varies across the strip. The
    depth field is spatially smooth, though, and a recruit's future depth is
    far better predicted by the landmarks it appears NEXT TO than by the
    whole map. One [M,K] masked distance matrix + a top-k — trivial next to
    the EKF congruence. Spherical representation only; XYZ falls back to the
    prior (same contract as the global-median variant)."""
    prior = params.sal_pnt_init_inv_dist.astype(x.dtype)
    M = cand_pix.shape[0]
    if params.sal_pnt_repres != REPRES_SPHERICAL:
        return jnp.full((M,), prior, x.dtype)
    rho = x[_N:].reshape(Kcap, 6)[:, 5]
    usable = active & (rho > 0) & jnp.isfinite(rho)
    d2 = jnp.sum((cand_pix[:, None, :].astype(x.dtype)
                  - slot_pix[None, :, :].astype(x.dtype)) ** 2, axis=-1)
    d2 = jnp.where(usable[None, :], d2, jnp.inf)          # [M,K]
    k = min(k_nearest, Kcap)             # small-capacity configs have <k slots
    _, nn = jax.lax.top_k(-d2, k)                         # nearest first
    # masked lower median over the (possibly <k) usable neighbours — the
    # same convention as the global-median prior
    return _clipped_median_or_prior(rho[nn], usable[nn], prior)


def assign_free_slots(free_mask: jnp.ndarray, new_valid: jnp.ndarray
                      ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Slot assignment for a batch of recruit candidates: the j-th VALID
    candidate claims the j-th free slot (lowest index first — the same order
    add_landmarks' sequential argmax(free) scan produces). Returns
    (slots [M] int32 with -1 where not assigned, valid [M] bool)."""
    Kcap = free_mask.shape[0]
    order = jnp.argsort(jnp.logical_not(free_mask).astype(jnp.int32),
                        stable=True)                     # free slots first
    n_free = jnp.sum(free_mask.astype(jnp.int32))
    rank = jnp.cumsum(new_valid.astype(jnp.int32)) - 1   # rank among valids
    valid = new_valid & (rank < n_free)
    slots_raw = order[jnp.clip(rank, 0, Kcap - 1)].astype(jnp.int32)
    return jnp.where(valid, slots_raw, -1), valid


def recruit_rows(params: MonoSlamParams, cam_pq: jnp.ndarray,
                 rows7: jnp.ndarray, P77: jnp.ndarray,
                 free_mask: jnp.ndarray, new_pix: jnp.ndarray,
                 new_valid: jnp.ndarray, rho0, F: jnp.ndarray):
    """Shared recruit linearization + row assembly (A.58 + A.67-A.79,
    landmarks.py): batched new-landmark states and their predict-transformed
    covariance rows, with candidate-candidate couplings placed and slots
    assigned in first-free order. Used by BOTH the single-chip fused recruit
    congruence and the landmark-sharded one
    (parallel/sharded_ekf._local_fused_kernel) — the replicated math is
    identical there; only the scatters differ.

    ``rows7`` [7,D] = top rows of the post-health/renorm posterior;
    ``P77`` its symmetrized [7,7] corner; ``cam_pq`` the post-renorm camera
    7-vector; ``F`` the kinematic transition Jacobian. Returns
    (y_m [M,6], Rt [6M,D] predict-transformed recruited rows,
    slots [M], valid [M], idx [6M], idx_safe [6M], v6 [6M])."""
    from surikatoko_tpu.models.monoslam import landmarks as lm_mod

    dtype = rows7.dtype
    D = rows7.shape[1]
    M = new_pix.shape[0]
    if rho0 is None:
        rho0 = params.sal_pnt_init_inv_dist.astype(dtype)
    else:
        rho0 = rho0.astype(dtype)
    rho0_m = jnp.broadcast_to(jnp.atleast_1d(rho0), (M,))  # scalar or [M]
    g_rho = lambda c, p, r: lm_mod.new_landmark_state(params, c, p, r)

    def one(pix, r0):
        y = g_rho(cam_pq, pix, r0)
        Jc, Jp, Jr = jax.jacfwd(g_rho, argnums=(0, 1, 2))(cam_pq, pix, r0)
        return y, Jc, Jp, Jr

    y_m, Jc_m, Jp_m, Jr_m = jax.vmap(one)(
        new_pix, rho0_m)                     # [M,6],[M,6,7],[M,6,2],[M,6]
    r_var = params.measurm_noise_var.astype(dtype)
    rho_var = params.sal_pnt_init_inv_dist_std.astype(dtype) ** 2
    JcP77 = jnp.einsum("mij,jk->mik", Jc_m, P77)        # [M,6,7]
    auto_m = (jnp.einsum("mik,mjk->mij", JcP77, Jc_m)
              + r_var * jnp.einsum("mik,mjk->mij", Jp_m, Jp_m)
              + rho_var * jnp.einsum("mi,mj->mij", Jr_m, Jr_m))
    cross_m = jnp.einsum("mij,jd->mid", Jc_m, rows7)    # [M,6,D]
    # candidate-candidate couplings (what sequential adds see of each other)
    newnew = jnp.einsum("mik,njk->minj", JcP77, Jc_m)   # [M,6,M,6]
    eye_m = jnp.eye(M, dtype=bool)
    blocks = jnp.where(eye_m[:, None, :, None],
                       auto_m[:, :, None, :], newnew)

    # --- slot assignment (first-free order, add_landmarks parity) ---
    slots, valid = assign_free_slots(free_mask, new_valid)
    v6 = jnp.repeat(valid, 6)
    offs = _N + jnp.where(valid, slots, 0) * 6
    idx = (offs[:, None] + jnp.arange(6)[None, :]).reshape(-1)   # [6M]
    idx_safe = jnp.where(v6, idx, D)        # out-of-bounds -> scatter drops

    # --- assemble recruited rows, predict-transformed ---
    Rfull = cross_m.reshape(6 * M, D)
    vvT = valid[:, None, None, None] & valid[None, None, :, None]
    colvals = jnp.where(vvT, blocks, 0.0).reshape(6 * M, 6 * M)
    colvals = 0.5 * (colvals + colvals.T)       # bitwise P == P^T invariant
    Rfull = Rfull.at[:, idx_safe].set(colvals, mode="drop")
    # predict: Delta F_emb^T — camera columns right-multiply F^T (landmark
    # rows themselves are identity under predict)
    Rt = Rfull.at[:, :_N].set(Rfull[:, :_N] @ F.T)
    return y_m, Rt, slots, valid, idx, idx_safe, v6


def fused_update_health_recruit_predict(
    params: MonoSlamParams, x: jnp.ndarray, P: jnp.ndarray,
    obs: jnp.ndarray, obs_mask: jnp.ndarray,
    new_pix: jnp.ndarray,       # [M,2] recruit candidate first observations
    new_valid: jnp.ndarray,     # [M] bool
    free_mask: jnp.ndarray,     # [K] bool: slots recruits may claim (caller
                                # computes ~active AFTER the delete policy)
    *, precomputed: tuple | None = None,
    deactivate_mask: jnp.ndarray | None = None,
    rho0: jnp.ndarray | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """``fused_update_health_predict`` with per-frame landmark RECRUITMENT
    spliced in at the reference's point in the pipeline: update -> health ->
    delete -> recruit -> predict (ProcessFrame davison-mono-slam.cpp:923 ->
    RecruitNewSalientPoints :1812 -> AddSalientPoint :2597, recruit on the
    post-update posterior, predict after).

    The naive composition would materialize the posterior covariance and run
    add_landmarks' M-candidate scan — M+1 extra O(D^2) passes per frame.
    Here recruitment stays inside the single fused congruence: a new slot's
    covariance rows are built from just the TOP-7 ROWS of the (post-health,
    post-renorm) posterior — a [7,D] stripe recovered from P and B without
    forming the posterior —

        rows7 = E_q diag(keep)[:7] (P[:7,:] - B[:,:7]^T B) diag(keep) E_q^T

    and the predict transform acts on recruited rows in closed form (their
    camera columns right-multiply F^T; landmark rows are predict-invariant),
    so the recruited rows/cols are scattered straight into the fused P_next.
    Candidate-candidate couplings J_ci P77 J_cj^T reproduce exactly what
    add_landmarks' sequential writes produce. Parity with the sequential
    pipeline (stacked update -> nonneg clamp -> rho substitution -> renorm ->
    add_landmarks -> predict) is pinned at 1e-12 f64 by
    tests/test_recruit_fused.py.

    Returns (x_next, P_next, resid, x_post_update, slots [M] int32 with -1
    where the candidate was not added). New-slot depth defaults to the
    configured prior ``sal_pnt_init_inv_dist`` (NOT ground truth — reference
    GetNewSphericalSalientPointState :2398 semantics); ``rho0`` overrides it
    with a traced scalar or per-candidate [M] vector (e.g. the median /
    spatially-local tracked inverse depth — scene-adaptive priors the caller
    computes from the live filter state).
    """
    Kcap = obs_mask.shape[0]
    M = new_pix.shape[0]

    x1, B, keep, resid = _fused_update_core(
        params, x, P, obs, obs_mask, precomputed, deactivate_mask)
    epi = camera_epilogue(params, x1, Kcap)
    x_next, Cp, G = epi.x_next, epi.Cp, epi.G

    # --- recruit-time covariance stripe: top 7 rows of the posterior after
    # nonneg clamp (keep) and quaternion renorm (E_q) ---
    kc = keep[:_N]
    rows7 = (P[:7, :] - B[:, :7].T @ B) * (kc[:7, None] * keep[None, :])
    rows7 = rows7.at[3:7, :].set(epi.Jq @ rows7[3:7, :])
    rows7 = rows7.at[:, 3:7].set(rows7[:, 3:7] @ epi.Jq.T)
    # exact symmetry of the [7,7] corner (the Jq congruence reassociates the
    # two triangles differently) so the scattered blocks keep the fused
    # steps' P == P^T bitwise invariant
    P77 = 0.5 * (rows7[:, :7] + rows7[:, :7].T)
    cam_pq = epi.x2[:7]                                 # post-renorm camera

    y_m, Rt, slots, valid, idx, idx_safe, v6 = recruit_rows(
        params, cam_pq, rows7, P77, free_mask, new_pix, new_valid, rho0,
        epi.F)

    # --- base fused covariance, then scatter the recruited rows/cols ---
    x_next, P_next, resid, x1 = _fused_covariance_predict(
        params, x, P, B, keep, x_next, Cp, G, resid, x1)
    P_next = P_next.at[idx_safe, :].set(Rt, mode="drop")
    P_next = P_next.at[:, idx_safe].set(Rt.T, mode="drop")
    x_next = x_next.at[idx_safe].set(y_m.reshape(6 * M), mode="drop")

    return x_next, P_next, resid, x1, slots
