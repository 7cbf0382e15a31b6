"""Sparse (padded-track) BA for the at-scale configuration.

The dense [Np, F] observation grid (problem.py) is right for dino-sized
problems but not for 10k+ landmarks x 500+ keyframes (the grid alone would
be ~600 MB and ~0.2% occupied). Here observations are track-major: each
point carries up to L observing frames (padded):

  obs [Np, L, 2], frame_idx [Np, L] int32, obs_mask [Np, L]

Gauss-Newton blocks: per-observation Jacobians exactly as the dense path
(autodiff of the same residual), E/gp reduced over L per point, G/gf by
segment_sum over frames, and the Schur reduction scattered into the
[F,10,F,10] reduced system in point-chunks (each point contributes an
L x L grid of 10x10 blocks at its observing-frame pairs) — O(sum_i deg_i^2)
work, the classic sparse-BA cost, with no dense point-frame grid anywhere.

Numerically identical to the dense path on the same problem
(tests/test_ba_sparse.py) and shardable over points (parallel/sharded_schur
pattern: psum the scattered S and rhs).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.scipy.linalg import cho_factor, cho_solve

from surikatoko_tpu.models.ba import derivs as dv
from surikatoko_tpu.models.ba.derivs import FRAME_VARS, frame_var_mask
from surikatoko_tpu.models.ba.schur import _damp, _fixed_var_identity


class BAProblemSparse(NamedTuple):
    points: jnp.ndarray      # [Np, 3]
    cfw_R: jnp.ndarray       # [F, 3, 3]
    cfw_t: jnp.ndarray       # [F, 3]
    K: jnp.ndarray           # [F, 3, 3] f0-scaled
    obs: jnp.ndarray         # [Np, L, 2] pixels
    frame_idx: jnp.ndarray   # [Np, L] int32 (0 where masked)
    obs_mask: jnp.ndarray    # [Np, L]
    f0: jnp.ndarray

    @property
    def n_points(self) -> int:
        return self.points.shape[0]

    @property
    def n_frames(self) -> int:
        return self.cfw_R.shape[0]

    @property
    def track_len(self) -> int:
        return self.obs.shape[1]


def dense_obs_to_tracks(obs, obs_mask):
    """Host-side vectorized dense-grid -> track-major conversion: numpy
    (obs [Np,F,2], mask [Np,F]) -> (obs_s [Np,L,2], frame_idx [Np,L] int32,
    track_mask [Np,L]) with L = max track length. Pure numpy — callers hand
    in HOST copies so no device->host fetch happens (see
    SparseBundleAdjustment.set_plan_inputs)."""
    import numpy as np

    obs = np.asarray(obs)
    mask = np.asarray(obs_mask, bool)
    Np, F = mask.shape
    L = max(int(mask.sum(axis=1).max()), 1)
    # stable argsort of ~mask puts each row's visible frames first, in
    # ascending frame order — the same layout the per-row loop produced
    order = np.argsort(~mask, axis=1, kind="stable")[:, :L]
    counts = mask.sum(axis=1)
    track_mask = np.arange(L)[None, :] < counts[:, None]
    fidx = np.where(track_mask, order, 0).astype(np.int32)
    obs_s = np.take_along_axis(obs, fidx[..., None], axis=1)
    obs_s = np.where(track_mask[..., None], obs_s, 0.0)
    return obs_s, fidx, track_mask


def from_dense(p) -> BAProblemSparse:
    """Convert a dense BAProblem (host-side; for tests/parity) — a thin
    wrapper over the vectorized ``dense_obs_to_tracks`` (same layout the
    original per-row loop produced)."""
    obs_s, fidx, mask = dense_obs_to_tracks(p.obs, p.obs_mask)
    return BAProblemSparse(
        points=p.points, cfw_R=p.cfw_R, cfw_t=p.cfw_t, K=p.K,
        obs=jnp.asarray(obs_s, p.points.dtype), frame_idx=jnp.asarray(fidx),
        obs_mask=jnp.asarray(mask), f0=p.f0)


class SparseBlocks(NamedTuple):
    E: jnp.ndarray       # [Np, 3, 3]
    G: jnp.ndarray       # [F, 10, 10]
    Fpf: jnp.ndarray     # [Np, L, 3, 10]
    gp: jnp.ndarray      # [Np, 3]
    gf: jnp.ndarray      # [F, 10]


def reproj_error(p: BAProblemSparse) -> jnp.ndarray:
    from surikatoko_tpu.models.ba.problem import project_f0

    Kg = p.K[p.frame_idx]                 # [Np,L,3,3]
    Rg = p.cfw_R[p.frame_idx]
    tg = p.cfw_t[p.frame_idx]
    proj = project_f0(Kg, Rg, tg, p.points[:, None, :])
    r = (proj - p.obs / p.f0) * p.obs_mask[..., None].astype(p.points.dtype)
    return jnp.sum(r * r)


def compute_blocks(p: BAProblemSparse, unity_comp_ind: int = 1,
                   pin_frames: tuple = (),
                   optimize_intrinsics: bool = True) -> SparseBlocks:
    dtype = p.points.dtype
    F = p.n_frames
    u0 = jnp.zeros((FRAME_VARS,), dtype)
    obs_f0 = p.obs / p.f0
    Kg = p.K[p.frame_idx]
    Rg = p.cfw_R[p.frame_idx]
    tg = p.cfw_t[p.frame_idx]

    def per_obs(K, R, t, o, X):
        f = lambda XX, uu: dv._residual_one(K, R, t, o, XX, uu)
        r = f(X, u0)
        Jp, Jf = jax.jacfwd(f, argnums=(0, 1))(X, u0)
        return r, Jp, Jf

    per_track = jax.vmap(per_obs, in_axes=(0, 0, 0, 0, None))
    r, Jp, Jf = jax.vmap(per_track)(Kg, Rg, tg, obs_f0, p.points)
    m = p.obs_mask[..., None].astype(dtype)
    r = r * m
    Jp = Jp * m[..., None]
    Jf = Jf * m[..., None]
    fmask = frame_var_mask(F, unity_comp_ind, optimize_intrinsics,
                           pin_frames).astype(dtype)
    Jf = Jf * fmask[p.frame_idx][:, :, None, :]

    E = jnp.einsum("ilca,ilcb->iab", Jp, Jp)
    unseen = jnp.logical_not(jnp.any(p.obs_mask, axis=1)).astype(dtype)
    E = E + jnp.eye(3, dtype=dtype)[None] * unseen[:, None, None]
    gp = jnp.einsum("ilca,ilc->ia", Jp, r)
    Fpf = jnp.einsum("ilca,ilcb->ilab", Jp, Jf)

    seg = p.frame_idx.reshape(-1)
    G = jax.ops.segment_sum(
        jnp.einsum("oca,ocb->oab", Jf.reshape(-1, 2, FRAME_VARS),
                   Jf.reshape(-1, 2, FRAME_VARS)),
        seg, num_segments=F)
    gf = jax.ops.segment_sum(
        jnp.einsum("oca,oc->oa", Jf.reshape(-1, 2, FRAME_VARS),
                   r.reshape(-1, 2)),
        seg, num_segments=F)
    return SparseBlocks(E=E, G=G, Fpf=Fpf, gp=gp, gf=gf)


def solve_corrections_schur_sparse(
    p: BAProblemSparse, blocks: SparseBlocks, hessian_factor,
    unity_comp_ind: int = 1, optimize_intrinsics: bool = True,
    point_chunk: int = 2048, pin_frames: tuple = (),
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Two-phase Schur solve; the reduction is one dense matmul in Gram form.

    S = G_diag - sum_i F_i^T E_i^-1 F_i is computed as G_diag - B^T B with
    B_i = L_i^-1 F_i (E_i = L_i L_i^T batched 3x3 Cholesky): per point chunk,
    the L-track sparse rows expand into a dense TRANSPOSED [10F, 3*pc] strip
    via a one-hot batched matmul and ONE [10F, 3*pc] @ [3*pc, 10F] product
    accumulates every (l, m) frame-pair cross term. This replaces the direct
    form's pc*L^2 10x10 block scatter-adds (the reference's per-point loop,
    bundle-adj-kanatani.cpp:1888): the O(pc * (10F)^2) FLOPs of the dense
    strip product are ~40x the nonzero work at L=12, F=500, traded for
    dense matmul throughput instead of small scatter-adds
    (analysis/roofline_schur.py measures the rate; bench.py reports it as
    schur_pct_of_ceiling). The strip is built transposed (point dim minor).
    The rhs reduction and the point back-substitution ride the same
    Cholesky factor (no batched 3x3 inverse). Exact same math: zero rows
    multiply to zero."""
    Np, L = blocks.Fpf.shape[0], blocks.Fpf.shape[1]
    F = p.n_frames
    dtype = blocks.E.dtype
    fmask = frame_var_mask(F, unity_comp_ind, optimize_intrinsics, pin_frames)

    E = _damp(blocks.E, hessian_factor)
    G = _fixed_var_identity(_damp(blocks.G, hessian_factor), fmask)
    Lch = jnp.linalg.cholesky(E)                            # [Np,3,3]
    # B_il = L_i^-1 F_il : solve over the 3 point vars, batched [Np,3,L*10]
    Bv = jax.scipy.linalg.solve_triangular(
        Lch, blocks.Fpf.transpose(0, 2, 1, 3).reshape(Np, 3, L * FRAME_VARS),
        lower=True).reshape(Np, 3, L, FRAME_VARS)           # [Np,3,L,10]
    # rhs reduction rides the same factor: F^T Einv g = B^T (L^-1 g)
    y = jax.scipy.linalg.solve_triangular(
        Lch, blocks.gp[:, :, None], lower=True)[..., 0]     # [Np,3]
    Rv = jnp.einsum("ialb,ia->ilb", Bv, y)                  # [Np,L,10]

    # pad Np to chunks
    pad = (-Np) % point_chunk
    def padz(x):
        return jnp.pad(x, ((0, pad),) + ((0, 0),) * (x.ndim - 1)) if pad else x
    Bp = padz(Bv)
    Rp = padz(Rv)
    fidxp = padz(p.frame_idx)
    n_chunks = Bp.shape[0] // point_chunk
    pc = point_chunk

    S0 = jnp.zeros((F * FRAME_VARS, F * FRAME_VARS), dtype)
    red0 = jnp.zeros((F, FRAME_VARS), dtype)

    def chunk_body(c, carry):
        S, red = carry
        sl = lambda x: jax.lax.dynamic_slice_in_dim(x, c * pc, pc)
        Bc, Rc, fc = sl(Bp), sl(Rp), sl(fidxp)
        # one-hot matmuls instead of scatter-adds of pc*L small blocks; the
        # strip is built TRANSPOSED ([10F, 3pc], point dim minor)
        oh = jax.nn.one_hot(fc, F, dtype=dtype)             # [pc,L,F]
        Bm = jnp.einsum("ilf,ialb->fbai", oh, Bc).reshape(
            F * FRAME_VARS, pc * 3)                         # [10F, 3pc]
        return S + Bm @ Bm.T, red + jnp.einsum("ilf,ilb->fb", oh, Rc)

    Sg, red = jax.lax.fori_loop(0, n_chunks, chunk_body, (S0, red0))
    S2 = (jnp.einsum("fab,fg->fagb", G, jnp.eye(F, dtype=dtype))
          .reshape(F * FRAME_VARS, F * FRAME_VARS) - Sg)

    rhs = (-(blocks.gf - red)).reshape(F * FRAME_VARS)

    # Jacobi symmetric preconditioning: essential for f32 at 5000+ unknowns
    # (pixel^2 vs radian^2 diagonal entries differ by ~1e6)
    d = jnp.sqrt(jnp.maximum(jnp.abs(jnp.diagonal(S2)), 1e-12))
    dinv = 1.0 / d
    S2p = S2 * dinv[:, None] * dinv[None, :]
    # SPD after damping + gauge unit diagonals: Cholesky (not LU); a failed
    # factorization surfaces as NaN and trips the ok flag (LM then raises
    # the damping factor)
    du = (dinv * cho_solve(cho_factor(S2p, lower=True), rhs * dinv)
          ).reshape(F, FRAME_VARS)
    du_g = du[p.frame_idx]                                   # [Np,L,10]
    # back-substitute through the same Cholesky factor (no batched inverse)
    rhs_pt = blocks.gp + jnp.einsum("ilab,ilb->ia", blocks.Fpf, du_g)
    dX = -cho_solve((Lch, True), rhs_pt[:, :, None])[..., 0]
    ok = jnp.all(jnp.isfinite(du)) & jnp.all(jnp.isfinite(dX))
    return dX, du, ok


class BandPlan(NamedTuple):
    """Host-computed plan for the banded Schur reduction (plan_bands)."""
    ext_idx: object          # [Npad] int32: sorted point index, or Np (pad)
    band_width: int          # W: frames per banded chunk window
    n_banded_chunks: int     # banded chunks of size point_chunk
    overflow_chunk: int      # chunk size of the full-width overflow loop
    point_chunk: int


def plan_bands(frame_idx, obs_mask, point_chunk: int, n_frames: int,
               max_band_frac: float = 0.5, max_overflow_frac: float = 0.5,
               band_accept_frac: float = 0.8, min_chunk: int = 256):
    """Host-side banding plan for :func:`solve_corrections_schur_banded`.

    Sorting points by their first observed frame makes each point chunk
    touch only a narrow frame band (bundle-adjustment observation graphs are
    frame-local except for loop closures). Points whose own track span
    exceeds ``max_band_frac * n_frames`` (loop-closure / wrap-around tracks)
    form an OVERFLOW group the solver processes with small full-width
    chunks — banding only needs the majority to be local. Both groups are
    padded to whole chunks via an extended index (pad entries point past the
    last point and read as zeros).

    A plan is only worth compiling if the band is genuinely narrow: when a
    chunk holds so many points that its fmin window spans most of the run
    (pc ~ Np => W ~ F), the banded gathers cost MORE than the full-width
    Gram strips they replace (measured 4-5x slower at W/F=0.93 on the MVF
    final-BA shape, analysis/profile_mvf_final_ba.py — VERDICT r4 item 3's
    degenerate plan). So: if W exceeds ``band_accept_frac * n_frames`` the
    planner retries with half the chunk size (down to ``min_chunk``), and
    refuses (None => caller uses the full-width solver) if the band never
    gets narrow enough.

    Returns a :class:`BandPlan`, or None when fewer than
    ``1 - max_overflow_frac`` of the points are local or the band is no
    narrower than ``band_accept_frac`` of the full width. Pure numpy; call
    once per problem (the observation structure is constant across LM
    iterations)."""
    import numpy as np

    fi = np.asarray(frame_idx)
    m = np.asarray(obs_mask)
    Np = fi.shape[0]
    fmin = np.where(m, fi, n_frames).min(axis=1)
    fmax = np.where(m, fi, -1).max(axis=1)
    fmin = np.where(fmax < 0, 0, fmin)      # unobserved points: trivial band
    fmax = np.maximum(fmax, fmin)
    span = fmax - fmin + 1
    overflow = span > max_band_frac * n_frames
    if overflow.mean() > max_overflow_frac:
        return None
    loc = np.where(~overflow)[0]
    ovf = np.where(overflow)[0]
    if len(loc) == 0:
        return None
    loc = loc[np.argsort(fmin[loc], kind="stable")]
    pc = min(point_chunk, Np)
    while True:
        nb = -(-len(loc) // pc)
        pc_ovf = min(pc, 256) if len(ovf) else pc
        no = -(-len(ovf) // pc_ovf)
        ext = np.full(nb * pc + no * pc_ovf, Np, np.int32)
        ext[:len(loc)] = loc
        ext[nb * pc:nb * pc + len(ovf)] = ovf
        W_raw = 1
        for c in range(nb):
            sel = ext[c * pc:(c + 1) * pc]
            sel = sel[sel < Np]
            W_raw = max(W_raw, int(fmax[sel].max() - fmin[sel].min() + 1))
        # accept on the RAW width (the x32 quantization below would
        # spuriously refuse small-F problems), then quantize: the compiled
        # solver is cached on the band GEOMETRY (W, chunk counts), and W
        # creeps with every point added — rounding up keeps the cache warm
        # across incremental growth. Keep the exact W when rounding would
        # reach full width (small problems).
        if W_raw < band_accept_frac * n_frames:
            W = W_raw
            Wq = -(-W // 32) * 32
            if Wq < n_frames:
                W = Wq
            break
        if pc // 2 >= min_chunk:
            pc //= 2            # narrower chunks -> narrower fmin windows
            continue
        return None             # band never narrow enough: full-width wins
    return BandPlan(ext_idx=ext, band_width=W, n_banded_chunks=nb,
                    overflow_chunk=pc_ovf, point_chunk=pc)


def plan_bands_sharded(frame_idx, obs_mask, n_dev: int, point_chunk: int,
                       n_frames: int, **kw):
    """Per-shard banding plans for the distributed solver: points are
    sharded in contiguous blocks over the mesh, so each shard gets its own
    first-frame sort, padded to COMMON chunk counts (shard_map needs one
    static program). Returns a BandPlan whose ext_idx is [n_dev, Npad] of
    LOCAL indices (sentinel = local Np), or None when any shard refuses."""
    import numpy as np

    fi = np.asarray(frame_idx)
    m = np.asarray(obs_mask)
    Np = fi.shape[0]
    assert Np % n_dev == 0
    Nl = Np // n_dev

    def _plan_all(pc_try):
        plans = []
        for d in range(n_dev):
            pl = plan_bands(fi[d * Nl:(d + 1) * Nl], m[d * Nl:(d + 1) * Nl],
                            pc_try, n_frames, **kw)
            if pl is None:
                return None
            plans.append(pl)
        return plans

    # shard_map needs one static program: if the degenerate-band retry
    # shrank chunks differently per shard, re-plan everyone at the min
    pc_try = point_chunk
    while True:
        plans = _plan_all(pc_try)
        if plans is None:
            return None
        pcs = {pl.point_chunk for pl in plans}
        if len(pcs) == 1:
            break
        pc_try = min(pcs)
    pc = plans[0].point_chunk
    pco = min(pl.overflow_chunk for pl in plans)
    W = max(pl.band_width for pl in plans)
    nb = max(pl.n_banded_chunks for pl in plans)
    n_ovf = [int((pl.ext_idx[pl.n_banded_chunks * pl.point_chunk:] < Nl)
                 .sum()) for pl in plans]
    no = max(-(-c // pco) if c else 0 for c in n_ovf)
    Npad = nb * pc + no * pco
    ext = np.full((n_dev, Npad), Nl, np.int32)
    for d, pl in enumerate(plans):
        nbl = pl.n_banded_chunks * pl.point_chunk
        ext[d, :nbl] = pl.ext_idx[:nbl]
        ovl = pl.ext_idx[nbl:]
        ovl = ovl[ovl < Nl]
        ext[d, nb * pc:nb * pc + len(ovl)] = ovl
    return BandPlan(ext_idx=ext, band_width=W, n_banded_chunks=nb,
                    overflow_chunk=pco, point_chunk=pc)


def _banded_reduction(E_d, Fpf, gp, frame_idx, obs_mask, plan: BandPlan,
                      F: int, ext=None):
    """Gram reduction over one point set in banded (extended) order.

    Returns (Sg [10F,10F], red [F,10], Lch, Fpf_s, gp_s, fidx_s, ext) where
    the *_s arrays and the per-point Cholesky factor are in extended order
    for back-substitution, and ``ext`` maps extended rows to original point
    indices (sentinel Np for pads). Shared by the local solver and the
    per-shard body of the distributed one.

    ``ext`` may be passed as a TRACED array (same shape as plan.ext_idx):
    only the band geometry (W, chunk counts/sizes) is compile-time static,
    so re-planning on a grown problem with unchanged geometry reuses the
    compiled program (the MVF's periodic global BA relies on this)."""
    Np, L = Fpf.shape[0], Fpf.shape[1]
    W = int(plan.band_width)
    pc = int(plan.point_chunk)
    pco = int(plan.overflow_chunk)
    nb = int(plan.n_banded_chunks)
    if ext is None:
        ext = jnp.asarray(plan.ext_idx)
    Next = ext.shape[0]
    no = (Next - nb * pc) // pco            # overflow chunks
    dtype = E_d.dtype

    # gather into extended (group-padded) order; sentinel row Np reads as
    # zeros (identity for E so its Cholesky stays finite)
    E1 = jnp.concatenate([E_d, jnp.eye(3, dtype=dtype)[None]], axis=0)[ext]
    Fpf_s = jnp.concatenate(
        [Fpf, jnp.zeros((1, L, 3, FRAME_VARS), dtype)], axis=0)[ext]
    gp_s = jnp.concatenate([gp, jnp.zeros((1, 3), dtype)], axis=0)[ext]
    fidx_s = jnp.concatenate(
        [frame_idx, jnp.zeros((1, L), frame_idx.dtype)], axis=0)[ext]
    mask_s = jnp.concatenate(
        [obs_mask, jnp.zeros((1, L), bool)], axis=0)[ext]

    Lch = jnp.linalg.cholesky(E1)
    Bv = jax.scipy.linalg.solve_triangular(
        Lch, Fpf_s.transpose(0, 2, 1, 3).reshape(Next, 3, L * FRAME_VARS),
        lower=True).reshape(Next, 3, L, FRAME_VARS)
    y = jax.scipy.linalg.solve_triangular(
        Lch, gp_s[:, :, None], lower=True)[..., 0]
    Rv = jnp.einsum("ialb,ia->ilb", Bv, y)

    # per-point first observed frame (sorted ascending within the banded
    # group by construction; pads read F-1 but carry zero rows)
    fmin_s = jnp.min(jnp.where(mask_s, fidx_s, F), axis=1)
    fmin_s = jnp.minimum(fmin_s, F - 1)

    S0 = jnp.zeros((F * FRAME_VARS, F * FRAME_VARS), dtype)
    red0 = jnp.zeros((F, FRAME_VARS), dtype)

    def banded_body(c, carry):
        S, red = carry
        sl = lambda x: jax.lax.dynamic_slice_in_dim(x, c * pc, pc)
        Bc, Rc, fc = sl(Bv), sl(Rv), sl(fidx_s)
        # chunk band starts at the chunk's smallest fmin (sorted -> first
        # element); clamp so the W-wide window stays inside [0, F)
        base = jnp.minimum(fmin_s[c * pc], F - W)
        # masked obs have fidx 0: fc - base may go negative there, and
        # one_hot maps out-of-range to an all-zero row — harmless because
        # the matching Bv/Rv rows are exact zeros too. Strip built
        # TRANSPOSED (point dim minor) — see solve_corrections_schur_sparse.
        oh = jax.nn.one_hot(fc - base, W, dtype=dtype)      # [pc,L,W]
        Bm = jnp.einsum("ilf,ialb->fbai", oh, Bc).reshape(
            W * FRAME_VARS, pc * 3)                         # [10W, 3pc]
        b10 = FRAME_VARS * base
        zero = jnp.zeros((), base.dtype)
        cur = jax.lax.dynamic_slice(
            S, (b10, b10), (FRAME_VARS * W, FRAME_VARS * W))
        S = jax.lax.dynamic_update_slice(S, cur + Bm @ Bm.T, (b10, b10))
        cur_r = jax.lax.dynamic_slice(red, (base, zero), (W, FRAME_VARS))
        red = jax.lax.dynamic_update_slice(
            red, cur_r + jnp.einsum("ilf,ilb->fb", oh, Rc), (base, zero))
        return S, red

    def full_body(d, carry):
        # overflow group (loop-closure tracks): small full-width chunks
        S, red = carry
        sl = lambda x: jax.lax.dynamic_slice_in_dim(x, nb * pc + d * pco, pco)
        Bc, Rc, fc = sl(Bv), sl(Rv), sl(fidx_s)
        oh = jax.nn.one_hot(fc, F, dtype=dtype)             # [pco,L,F]
        Bm = jnp.einsum("ilf,ialb->fbai", oh, Bc).reshape(
            F * FRAME_VARS, pco * 3)                        # [10F, 3pco]
        return S + Bm @ Bm.T, red + jnp.einsum("ilf,ilb->fb", oh, Rc)

    carry = jax.lax.fori_loop(0, nb, banded_body, (S0, red0))
    Sg, red = jax.lax.fori_loop(0, no, full_body, carry)
    return Sg, red, Lch, Fpf_s, gp_s, fidx_s, ext


def solve_corrections_schur_banded(
    p: BAProblemSparse, blocks: SparseBlocks, hessian_factor,
    plan: BandPlan, ext_idx=None,
    unity_comp_ind: int = 1, optimize_intrinsics: bool = True,
    pin_frames: tuple = (),
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Banded variant of :func:`solve_corrections_schur_sparse`.

    Points are processed in first-observed-frame order (:func:`plan_bands`),
    so each banded chunk's Gram strip is [3*pc, 10*W] instead of
    [3*pc, 10*F] and its B^T B block lands in the reduced system via one
    dynamic-slice update — cutting the reduction FLOPs by (F/W)^2 per chunk
    (~18x at the 10k x 500 / W~120 configuration) while computing the exact
    same S. Loop-closure / wrap-around tracks form a small overflow tail
    processed by full-width chunks (same math, no band); pad entries of the
    extended index read as zero rows and contribute nothing."""
    Np = blocks.Fpf.shape[0]
    F = p.n_frames
    dtype = blocks.E.dtype
    fmask = frame_var_mask(F, unity_comp_ind, optimize_intrinsics, pin_frames)
    G = _fixed_var_identity(_damp(blocks.G, hessian_factor), fmask)

    E_d = _damp(blocks.E, hessian_factor)
    Sg, red, Lch, Fpf_s, gp_s, fidx_s, ext = _banded_reduction(
        E_d, blocks.Fpf, blocks.gp, p.frame_idx, p.obs_mask, plan, F,
        ext=ext_idx)
    S2 = (jnp.einsum("fab,fg->fagb", G, jnp.eye(F, dtype=dtype))
          .reshape(F * FRAME_VARS, F * FRAME_VARS) - Sg)

    rhs = (-(blocks.gf - red)).reshape(F * FRAME_VARS)
    d = jnp.sqrt(jnp.maximum(jnp.abs(jnp.diagonal(S2)), 1e-12))
    dinv = 1.0 / d
    S2p = S2 * dinv[:, None] * dinv[None, :]
    du = (dinv * cho_solve(cho_factor(S2p, lower=True), rhs * dinv)
          ).reshape(F, FRAME_VARS)
    du_g = du[fidx_s]
    rhs_pt = gp_s + jnp.einsum("ilab,ilb->ia", Fpf_s, du_g)
    dX_s = -cho_solve((Lch, True), rhs_pt[:, :, None])[..., 0]
    # un-permute; writes through pad entries land on the sentinel row
    dX = jnp.zeros((Np + 1, 3), dtype).at[ext].set(dX_s)[:Np]
    ok = jnp.all(jnp.isfinite(du)) & jnp.all(jnp.isfinite(dX))
    return dX, du, ok


def apply_corrections(p: BAProblemSparse, dX, du) -> BAProblemSparse:
    from surikatoko_tpu.models.ba.problem import BAProblem

    dummy = BAProblem(points=p.points, cfw_R=p.cfw_R, cfw_t=p.cfw_t, K=p.K,
                      obs=jnp.zeros((1, p.n_frames, 2), p.points.dtype),
                      obs_mask=jnp.zeros((1, p.n_frames), bool), f0=p.f0)
    out = dv.apply_corrections(dummy, dX, du)
    return p._replace(points=out.points, cfw_R=out.cfw_R, cfw_t=out.cfw_t,
                      K=out.K)
