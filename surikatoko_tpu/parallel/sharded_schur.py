"""Distributed Schur-complement BA solve: point blocks sharded over the mesh.

The Schur reduction S = G - sum_i F_i^T E_i^-1 F_i is a sum over points —
embarrassingly parallel over point shards. Each device reduces its shard's
contribution (the reference's "perf hot spot", bundle-adj-kanatani.cpp:1888,
becomes a local einsum + one psum of the [10F,10F] reduced system); the
reduced camera solve is replicated (10F x 10F is tiny next to the reduction);
point back-substitution is local to each shard.

Numerically identical to models/ba/schur.solve_corrections_schur (tested in
tests/test_parallel_schur.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.scipy.linalg import cho_factor, cho_solve
from jax.sharding import Mesh, PartitionSpec as P
from jax.experimental.shard_map import shard_map

from surikatoko_tpu.models.ba import derivs
from surikatoko_tpu.models.ba.derivs import FRAME_VARS, GNBlocks, frame_var_mask
from surikatoko_tpu.models.ba.schur import _damp, _fixed_var_identity


def _schur_kernel(n_frames: int, unity_comp_ind: int,
                  E, Fpf, gp, G, gf, hessian_factor):
    """Per-device body. E [L,3,3], Fpf [L,F,3,10], gp [L,3] are the local
    point shard; G [F,10,10], gf [F,10], hessian_factor replicated."""
    F = n_frames
    dtype = E.dtype
    fmask = frame_var_mask(F, unity_comp_ind)

    E_d = _damp(E, hessian_factor)
    G_d = _fixed_var_identity(_damp(G, hessian_factor), fmask)

    Einv = jnp.linalg.inv(E_d)
    C = jnp.einsum("iab,ifbc->ifac", Einv, Fpf)
    # local partial reduction, then one psum
    S_part = -jnp.einsum("ifab,igac->fbgc", Fpf, C)
    w = jnp.einsum("iab,ib->ia", Einv, gp)
    rhs_part = jnp.einsum("ifab,ia->fb", Fpf, w)
    S = jax.lax.psum(S_part, "lm")
    rhs_red = jax.lax.psum(rhs_part, "lm")

    S = S + jnp.einsum("fab,fg->fagb", G_d, jnp.eye(F, dtype=dtype))
    S2 = S.reshape(F * FRAME_VARS, F * FRAME_VARS)
    rhs = (-(gf - rhs_red)).reshape(F * FRAME_VARS)

    du = jnp.linalg.solve(S2, rhs).reshape(F, FRAME_VARS)
    # back-substitute local points
    dX = -jnp.einsum("iab,ib->ia",
                     Einv, gp + jnp.einsum("ifab,fb->ia", Fpf, du))
    return dX, du


def make_sharded_schur_solver(n_points: int, n_frames: int, mesh: Mesh,
                              unity_comp_ind: int = 1):
    """Returns jitted (blocks, hessian_factor) -> (dX, du, ok) with the point
    dimension sharded over mesh axis "lm". n_points must divide the mesh."""
    n_dev = mesh.devices.size
    assert n_points % n_dev == 0, (n_points, n_dev)

    kernel = functools.partial(_schur_kernel, n_frames, unity_comp_ind)
    smapped = shard_map(
        kernel,
        mesh=mesh,
        in_specs=(P("lm"), P("lm"), P("lm"), P(), P(), P()),
        out_specs=(P("lm"), P()),
        check_rep=False,
    )

    @jax.jit
    def solve(blocks: GNBlocks, hessian_factor):
        hf = jnp.asarray(hessian_factor, blocks.E.dtype)
        dX, du = smapped(blocks.E, blocks.Fpf, blocks.gp, blocks.G, blocks.gf, hf)
        ok = jnp.all(jnp.isfinite(du)) & jnp.all(jnp.isfinite(dX))
        return dX, du, ok

    return solve


def make_sharded_sparse_schur_solver(n_points: int, n_frames: int,
                                     track_len: int, mesh: Mesh,
                                     unity_comp_ind: int = 1,
                                     optimize_intrinsics: bool = True,
                                     point_chunk: int = 2048,
                                     pin_frames: tuple = (),
                                     band_plan=None):
    """Distributed sparse Schur solve: point shards each accumulate their
    partial reduced system (Gram-form matmuls), one psum of [F,10,F,10]
    + rhs, replicated preconditioned solve, local back-substitution. The
    at-scale (10k x 500) configuration sharded over the mesh.

    Takes (p_sparse: BAProblemSparse, blocks: SparseBlocks, hessian_factor)
    with point-major arrays sharded on axis 'lm'.

    ``band_plan`` (sparse.plan_bands_sharded) switches each shard to the
    banded reduction: per-shard first-frame sort, W-frame strips, small
    full-width overflow chunks — same psum, ~10x fewer local FLOPs on
    frame-local problems.
    """
    import functools as _ft

    from surikatoko_tpu.models.ba.derivs import frame_var_mask as _fvm
    from surikatoko_tpu.models.ba import sparse as _sp

    n_dev = mesh.devices.size
    assert n_points % n_dev == 0
    L = track_len
    F = n_frames

    def kernel(E, Fpf, gp, fidx, G, gf, hessian_factor):
        # Gram-form reduction (see models/ba/sparse.py): the local shard's
        # -sum F^T E^-1 F accumulates as -B^T B with B = L^-1 F expanded
        # into dense [3*pc, 10F] strips — one matmul per point chunk.
        dtype = E.dtype
        fmask = _fvm(F, unity_comp_ind, optimize_intrinsics, pin_frames)
        E_d = _damp(E, hessian_factor)
        G_d = _fixed_var_identity(_damp(G, hessian_factor), fmask)
        Nl = Fpf.shape[0]
        Lch = jnp.linalg.cholesky(E_d)
        Bv = jax.scipy.linalg.solve_triangular(
            Lch, Fpf.transpose(0, 2, 1, 3).reshape(Nl, 3, L * FRAME_VARS),
            lower=True).reshape(Nl, 3, L, FRAME_VARS)
        # rhs reduction rides the same factor: F^T Einv g = B^T (L^-1 g)
        y = jax.scipy.linalg.solve_triangular(
            Lch, gp[:, :, None], lower=True)[..., 0]        # [Nl,3]
        Rv = jnp.einsum("ialb,ia->ilb", Bv, y)              # [Nl,L,10]

        pc = min(point_chunk, Nl)
        pad = (-Nl) % pc
        Bp = jnp.pad(Bv, ((0, pad), (0, 0), (0, 0), (0, 0))) if pad else Bv
        Rp = jnp.pad(Rv, ((0, pad), (0, 0), (0, 0))) if pad else Rv
        fp = jnp.pad(fidx, ((0, pad), (0, 0))) if pad else fidx

        S0 = jnp.zeros((F * FRAME_VARS, F * FRAME_VARS), dtype)
        red0 = jnp.zeros((F, FRAME_VARS), dtype)

        def chunk_body(c, carry):
            S, red = carry
            sl = lambda x: jax.lax.dynamic_slice_in_dim(x, c * pc, pc)
            Bc, Rc, fc = sl(Bp), sl(Rp), sl(fp)
            # one-hot matmuls instead of scatter-adds; TRANSPOSED strip
            # (point dim minor), as in models/ba/sparse.py
            oh = jax.nn.one_hot(fc, F, dtype=dtype)         # [pc,L,F]
            Bm = jnp.einsum("ilf,ialb->fbai", oh, Bc).reshape(
                F * FRAME_VARS, pc * 3)                     # [10F, 3pc]
            return S - Bm @ Bm.T, red + jnp.einsum("ilf,ilb->fb", oh, Rc)

        S_part, red_part = jax.lax.fori_loop(
            0, Bp.shape[0] // pc, chunk_body, (S0, red0))
        S_part = S_part.reshape(F, FRAME_VARS, F, FRAME_VARS)

        S = jax.lax.psum(S_part, "lm")
        red = jax.lax.psum(red_part, "lm")
        S = S + jnp.einsum("fab,fg->fagb", G_d, jnp.eye(F, dtype=dtype))
        S2 = S.reshape(F * FRAME_VARS, F * FRAME_VARS)
        rhs = (-(gf - red)).reshape(F * FRAME_VARS)
        d = jnp.sqrt(jnp.maximum(jnp.abs(jnp.diagonal(S2)), 1e-12))
        dinv = 1.0 / d
        S2p = S2 * dinv[:, None] * dinv[None, :]
        du = (dinv * cho_solve(cho_factor(S2p, lower=True), rhs * dinv)
              ).reshape(F, FRAME_VARS)
        du_g = du[fidx]
        # back-substitute through the same Cholesky (no batched inverse)
        rhs_pt = gp + jnp.einsum("ilab,ilb->ia", Fpf, du_g)
        dX = -cho_solve((Lch, True), rhs_pt[:, :, None])[..., 0]
        return dX, du

    def kernel_banded(E, Fpf, gp, fidx, mask, ext, G, gf, hessian_factor):
        dtype = E.dtype
        fmask = _fvm(F, unity_comp_ind, optimize_intrinsics, pin_frames)
        E_d = _damp(E, hessian_factor)
        G_d = _fixed_var_identity(_damp(G, hessian_factor), fmask)
        local_plan = band_plan._replace(ext_idx=ext[0])   # this shard's map
        Sg, red_part, Lch, Fpf_s, gp_s, fidx_s, exti = _sp._banded_reduction(
            E_d, Fpf, gp, fidx, mask, local_plan, F)

        Sg = jax.lax.psum(Sg, "lm")
        red = jax.lax.psum(red_part, "lm")
        S2 = (jnp.einsum("fab,fg->fagb", G_d, jnp.eye(F, dtype=dtype))
              .reshape(F * FRAME_VARS, F * FRAME_VARS) - Sg)
        rhs = (-(gf - red)).reshape(F * FRAME_VARS)
        d = jnp.sqrt(jnp.maximum(jnp.abs(jnp.diagonal(S2)), 1e-12))
        dinv = 1.0 / d
        S2p = S2 * dinv[:, None] * dinv[None, :]
        du = (dinv * cho_solve(cho_factor(S2p, lower=True), rhs * dinv)
              ).reshape(F, FRAME_VARS)
        du_g = du[fidx_s]
        rhs_pt = gp_s + jnp.einsum("ilab,ilb->ia", Fpf_s, du_g)
        dX_s = -cho_solve((Lch, True), rhs_pt[:, :, None])[..., 0]
        Nl = Fpf.shape[0]
        dX = jnp.zeros((Nl + 1, 3), dtype).at[exti].set(dX_s)[:Nl]
        return dX, du

    if band_plan is not None:
        ext_default = jnp.asarray(band_plan.ext_idx)      # [n_dev, Npad]
        smapped_b = shard_map(
            kernel_banded,
            mesh=mesh,
            in_specs=(P("lm"), P("lm"), P("lm"), P("lm"), P("lm"),
                      P("lm"), P(), P(), P()),
            out_specs=(P("lm"), P()),
            check_rep=False,
        )

        @jax.jit
        def solve(p_sparse, blocks, hessian_factor, ext_idx=None):
            # ext_idx as a traced argument: re-planning a grown problem
            # with unchanged band geometry reuses this compiled program
            ext = ext_default if ext_idx is None else ext_idx
            hf = jnp.asarray(hessian_factor, blocks.E.dtype)
            dX, du = smapped_b(blocks.E, blocks.Fpf, blocks.gp,
                               p_sparse.frame_idx, p_sparse.obs_mask,
                               ext, blocks.G, blocks.gf, hf)
            ok = jnp.all(jnp.isfinite(du)) & jnp.all(jnp.isfinite(dX))
            return dX, du, ok

        return solve

    smapped = shard_map(
        kernel,
        mesh=mesh,
        in_specs=(P("lm"), P("lm"), P("lm"), P("lm"), P(), P(), P()),
        out_specs=(P("lm"), P()),
        check_rep=False,
    )

    @jax.jit
    def solve(p_sparse, blocks, hessian_factor):
        hf = jnp.asarray(hessian_factor, blocks.E.dtype)
        dX, du = smapped(blocks.E, blocks.Fpf, blocks.gp,
                         p_sparse.frame_idx, blocks.G, blocks.gf, hf)
        ok = jnp.all(jnp.isfinite(du)) & jnp.all(jnp.isfinite(dX))
        return dX, du, ok

    return solve


def make_sharded_ba_step(n_points: int, n_frames: int, mesh: Mesh,
                         unity_comp_ind: int = 1):
    """One full distributed Gauss-Newton/LM trial step: derivative blocks
    (sharded over points via vmap sharding from the dense grid) + distributed
    Schur solve + correction apply. Used by the multichip dry run and the
    scaled MVF configuration."""
    solver = make_sharded_schur_solver(n_points, n_frames, mesh, unity_comp_ind)

    @jax.jit
    def step(p, hessian_factor):
        blocks = derivs.compute_blocks(p, unity_comp_ind=unity_comp_ind)
        dX, du, ok = solver(blocks, hessian_factor)
        p_new = derivs.apply_corrections(p, dX, du)
        return p_new, ok

    return step
