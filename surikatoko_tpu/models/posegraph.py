"""SE(3) pose-graph optimization.

The north-star SfM path names a pose graph alongside BA (BASELINE.json); the
reference has only implicit odometry chains. This module optimizes keyframe
poses against relative-pose constraints (odometry + loop closures):

  minimize  sum_e || w_e * log( Z_e^-1 * T_i^-1 * T_j ) ||^2

with T = world-from-keyframe, Z_e the measured j-from-i relative transform,
log the SE(3) right-translation residual split into (rotation log, position
difference in frame i). Gauss-Newton with autodiff Jacobians over local
increments (left-multiplied se(3) twists), gauge fixed by pinning pose 0 (the
unit-diagonal masking trick used across the framework). Edges are a fixed-
capacity masked array; everything jits.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from surikatoko_tpu.geom import so3


class PoseGraph(NamedTuple):
    R: jnp.ndarray          # [N,3,3] world-from-keyframe rotations
    t: jnp.ndarray          # [N,3] keyframe positions
    edge_i: jnp.ndarray     # [E] int32 source pose index
    edge_j: jnp.ndarray     # [E] int32 target pose index
    rel_R: jnp.ndarray      # [E,3,3] measured R_i^-1 R_j
    rel_t: jnp.ndarray      # [E,3] measured t_ij in frame i
    weight: jnp.ndarray     # [E] scalar edge weights
    mask: jnp.ndarray       # [E] valid edges


def make_pose_graph(R, t, edges) -> PoseGraph:
    """edges: list of (i, j, rel_R [3,3], rel_t [3], weight)."""
    import numpy as np

    E = len(edges)
    ei = np.asarray([e[0] for e in edges], np.int32)
    ej = np.asarray([e[1] for e in edges], np.int32)
    rR = np.stack([np.asarray(e[2]) for e in edges])
    rt = np.stack([np.asarray(e[3]) for e in edges])
    w = np.asarray([e[4] if len(e) > 4 else 1.0 for e in edges])
    return PoseGraph(
        R=jnp.asarray(R), t=jnp.asarray(t),
        edge_i=jnp.asarray(ei), edge_j=jnp.asarray(ej),
        rel_R=jnp.asarray(rR, jnp.asarray(R).dtype),
        rel_t=jnp.asarray(rt, jnp.asarray(R).dtype),
        weight=jnp.asarray(w, jnp.asarray(R).dtype),
        mask=jnp.ones((E,), bool))


def edge_residuals(g: PoseGraph, dw: jnp.ndarray, dt: jnp.ndarray) -> jnp.ndarray:
    """[E,6] residuals at local increments (dw, dt) [N,3] each (zeros at the
    linearization point): rotation-log and frame-i translation errors."""
    R = jax.vmap(lambda w, Rb: so3.exp(w) @ Rb)(dw, g.R)
    t = g.t + dt
    Ri = R[g.edge_i]
    Rj = R[g.edge_j]
    ti = t[g.edge_i]
    tj = t[g.edge_j]
    R_ij = jnp.einsum("eab,eac->ebc", Ri, Rj)          # Ri^T Rj
    t_ij = jnp.einsum("eab,ea->eb", Ri, tj - ti)       # Ri^T (tj - ti)
    dR = jnp.einsum("eab,eac->ebc", g.rel_R, R_ij)     # Z_R^T R_ij
    r_rot = so3.log(dR)
    r_trn = t_ij - g.rel_t
    r = jnp.concatenate([r_rot, r_trn], axis=-1)
    wgt = (g.weight * g.mask.astype(r.dtype))[:, None]
    return r * wgt


def graph_error(g: PoseGraph) -> jnp.ndarray:
    z = jnp.zeros_like(g.t)
    r = edge_residuals(g, z, z)
    return jnp.sum(r * r)


def _linearize(g: PoseGraph) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Residuals r [m] and Jacobian J [m, 6N] at the current poses, with
    pose-0 columns zeroed (gauge pin)."""
    N = g.R.shape[0]
    dtype = g.t.dtype
    z = jnp.zeros((N, 3), dtype)

    def res_flat(dw, dt):
        return edge_residuals(g, dw, dt).reshape(-1)

    r = res_flat(z, z)
    Jw, Jt = jax.jacfwd(res_flat, argnums=(0, 1))(z, z)
    J = jnp.concatenate([Jw.reshape(r.shape[0], -1),
                         Jt.reshape(r.shape[0], -1)], axis=1)  # [m, 6N]
    # pin pose 0: zero its columns (dw0 at cols 0:3, dt0 at 3N:3N+3)
    free = jnp.ones((2 * 3 * N,), dtype)
    free = free.at[0:3].set(0.0).at[3 * N:3 * N + 3].set(0.0)
    return r, J * free[None, :]


def _solve_damped(g: PoseGraph, blocks, lam: jnp.ndarray) -> jnp.ndarray:
    """-(JᵀJ + λI + pin-diag)⁻¹ Jᵀr — one damped GN step [6N]."""
    N = g.R.shape[0]
    dtype = g.t.dtype
    r, J = blocks
    H = J.T @ J + (lam + 1e-12) * jnp.eye(6 * N, dtype=dtype)
    pin = jnp.zeros((6 * N,), dtype)
    pin = pin.at[0:3].set(1.0).at[3 * N:3 * N + 3].set(1.0)
    H = H + jnp.diag(pin)       # unit diagonal on pinned vars
    return -jnp.linalg.solve(H, J.T @ r)


def _apply_step(g: PoseGraph, d: jnp.ndarray) -> PoseGraph:
    N = g.R.shape[0]
    dw = d[: 3 * N].reshape(N, 3)
    dt = d[3 * N:].reshape(N, 3)
    R_new = jax.vmap(lambda w, Rb: so3.exp(w) @ Rb)(dw, g.R)
    return g._replace(R=R_new, t=g.t + dt)


class Sim3Graph(NamedTuple):
    """Sim(3) pose graph: nodes are world-from-keyframe SIMILARITIES
    (R, t, s) — the standard mechanism for monocular loop closure, where
    pure SE(3) graphs cannot absorb accumulated SCALE drift (Strasdat et
    al., "Scale Drift-Aware Large Scale Monocular SLAM", RSS 2010). The
    reference has no loop-closure machinery at all."""

    R: jnp.ndarray          # [N,3,3]
    t: jnp.ndarray          # [N,3]
    s: jnp.ndarray          # [N] per-keyframe scale
    edge_i: jnp.ndarray     # [E]
    edge_j: jnp.ndarray     # [E]
    rel_R: jnp.ndarray      # [E,3,3] measured R of S_i^-1 S_j
    rel_t: jnp.ndarray      # [E,3]
    rel_s: jnp.ndarray      # [E] measured scale of S_i^-1 S_j
    weight: jnp.ndarray     # [E]
    mask: jnp.ndarray       # [E]


def sim3_compose(a, b):
    """(s,R,t) tuples: a ∘ b (apply b then a)."""
    sa, Ra, ta = a
    sb, Rb, tb = b
    return (sa * sb, Ra @ Rb, sa * (Ra @ tb) + ta)


def sim3_inverse(a):
    s, R, t = a
    return (1.0 / s, R.T, -(R.T @ t) / s)


def make_sim3_graph(R, t, edges, s=None) -> Sim3Graph:
    """edges: list of (i, j, rel_R, rel_t, rel_s, weight). Odometry edges
    use rel_s = 1 (no scale change measured along the chain)."""
    import numpy as np

    E = len(edges)
    dtype = jnp.asarray(R).dtype
    N = np.asarray(R).shape[0]
    ei = np.asarray([e[0] for e in edges], np.int32)
    ej = np.asarray([e[1] for e in edges], np.int32)
    rR = np.stack([np.asarray(e[2]) for e in edges])
    rt = np.stack([np.asarray(e[3]) for e in edges])
    rs = np.asarray([float(e[4]) for e in edges])
    w = np.asarray([e[5] if len(e) > 5 else 1.0 for e in edges])
    s0 = np.ones(N) if s is None else np.asarray(s)
    return Sim3Graph(
        R=jnp.asarray(R), t=jnp.asarray(t), s=jnp.asarray(s0, dtype),
        edge_i=jnp.asarray(ei), edge_j=jnp.asarray(ej),
        rel_R=jnp.asarray(rR, dtype), rel_t=jnp.asarray(rt, dtype),
        rel_s=jnp.asarray(rs, dtype), weight=jnp.asarray(w, dtype),
        mask=jnp.ones((E,), bool))


def sim3_edge_residuals(g: Sim3Graph, dw, dt, dls) -> jnp.ndarray:
    """[E,7] residuals of S_i^-1 S_j vs the measurement at local increments
    (dw,dt [N,3], dls [N]): rotation log, frame-i translation difference,
    log-scale difference."""
    R = jax.vmap(lambda w, Rb: so3.exp(w) @ Rb)(dw, g.R)
    t = g.t + dt
    s = g.s * jnp.exp(dls)
    Ri, Rj = R[g.edge_i], R[g.edge_j]
    ti, tj = t[g.edge_i], t[g.edge_j]
    si, sj = s[g.edge_i], s[g.edge_j]
    R_ij = jnp.einsum("eab,eac->ebc", Ri, Rj)
    t_ij = jnp.einsum("eab,ea->eb", Ri, tj - ti) / si[:, None]
    r_rot = so3.log(jnp.einsum("eab,eac->ebc", g.rel_R, R_ij))
    r_trn = t_ij - g.rel_t
    r_scl = (jnp.log(sj) - jnp.log(si) - jnp.log(g.rel_s))[:, None]
    r = jnp.concatenate([r_rot, r_trn, r_scl], axis=-1)
    wgt = (g.weight * g.mask.astype(r.dtype))[:, None]
    return r * wgt


def sim3_graph_error(g: Sim3Graph) -> jnp.ndarray:
    z = jnp.zeros_like(g.t)
    r = sim3_edge_residuals(g, z, z, jnp.zeros_like(g.s))
    return jnp.sum(r * r)


def _sim3_linearize(gc: Sim3Graph):
    N = gc.R.shape[0]
    dtype = gc.t.dtype
    z3 = jnp.zeros((N, 3), dtype)
    z1 = jnp.zeros((N,), dtype)

    def res_flat(dw, dt, dls):
        return sim3_edge_residuals(gc, dw, dt, dls).reshape(-1)

    r = res_flat(z3, z3, z1)
    Jw, Jt, Js = jax.jacfwd(res_flat, argnums=(0, 1, 2))(z3, z3, z1)
    J = jnp.concatenate([Jw.reshape(r.shape[0], -1),
                         Jt.reshape(r.shape[0], -1),
                         Js.reshape(r.shape[0], -1)], axis=1)  # [m,7N]
    free = jnp.ones((7 * N,), dtype)
    free = (free.at[0:3].set(0.0)
            .at[3 * N:3 * N + 3].set(0.0)
            .at[6 * N].set(0.0))
    return r, J * free[None, :]


def _sim3_solve_damped(gc: Sim3Graph, blocks, lam):
    r, J = blocks
    N = gc.R.shape[0]
    dtype = gc.t.dtype
    H = J.T @ J + (lam + 1e-12) * jnp.eye(7 * N, dtype=dtype)
    pin = jnp.zeros((7 * N,), dtype)
    pin = pin.at[0:3].set(1.0).at[3 * N:3 * N + 3].set(1.0).at[6 * N].set(1.0)
    H = H + jnp.diag(pin)
    return -jnp.linalg.solve(H, J.T @ r)


def _sim3_apply_step(gc: Sim3Graph, d) -> Sim3Graph:
    N = gc.R.shape[0]
    dw = d[:3 * N].reshape(N, 3)
    dt = d[3 * N:6 * N].reshape(N, 3)
    dls = d[6 * N:]
    R_new = jax.vmap(lambda w, Rb: so3.exp(w) @ Rb)(dw, gc.R)
    return gc._replace(R=R_new, t=gc.t + dt, s=gc.s * jnp.exp(dls))


def optimize_sim3_graph(g: Sim3Graph, iters: int = 30,
                        damping: float = 1e-6,
                        max_damping: float = 1e8,
                        device_loop: bool = False) -> Sim3Graph:
    """LM over (R, t, log s) of all nodes; node 0 pinned (full Sim(3)
    gauge: orientation, position, AND global scale).

    ``device_loop=True`` compiles the whole damping schedule as one program
    (models/ba/lm_device.py, the same driver the SE(3) graph and the BA
    use): the host path pays a dispatch plus a blocking error fetch per
    attempt and re-linearizes after every rejected step, while the device
    driver caches the linearization across damping retries."""
    dtype = g.t.dtype

    if device_loop:
        from surikatoko_tpu.models.ba import lm_device

        def solve_fn(p, blocks, factor):
            lam = jnp.maximum(factor, damping)
            d = _sim3_solve_damped(p, blocks, lam)
            return d, jnp.zeros((), dtype), jnp.all(jnp.isfinite(d))

        g_out, _code, _iters, _err, _tr = jax.jit(
            lambda g0: lm_device.run_lm_on_device(
                g0, blocks_fn=_sim3_linearize, solve_fn=solve_fn,
                apply_fn=lambda p, dX, _du: _sim3_apply_step(p, dX),
                err_fn=sim3_graph_error, err_thresh=None,
                max_factor=max_damping, max_iters=iters,
                initial_factor=damping))(g)
        return g_out

    lm_step = jax.jit(
        lambda gc, lam: _sim3_apply_step(
            gc, _sim3_solve_damped(gc, _sim3_linearize(gc), lam)))
    lam = damping
    err = float(sim3_graph_error(g))
    for _ in range(iters):
        g_try = lm_step(g, jnp.asarray(lam, dtype))
        err_try = float(sim3_graph_error(g_try))
        if err_try < err:
            g, err = g_try, err_try
            lam = max(lam / 10.0, damping)
        else:
            lam *= 10.0
            if lam > max_damping:
                break
    return g


def optimize_pose_graph(g: PoseGraph, iters: int = 20,
                        damping: float = 1e-6,
                        max_damping: float = 1e8,
                        device_loop: bool = False) -> PoseGraph:
    """Levenberg-Marquardt over all poses; pose 0 pinned (gauge).

    Adaptive damping with the framework's x10/÷10 schedule (the BA loop's,
    reference bundle-adj-kanatani.cpp:841,:889): a rejected step raises
    lambda and retries from the same linearization, so far-from-linear
    initializations (large loop-closure residuals) converge instead of
    stalling on the first overshoot.

    ``device_loop=True`` compiles the whole schedule as one program
    (models/ba/lm_device.py — the same driver the BA uses): one dispatch for
    the full optimization instead of 2 blocking host syncs per attempt, and
    the linearization is cached across damping retries (the host path
    recomputes an identical J after each rejection)."""
    dtype = g.t.dtype

    if device_loop:
        from surikatoko_tpu.models.ba import lm_device

        def solve_fn(p, blocks, factor):
            lam = jnp.maximum(factor, damping)   # host path floors λ too
            d = _solve_damped(p, blocks, lam)
            return d, jnp.zeros((), dtype), jnp.all(jnp.isfinite(d))

        g_out, _code, _iters, _err, _tr = jax.jit(lambda g0: lm_device.run_lm_on_device(
            g0, blocks_fn=_linearize, solve_fn=solve_fn,
            apply_fn=lambda p, dX, _du: _apply_step(p, dX),
            err_fn=graph_error, err_thresh=None, max_factor=max_damping,
            max_iters=iters, initial_factor=damping))(g)
        return g_out

    @jax.jit
    def lm_step(g: PoseGraph, lam: jnp.ndarray) -> PoseGraph:
        return _apply_step(g, _solve_damped(g, _linearize(g), lam))

    lam = damping
    err = float(graph_error(g))
    for _ in range(iters):
        g_try = lm_step(g, jnp.asarray(lam, dtype))
        err_try = float(graph_error(g_try))
        if err_try < err:
            g, err = g_try, err_try
            lam = max(lam / 10.0, damping)
        else:
            lam *= 10.0
            if lam > max_damping:
                break
    return g
