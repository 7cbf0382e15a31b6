"""Optimal two-view correspondence correction (Hartley-Sturm, HZ alg. 12.1).

Capability match for the reference prototype's "poly6" correction
(py_proto/suriko/mvg.py:2558-2728): given a fundamental matrix F and a
correspondence (x1, x2), find the pair (x1', x2') *exactly* satisfying the
epipolar constraint while minimizing geometric distance — by parametrizing
the epipolar pencil with angle t and finding the global minimum of the
6th-degree polynomial g(t).

Accelerator note: the degree-6 root solve is jit-safe — roots come from my own
companion-matrix eigenvalue iteration? No: we only need the *real minima* of
a smooth scalar cost s(t) on a bounded parametrization, so instead of
polynomial root extraction this implementation minimizes s(t) directly by
dense scan + Newton polish (global on t in (-pi/2, pi/2] via tan
substitution) — same optimum as the poly6 roots, no eigensolver, fully
batched over correspondences.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _transforms(F, x1, x2):
    """Translate points to origin and rotate epipoles onto the x-axis
    (HZ 12.1 steps i-iv). Returns F' and the rigid transforms."""
    dtype = F.dtype

    def trans(p):
        T = jnp.eye(3, dtype=dtype)
        T = T.at[0, 2].set(-p[0]).at[1, 2].set(-p[1])
        return T

    T1, T2 = trans(x1), trans(x2)
    T1i = jnp.linalg.inv(T1)
    T2i = jnp.linalg.inv(T2)
    Fs = T2i.T @ F @ T1i

    # epipoles: F e1 = 0, F^T e2 = 0; normalize e_x^2 + e_y^2 = 1
    _, _, Vt = jnp.linalg.svd(Fs)
    e1 = Vt[-1]
    U, _, _ = jnp.linalg.svd(Fs)
    e2 = U[:, -1]

    def normi(e):
        s = jnp.sqrt(e[0] ** 2 + e[1] ** 2)
        return e / jnp.where(s < 1e-15, 1.0, s)

    e1 = normi(e1)
    e2 = normi(e2)

    def rot(e):
        R = jnp.eye(3, dtype=dtype)
        R = R.at[0, 0].set(e[0]).at[0, 1].set(e[1])
        R = R.at[1, 0].set(-e[1]).at[1, 1].set(e[0])
        return R

    R1, R2 = rot(e1), rot(e2)
    Fr = R2 @ Fs @ R1.T
    return Fr, T1, T2, R1, R2, e1[2], e2[2]


def _cost(t, f1, f2, a, b, c, d):
    """Squared geometric distance s(t) (HZ 12.5)."""
    return (t * t / (1 + f1 * f1 * t * t)
            + (c * t + d) ** 2 / ((a * t + b) ** 2 + f2 * f2 * (c * t + d) ** 2))


def correct_correspondence(F: jnp.ndarray, x1: jnp.ndarray, x2: jnp.ndarray,
                           n_samples: int = 256, newton_iters: int = 4
                           ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Optimal (x1', x2') with x2'^T F x1' = 0 minimizing
    |x1-x1'|^2 + |x2-x2'|^2. Batched via vmap over the leading axis if
    inputs are stacked."""
    dtype = F.dtype
    Fr, T1, T2, R1, R2, f1, f2 = _transforms(F, x1, x2)
    a, b, c, d = Fr[1, 1], Fr[1, 2], Fr[2, 1], Fr[2, 2]

    # global scan over t = tan(theta) via theta grid, then Newton polish
    theta = jnp.linspace(-jnp.pi / 2 + 1e-3, jnp.pi / 2 - 1e-3, n_samples,
                         dtype=dtype)
    ts = jnp.tan(theta)
    costs = _cost(ts, f1, f2, a, b, c, d)
    t0 = ts[jnp.argmin(costs)]

    g = jax.grad(lambda t: _cost(t, f1, f2, a, b, c, d))
    h = jax.grad(g)

    def newton(t, _):
        dg = g(t)
        ddg = h(t)
        step = dg / jnp.where(jnp.abs(ddg) < 1e-18, 1e-18, ddg)
        t_new = t - jnp.clip(step, -1e3, 1e3)
        better = _cost(t_new, f1, f2, a, b, c, d) < _cost(t, f1, f2, a, b, c, d)
        return jnp.where(better, t_new, t), None

    t_star, _ = jax.lax.scan(newton, t0, None, length=newton_iters)
    # also consider t -> inf (epipolar line at infinity, HZ note)
    cost_inf = 1.0 / (f1 * f1) + c * c / (a * a + f2 * f2 * c * c)
    use_inf = cost_inf < _cost(t_star, f1, f2, a, b, c, d)

    # closest points on the epipolar lines l1 = (t f1, 1, -t), l2 = F [0,t,1]^T
    l1 = jnp.stack([t_star * f1, jnp.ones((), dtype), -t_star])
    l2 = Fr @ jnp.stack([jnp.zeros((), dtype), t_star, jnp.ones((), dtype)])
    l1_inf = jnp.stack([f1, jnp.zeros((), dtype), -jnp.ones((), dtype)])
    l2_inf = Fr @ jnp.stack([jnp.zeros((), dtype), jnp.ones((), dtype),
                             jnp.zeros((), dtype)])
    l1 = jnp.where(use_inf, l1_inf, l1)
    l2 = jnp.where(use_inf, l2_inf, l2)

    def closest_to_origin(l):
        lx, ly, lz = l[0], l[1], l[2]
        s = lx * lx + ly * ly
        return jnp.stack([-lx * lz, -ly * lz, s]) / jnp.where(s < 1e-30, 1.0, s)

    x1h = closest_to_origin(l1)
    x2h = closest_to_origin(l2)
    # undo the transforms
    x1c = jnp.linalg.inv(T1) @ (R1.T @ x1h)
    x2c = jnp.linalg.inv(T2) @ (R2.T @ x2h)
    return x1c[:2] / x1c[2], x2c[:2] / x2c[2]


correct_correspondences_batch = jax.vmap(
    correct_correspondence, in_axes=(None, 0, 0))
