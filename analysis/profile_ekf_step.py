"""Ablation profile of the on-device EKF frame step (bench.py hot path).

Times each stage of device_runner.frame_body as its own lax.scan on the
current backend, reporting us/iteration, to see where the per-frame time
goes:

    python analysis/profile_ekf_step.py [--capacity 96] [--iters 480]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--capacity", type=int, default=96)
    ap.add_argument("--iters", type=int, default=480)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    jax.config.update("jax_default_matmul_precision", "highest")

    from surikatoko_tpu.geom import camera
    from surikatoko_tpu.models.monoslam import (health, make_params,
                                                init_state, predict, update)
    from surikatoko_tpu.utils.profiling import median_wall_time
    from surikatoko_tpu.world.device_runner import (
        build_oscillating_scenario, init_with_gt_landmarks, make_scan_runner,
        _project_gt)

    capacity = args.capacity
    dtype = jnp.float32
    sc = build_oscillating_scenario(capacity=capacity, dtype=dtype)
    cam = camera.make_intrinsics((320, 240), (160.0, 120.0), 1.95,
                                 (0.01, 0.01), dtype=dtype)
    params = make_params(cam, None, dt=1.0,
                         process_noise_lin_veloc_std=0.075,
                         process_noise_ang_veloc_std=0.01, dtype=dtype)
    state = init_state(capacity, dtype=dtype)
    state = init_with_gt_landmarks(params, sc, state, jax.random.PRNGKey(0))
    obs, vis = jax.jit(lambda f, k: _project_gt(params, sc, f, k))(
        jnp.asarray(1), jax.random.PRNGKey(1))
    obs_mask = jnp.logical_and(vis, state.lm_active)

    N = args.iters

    def timed(name, body, init):
        run = jax.jit(lambda c: jax.lax.scan(
            lambda c, _: (body(c), None), c, None, length=N)[0])
        jax.block_until_ready(run(init))        # compile + warmup
        dt = median_wall_time(lambda: run(init))
        print(f"{name:32s} {dt / N * 1e6:9.1f} us/iter")

    # full frame (reference point)
    run_full = make_scan_runner(params, update_impl=1)
    frames = jnp.arange(1, 1 + N) % (sc.gt_cfw_R.shape[0] - 1)
    key = jax.random.PRNGKey(1)
    jax.block_until_ready(run_full(state, sc, frames, key))
    dt = median_wall_time(lambda: run_full(state, sc, frames, key))
    print(f"{'FULL frame_body':32s} {dt / N * 1e6:9.1f} us/iter")

    x, P = state.x, state.P

    timed("stacked_update", lambda c: update.stacked_update(
        params, c[0], c[1], obs, obs_mask)[:2], (x, P))

    # update decomposition
    from surikatoko_tpu.models.monoslam import measure
    from surikatoko_tpu.models.monoslam.update import (_dense_h, _hp,
                                                       _masked_jacobians)
    from jax.scipy.linalg import cho_factor, cho_solve
    Kcap = capacity

    # scan floor: trivial body to expose the fixed per-iteration cost that
    # every stage measurement below includes (subtract it mentally)
    timed("scan floor (trivial body)",
          lambda c: (c[0] + 1e-30, c[1]), (x, P))
    timed("scan floor (P pass-through)",
          lambda c: (c[0] + 1e-30, c[1] * 1.0), (x, P))

    def jac_only(c):
        h, Hcam, Hlm = _masked_jacobians(params, c[0], obs_mask)
        return c[0] + h.sum() * 0 + Hcam.sum() * 0 + Hlm.sum() * 0, c[1]
    timed("  jacobians", jac_only, (x, P))

    h0, Hcam0, Hlm0 = jax.jit(
        lambda xx: _masked_jacobians(params, xx, obs_mask))(x)

    def hp_only(c):
        A = _hp(Hcam0, Hlm0, c[1])
        return c[0] + A[0, 0, :] * 0 + A[0, 1, :] * 1e-12, c[1]
    timed("  A = H P", hp_only, (x, P))

    A0 = jax.jit(lambda PP: _hp(Hcam0, Hlm0, PP))(P)
    H0 = jax.jit(lambda: _dense_h(Hcam0, Hlm0))()

    def s_only(c):
        A2l = A0.reshape(2 * Kcap, -1)
        S = A2l @ H0.T + params.measurm_noise_var.astype(dtype) * jnp.eye(
            2 * Kcap, dtype=dtype)
        return c[0].at[:13].add(S.reshape(-1)[:13]), c[1]
    timed("  S build", s_only, (x, P))

    S2 = jax.jit(lambda: A0.reshape(2 * Kcap, -1) @ H0.T
                 + params.measurm_noise_var.astype(dtype)
                 * jnp.eye(2 * Kcap, dtype=dtype))()

    def cho_only(c):
        f, _ = cho_factor(c[1][: 2 * Kcap, : 2 * Kcap] * 0 + S2, lower=True)
        return c[0].at[:13].add(f[0, :13]), c[1]
    timed("  cho_factor(S)", cho_only, (x, P))

    cho0 = jax.jit(lambda: cho_factor(S2, lower=True)[0])()
    A2 = A0.reshape(2 * Kcap, -1)

    def solve_only(c):
        G = cho_solve((cho0 + c[0][0] * 0, True), A2)
        return c[0].at[:13].add(G[0, :13]), c[1]
    timed("  cho_solve(A2)", solve_only, (x, P))

    def solve_inv(c):
        Sinv = cho_solve((cho0 + c[0][0] * 0, True),
                         jnp.eye(2 * Kcap, dtype=dtype))
        G = Sinv @ A2
        return c[0].at[:13].add(G[0, :13]), c[1]
    timed("  S^-1 then matmul", solve_inv, (x, P))

    G0 = jax.jit(lambda: cho_solve((cho0, True), A2))()

    def downdate_only(c):
        Pn = c[1] - A2.T @ G0
        Pn = 0.5 * (Pn + Pn.T)
        return c[0], Pn * 0 + c[1]
    timed("  P -= A^T G + symm", downdate_only, (x, P))

    timed("health.normalize_quat_covar",
          lambda c: health.normalize_quat_and_covar(c[0], c[1]), (x, P))
    timed("health.nonneg_variance",
          lambda c: (c[0], health.ensure_nonneg_variance(c[1])), (x, P))
    timed("predict", lambda c: (lambda s: (s.x, s.P))(
        predict.predict(params, state._replace(x=c[0], P=c[1]))), (x, P))


if __name__ == "__main__":
    main()
