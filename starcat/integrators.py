"""Symplectic integrators (SURVEY.md ⑤⑥): velocity-Verlet leapfrog and the
generalized (implicit) Riemannian leapfrog.

Both integrators are expressed as ``lax.scan`` bodies with static trip
counts — no data-dependent Python control flow — so they jit, vmap over
thousands of chains, and shard over device meshes unchanged (SURVEY.md §7.3
"RHMC integrator inside vmap/jit": the implicit fixed-point iterations run a
FIXED number of sweeps; divergences are detected by energy error and
rejected by the MH step, never allowed to NaN the batch).

The gradient callable has signature grad_fn(theta) -> (U, dU/dtheta) so one
closure (potential.make_potential_and_grad, or jax.value_and_grad of the
potential) serves every head.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


class LeapfrogResult(NamedTuple):
    theta: jax.Array
    p: jax.Array
    u: jax.Array      # potential at final theta
    grad: jax.Array   # gradient at final theta


def leapfrog(
    grad_fn: Callable,
    theta: jax.Array,
    p: jax.Array,
    u: jax.Array,
    grad: jax.Array,
    eps: jax.Array,
    n_steps: int,
    inv_mass: jax.Array,
) -> LeapfrogResult:
    """n_steps of velocity-Verlet with diagonal (inverse) mass matrix.

    Reuses the cached gradient at the initial point, so the cost is exactly
    ``n_steps`` fresh gradient evaluations (the hot-loop unit the benchmark
    counts, BASELINE.json:2 "leapfrog grad-evals/sec").
    """

    def step(carry, _):
        theta, p, _, grad = carry
        p_half = p - 0.5 * eps * grad
        theta_new = theta + eps * inv_mass * p_half
        u_new, grad_new = grad_fn(theta_new)
        p_new = p_half - 0.5 * eps * grad_new
        return (theta_new, p_new, u_new, grad_new), None

    (theta, p, u, grad), _ = jax.lax.scan(
        step, (theta, p, u, grad), None, length=n_steps
    )
    return LeapfrogResult(theta, p, u, grad)


def kinetic_energy(p: jax.Array, inv_mass: jax.Array) -> jax.Array:
    return 0.5 * jnp.sum(inv_mass * p * p)


# ---------------------------------------------------------------------------
# Generalized (implicit) Riemannian leapfrog — Girolami & Calderhead 2011,
# with fixed-sweep fixed-point solves (SURVEY.md ⑥; P:7, P:9).
# ---------------------------------------------------------------------------

class RiemannianLeapfrogResult(NamedTuple):
    theta: jax.Array
    p: jax.Array
    # max (over steps and both implicit solves) relative last-sweep Picard
    # delta ||x_k - x_{k-1}||_inf / (1 + ||x_k||_inf): a contraction-mapping
    # estimate of the fixed-point solver error, tracked for free from the
    # final sweep's carry.  Large values mean the solver did NOT converge —
    # the proposal is not the symplectic map and must be rejected
    # (rhmc_step's solver_fail; VERDICT round-3 item 5).
    solver_resid: jax.Array


def fp_delta(x_new: jax.Array, x_old: jax.Array) -> jax.Array:
    """Relative sup-norm Picard delta (shared by the XLA and Pallas paths
    so solver_tol means the same thing on both; reduces ALL axes — use
    inside per-chain code, or axis-specified variants in the kernels)."""
    return jnp.max(jnp.abs(x_new - x_old)) / (1.0 + jnp.max(jnp.abs(x_new)))


def riemannian_leapfrog(
    dH_dtheta: Callable,  # (theta, p) -> dH/dtheta   (includes U, logdet, quad terms)
    dH_dp: Callable,      # (theta, p) -> dH/dp = G(theta)^{-1} p
    theta: jax.Array,
    p: jax.Array,
    eps: jax.Array,
    n_steps: int,
    fixed_point_iters: int = 6,
) -> RiemannianLeapfrogResult:
    """Generalized leapfrog for the non-separable Riemannian Hamiltonian

        H(theta, p) = U(theta) + 1/2 log det G(theta) + 1/2 p^T G(theta)^-1 p

    Each step solves two implicit equations by ``fixed_point_iters`` Picard
    sweeps (static count — vmap/jit-safe):

        p_half    = p      - eps/2 * dH/dtheta(theta,  p_half)
        theta_new = theta  + eps/2 * [dH/dp(theta, p_half) + dH/dp(theta_new, p_half)]
        p_new     = p_half - eps/2 * dH/dtheta(theta_new, p_half)

    The final sweep of each solve also reports its relative delta (see
    RiemannianLeapfrogResult.solver_resid); sweep counts stay STATIC so the
    head stays lockstep across vmapped chains.
    """

    def fp(f, x0):
        def body(_, carry):
            x, _ = carry
            x_new = f(x)
            return x_new, fp_delta(x_new, x)
        x, delta = jax.lax.fori_loop(
            0, fixed_point_iters, body, (x0, jnp.zeros((), x0.dtype))
        )
        return x, delta

    def step(carry, _):
        theta, p, resid = carry
        p_half, d1 = fp(lambda ph: p - 0.5 * eps * dH_dtheta(theta, ph), p)
        v0 = dH_dp(theta, p_half)
        theta_new, d2 = fp(
            lambda th: theta + 0.5 * eps * (v0 + dH_dp(th, p_half)),
            theta + eps * v0,
        )
        p_new = p_half - 0.5 * eps * dH_dtheta(theta_new, p_half)
        resid = jnp.maximum(resid, jnp.maximum(d1, d2))
        return (theta_new, p_new, resid), None

    (theta, p, resid), _ = jax.lax.scan(
        step, (theta, p, jnp.zeros((), theta.dtype)), None, length=n_steps
    )
    return RiemannianLeapfrogResult(theta, p, resid)


# NOTE: an explicit symplectic integrator (Tao 2016 phase-space doubling,
# as applied to RMHMC by Cobb et al. 2019) was implemented here in round 1
# and RETIRED in round 2 after a decisive omega sweep on config 1 — see
# docs/DESIGN.md "Explicit Riemannian integrator: measured and retired".
# At every binding strength (omega 1..100) the
# dual-averaged step size shrank ~omega^-1/2 and total-flux ESS/s was
# ~2.6x WORSE than the implicit fixed-sweep scheme.  The implicit generalized leapfrog
# above is the only supported Riemannian integrator.
