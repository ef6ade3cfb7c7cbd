"""Riemannian-manifold HMC head (SURVEY.md ⑥⑧; BASELINE.json:8, config 1).

Non-separable Hamiltonian on the Fisher metric G(theta) (metric.py):

    H(theta, p) = U(theta) + 1/2 log det G(theta) + 1/2 p^T G(theta)^-1 p

integrated with the generalized (implicit) leapfrog of Girolami &
Calderhead (2011) using a FIXED number of Picard sweeps
(integrators.riemannian_leapfrog) so the whole transition jits and vmaps
(SURVEY.md §7.3).  dH/dtheta is obtained by jax.grad through the metric
construction and its Cholesky — XLA differentiates the (3K,3K) factor at
negligible cost next to the J^T J contraction.

Momentum refresh: p ~ N(0, G(theta)) via the Cholesky factor; dead slots'
momenta are zeroed (their G rows are identity, so the flow leaves them
fixed either way — zeroing also keeps Delta-H exactly mask-invariant).

Internally theta and p are FLAT (3K,) vectors (the metric is a dense
(3K,3K) matrix); the (K,3) catalog layout is restored at the ChainState
boundary.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from .driver import ChainState, run_mcmc
from .integrators import riemannian_leapfrog


class RHMCConfig(NamedTuple):
    step_size: float = 0.05
    n_leapfrog: int = 10
    fixed_point_iters: int = 6
    # 0.9 (not the usual 0.8): the smaller adapted step keeps the implicit
    # solver convergent — measured on config 1: divergences 12% -> 5% and
    # total-flux ESS 16 -> 23 vs target 0.8.
    target_accept: float = 0.9
    divergence_threshold: float = 1000.0
    # "full": dense Fisher metric (make_metric_fn) — config-1 default.
    # "diag": diagonal Fisher (make_diag_metric_fn) — no Cholesky, O(3K*P)
    #         metric evals; 4x cheaper per step at the crowded-field shape
    #         (round-3 measurement) with the same invariant distribution.
    metric: str = "full"
    # The generalized (implicit, fixed-Picard-sweep) leapfrog is the only
    # integrator: an explicit Tao/Cobb doubled-phase-space scheme was
    # measured ~2.6x worse in ESS/s at every binding strength on config 1
    # and retired (docs/DESIGN.md).
    #
    # Solver-failure handling (VERDICT round-3 item 5): fixed-point
    # NON-convergence is detected directly from the final Picard sweep's
    # relative delta (integrators.fp_delta) — a transition whose residual
    # exceeds solver_tol is force-rejected (solver_fail, reported
    # separately from Delta-H divergences) because its proposal is not the
    # symplectic map the MH ratio assumes.  Recovery is via the step size:
    # warmup's dual averaging subtracts divergence_penalty * (divergence +
    # solver-failure fraction) from the pooled acceptance statistic, so eps
    # settles where failures are rare (< ~(1-target)/penalty) instead of
    # being invisible to adaptation.  A per-transition retry was considered
    # and rejected: under vmap lockstep, a retried chain costs every
    # chain a second trajectory (docs/DESIGN.md).
    solver_tol: float = 0.05
    divergence_penalty: float = 5.0


class RHMCInfo(NamedTuple):
    accept_prob: jax.Array
    accepted: jax.Array
    diverged: jax.Array
    energy_error: jax.Array
    # fixed-point solver failed to converge (residual > solver_tol):
    # force-rejected, counted separately from Delta-H divergences
    solver_fail: jax.Array


def make_rhmc_functions(potential_fn: Callable, metric_fn: Callable):
    """Flat-vector Hamiltonian callables for the generalized leapfrog.

    potential_fn: (theta (K,3), mask (K,)) -> U scalar.
    metric_fn:    (theta (K,3), mask (K,)) -> G (3K,3K).
    Returns (hamiltonian, dH_dtheta, dH_dp), all taking
    (theta_flat, p_flat, mask) — mask may vary per chain (trans-d heads).
    """

    def ham(theta_flat, p, mask):
        theta = theta_flat.reshape(-1, 3)
        g = metric_fn(theta, mask)
        chol = jnp.linalg.cholesky(g)
        logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(chol)))
        ginv_p = jax.scipy.linalg.cho_solve((chol, True), p)
        return potential_fn(theta, mask) + 0.5 * logdet + 0.5 * jnp.dot(p, ginv_p, precision="highest")

    # remat: recompute the metric/Jacobian in the backward pass instead of
    # storing the (3K, H*W)-sized residuals of every Picard sweep — without
    # this, 4096-particle RHMC mutation (SMC config 3) runs out of device
    # memory.
    dham_dtheta = jax.grad(jax.checkpoint(ham), argnums=0)

    def dham_dp(theta_flat, p, mask):
        theta = theta_flat.reshape(-1, 3)
        g = metric_fn(theta, mask)
        chol = jnp.linalg.cholesky(g)
        return jax.scipy.linalg.cho_solve((chol, True), p)

    return ham, dham_dtheta, dham_dp


def make_rhmc_diag_functions(potential_fn: Callable, diag_metric_fn: Callable):
    """Hamiltonian callables for a DIAGONAL position-dependent metric
    (metric.make_diag_metric_fn).  Same generalized-leapfrog contract as
    make_rhmc_functions, but log det is a log-sum, G^-1 p is a divide, and
    dH/dtheta needs no Cholesky differentiation — the cheap Riemannian
    path for crowded-field scenes (SMC mutation "rhmc_diag").
    """

    def ham(theta_flat, p, mask):
        theta = theta_flat.reshape(-1, 3)
        g = diag_metric_fn(theta, mask)                # (3K,)
        return (
            potential_fn(theta, mask)
            + 0.5 * jnp.sum(jnp.log(g))
            + 0.5 * jnp.sum(p * p / g)
        )

    dham_dtheta = jax.grad(jax.checkpoint(ham), argnums=0)

    def dham_dp(theta_flat, p, mask):
        theta = theta_flat.reshape(-1, 3)
        return p / diag_metric_fn(theta, mask)

    return ham, dham_dtheta, dham_dp


def rhmc_step(
    state: ChainState,
    potential_fn: Callable,
    metric_fn: Callable,
    hamiltonian: Callable,
    dH_dtheta: Callable,
    dH_dp: Callable,
    eps: jax.Array,
    n_leapfrog: int,
    fixed_point_iters: int,
    mask: jax.Array,
    divergence_threshold: float = 1000.0,
    diag_metric: bool = False,
    solver_tol: float = 0.05,
):
    """One RHMC transition for a single chain (vmap over chains in driver).

    diag_metric=True: metric_fn returns the (3K,) diagonal metric and the
    momentum refresh is p ~ N(0, diag g) — no Cholesky.
    """
    key, k_mom, k_acc, k_jit = jax.random.split(state.key, 4)
    kshape = state.theta.shape
    theta0 = state.theta.reshape(-1)
    mask_p = jnp.repeat(mask, 3)

    eps_j = eps * (0.8 + 0.4 * jax.random.uniform(k_jit))

    g = metric_fn(state.theta, mask)
    xi = jax.random.normal(k_mom, theta0.shape, theta0.dtype)
    if diag_metric:
        p0 = jnp.sqrt(g) * xi * mask_p
    else:
        chol = jnp.linalg.cholesky(g)
        p0 = jnp.matmul(chol, xi, precision="highest") * mask_p

    dhdt = lambda th, p: dH_dtheta(th, p, mask)
    dhdp = lambda th, p: dH_dp(th, p, mask)
    res = riemannian_leapfrog(
        dhdt, dhdp, theta0, p0, eps_j, n_leapfrog, fixed_point_iters
    )
    h0 = hamiltonian(theta0, p0, mask)
    h1 = hamiltonian(res.theta, res.p, mask)
    energy_error = jnp.where(jnp.isfinite(h1 - h0), h1 - h0, jnp.inf)
    accept_prob = jnp.exp(jnp.minimum(0.0, -energy_error))
    diverged = energy_error > divergence_threshold
    # solver non-convergence (NaN residual also fails): the proposal is not
    # the reversible symplectic map, so force rejection regardless of
    # Delta-H — and let accept_prob=0 teach dual averaging about it
    solver_fail = ~(res.solver_resid < solver_tol)
    accept_prob = jnp.where(solver_fail, 0.0, accept_prob)

    accept = jax.random.uniform(k_acc) < accept_prob
    theta_new = jnp.where(accept, res.theta, theta0).reshape(kshape)
    # keep ChainState's cached u coherent; grad is unused by this head
    u = jnp.where(accept, potential_fn(res.theta.reshape(kshape), mask), state.u)

    return ChainState(theta_new, u, state.grad, key), RHMCInfo(
        accept_prob, accept, diverged, energy_error, solver_fail
    )


def make_rhmc_kernel(
    potential_fn: Callable,
    metric_fn: Callable,
    mask: jax.Array,
    config: RHMCConfig = RHMCConfig(),
    diag_metric: bool = False,
):
    """Kernel factory with the driver.py signature (state, eps, inv_mass).

    The driver's inv_mass argument is ignored — the Fisher metric IS the
    (position-dependent) mass matrix, so run with adapt_mass=False.
    diag_metric=True selects the diagonal-Fisher path: metric_fn must
    return a (3K,) vector (metric.make_diag_metric_fn).
    """
    if diag_metric:
        ham, dhdt, dhdp = make_rhmc_diag_functions(potential_fn, metric_fn)
    else:
        ham, dhdt, dhdp = make_rhmc_functions(potential_fn, metric_fn)

    def kernel(state, eps, inv_mass):
        del inv_mass
        return rhmc_step(
            state, potential_fn, metric_fn, ham, dhdt, dhdp,
            eps, config.n_leapfrog, config.fixed_point_iters, mask,
            config.divergence_threshold, diag_metric=diag_metric,
            solver_tol=config.solver_tol,
        )

    return kernel


def run_rhmc(
    key: jax.Array,
    potential_fn: Callable,
    metric_fn: Callable,
    grad_fn: Callable,
    theta0: jax.Array,  # (n_chains, K, 3)
    mask: jax.Array,
    n_samples: int,
    n_warmup: int,
    config: RHMCConfig = RHMCConfig(),
    block_size: int | None = None,
    checkpoint_path: str | None = None,
    resume: bool = False,
    logger=None,
    thin: int = 1,
):
    """Config-1 driver: 64-chain RHMC with step-size-only warmup.

    metric_fn must match config.metric: a (3K,3K) matrix fn for "full"
    (metric.make_metric_fn) or a (3K,) vector fn for "diag"
    (metric.make_diag_metric_fn).
    """
    kernel = make_rhmc_kernel(potential_fn, metric_fn, mask, config,
                              diag_metric=config.metric == "diag")
    return run_mcmc(
        key, kernel, grad_fn, theta0, n_samples, n_warmup,
        step_size=config.step_size, target_accept=config.target_accept,
        adapt_mass=False, block_size=block_size,
        checkpoint_path=checkpoint_path, resume=resume, logger=logger,
        thin=thin, divergence_penalty=config.divergence_penalty,
    )
