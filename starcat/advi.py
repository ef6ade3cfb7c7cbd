"""ADVI head (SURVEY.md ⑯; BASELINE.json:5 "ADVI ... sharing the same
potential function").

Mean-field Gaussian q(theta) = N(mu, diag(exp(2 log_sigma))) over the
unconstrained catalog params, fit by maximizing the reparameterized ELBO

    ELBO = E_q[ -U(theta) ] + H[q],    theta = mu + sigma * xi,  xi ~ N(0, I)

with optax Adam, the whole optimization loop a lax.scan inside one jit.
Because the potential is the same closure every MCMC head uses, ADVI serves
as a fast initializer and a cross-check on posterior locations/scales.

Dead slots (mask == 0) are frozen: their gradient contribution is zero by
the masked potential, and their entropy term is excluded from the ELBO.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import optax


class ADVIConfig(NamedTuple):
    n_steps: int = 2000
    n_mc: int = 8              # MC samples per ELBO gradient
    learning_rate: float = 5e-2
    log_sigma0: float = -2.0   # initial log sd
    full_rank: bool = False    # N(mu, L L^T) with dense lower-triangular L


class ADVIResult(NamedTuple):
    mu: jax.Array          # (K, 3) variational mean
    log_sigma: jax.Array   # (K, 3) variational log sd
    elbo_trace: jax.Array  # (n_steps,)


_LOG_2PI_E = jnp.log(2.0 * jnp.pi) + 1.0


@partial(jax.jit, static_argnames=("grad_fn", "config"))
def fit_advi(
    key: jax.Array,
    grad_fn: Callable,   # theta -> (U, dU/dtheta), mask already bound
    mu0: jax.Array,      # (K, 3) initial mean
    mask: jax.Array,     # (K,)
    config: ADVIConfig = ADVIConfig(),
) -> ADVIResult:
    """Fit the mean-field family; returns variational params + ELBO trace."""
    mask3 = mask[..., None]
    log_sigma0 = jnp.full_like(mu0, config.log_sigma0)
    params = (mu0, log_sigma0)
    # cosine decay kills the MC-noise plateau of constant-lr Adam
    schedule = optax.cosine_decay_schedule(config.learning_rate, config.n_steps, 1e-2)
    opt = optax.adam(schedule)
    opt_state = opt.init(params)

    def neg_elbo_and_grad(params, key):
        mu, log_sigma = params
        sigma = jnp.exp(log_sigma)
        xis = jax.random.normal(key, (config.n_mc,) + mu.shape, mu.dtype)

        def one(xi):
            theta = mu + sigma * xi * mask3
            u, g = grad_fn(theta)
            # reparameterized grads: dU/dmu = g ; dU/dlog_sigma = g * sigma * xi
            return u, g, g * sigma * xi

        us, g_mu, g_ls = jax.vmap(one)(xis)
        # entropy of alive coords: sum log sigma + const
        ent = jnp.sum(mask3 * (log_sigma + 0.5 * _LOG_2PI_E))
        neg_elbo = jnp.mean(us) - ent
        grad_mu = jnp.mean(g_mu, 0) * mask3
        grad_ls = jnp.mean(g_ls, 0) * mask3 - mask3  # d(-H)/dlog_sigma = -1
        return neg_elbo, (grad_mu, grad_ls)

    def step(carry, key):
        params, opt_state = carry
        neg_elbo, grads = neg_elbo_and_grad(params, key)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return (params, opt_state), -neg_elbo

    keys = jax.random.split(key, config.n_steps)
    (params, _), elbos = jax.lax.scan(step, (params, opt_state), keys)
    mu, log_sigma = params
    return ADVIResult(mu, log_sigma, elbos)


def advi_sample(key: jax.Array, result: ADVIResult, mask: jax.Array, n: int) -> jax.Array:
    """Draw n samples from the fitted q, dead slots pinned at mu."""
    xi = jax.random.normal(key, (n,) + result.mu.shape, result.mu.dtype)
    return result.mu + jnp.exp(result.log_sigma) * xi * mask[..., None]


class FullRankADVIResult(NamedTuple):
    mu: jax.Array          # (K, 3)
    scale_tril: jax.Array  # (3K, 3K) lower-triangular L with positive diag
    elbo_trace: jax.Array


@partial(jax.jit, static_argnames=("grad_fn", "config"))
def fit_advi_fullrank(
    key: jax.Array,
    grad_fn: Callable,   # theta (K,3) -> (U, dU/dtheta)
    mu0: jax.Array,      # (K, 3)
    config: ADVIConfig = ADVIConfig(),
) -> FullRankADVIResult:
    """Full-rank Gaussian family q = N(mu, L L^T) over the flattened params.

    Captures the posterior correlations the mean-field family cannot
    (e.g. the x-flux degeneracy of a blended star).  All slots must be
    alive — the dense L couples coordinates, so masking is not supported;
    use the mean-field fit for trans-dimensional states.
    """
    d = mu0.size
    kshape = mu0.shape
    mu_flat0 = mu0.reshape(d)
    # L = tril(strictly lower) + diag(exp(log_diag))
    log_diag0 = jnp.full((d,), config.log_sigma0, mu0.dtype)
    lower0 = jnp.zeros((d, d), mu0.dtype)
    params = (mu_flat0, log_diag0, lower0)
    schedule = optax.cosine_decay_schedule(config.learning_rate, config.n_steps, 1e-2)
    opt = optax.adam(schedule)
    opt_state = opt.init(params)
    tril_mask = jnp.tril(jnp.ones((d, d), mu0.dtype), k=-1)

    def neg_elbo(params, key):
        mu, log_diag, lower = params
        l_mat = lower * tril_mask + jnp.diag(jnp.exp(log_diag))
        xis = jax.random.normal(key, (config.n_mc, d), mu.dtype)

        def one(xi):
            theta = (mu + jnp.matmul(l_mat, xi, precision="highest")).reshape(kshape)
            u, _ = grad_fn(theta)
            return u

        ent = jnp.sum(log_diag) + 0.5 * d * _LOG_2PI_E
        return jnp.mean(jax.vmap(one)(xis)) - ent

    grad_fn_elbo = jax.grad(neg_elbo)

    def step(carry, key):
        params, opt_state = carry
        g = grad_fn_elbo(params, key)
        updates, opt_state = opt.update(g, opt_state, params)
        params = optax.apply_updates(params, updates)
        return (params, opt_state), -neg_elbo(params, key)

    keys = jax.random.split(key, config.n_steps)
    (params, _), elbos = jax.lax.scan(step, (params, opt_state), keys)
    mu, log_diag, lower = params
    l_mat = lower * tril_mask + jnp.diag(jnp.exp(log_diag))
    return FullRankADVIResult(mu.reshape(kshape), l_mat, elbos)


def advi_sample_fullrank(
    key: jax.Array, result: FullRankADVIResult, n: int
) -> jax.Array:
    kshape = result.mu.shape
    d = result.mu.size
    xi = jax.random.normal(key, (n, d), result.mu.dtype)
    scaled = jnp.matmul(xi, result.scale_tril.T, precision="highest")
    return (result.mu.reshape(d) + scaled).reshape((n,) + kshape)
