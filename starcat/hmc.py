"""HMC head (SURVEY.md ⑦⑫): single-chain kernel, vmapped by driver.py.

See driver.py for the warmup/sampling loop structure and SURVEY.md §3.3 for
the target call stack.  The kernel adds ±20% per-transition step-size
jitter: without it, fixed-length trajectories on the mass-adapted (nearly
isotropic) posterior are near-periodic and R-hat stalls ~1.2 even at
accept ~0.9 (observed on the single-star scene; jitter restores near-iid
draws).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from .driver import ChainState, init_chain_states, run_mcmc
from .integrators import leapfrog


class HMCConfig(NamedTuple):
    step_size: float = 0.1
    n_leapfrog: int = 20
    target_accept: float = 0.8
    divergence_threshold: float = 1000.0


class StepInfo(NamedTuple):
    accept_prob: jax.Array
    accepted: jax.Array
    diverged: jax.Array
    energy_error: jax.Array


def init_chain_state(key: jax.Array, theta0: jax.Array, grad_fn: Callable) -> ChainState:
    u, g = grad_fn(theta0)
    return ChainState(theta0, u, g, key)


def hmc_step(
    state: ChainState,
    grad_fn: Callable,
    eps: jax.Array,
    inv_mass: jax.Array,
    n_leapfrog: int,
    mask: jax.Array,
    divergence_threshold: float = 1000.0,
):
    """One HMC transition for a single chain.

    ``mask`` freezes dead catalog slots: their momentum is zeroed so masked
    coordinates never move (SURVEY.md §7.3); ``grad_fn`` must already mask
    its gradient (potential.make_potential_and_grad does).
    """
    key, k_mom, k_acc, k_jit = jax.random.split(state.key, 4)
    mask3 = mask[..., None]

    # Step-size jitter breaks trajectory resonance (see module docstring).
    eps = eps * (0.8 + 0.4 * jax.random.uniform(k_jit))

    p0 = jax.random.normal(k_mom, state.theta.shape, state.theta.dtype)
    p0 = p0 / jnp.sqrt(inv_mass) * mask3
    h0 = state.u + 0.5 * jnp.sum(inv_mass * p0 * p0)

    res = leapfrog(
        grad_fn, state.theta, p0, state.u, state.grad, eps, n_leapfrog, inv_mass
    )
    h1 = res.u + 0.5 * jnp.sum(inv_mass * res.p * res.p)
    energy_error = h1 - h0
    # NaN-safe: divergent / non-finite trajectories are rejected, not propagated.
    energy_error = jnp.where(jnp.isfinite(energy_error), energy_error, jnp.inf)
    accept_prob = jnp.exp(jnp.minimum(0.0, -energy_error))
    diverged = energy_error > divergence_threshold

    accept = jax.random.uniform(k_acc) < accept_prob
    theta = jnp.where(accept, res.theta, state.theta)
    u = jnp.where(accept, res.u, state.u)
    grad = jnp.where(accept, res.grad, state.grad)

    return ChainState(theta, u, grad, key), StepInfo(
        accept_prob, accept, diverged, energy_error
    )


def make_hmc_kernel(grad_fn: Callable, mask: jax.Array, config: HMCConfig = HMCConfig()):
    """Kernel factory with the driver.py signature (state, eps, inv_mass)."""

    def kernel(state, eps, inv_mass):
        return hmc_step(
            state, grad_fn, eps, inv_mass, config.n_leapfrog, mask,
            config.divergence_threshold,
        )

    return kernel


def make_pallas_hmc_kernel(
    spec,
    image,
    prior,
    mask: jax.Array,
    config: HMCConfig = HMCConfig(),
    interpret: bool = False,
    mesh=None,
):
    """Batched HMC kernel on the fused GPU leapfrog (pallas_kernels.py).

    The whole L-step trajectory for every chain runs inside one kernel
    launch; momentum refresh and MH accept stay in XLA.  Any chain count
    works (the kernel pads to its chain block).

    With ``mesh`` (1-D chain mesh, dist.make_mesh) the pallas_call is
    wrapped in shard_map over the chain axis so multi-device runs keep the
    fused kernel per shard — pallas_call itself has no GSPMD partitioning
    rule.  The surrounding momentum refresh / MH accept math is plain XLA
    and partitions under GSPMD as usual.

    mask may be shared (K,) or per-chain (C, K) — the trans-d MCMC head
    (transdim_mcmc.py) rides this kernel with per-chain alive masks.
    """
    from .pallas_kernels import make_pallas_leapfrog

    kmax = int(mask.shape[-1])
    fused = make_pallas_leapfrog(spec, image, prior, kmax, interpret=interpret)
    n_steps = config.n_leapfrog
    fused_call = lambda th, pp, e, im, m, g: fused(th, pp, e, im, m, n_steps, g)
    if mesh is not None:
        from jax.sharding import PartitionSpec as PSpec

        ax = mesh.axis_names[0]
        mask_sp = PSpec(ax) if mask.ndim == 2 else PSpec()
        fused_call = jax.shard_map(
            fused_call, mesh=mesh,
            in_specs=(PSpec(ax), PSpec(ax), PSpec(ax), PSpec(), mask_sp,
                      PSpec(ax)),
            out_specs=(PSpec(ax), PSpec(ax), PSpec(ax), PSpec(ax)),
            # pallas_call's out_shape carries no varying-mesh-axes info, so
            # the vma check cannot see through it
            check_vma=False,
        )
    mask3 = mask[..., None]

    def kernel(states: ChainState, eps, inv_mass):
        n_chains = states.theta.shape[0]
        keys = jax.vmap(lambda k: jax.random.split(k, 4))(states.key)
        key, k_mom, k_acc, k_jit = keys[:, 0], keys[:, 1], keys[:, 2], keys[:, 3]

        eps_c = eps * (0.8 + 0.4 * jax.vmap(jax.random.uniform)(k_jit))  # (C,)

        p0 = jax.vmap(
            lambda k, t: jax.random.normal(k, t.shape, t.dtype)
        )(k_mom, states.theta)
        p0 = p0 / jnp.sqrt(inv_mass) * mask3
        h0 = states.u + 0.5 * jnp.sum(inv_mass * p0 * p0, axis=(1, 2))

        theta_new, p_new, u_new, grad_new = fused_call(
            states.theta, p0, eps_c, inv_mass, mask, states.grad
        )
        h1 = u_new + 0.5 * jnp.sum(inv_mass * p_new * p_new, axis=(1, 2))
        energy_error = jnp.where(jnp.isfinite(h1 - h0), h1 - h0, jnp.inf)
        accept_prob = jnp.exp(jnp.minimum(0.0, -energy_error))
        diverged = energy_error > config.divergence_threshold

        accept = jax.vmap(jax.random.uniform)(k_acc) < accept_prob
        acc3 = accept[:, None, None]
        theta = jnp.where(acc3, theta_new, states.theta)
        u = jnp.where(accept, u_new, states.u)
        grad = jnp.where(acc3, grad_new, states.grad)

        return ChainState(theta, u, grad, key), StepInfo(
            accept_prob, accept, diverged, energy_error
        )

    kernel.is_batched = True
    return kernel


def run_hmc(
    key: jax.Array,
    grad_fn: Callable,
    theta0: jax.Array,  # (n_chains, K, 3)
    mask: jax.Array,    # (K,)
    n_samples: int,
    n_warmup: int,
    config: HMCConfig = HMCConfig(),
    adapt_mass: bool = True,
    block_size: int | None = None,
    checkpoint_path: str | None = None,
    resume: bool = False,
    logger=None,
    thin: int = 1,
):
    """Convenience driver: init -> warmup -> sample (SURVEY.md §3.3)."""
    kernel = make_hmc_kernel(grad_fn, mask, config)
    return run_mcmc(
        key, kernel, grad_fn, theta0, n_samples, n_warmup,
        step_size=config.step_size, target_accept=config.target_accept,
        adapt_mass=adapt_mass, block_size=block_size,
        checkpoint_path=checkpoint_path, resume=resume, logger=logger,
        thin=thin,
    )


def run_hmc_pallas(
    key: jax.Array,
    spec,
    image,
    prior,
    theta0: jax.Array,  # (n_chains, K, 3)
    mask: jax.Array,
    n_samples: int,
    n_warmup: int,
    config: HMCConfig = HMCConfig(),
    adapt_mass: bool = True,
    interpret: bool = False,
    block_size: int | None = None,
    checkpoint_path: str | None = None,
    resume: bool = False,
    logger=None,
    thin: int = 1,
    mesh=None,
):
    """run_hmc on the fused GPU trajectory kernel (performance path).

    Pass ``mesh`` (with theta0 sharded over its chain axis, see
    dist.shard_chains) for multi-device runs — the fused kernel then runs
    per-shard under shard_map.
    """
    from .potential import make_potential_and_grad

    pg = make_potential_and_grad(spec, image, prior)
    grad_fn = lambda th: pg(th, mask)
    kernel = make_pallas_hmc_kernel(
        spec, image, prior, mask, config, interpret, mesh=mesh
    )
    return run_mcmc(
        key, kernel, grad_fn, theta0, n_samples, n_warmup,
        step_size=config.step_size, target_accept=config.target_accept,
        adapt_mass=adapt_mass, block_size=block_size,
        checkpoint_path=checkpoint_path, resume=resume, logger=logger,
        thin=thin,
    )
