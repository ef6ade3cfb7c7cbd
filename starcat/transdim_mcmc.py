"""Trans-dimensional MCMC head (SURVEY.md §3.2 — the reference's own
sampler shape; §1.1 L4 "trans-dimensional birth/death ... layered on the
within-model sampler").

Each transition composes two reversible kernels targeting the SAME joint
distribution over (mask, theta) — the slot-symmetrized trans-d measure of
transdim.py:

  1. ``n_transdim_sweeps`` birth/death + split/merge sweeps (transdim.py),
     which change the per-chain alive mask;
  2. one within-model HMC or RHMC transition at the chain's CURRENT mask —
     dead slots are frozen (momenta zeroed, gradients masked), so the move
     is a valid fixed-dimension MH kernel conditional on the mask.

This is Metropolis-within-Gibbs: each component kernel preserves the joint
target, so the composition does.  Unlike the fixed-K heads (driver.py), the
mask lives in the chain state and varies per chain — which is why this head
carries its own warmup/sampling loops instead of driver.run_mcmc (the
shared driver assumes one static mask closed over by the kernel).

Device mapping: everything vmaps over chains with static (K_max,) shapes
(SURVEY.md §7.3 "trans-dimensionality under XLA's static shapes"); the
within-model HMC move can ride the fused GPU leapfrog kernel
(pallas_kernels.py), which accepts per-chain (C, K) masks.

The log-likelihood cache needed by the trans-d acceptance ratios is
refreshed for free after the within-model move: U = -(loglik + logprior)
and the within-model kernels keep U coherent, so loglik = -U - logprior
costs one O(K) prior evaluation, not a scene render.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .adapt import da_init, da_restart, da_update
from .driver import ChainState
from .hmc import hmc_step
from .metric import make_metric_fn
from .potential import (
    PriorSpec,
    log_likelihood,
    log_prior,
    make_potential,
    make_potential_and_grad,
    make_tempered_potential_and_grad,
    sample_prior,
)
from .rhmc import make_rhmc_functions, rhmc_step
from .scene import SceneSpec
from .transdim import TransDimConfig, transdim_sweep


class TransDimMCMCConfig(NamedTuple):
    step_size: float = 0.1
    # "hmc" | "rhmc" | "rhmc_diag" | "hmc_pallas" within-model move
    # (rhmc_diag: diagonal-Fisher Riemannian — metric.make_diag_metric_fn;
    # hmc_pallas: the fused GPU leapfrog kernel)
    mutation: str = "hmc"
    n_leapfrog: int = 10
    fixed_point_iters: int = 4
    n_transdim_sweeps: int = 2
    target_accept: float = 0.8
    divergence_threshold: float = 1000.0
    # Solver-failure handling for the Riemannian mutations (VERDICT round-3
    # item 5; see rhmc.RHMCConfig): residual-detected non-convergence is
    # force-rejected and reported separately, and warmup's dual averaging
    # subtracts divergence_penalty * failure fraction so eps settles where
    # failures are rare.
    solver_tol: float = 0.05
    divergence_penalty: float = 5.0
    transdim: TransDimConfig = TransDimConfig()


class TDState(NamedTuple):
    """Per-chain trans-dimensional sampler state.  The mask is STATE here —
    the fixed-K heads close over it (SURVEY.md ⑪ vs this head)."""

    theta: jax.Array   # (C, K, 3)
    mask: jax.Array    # (C, K) in {0., 1.}
    loglik: jax.Array  # (C,) untempered log-likelihood cache
    key: jax.Array     # (C,) PRNG keys


class TDInfo(NamedTuple):
    accept_prob: jax.Array  # (C,) within-model MH acceptance prob
    diverged: jax.Array     # (C,)
    td_accept: jax.Array    # (C,) mean trans-d acceptance over the sweeps
    n_alive: jax.Array      # (C,) star count after the transition
    solver_fail: jax.Array  # (C,) Riemannian fixed-point force-rejections


def init_td_states(
    key: jax.Array,
    spec: SceneSpec,
    image: jax.Array,
    prior: PriorSpec,
    kmax: int,
    n_chains: int,
    lam_count: float,
    beta: float = 1.0,
) -> TDState:
    """Prior-initialized chains: params from the prior, n ~ truncated
    Poisson(lam_count) with the first n slots alive (slot assignments are
    exchangeable under the 1/C(K, n) symmetrized target)."""
    k_theta, k_n, k_run = jax.random.split(key, 3)
    thetas = jax.vmap(lambda k: sample_prior(k, kmax, prior))(
        jax.random.split(k_theta, n_chains)
    )
    ks = jnp.arange(kmax + 1, dtype=jnp.float32)
    logpmf = ks * math.log(lam_count) - jax.scipy.special.gammaln(ks + 1.0)
    n_draw = jax.random.categorical(k_n, logpmf, shape=(n_chains,))
    masks = (jnp.arange(kmax)[None, :] < n_draw[:, None]).astype(jnp.float32)
    loglik = beta * jax.vmap(
        lambda t, m: log_likelihood(t, m, spec, image)
    )(thetas, masks)
    return TDState(thetas, masks, loglik, jax.random.split(k_run, n_chains))


def make_transdim_kernel(
    spec: SceneSpec,
    image: jax.Array,
    prior: PriorSpec,
    cfg: TransDimMCMCConfig,
    interpret: bool = False,
    beta: float = 1.0,
):
    """Batched transition kernel: (TDState, eps) -> (TDState, TDInfo).

    beta tempers the likelihood (target = prior * L^beta); the TDState
    loglik cache then holds the TEMPERED log-likelihood.  beta=0 makes the
    composed kernel target the pure prior — the detailed-balance test of
    SURVEY.md §4.2 ("prior recovery with no data") for the WHOLE head, not
    just the moves.
    """
    if beta == 1.0:
        llf = lambda th, m: log_likelihood(th, m, spec, image)
        pg = make_potential_and_grad(spec, image, prior)
        pfn = make_potential(spec, image, prior)
    else:
        llf = lambda th, m: beta * log_likelihood(th, m, spec, image)
        tpg = make_tempered_potential_and_grad(spec, image, prior)
        pg = lambda th, m: tpg(th, m, beta)
        pfn = lambda th, m: tpg(th, m, beta)[0]
    lpf = lambda th, m: log_prior(th, m, prior)
    if cfg.mutation == "rhmc":
        metric = make_metric_fn(spec, prior)
        metric2 = lambda th, m: metric(th, m, beta)
        ham, dhdt, dhdp = make_rhmc_functions(pfn, metric2)
    if cfg.mutation == "rhmc_diag":
        from .metric import make_diag_metric_fn
        from .rhmc import make_rhmc_diag_functions

        metric2 = lambda th, m: make_diag_metric_fn(spec, prior)(th, m, beta)
        ham, dhdt, dhdp = make_rhmc_diag_functions(pfn, metric2)
    if cfg.mutation == "hmc_pallas" and beta != 1.0:
        # the fused trajectory kernel evaluates the beta=1 posterior
        raise ValueError("tempered trans-d MCMC: use hmc/rhmc/rhmc_diag")

    def kernel(state: TDState, eps: jax.Array) -> tuple[TDState, TDInfo]:
        keys = jax.vmap(lambda k: jax.random.split(k, 3))(state.key)
        key, k_td, k_wm = keys[:, 0], keys[:, 1], keys[:, 2]

        # -- 1. trans-dimensional sweeps (vmapped over chains) -------------
        theta, mask, ll = state.theta, state.mask, state.loglik
        if cfg.n_transdim_sweeps > 0:

            def td_body(carry, i):
                th, m, l = carry
                sweep_keys = jax.vmap(lambda k: jax.random.fold_in(k, i))(k_td)
                th, m, l, info = jax.vmap(
                    lambda kk, t, mm, lc: transdim_sweep(
                        kk, t, mm, lc, llf, prior, spec, cfg.transdim,
                        image=image,
                    )
                )(sweep_keys, th, m, l)
                return (th, m, l), info.accepted

            (theta, mask, ll), td_acc = jax.lax.scan(
                td_body, (theta, mask, ll), jnp.arange(cfg.n_transdim_sweeps)
            )
            td_accept = jnp.mean(td_acc.astype(jnp.float32), axis=0)
        else:
            td_accept = jnp.zeros(theta.shape[0])

        # -- 2. within-model move at the (new) per-chain mask ---------------
        lp = jax.vmap(lpf)(theta, mask)
        u = -(ll + lp)

        if cfg.mutation == "hmc":
            _, g = jax.vmap(pg)(theta, mask)
            sts = ChainState(theta, u, g, k_wm)
            sts, info = jax.vmap(
                lambda st, m: hmc_step(
                    st, lambda th: pg(th, m), eps, jnp.ones_like(st.theta),
                    cfg.n_leapfrog, m, cfg.divergence_threshold,
                )
            )(sts, mask)
        elif cfg.mutation == "hmc_pallas":
            from .hmc import HMCConfig, make_pallas_hmc_kernel

            _, g = jax.vmap(pg)(theta, mask)
            kern = make_pallas_hmc_kernel(
                spec, image, prior, mask,
                HMCConfig(n_leapfrog=cfg.n_leapfrog,
                          divergence_threshold=cfg.divergence_threshold),
                interpret=interpret,
            )
            sts, info = kern(ChainState(theta, u, g, k_wm), eps,
                             jnp.ones(theta.shape[1:]))
        elif cfg.mutation in ("rhmc", "rhmc_diag"):
            sts = ChainState(theta, u, jnp.zeros_like(theta), k_wm)
            sts, info = jax.vmap(
                lambda st, m: rhmc_step(
                    st, pfn, metric2, ham, dhdt, dhdp, eps,
                    cfg.n_leapfrog, cfg.fixed_point_iters, m,
                    cfg.divergence_threshold,
                    diag_metric=cfg.mutation == "rhmc_diag",
                    solver_tol=cfg.solver_tol,
                )
            )(sts, mask)
        else:
            raise ValueError(f"unknown mutation {cfg.mutation!r}")

        # -- 3. free loglik refresh: loglik = -U - logprior -----------------
        lp2 = jax.vmap(lpf)(sts.theta, mask)
        ll2 = -sts.u - lp2

        new = TDState(sts.theta, mask, ll2, key)
        sf = getattr(info, "solver_fail", None)
        if sf is None:  # HMC mutations have no implicit solver
            sf = jnp.zeros_like(info.diverged)
        return new, TDInfo(info.accept_prob, info.diverged, td_accept,
                           jnp.sum(mask, axis=-1), sf)

    return kernel


class TDSampleResult(NamedTuple):
    thetas: jax.Array       # (C, N, K, 3)
    masks: jax.Array        # (C, N, K) bool
    accept_prob: jax.Array  # (C, N)
    diverged: jax.Array     # (C, N)
    td_accept: jax.Array    # (C, N)
    solver_fail: jax.Array  # (C, N) Riemannian solver force-rejections
    final_state: TDState


def _warmup_jit(states, kernel, n_warmup, step_size, target_accept,
                divergence_penalty=0.0):
    """Dual-averaging step-size warmup (no mass matrix: the mask varies per
    chain, so pooled Welford over dead slots would be meaningless; RHMC's
    Fisher metric plays that role, and the HMC move uses unit mass).

    divergence_penalty: as driver.warmup — subtracted times the pooled
    (diverged | solver_fail) fraction so eps learns about solver failures
    (VERDICT round-3 item 5)."""

    def body(carry, _):
        st, da = carry
        st, info = kernel(st, jnp.exp(da.log_eps))
        acc = jnp.mean(info.accept_prob)
        bad = jnp.mean((info.diverged | info.solver_fail).astype(jnp.float32))
        da = da_update(da, acc - divergence_penalty * bad,
                       target=target_accept)
        # per-iteration pooled diagnostics (tiny: 4 scalars x n_warmup) so
        # the driver can emit per-window warmup records like driver.warmup
        # (SURVEY.md §5.5; VERDICT round-2 Weak #7: dual-averaging
        # pathologies during the mask-varying warmup were invisible)
        rec = (acc, jnp.mean(info.td_accept),
               jnp.mean(jnp.sum(st.mask, axis=-1)), jnp.exp(da.log_eps))
        return (st, da), rec

    (st, da), recs = jax.lax.scan(body, (states, da_init(step_size)), None,
                                  length=n_warmup)
    return st, jnp.exp(da.log_eps_bar), recs


def _sample_jit(states, kernel, n_samples, eps):
    def body(st, _):
        st, info = kernel(st, eps)
        return st, (st.theta, st.mask > 0.5, info.accept_prob, info.diverged,
                    info.td_accept, info.solver_fail)

    st, (thetas, masks, aprob, div, td, sf) = jax.lax.scan(
        body, states, None, length=n_samples
    )
    return TDSampleResult(
        jnp.moveaxis(thetas, 0, 1), jnp.moveaxis(masks, 0, 1),
        aprob.T, div.T, td.T, sf.T, st,
    )


class TDBlockCheckpoint(NamedTuple):
    """Block-checkpoint payload for the trans-d head (SURVEY.md §5.4)."""

    state: TDState
    done: jax.Array       # () int32
    step_size: jax.Array  # ()


def run_transdim(
    key: jax.Array,
    spec: SceneSpec,
    image: jax.Array,
    prior: PriorSpec,
    kmax: int,
    n_chains: int,
    n_samples: int,
    n_warmup: int,
    cfg: TransDimMCMCConfig = TransDimMCMCConfig(),
    block_size: int | None = None,
    checkpoint_path: str | None = None,
    resume: bool = False,
    logger=None,
    mesh=None,
):
    """init -> warmup -> (blocked) sampling for the trans-d MCMC chain.

    mesh: shard the chain axis of the TDState over a device mesh — the
    vmapped trans-d sweeps and XLA within-model moves partition under
    GSPMD (chains are embarrassingly parallel; only the pooled
    dual-averaging acceptance mean reduces across devices).

    Mirrors driver.run_mcmc's contract: returns (TDSampleResult, step_size).
    With checkpoint_path, every block writes a TDBlockCheckpoint; with
    resume=True a crashed run continues from its last completed block
    (continuation is deterministic — per-chain keys live in TDState).
    """
    import os

    import numpy as np

    warm = jax.jit(_warmup_jit, static_argnames=("kernel", "n_warmup"))
    samp = jax.jit(_sample_jit, static_argnames=("kernel", "n_samples"))
    kernel = make_transdim_kernel(spec, image, prior, cfg)

    states = init_td_states(
        key, spec, image, prior, kmax, n_chains, cfg.transdim.lam_count
    )
    if mesh is not None:
        from .dist import shard_chains

        states = shard_chains(states, mesh)
    start_done = 0
    if resume and checkpoint_path is not None and os.path.exists(checkpoint_path):
        from .checkpoint import restore_state

        like = TDBlockCheckpoint(states, jnp.zeros((), jnp.int32), jnp.zeros(()))
        ck = restore_state(checkpoint_path, like)
        states, eps, start_done = ck.state, ck.step_size, int(ck.done)
    else:
        states, eps, wrec = warm(states, kernel, n_warmup, cfg.step_size,
                                 cfg.target_accept,
                                 cfg.divergence_penalty)
        if logger is not None:
            acc, tda, mean_n, eps_tr = (np.asarray(r) for r in wrec)
            n_win = min(4, n_warmup)
            for i in range(n_win):
                lo = i * n_warmup // n_win
                hi = (i + 1) * n_warmup // n_win
                logger.log(
                    "warmup_window", head="transdim", window=i,
                    accept=float(acc[lo:hi].mean()),
                    td_accept=float(tda[lo:hi].mean()),
                    mean_n=float(mean_n[lo:hi].mean()),
                    step_size=float(eps_tr[hi - 1]),
                )
            logger.log("warmup_complete", head="transdim",
                       step_size=float(eps), n_warmup=n_warmup)

    if block_size is None:
        res = samp(states, kernel, n_samples, eps)
        return res, eps

    n_blocks = max(1, math.ceil(n_samples / block_size))
    block_size = math.ceil(n_samples / n_blocks)
    parts = []
    done = start_done
    while done < n_samples:
        n = min(block_size, n_samples - done)
        res = samp(states, kernel, n, eps)
        states = res.final_state
        parts.append(jax.tree.map(np.asarray, res._replace(final_state=None)))
        done += n
        if logger is not None:
            logger.log("sampling_block", head="transdim", done=done,
                       accept=float(np.asarray(res.accept_prob).mean()),
                       td_accept=float(np.asarray(res.td_accept).mean()),
                       mean_n=float(np.asarray(res.masks).sum(-1).mean()))
        if checkpoint_path is not None:
            from .checkpoint import save_state

            save_state(checkpoint_path, TDBlockCheckpoint(
                states, jnp.asarray(done, jnp.int32),
                jnp.asarray(eps, jnp.float32),
            ))
    if not parts:  # resume found the run complete
        c, k = states.theta.shape[0], states.theta.shape[1]
        return TDSampleResult(
            jnp.zeros((c, 0, k, 3)), jnp.zeros((c, 0, k), bool),
            jnp.zeros((c, 0)), jnp.zeros((c, 0), bool), jnp.zeros((c, 0)),
            jnp.zeros((c, 0), bool), states,
        ), eps
    cat = lambda xs: jnp.concatenate([jnp.asarray(x) for x in xs], axis=1)
    return TDSampleResult(
        cat([p.thetas for p in parts]), cat([p.masks for p in parts]),
        cat([p.accept_prob for p in parts]), cat([p.diverged for p in parts]),
        cat([p.td_accept for p in parts]), cat([p.solver_fail for p in parts]),
        states,
    ), eps
