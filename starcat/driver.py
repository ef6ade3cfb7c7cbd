"""Shared warmup/sampling driver for all MCMC heads (SURVEY.md ⑦⑨⑩⑫).

A *kernel* is a callable ``kernel(state, eps, inv_mass) -> (state, info)``
for ONE chain, where ``info`` exposes ``accept_prob`` and ``diverged``.
The driver vmaps it over the chain axis, runs the three-phase pooled warmup
(dual averaging + Welford mass, adapt.py) and the sampling loop as
``lax.scan`` bodies inside ``jit`` — one host→device round-trip per phase
(SURVEY.md §3.3).  Chain-axis reductions pool adaptation statistics; under a
sharded chain axis XLA lowers them to psum collectives (SURVEY.md §5.8).
"""
from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from .adapt import (
    da_init,
    da_restart,
    da_update,
    welford_init,
    welford_update_batch,
    welford_variance,
)


class ChainState(NamedTuple):
    theta: jax.Array  # (K, 3) unconstrained params
    u: jax.Array      # potential at theta
    grad: jax.Array   # dU/dtheta
    key: jax.Array    # per-chain PRNG key


def init_chain_states(key: jax.Array, theta0: jax.Array, grad_fn: Callable) -> ChainState:
    """Vectorized init over the chain axis: theta0 is (n_chains, K, 3)."""
    keys = jax.random.split(key, theta0.shape[0])

    def one(k, t):
        u, g = grad_fn(t)
        return ChainState(t, u, g, k)

    return jax.vmap(one)(keys, theta0)


def _batched(kernel: Callable) -> Callable:
    """Kernels are single-chain by default and vmapped over the chain axis;
    a kernel marked ``is_batched`` (e.g. the Pallas fused-leapfrog HMC
    kernel, which tiles chains onto the VPU lanes itself) is used as-is."""
    if getattr(kernel, "is_batched", False):
        return kernel
    return jax.vmap(kernel, in_axes=(0, None, None))


def _bad_frac(info):
    """Pooled fraction of failed transitions (Delta-H divergences plus, for
    the Riemannian kernels, solver force-rejections) — the statistic the
    divergence-penalized dual averaging subtracts (VERDICT round-3 item 5)."""
    bad = info.diverged
    sf = getattr(info, "solver_fail", None)
    if sf is not None:
        bad = bad | sf
    return jnp.mean(bad.astype(jnp.float32))


class WarmupResult(NamedTuple):
    states: ChainState
    step_size: jax.Array
    inv_mass: jax.Array
    # per-phase observability (SURVEY.md §5.5): mean acceptance and the
    # dual-averaged eps at the end of each of the three warmup phases
    # (None on checkpoint-resume paths, which skip warmup)
    phase_accept: jax.Array | None = None
    phase_eps: jax.Array | None = None


def warmup(
    states: ChainState,
    kernel: Callable,
    n_warmup: int,
    step_size: float = 0.1,
    target_accept: float = 0.8,
    adapt_mass: bool = True,
    divergence_penalty: float = 0.0,
) -> WarmupResult:
    """Three-phase pooled warmup (15% eps / 60% eps+mass / 25% eps).

    divergence_penalty > 0 makes dual averaging divergence-aware (VERDICT
    round-3 item 5): the pooled statistic becomes mean(accept_prob) -
    penalty * frac(diverged | solver_fail), so eps settles where failures
    are rare - at equilibrium frac <= (1 - target_accept) / penalty -
    instead of failures hiding inside ordinary MH rejections.

    Thin wrapper over warmup_blocked with one program per phase; run_mcmc
    uses smaller blocks where runtime.max_program_steps sets a cap.
    """
    return warmup_blocked(
        states, kernel, n_warmup, step_size=step_size,
        target_accept=target_accept, adapt_mass=adapt_mass,
        divergence_penalty=divergence_penalty, block=max(n_warmup, 1),
    )


@partial(jax.jit, static_argnames=("kernel", "n_steps", "accumulate"))
def _warmup_chunk(
    states: ChainState,
    kernel: Callable,
    da,
    wf,
    inv_mass: jax.Array,
    acc: jax.Array,
    n_steps: int,
    accumulate: bool,
    target_accept,
    divergence_penalty,
):
    """n_steps warmup transitions as one device program (see warmup_blocked)."""
    batch_kernel = _batched(kernel)

    def body(carry, _):
        st, da, wf, acc = carry
        st, info = batch_kernel(st, jnp.exp(da.log_eps), inv_mass)
        a = jnp.mean(info.accept_prob)
        da = da_update(da, a - divergence_penalty * _bad_frac(info),
                       target=target_accept)
        if accumulate:
            wf = welford_update_batch(wf, st.theta)
        return (st, da, wf, acc + a), None

    (st, da, wf, acc), _ = jax.lax.scan(
        body, (states, da, wf, acc), None, length=n_steps
    )
    return st, da, wf, acc


def warmup_blocked(
    states: ChainState,
    kernel: Callable,
    n_warmup: int,
    step_size: float = 0.1,
    target_accept: float = 0.8,
    adapt_mass: bool = True,
    divergence_penalty: float = 0.0,
    block: int = 100,
) -> WarmupResult:
    """warmup() with each phase split into <= block-step jit programs.

    Bitwise-identical to warmup() — a scan split at chunk boundaries runs
    the same op sequence (tested) — but every device program stays small.
    The one-program warmup scan is the largest program in every MCMC head;
    run_mcmc routes warmup through this with block = the program-step cap
    (runtime.max_program_steps), mirroring run_smc's stepwise routing.
    """
    import math

    n1 = max(n_warmup * 15 // 100, 1)
    n3 = max(n_warmup * 25 // 100, 1)
    n2 = max(n_warmup - n1 - n3, 1)
    param_shape = states.theta.shape[1:]

    def run_phase(st, da, wf, inv_mass, n, accumulate):
        acc = jnp.zeros(())
        nb = max(1, math.ceil(n / block))
        # chunk sizes differ by at most 1 -> at most TWO compiled program
        # sizes per phase (q and q+1; e.g. n=57, block=10 -> 10,10,10,9,9,9)
        q, r = divmod(n, nb)
        for k in [q + 1] * r + [q] * (nb - r):
            st, da, wf, acc = _warmup_chunk(
                st, kernel, da, wf, inv_mass, acc, k, accumulate,
                target_accept, divergence_penalty,
            )
        return st, da, wf, acc / n

    da = da_init(step_size)
    wf = welford_init(param_shape)
    inv_mass = jnp.ones(param_shape, jnp.float32)

    st, da, wf, a1 = run_phase(states, da, wf, inv_mass, n1, False)
    e1 = jnp.exp(da.log_eps)
    st, da, wf, a2 = run_phase(st, da, wf, inv_mass, n2, adapt_mass)
    e2 = jnp.exp(da.log_eps)
    if adapt_mass:
        inv_mass = welford_variance(wf)
        da = da_restart(da)
    st, da, wf, a3 = run_phase(st, da, wf, inv_mass, n3, False)
    e3 = jnp.exp(da.log_eps)
    return WarmupResult(st, jnp.exp(da.log_eps_bar), inv_mass,
                        jnp.stack([a1, a2, a3]), jnp.stack([e1, e2, e3]))


class SampleResult(NamedTuple):
    thetas: jax.Array        # (n_chains, n_samples, K, 3)
    accept_prob: jax.Array   # (n_chains, n_samples)
    diverged: jax.Array      # (n_chains, n_samples)
    final_states: ChainState
    # fixed-point-solver force-rejections (RHMC heads only; None for
    # kernels whose info has no solver_fail) — reported separately from
    # Delta-H divergences (VERDICT round-3 item 5)
    solver_fail: jax.Array | None = None


@partial(jax.jit, static_argnames=("kernel", "n_samples", "thin"))
def sample(
    states: ChainState,
    kernel: Callable,
    n_samples: int,
    step_size: jax.Array,
    inv_mass: jax.Array,
    thin: int = 1,
) -> SampleResult:
    """Post-warmup sampling at fixed eps/mass; draws collected on-device.

    thin: record every thin-th transition — n_samples draws are RECORDED,
    n_samples * thin transitions run.  Keeps device/host draw buffers small
    on long runs (SURVEY.md §5.4 "long multi-host runs"); accept/diverged
    diagnostics are those of the last transition per record.
    """
    batch_kernel = _batched(kernel)
    seen_sf = {}  # populated at trace time: does this kernel's info carry it?

    def _sf(info):
        # kernels without solver accounting report a zeros placeholder so
        # the scan carry keeps a fixed structure; sample() drops it again
        seen_sf["v"] = hasattr(info, "solver_fail")
        return (info.solver_fail if seen_sf["v"]
                else jnp.zeros_like(info.diverged))

    def body(st, _):
        st, info = batch_kernel(st, step_size, inv_mass)
        if thin > 1:
            def sub(_, carry):
                st, _, _, _ = carry
                st, info = batch_kernel(st, step_size, inv_mass)
                return st, info.accept_prob, info.diverged, _sf(info)

            st, ap, dv, sf = jax.lax.fori_loop(
                1, thin, sub,
                (st, info.accept_prob, info.diverged, _sf(info))
            )
        else:
            ap, dv, sf = info.accept_prob, info.diverged, _sf(info)
        return st, (st.theta, ap, dv, sf)

    st, (thetas, aprob, div, sfail) = jax.lax.scan(
        body, states, None, length=n_samples
    )
    return SampleResult(jnp.moveaxis(thetas, 0, 1), aprob.T, div.T, st,
                        sfail.T if seen_sf.get("v") else None)


class BlockCheckpoint(NamedTuple):
    """Checkpoint payload written after every sampling block (SURVEY.md
    §5.4): chain states (incl. per-chain PRNG keys), completed-draw count and
    the fixed post-warmup kernel parameters — everything a replacement
    process needs to continue without re-warming (SURVEY.md §5.3
    checkpoint-restart recovery)."""

    states: ChainState
    done: jax.Array       # () int32 — draws completed
    step_size: jax.Array  # ()
    inv_mass: jax.Array   # param-shaped


def checkpoint_like(states: ChainState) -> BlockCheckpoint:
    """Structure donor for restore_state on a BlockCheckpoint."""
    return BlockCheckpoint(
        states, jnp.zeros((), jnp.int32), jnp.zeros(()),
        jnp.ones(states.theta.shape[1:]),
    )


def sample_blocked(
    states: ChainState,
    kernel: Callable,
    n_samples: int,
    step_size: jax.Array,
    inv_mass: jax.Array,
    block_size: int = 250,
    checkpoint_path: str | None = None,
    start_done: int = 0,
    logger=None,
    thin: int = 1,
) -> SampleResult:
    """Sampling in fixed-size jit blocks with optional checkpoints.

    Bitwise-identical to one big sample() call (per-chain PRNG keys live in
    ChainState, so continuation is deterministic — tested), but each device
    program stays small and a crash loses at most one block: the pattern for
    long production runs (SURVEY.md §5.4) and for environments where very
    long single programs are fragile.

    start_done: draws already completed by a previous (crashed) process —
    this call produces only the remaining n_samples - start_done draws
    (fault recovery, SURVEY.md §5.3; see run_mcmc(resume=True)).
    """
    import math

    import numpy as np

    # uniform block sizes -> a single compiled sampling program is reused
    # for every block (a trailing remainder block would recompile)
    n_blocks = max(1, math.ceil(n_samples / block_size))
    block_size = math.ceil(n_samples / n_blocks)

    blocks = []
    aprobs = []
    divs = []
    sfails = []
    done = start_done
    while done < n_samples:
        n = min(block_size, n_samples - done)
        res = sample(states, kernel, n, step_size, inv_mass, thin=thin)
        states = res.final_states
        blocks.append(np.asarray(res.thetas))
        aprobs.append(np.asarray(res.accept_prob))
        divs.append(np.asarray(res.diverged))
        if res.solver_fail is not None:
            sfails.append(np.asarray(res.solver_fail))
        done += n
        if logger is not None:  # per-block observability (SURVEY.md §5.5)
            extra = ({"solver_rejections": int(sfails[-1].sum())}
                     if sfails else {})
            logger.log("sampling_block", done=done, n_total=n_samples,
                       accept=float(aprobs[-1].mean()),
                       divergences=int(divs[-1].sum()), **extra)
        if checkpoint_path is not None:
            from .checkpoint import save_state

            save_state(checkpoint_path, BlockCheckpoint(
                states, jnp.asarray(done, jnp.int32),
                jnp.asarray(step_size, jnp.float32), jnp.asarray(inv_mass),
            ))
    if not blocks:  # resume found the run already complete
        c = states.theta.shape[0]
        return SampleResult(
            jnp.zeros((c, 0) + states.theta.shape[1:]),
            jnp.zeros((c, 0)), jnp.zeros((c, 0), bool), states,
        )
    return SampleResult(
        jnp.concatenate([jnp.asarray(b) for b in blocks], axis=1),
        jnp.concatenate([jnp.asarray(a) for a in aprobs], axis=1),
        jnp.concatenate([jnp.asarray(d) for d in divs], axis=1),
        states,
        (jnp.concatenate([jnp.asarray(s) for s in sfails], axis=1)
         if sfails else None),
    )


def run_mcmc(
    key: jax.Array,
    kernel: Callable,
    grad_fn: Callable,
    theta0: jax.Array,
    n_samples: int,
    n_warmup: int,
    step_size: float = 0.1,
    target_accept: float = 0.8,
    adapt_mass: bool = True,
    block_size: int | None = None,
    checkpoint_path: str | None = None,
    resume: bool = False,
    logger=None,
    thin: int = 1,
    divergence_penalty: float = 0.0,
):
    """init -> warmup -> sample; returns (SampleResult, WarmupResult).

    block_size: if set, sample in blocks of this many draws (see
    sample_blocked) — recommended for long runs.

    resume: if True and checkpoint_path holds a BlockCheckpoint from a
    previous (crashed or preempted) run, skip warmup, restore chain states /
    step size / mass, and produce only the remaining draws — the
    checkpoint-restart recovery path of SURVEY.md §5.3 (tested by
    tests/test_fault_recovery.py).  Continuation is bitwise-identical to an
    uninterrupted run on the same backend.
    """
    import os

    states = init_chain_states(key, theta0, grad_fn)
    if resume and checkpoint_path is not None and os.path.exists(checkpoint_path):
        from .checkpoint import restore_state

        ck = restore_state(checkpoint_path, checkpoint_like(states))
        wr = WarmupResult(ck.states, ck.step_size, ck.inv_mass)
        res = sample_blocked(
            ck.states, kernel, n_samples, ck.step_size, ck.inv_mass,
            block_size=block_size or 250, checkpoint_path=checkpoint_path,
            start_done=int(ck.done), logger=logger, thin=thin,
        )
        return res, wr
    # program-size cap (runtime.max_program_steps): small warmup chunks
    # where a cap is set; one program per phase where unlimited
    from .runtime import cap_block

    wr = warmup_blocked(
        states, kernel, n_warmup,
        step_size=step_size, target_accept=target_accept, adapt_mass=adapt_mass,
        divergence_penalty=divergence_penalty,
        block=cap_block(None, max(n_warmup, 1)),
    )
    if logger is not None:  # per-phase warmup observability (SURVEY.md §5.5)
        import numpy as np

        pa = np.asarray(wr.phase_accept)
        pe = np.asarray(wr.phase_eps)
        for i in range(3):
            logger.log("warmup_phase", phase=i + 1, accept=float(pa[i]),
                       step_size=float(pe[i]))
    if block_size is not None:
        res = sample_blocked(
            wr.states, kernel, n_samples, wr.step_size, wr.inv_mass,
            block_size=block_size, checkpoint_path=checkpoint_path,
            logger=logger, thin=thin,
        )
    else:
        res = sample(wr.states, kernel, n_samples, wr.step_size, wr.inv_mass,
                     thin=thin)
    return res, wr
