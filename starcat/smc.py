"""Likelihood-tempered SMC head (SURVEY.md ⑬; BASELINE.json:10-11,
configs 3-4): adaptive tempering, systematic resampling, RHMC/HMC mutation,
optional trans-dimensional moves — one global jit program whose particle
axis shards over a device mesh (dist.py).

Per temperature step (SURVEY.md §3.4 call stack):
  1. adaptive Delta-beta by bisection so the incremental ESS hits
     ess_target_frac * P (26 fixed bisection sweeps, on-device);
  2. reweight: logw += Delta-beta * loglik; logZ += logmeanexp(incr);
  3. systematic resampling: the cumulative-weight inversion is computed
     from the GLOBAL weight vector (a logsumexp + cumsum — XLA lowers these
     to psum-style collectives under sharding) and the particle gather
     theta[idx] becomes the cross-device all-to-all; every device computes
     the identical plan from the same folded key (SURVEY.md §7.3
     "distributed resampling determinism");
  4. mutation at the new temperature: n_mutation_steps of RHMC (tempered
     Fisher metric) or HMC, plus n_transdim_sweeps birth/death/split-merge
     sweeps; step size follows a Robbins-Monro acceptance controller.

Communication per step is one scalar reduction + one P-float logsumexp +
the resampling gather — tiny by design; this is why >=95% scaling
efficiency 1->8 hosts is reachable (SURVEY.md §5.8).
"""
from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from .driver import ChainState
from .hmc import hmc_step
from .metric import make_metric_fn
from .potential import (
    PriorSpec,
    log_likelihood,
    make_tempered_potential_and_grad,
    sample_prior,
)
from .rhmc import make_rhmc_functions, rhmc_step
from .scene import SceneSpec
from .transdim import TransDimConfig, transdim_sweep


class SMCConfig(NamedTuple):
    n_particles: int = 1024
    ess_target_frac: float = 0.5
    max_steps: int = 60
    # "rhmc"        — XLA generalized leapfrog (autodiff metric derivative)
    # "rhmc_diag"   — generalized leapfrog on the DIAGONAL Fisher metric
    #                 (metric.make_diag_metric_fn): still position-dependent
    #                 and exact-MH, but O(3K*P) per metric eval with no
    #                 Cholesky — the cheap Riemannian mutation for
    #                 crowded-field scenes (config 4) where the full
    #                 (3K,P)@(P,3K) contraction dominates the step.
    # "hmc"         — plain leapfrog, unit mass
    mutation: str = "rhmc"   # "rhmc" | "rhmc_diag" | "hmc"
    n_mutation_steps: int = 2
    n_leapfrog: int = 8
    fixed_point_iters: int = 4
    n_transdim_sweeps: int = 0         # > 0 enables trans-dimensional moves
    # Dimension-preserving relocate sweeps per temperature step (round 5):
    # each sweep gives every particle one transdim.relocate_step attempt
    # (death + data-driven residual birth fused into one exact MH move,
    # mixture proposal over debiased matched-filter maps).  A NEW move
    # class for the crowded-field diversity problem: the round-4 study
    # measured population flux ESS flat (~10-15) across 16x trajectory
    # length and 4x trans-d churn — relocation hops star/flux
    # CONFIGURATIONS within a lineage, which neither within-model
    # trajectories nor birth/death churn at equilibrium K do efficiently.
    # Costs one tempered-loglik eval + matched-filter maps per particle
    # per sweep.  0 disables (the default): measured on the cfg4 failing
    # islands point (16x256, 300 rounds), 2/6 sweeps left between-island
    # R-hat at 1.59/1.47 vs the 1.56 baseline at +35% wall — the P=4096
    # spread is between-island ANCESTRAL variance, which per-lineage
    # configuration hops do not reduce (the measured lever is total
    # population, round 5).  The knob stays for scenes
    # where per-lineage configuration mixing IS the limiter (it is
    # posterior-preserving by construction and tested).
    n_relocate_sweeps: int = 0
    relocate_flux_sigma: float = 0.1
    relocate_pos_sigma: float = 0.12
    # extra mutation+trans-d rounds AFTER beta reaches 1 (the tempering
    # loop otherwise stops the moment it lands on the posterior; crowded
    # fields keep finding faint stars for several more rounds — measured
    # on cfg4).  At beta=1 the reweight is a no-op (d-beta = 0, equal
    # weights), so these are pure posterior MCMC rounds.
    n_final_rounds: int = 0
    # Plateau-based stopping of the posterior rounds (VERDICT round-3 item
    # 1: the shipped preset must converge out of the box).  When
    # plateau_window > 0 the final rounds run in the stepwise host loop
    # until the windowed mean star count stabilizes — stop when
    # |mean_n(last W rounds) - mean_n(previous W rounds)| < plateau_tol
    # (first checked after 2 W rounds), capped at max_final_rounds — and
    # n_final_rounds is ignored.  Measured basis: the cfg4 star-count
    # budget curve climbs monotonically and saturates ON the 50-star truth
    # (round 3), so windowed-mean
    # stability is exactly the convergence signal.
    plateau_window: int = 0
    plateau_tol: float = 0.25
    max_final_rounds: int = 2000
    # n_leapfrog for the POST-beta=1 rounds only (0 = same as n_leapfrog):
    # once the reweight is a no-op the bottleneck is pure posterior mixing,
    # and the crowded-field flux posterior mixes slowly at the short
    # tempering trajectories (VERDICT round-3 item 2) — spend the cheap
    # mutation on longer trajectories where they matter.
    final_n_leapfrog: int = 0
    step_size0: float = 0.1
    target_accept: float = 0.65
    divergence_threshold: float = 1000.0
    transdim: TransDimConfig = TransDimConfig()
    # RHMC mutation is chunked over the particle axis (lax.map batch_size):
    # a fully-vmapped metric build materializes (P, 3K, H*W) Jacobians per
    # Picard sweep, which at P=4096 outgrows device memory; chunks keep
    # peak memory flat.
    mutation_chunk: int = 1024
    # > 1: independent-ancestry resampling islands (see
    # systematic_resample) — preserves population diversity structurally;
    # the tempering/eps schedule stays global (synchronized across
    # islands), mutations are particle-local either way.
    n_islands: int = 1


class SMCState(NamedTuple):
    key: jax.Array
    theta: jax.Array    # (P, K, 3)
    mask: jax.Array     # (P, K)
    loglik: jax.Array   # (P,) untempered log-likelihood
    beta: jax.Array
    log_z: jax.Array
    eps: jax.Array
    n_steps: jax.Array
    mean_accept: jax.Array
    # temperature steps taken while ALREADY at beta=1 — i.e. completed
    # posterior ("final") rounds.  Checkpointed, so a resume from a beta=1
    # checkpoint continues with the REMAINING n_final_rounds instead of
    # rerunning all of them (the cfg4 extended-posterior studies are built
    # on exactly such resume loops).
    final_done: jax.Array


class _SMCStateV0(NamedTuple):
    """Round-2 SMCState layout (no final_done) — restore template for
    checkpoints written before the final_done field was added."""

    key: jax.Array
    theta: jax.Array
    mask: jax.Array
    loglik: jax.Array
    beta: jax.Array
    log_z: jax.Array
    eps: jax.Array
    n_steps: jax.Array
    mean_accept: jax.Array


class SMCResult(NamedTuple):
    theta: jax.Array
    mask: jax.Array
    loglik: jax.Array
    log_z: jax.Array
    n_steps: jax.Array
    eps: jax.Array
    mean_accept: jax.Array
    beta: jax.Array  # final temperature; < 1 means max_steps capped the pass
    final_done: jax.Array | None = None  # posterior rounds run (plateau mode)
    # first-class between-island convergence diagnostics, attached by
    # run_smc when n_islands > 1 (VERDICT round-4 item 2; previously an ad
    # hoc study script): {"island_rhat_flux", "island_ess_flux",
    # "island_rhat_count"} — see _attach_island_diag
    island_diag: dict | None = None


def ess_from_logw(logw: jax.Array) -> jax.Array:
    """Kish effective sample size of (unnormalized) log weights."""
    return jnp.exp(2.0 * jax.nn.logsumexp(logw) - jax.nn.logsumexp(2.0 * logw))


def systematic_resample(key: jax.Array, logw: jax.Array,
                        n_islands: int = 1) -> jax.Array:
    """Systematic resampling plan: (P,) parent indices, static shape.

    Deterministic given (key, logw): under sharding every device computes
    the same plan from the same key, then the gather is a collective.

    n_islands > 1 partitions the P particles into contiguous islands that
    resample ONLY within themselves (parent indices stay inside each
    island).  Each island then carries an independent ancestry — the
    population is a union of n_islands independent SMC runs sharing one
    adaptive (beta, eps) schedule — which bounds ancestral collapse: a
    single high-weight particle can take over at most P/n_islands slots.
    Round-4 motivation (VERDICT round-3 item 2): the crowded-field
    population's total-flux diversity is ancestral-lineage-limited (ESS
    ~10-15 of 4096 regardless of mutation length/sweeps), so diversity must be preserved structurally at
    resampling rather than regenerated by mutation afterwards.
    """
    n = logw.shape[0]
    if n_islands > 1:
        assert n % n_islands == 0, (n, n_islands)
        m = n // n_islands
        keys = jax.random.split(key, n_islands)
        local = jax.vmap(lambda k, lw: systematic_resample(k, lw))(
            keys, logw.reshape(n_islands, m)
        )
        offs = (jnp.arange(n_islands, dtype=local.dtype) * m)[:, None]
        return (local + offs).reshape(n)
    w = jax.nn.softmax(logw)
    cum = jnp.cumsum(w)
    u0 = jax.random.uniform(key) / n
    pos = u0 + jnp.arange(n, dtype=w.dtype) / n
    idx = jnp.searchsorted(cum, pos)
    return jnp.clip(idx, 0, n - 1)


def _attach_island_diag(res: SMCResult, cfg: SMCConfig) -> SMCResult:
    """Between-island convergence stats on the final population (host-side).

    Islands carry independent ancestries (systematic_resample), so they are
    the SMC analog of independent chains: between-island R̂ on total flux /
    star count measures true population convergence where the
    single-population split-R̂ UNDERSTATES it (clones agree by
    construction — measured round 4: islands R̂ 1.50 where pooled split-R̂
    read 1.2).  island_ess_flux sums the
    per-island particle-series ESS — the island-count-aware effective
    sample count (each island contributes at most its own ancestral
    diversity).
    """
    if cfg.n_islands <= 1:
        return res
    import numpy as np

    from . import diagnostics

    theta = np.asarray(res.theta)
    mask = np.asarray(res.mask)
    flux = (np.exp(theta[..., 2]) * mask).sum(-1)          # (P,)
    count = mask.sum(-1)                                    # (P,)
    g = cfg.n_islands
    fx = flux.reshape(g, -1)
    ct = count.reshape(g, -1)
    ess = float(sum(diagnostics.ess(row[None, :]) for row in fx))
    diag = {
        "island_rhat_flux": diagnostics.rhat_groups(fx),
        "island_ess_flux": ess,
        "island_rhat_count": diagnostics.rhat_groups(ct),
        "n_islands": g,
    }
    return res._replace(island_diag=diag)


def _next_dbeta(beta, loglik, target_ess, n_bisect: int = 26):
    """Largest Delta-beta <= 1-beta with ESS(Delta-beta * loglik) >= target."""
    full = 1.0 - beta

    def ess_of(db):
        return ess_from_logw(db * loglik)

    def bisect(_):
        def body(i, lohi):
            lo, hi = lohi
            mid = 0.5 * (lo + hi)
            ok = ess_of(mid) >= target_ess
            return jnp.where(ok, mid, lo), jnp.where(ok, hi, mid)

        lo, hi = jax.lax.fori_loop(0, n_bisect, body, (jnp.zeros_like(full), full))
        return lo

    return jax.lax.cond(ess_of(full) >= target_ess, lambda _: full, bisect, None)


def init_smc(
    key: jax.Array,
    spec: SceneSpec,
    image: jax.Array,
    prior: PriorSpec,
    kmax: int,
    cfg: SMCConfig,
) -> SMCState:
    """Draw P particles from the prior at beta = 0."""
    k_theta, k_n, k_run = jax.random.split(key, 3)
    p = cfg.n_particles
    thetas = jax.vmap(lambda k: sample_prior(k, kmax, prior))(
        jax.random.split(k_theta, p)
    )
    if cfg.n_transdim_sweeps > 0:
        # n ~ Poisson(Lambda) truncated to [0, kmax]; first-n slots alive
        # (slot assignments are exchangeable under the 1/C(K,n) target).
        ks = jnp.arange(kmax + 1, dtype=jnp.float32)
        logpmf = ks * jnp.log(cfg.transdim.lam_count) - jax.scipy.special.gammaln(ks + 1.0)
        n_draw = jax.random.categorical(k_n, logpmf, shape=(p,))
        masks = (jnp.arange(kmax)[None, :] < n_draw[:, None]).astype(jnp.float32)
    else:
        masks = jnp.ones((p, kmax), jnp.float32)
    loglik = jax.vmap(lambda t, m: log_likelihood(t, m, spec, image))(thetas, masks)
    return SMCState(
        key=k_run,
        theta=thetas,
        mask=masks,
        loglik=loglik,
        beta=jnp.asarray(0.0, jnp.float32),
        log_z=jnp.asarray(0.0, jnp.float32),
        eps=jnp.asarray(cfg.step_size0, jnp.float32),
        n_steps=jnp.asarray(0, jnp.int32),
        mean_accept=jnp.asarray(0.0, jnp.float32),
        final_done=jnp.asarray(0, jnp.int32),
    )


def make_smc_step(spec: SceneSpec, image: jax.Array, prior: PriorSpec, cfg: SMCConfig):
    """One temperature step: reweight -> resample -> mutate.  jit-able.

    A particle axis sharded over a device mesh needs nothing here: GSPMD
    partitions every mutation from the input shardings alone.
    """
    tempered_pg = make_tempered_potential_and_grad(spec, image, prior)
    metric = make_metric_fn(spec, prior)
    llf = lambda th, m: log_likelihood(th, m, spec, image)
    p = cfg.n_particles

    def step(s: SMCState) -> SMCState:
        key, k_res, k_mut, k_td, k_rel = jax.random.split(s.key, 5)

        # 1-2. adaptive tempering + reweight (weights are equal post-resample)
        db = _next_dbeta(s.beta, s.loglik, cfg.ess_target_frac * p)
        beta = s.beta + db
        logw = db * s.loglik
        log_z = s.log_z + jax.nn.logsumexp(logw) - jnp.log(float(p))

        # 3. systematic resampling (identical plan on every device)
        idx = systematic_resample(k_res, logw, n_islands=cfg.n_islands)
        theta = s.theta[idx]
        mask = s.mask[idx]
        loglik = s.loglik[idx]

        # 4a. trans-dimensional sweeps at temperature beta
        if cfg.n_transdim_sweeps > 0:
            tllf = lambda th, m: beta * llf(th, m)
            tll = beta * loglik

            def td_sweep(carry, k_step):
                th, m, l = carry
                keys = jax.random.split(k_step, p)
                th, m, l, _ = jax.vmap(
                    lambda kk, t, mm, ll: transdim_sweep(
                        kk, t, mm, ll, tllf, prior, spec, cfg.transdim,
                        image=image,
                    )
                )(keys, th, m, l)
                return (th, m, l), None

            (theta, mask, tll), _ = jax.lax.scan(
                td_sweep, (theta, mask, tll),
                jax.random.split(k_td, cfg.n_transdim_sweeps),
            )

        # 4a'. dimension-preserving relocate sweeps at temperature beta
        # (round 5, SMCConfig.n_relocate_sweeps rationale): configuration
        # hops within each lineage; mask is untouched, so this composes
        # with the trans-d phase and with islands/sharding unchanged.
        if cfg.n_relocate_sweeps > 0:
            from .transdim import relocate_step

            tllf_r = lambda th, m: beta * llf(th, m)
            rll = jax.vmap(tllf_r)(theta, mask)

            def rel_sweep(carry, k_step):
                th, l = carry
                keys = jax.random.split(k_step, p)
                th, _, l, _ = jax.vmap(
                    lambda kk, t, mm, ll: relocate_step(
                        kk, t, mm, ll, tllf_r, prior, spec, image,
                        cfg.transdim.resid_floor,
                        cfg.relocate_flux_sigma, cfg.relocate_pos_sigma,
                    )
                )(keys, th, mask, l)
                return (th, l), None

            (theta, rll), _ = jax.lax.scan(
                rel_sweep, (theta, rll),
                jax.random.split(k_rel, cfg.n_relocate_sweeps),
            )

        # 4b. within-model mutation at temperature beta
        pfn = lambda th, m: tempered_pg(th, m, beta)[0]
        gfn = lambda th, m: tempered_pg(th, m, beta)
        metric_b = lambda th, m: metric(th, m, beta)

        u0, g0 = jax.vmap(gfn)(theta, mask)
        states = ChainState(theta, u0, g0, jax.random.split(k_mut, p))

        if cfg.mutation == "rhmc":
            ham, dhdt, dhdp = make_rhmc_functions(pfn, metric_b)

            def one(st, m):
                return rhmc_step(
                    st, pfn, metric_b, ham, dhdt, dhdp, s.eps,
                    cfg.n_leapfrog, cfg.fixed_point_iters, m,
                    cfg.divergence_threshold,
                )
        elif cfg.mutation == "rhmc_diag":
            from .metric import make_diag_metric_fn
            from .rhmc import make_rhmc_diag_functions

            dmetric = make_diag_metric_fn(spec, prior)
            dmetric_b = lambda th, m: dmetric(th, m, beta)
            ham, dhdt, dhdp = make_rhmc_diag_functions(pfn, dmetric_b)

            def one(st, m):
                return rhmc_step(
                    st, pfn, dmetric_b, ham, dhdt, dhdp, s.eps,
                    cfg.n_leapfrog, cfg.fixed_point_iters, m,
                    cfg.divergence_threshold, diag_metric=True,
                )
        elif cfg.mutation == "hmc":

            def one(st, m):
                return hmc_step(
                    st, lambda th: gfn(th, m), s.eps,
                    jnp.ones_like(st.theta), cfg.n_leapfrog, m,
                    cfg.divergence_threshold,
                )
        else:
            raise ValueError(f"unknown SMC mutation {cfg.mutation!r}")

        chunk = min(cfg.mutation_chunk, p)

        def mut_step(sts, _):
            if cfg.mutation in ("rhmc", "rhmc_diag") and chunk < p:
                sts, info = jax.lax.map(
                    lambda sm: one(sm[0], sm[1]), (sts, mask), batch_size=chunk
                )
            else:
                sts, info = jax.vmap(one)(sts, mask)
            return sts, info.accept_prob

        states, aprobs = jax.lax.scan(mut_step, states, None,
                                      length=cfg.n_mutation_steps)
        mean_accept = jnp.mean(aprobs)
        theta = states.theta

        # Robbins-Monro step-size controller toward target acceptance
        eps = s.eps * jnp.exp(0.3 * (mean_accept - cfg.target_accept))
        eps = jnp.clip(eps, 1e-5, 10.0)

        loglik = jax.vmap(llf)(theta, mask)
        return SMCState(
            key=key, theta=theta, mask=mask, loglik=loglik, beta=beta,
            log_z=log_z, eps=eps, n_steps=s.n_steps + 1, mean_accept=mean_accept,
            final_done=s.final_done + (s.beta >= 1.0).astype(jnp.int32),
        )

    return step


@partial(jax.jit, static_argnames=("spec", "prior", "cfg"))
def smc_tempering(
    s0: SMCState,
    spec: SceneSpec,
    image: jax.Array,
    prior: PriorSpec,
    cfg: SMCConfig,
) -> SMCResult:
    """Run the tempering loop beta: 0 -> 1 from an initial state.

    If s0's particle arrays carry a NamedSharding (dist.shard_chains), GSPMD
    propagates it through the while loop: reductions become psums and the
    resampling gather becomes a cross-device collective — same program,
    1 device to N hosts (SURVEY.md §5.8).
    """
    step = make_smc_step(spec, image, prior, cfg)

    def cond(s):
        return (s.beta < 1.0) & (s.n_steps < cfg.max_steps)

    s = jax.lax.while_loop(cond, step, s0)
    if cfg.n_final_rounds > 0:
        fstep = (step if cfg.final_n_leapfrog in (0, cfg.n_leapfrog)
                 else make_smc_step(
                     spec, image, prior,
                     cfg._replace(n_leapfrog=cfg.final_n_leapfrog)))
        s = jax.lax.fori_loop(0, cfg.n_final_rounds, lambda i, ss: fstep(ss), s)
    return SMCResult(s.theta, s.mask, s.loglik, s.log_z, s.n_steps, s.eps,
                     s.mean_accept, s.beta, s.final_done)


@partial(jax.jit, static_argnames=("spec", "prior", "cfg"))
def _smc_step_jit(
    s: SMCState,
    spec: SceneSpec,
    image: jax.Array,
    prior: PriorSpec,
    cfg: SMCConfig,
) -> SMCState:
    """One temperature step as its own device program (host-stepped loop)."""
    return make_smc_step(spec, image, prior, cfg)(s)


def run_smc(
    key: jax.Array,
    spec: SceneSpec,
    image: jax.Array,
    prior: PriorSpec,
    kmax: int,
    cfg: SMCConfig,
    mesh=None,
    checkpoint_path: str | None = None,
    resume: bool = False,
    logger=None,
) -> SMCResult:
    """Full SMC pass (SURVEY.md §3.4).  Pass a dist.make_mesh() to shard the
    particle axis over devices (config 4).

    With ``checkpoint_path`` or ``logger`` the tempering loop is stepped
    from the host — one jit program per temperature step, reused across
    steps — so every step can append a JSONL record (beta, logZ, accept,
    eps — SURVEY.md §5.5) and write a checkpoint of the full
    SMCState (weights are implicit: post-resample they are equal, and the
    state is saved at step boundaries — SURVEY.md §5.4).  ``resume=True``
    continues a crashed pass from the last completed temperature step;
    the device program is identical to the single-program while_loop path
    (same make_smc_step), so both paths produce the same tempering
    trajectory.  Otherwise the whole loop runs as one device program
    (smc_tempering).
    """
    s0 = init_smc(key, spec, image, prior, kmax, cfg)
    if mesh is not None:
        from .dist import shard_chains

        # whole-state sharding: particle axes split, scalars replicated —
        # also makes s0 a sharding-complete restore template (checkpoint
        # resume on a mesh, SURVEY.md §5.4)
        s0 = shard_chains(s0, mesh)
    # The fully-fused smc_tempering path compiles the WHOLE pass as one
    # device program: the GSPMD multi-device reference, exercised by the
    # sharded-invariance tests and dryrun_multichip.  Where
    # runtime.max_program_steps sets a cap (STARCAT_MAX_PROGRAM_STEPS) the
    # pass runs the stepwise host loop instead: one jit per temperature
    # step, as the checkpointing, logging and plateau-stopped paths do.
    from .runtime import max_program_steps

    if (max_program_steps() is None
            and checkpoint_path is None and logger is None
            and cfg.n_final_rounds <= 50 and cfg.plateau_window <= 0):
        res = smc_tempering(s0, spec, image, prior, cfg)
        return _attach_island_diag(res, cfg)

    import os

    s = s0
    if resume and checkpoint_path is not None and os.path.exists(checkpoint_path):
        from .checkpoint import restore_state

        try:
            s = restore_state(checkpoint_path, s0)
        except Exception as e_cur:
            # Pre-round-3 checkpoints lack the final_done leaf (ADVICE r3):
            # restore against the legacy structure and default final_done
            # to 0 — the conservative old behavior (rerun all final rounds).
            # A checkpoint that ALSO fails the legacy layout is genuinely
            # corrupt/incompatible: surface BOTH failures with the original
            # error chained, instead of the confusing legacy-template
            # message alone (VERDICT round-4 item 8 / ADVICE round-4).
            legacy = _SMCStateV0(*s0[:-1])
            try:
                s = SMCState(*restore_state(checkpoint_path, legacy),
                             final_done=jnp.zeros((), jnp.int32))
            except Exception as e_old:
                raise RuntimeError(
                    f"SMC checkpoint restore failed for {checkpoint_path!r} "
                    f"under both the current SMCState layout ({e_cur!r}) and "
                    f"the legacy pre-final_done layout ({e_old!r}); the "
                    "checkpoint is corrupt or from an incompatible run"
                ) from e_cur
    final_left = max(cfg.n_final_rounds - int(s.final_done), 0)

    def emit_and_save(s):
        if logger is not None:
            logger.log(
                "smc_temperature_step", step=int(s.n_steps),
                beta=float(s.beta), log_z=float(s.log_z),
                accept=float(s.mean_accept), step_size=float(s.eps),
                mean_n=float(jnp.mean(jnp.sum(s.mask, axis=-1))),
            )
        if checkpoint_path is not None:
            from .checkpoint import save_state

            save_state(checkpoint_path, s)

    while float(s.beta) < 1.0 and int(s.n_steps) < cfg.max_steps:
        s = _smc_step_jit(s, spec, image, prior, cfg, )
        emit_and_save(s)

    # post-beta=1 posterior rounds, optionally with longer trajectories
    # (final_n_leapfrog) — a separate compiled step program, reused
    fcfg = (cfg if cfg.final_n_leapfrog in (0, cfg.n_leapfrog)
            else cfg._replace(n_leapfrog=cfg.final_n_leapfrog))
    if cfg.plateau_window > 0:
        # plateau-stopped posterior rounds (VERDICT round-3 item 1): run
        # until the windowed mean star count stops moving.  On resume the
        # window restarts from the checkpointed state (conservative: at
        # least 2*W more rounds), and final_done keeps the total under
        # max_final_rounds across crashes.
        w = cfg.plateau_window
        hist: list[float] = []
        # only posterior rounds are plateau-stopped; a max_steps-capped
        # pass (beta < 1) returns immediately as before
        while (float(s.beta) >= 1.0
               and int(s.final_done) < cfg.max_final_rounds):
            s = _smc_step_jit(s, spec, image, prior, fcfg, )
            emit_and_save(s)
            hist.append(float(jnp.mean(jnp.sum(s.mask, axis=-1))))
            if len(hist) >= 2 * w:
                drift = abs(sum(hist[-w:]) / w - sum(hist[-2 * w:-w]) / w)
                if drift < cfg.plateau_tol:
                    break
    else:
        while final_left > 0:
            s = _smc_step_jit(s, spec, image, prior, fcfg, )
            final_left -= 1
            emit_and_save(s)
    res = _attach_island_diag(
        SMCResult(s.theta, s.mask, s.loglik, s.log_z, s.n_steps, s.eps,
                  s.mean_accept, s.beta, s.final_done),
        cfg,
    )
    if logger is not None and res.island_diag is not None:
        logger.log("smc_island_diag", **res.island_diag)
    return res
