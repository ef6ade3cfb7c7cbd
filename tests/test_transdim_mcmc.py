"""Trans-dimensional MCMC head tests (SURVEY.md §3.2 reference call stack;
round-1 review item 2): prior recovery of the COMPOSED kernel
(trans-d sweeps + within-model move), star-count recovery on a 2-star mock,
fixed-K agreement with the plain HMC head, and blocked/resume determinism.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy import stats

import starcat
from starcat.potential import PriorSpec, sample_prior, unconstrain
from starcat.scene import SceneSpec, make_mock_image
from starcat.transdim import TransDimConfig
from starcat.transdim_mcmc import (
    TDState,
    TransDimMCMCConfig,
    init_td_states,
    make_transdim_kernel,
    run_transdim,
)

SPEC = SceneSpec(16, 16, 1.5, 5.0)
PRIOR = PriorSpec(logf_mean=3.0, logf_sigma=0.8)
KMAX = 6


def _truncated_poisson_pmf(lam, kmax):
    ks = np.arange(kmax + 1)
    pmf = stats.poisson.pmf(ks, lam)
    return pmf / pmf.sum()


@pytest.mark.slow
def test_composed_kernel_prior_recovery():
    """beta=0 (flat likelihood): the full head — trans-d sweeps interleaved
    with within-model HMC — must leave the prior invariant: n ~ truncated
    Poisson(lam) and alive-slot log-flux ~ N(logf_mean, logf_sigma)."""
    lam = 2.0
    img = jnp.full((16, 16), SPEC.background)  # unused at beta=0
    cfg = TransDimMCMCConfig(
        step_size=0.4, mutation="hmc", n_leapfrog=5, n_transdim_sweeps=2,
        transdim=TransDimConfig(lam_count=lam, split_sigma=1.0),
    )
    kernel = make_transdim_kernel(SPEC, img, PRIOR, cfg, beta=0.0)
    states = init_td_states(jax.random.key(0), SPEC, img, PRIOR, KMAX, 96,
                            lam, beta=0.0)

    @jax.jit
    def run(states):
        def body(st, _):
            st, info = kernel(st, jnp.asarray(0.4))
            return st, (st.mask.sum(-1), info.accept_prob)

        return jax.lax.scan(body, states, None, length=400)

    states, (ns, aprob) = run(states)
    assert float(aprob[200:].mean()) > 0.5  # HMC on the prior accepts easily

    counts = np.asarray(ns)[200:].reshape(-1).astype(int)
    pmf = _truncated_poisson_pmf(lam, KMAX)
    emp = np.bincount(counts, minlength=KMAX + 1)[: KMAX + 1] / counts.size
    assert np.abs(emp - pmf).max() < 0.04, (emp, pmf)

    # alive-slot flux marginal: the within-model move perturbs fluxes, so
    # this catches a wrong potential/tempering wiring, not just the moves
    s = np.asarray(states.theta[..., 2])[np.asarray(states.mask) > 0]
    ks = stats.kstest(s, "norm", args=(PRIOR.logf_mean, PRIOR.logf_sigma))
    assert ks.pvalue > 1e-4, ks


@pytest.mark.slow
def test_star_count_recovery_two_stars():
    """2 bright, well-separated stars: the trans-d chain must put the
    posterior mode of n at 2."""
    bright = PriorSpec(logf_mean=5.0, logf_sigma=0.4)
    x = jnp.array([5.0, 11.0])
    y = jnp.array([5.0, 11.0])
    f = jnp.array([150.0, 130.0])
    img = make_mock_image(jax.random.key(1), x, y, f, SPEC)
    cfg = TransDimMCMCConfig(
        step_size=0.05, mutation="hmc", n_leapfrog=8, n_transdim_sweeps=2,
        transdim=TransDimConfig(lam_count=2.0, split_sigma=1.0),
    )
    res, eps = run_transdim(
        jax.random.key(2), SPEC, img, bright, KMAX, 64, 300, 200, cfg,
    )
    counts = np.asarray(res.masks)[:, 100:, :].sum(-1).reshape(-1).astype(int)
    hist = np.bincount(counts, minlength=KMAX + 1)
    assert hist.argmax() == 2, hist
    assert 1.7 < counts.mean() < 2.4, counts.mean()


@pytest.mark.slow
def test_star_count_recovery_rhmc_diag():
    """Same 2-star recovery through the diagonal-Fisher Riemannian move —
    the cheap crowded-field mutation composed with trans-d sweeps targets
    the same trans-dimensional posterior."""
    bright = PriorSpec(logf_mean=5.0, logf_sigma=0.4)
    x = jnp.array([5.0, 11.0])
    y = jnp.array([5.0, 11.0])
    f = jnp.array([150.0, 130.0])
    img = make_mock_image(jax.random.key(1), x, y, f, SPEC)
    cfg = TransDimMCMCConfig(
        step_size=0.3, mutation="rhmc_diag", n_leapfrog=5,
        fixed_point_iters=4, n_transdim_sweeps=2,
        transdim=TransDimConfig(lam_count=2.0, split_sigma=1.0),
    )
    res, eps = run_transdim(
        jax.random.key(2), SPEC, img, bright, KMAX, 32, 200, 150, cfg,
    )
    counts = np.asarray(res.masks)[:, 60:, :].sum(-1).reshape(-1).astype(int)
    hist = np.bincount(counts, minlength=KMAX + 1)
    assert hist.argmax() == 2, hist
    assert 1.6 < counts.mean() < 2.5, counts.mean()


@pytest.mark.slow
def test_fixed_k_matches_plain_hmc():
    """With trans-d sweeps disabled and all slots alive, the head must
    reproduce the plain HMC head's posterior (same target, same moves)."""
    from starcat import diagnostics
    from starcat.hmc import HMCConfig, run_hmc
    from starcat.potential import make_potential_and_grad

    truth = sample_prior(jax.random.key(5), 1, PriorSpec(4.5, 0.3))
    x, y, f = starcat.constrain(truth, SPEC)
    img = make_mock_image(jax.random.key(6), x, y, f, SPEC)

    cfg = TransDimMCMCConfig(step_size=0.05, mutation="hmc", n_leapfrog=10,
                             n_transdim_sweeps=0)
    kernel = make_transdim_kernel(SPEC, img, PRIOR, cfg)
    theta0 = jnp.broadcast_to(truth, (32, 1, 3)) + 0.01 * jax.random.normal(
        jax.random.key(7), (32, 1, 3)
    )
    ll0 = jax.vmap(lambda t: starcat.log_likelihood(t, jnp.ones(1), SPEC, img))(theta0)
    states = TDState(theta0, jnp.ones((32, 1)), ll0,
                     jax.random.split(jax.random.key(8), 32))

    @jax.jit
    def run(states):
        def body(st, _):
            st, info = kernel(st, jnp.asarray(0.05))
            return st, st.theta

        return jax.lax.scan(body, states, None, length=500)

    _, draws_td = run(states)  # (N, C, 1, 3)
    draws_td = np.moveaxis(np.asarray(draws_td), 0, 1)[:, 200:]

    pg = make_potential_and_grad(SPEC, img, PRIOR)
    gf = lambda th: pg(th, jnp.ones(1))
    res, _ = run_hmc(jax.random.key(9), gf, theta0, jnp.ones(1), 300, 200,
                     HMCConfig(step_size=0.05, n_leapfrog=10))
    draws_hmc = np.asarray(res.thetas)

    for j, nm in enumerate(["ux", "uy", "s"]):
        cmp = diagnostics.compare_moments(
            draws_td[..., 0, j], draws_hmc[..., 0, j], nm
        )
        assert cmp["z"] < 4.0, (nm, cmp)


@pytest.mark.slow
def test_blocked_equals_unblocked_and_resume():
    """Blocked sampling is bitwise-identical to one big scan; resume from a
    checkpoint reproduces the remaining draws exactly."""
    img = make_mock_image(
        jax.random.key(1), jnp.array([8.0]), jnp.array([8.0]),
        jnp.array([60.0]), SPEC
    )
    cfg = TransDimMCMCConfig(
        step_size=0.1, mutation="hmc", n_leapfrog=4, n_transdim_sweeps=1,
        transdim=TransDimConfig(lam_count=2.0),
    )
    kw = dict(n_chains=8, n_samples=24, n_warmup=12, cfg=cfg)
    res_a, eps_a = run_transdim(jax.random.key(3), SPEC, img, PRIOR, KMAX, **kw)
    res_b, eps_b = run_transdim(jax.random.key(3), SPEC, img, PRIOR, KMAX,
                                block_size=8, **kw)
    np.testing.assert_array_equal(np.asarray(res_a.thetas), np.asarray(res_b.thetas))
    np.testing.assert_array_equal(np.asarray(res_a.masks), np.asarray(res_b.masks))

    # checkpointed run, then resume-from-scratch must complete the tail
    import tempfile, os

    with tempfile.TemporaryDirectory() as d:
        ck = os.path.join(d, "td_ckpt")
        res_c, _ = run_transdim(jax.random.key(3), SPEC, img, PRIOR, KMAX,
                                block_size=8, checkpoint_path=ck, **kw)
        # simulate a crash that lost the in-memory draws: resume produces
        # zero new draws (run already complete) without re-warming
        res_d, _ = run_transdim(jax.random.key(3), SPEC, img, PRIOR, KMAX,
                                block_size=8, checkpoint_path=ck,
                                resume=True, **kw)
        assert res_d.thetas.shape[1] == 0
        np.testing.assert_array_equal(
            np.asarray(res_d.final_state.theta),
            np.asarray(res_c.final_state.theta),
        )


@pytest.mark.slow
def test_pallas_leapfrog_per_chain_masks():
    """(C, K) per-chain masks in the fused kernel must match per-chain XLA
    leapfrog runs with each chain's own mask (interpret mode)."""
    from starcat.integrators import leapfrog
    from starcat.pallas_kernels import make_pallas_leapfrog
    from starcat.potential import make_potential_and_grad

    C, K = 8, 4
    truth = sample_prior(jax.random.key(0), K, PRIOR)
    x, y, f = starcat.constrain(truth, SPEC)
    img = make_mock_image(jax.random.key(1), x, y, f, SPEC)
    pg = make_potential_and_grad(SPEC, img, PRIOR)

    theta = truth[None] + 0.02 * jax.random.normal(jax.random.key(2), (C, K, 3))
    masks = (jax.random.uniform(jax.random.key(3), (C, K)) > 0.4).astype(jnp.float32)
    p = jax.random.normal(jax.random.key(4), theta.shape) * masks[..., None]
    inv_mass = jnp.ones((K, 3))

    fused = make_pallas_leapfrog(SPEC, img, PRIOR, K, interpret=True)
    g0 = jax.vmap(pg)(theta, masks)[1]
    th2, p2, u2, g2 = fused(theta, p, 0.002, inv_mass, masks, 4, g0)

    def one(t, q, m):
        u0, g0 = pg(t, m)
        r = leapfrog(lambda th: pg(th, m), t, q, u0, g0, jnp.asarray(0.002), 4,
                     inv_mass)
        return r.theta, r.p, r.u, r.grad

    tr, pr, ur, gr = jax.vmap(one)(theta, p, masks)
    np.testing.assert_allclose(np.asarray(th2), np.asarray(tr), atol=3e-4)
    np.testing.assert_allclose(np.asarray(u2), np.asarray(ur), atol=0.3)
    # dead slots frozen and zero-grad per chain
    dead = np.asarray(masks) == 0.0
    np.testing.assert_array_equal(np.asarray(th2)[dead], np.asarray(theta)[dead])
    np.testing.assert_array_equal(np.asarray(g2)[dead], 0.0)


@pytest.mark.slow
def test_transdim_sharded_smoke():
    """Trans-d head on the fake 8-device chain mesh: state shards, the
    composed kernel partitions under GSPMD, results stay statistically
    consistent with the single-device run (star-count posterior)."""
    from starcat.dist import make_mesh

    img = make_mock_image(
        jax.random.key(1), jnp.array([5.0, 11.0]), jnp.array([8.0, 8.0]),
        jnp.array([150.0, 130.0]), SPEC
    )
    bright = PriorSpec(logf_mean=5.0, logf_sigma=0.4)
    cfg = TransDimMCMCConfig(
        step_size=0.05, mutation="hmc", n_leapfrog=5, n_transdim_sweeps=1,
        transdim=TransDimConfig(lam_count=2.0),
    )
    res, _ = run_transdim(jax.random.key(2), SPEC, img, bright, KMAX, 16,
                          60, 40, cfg, mesh=make_mesh("chains"))
    counts = np.asarray(res.masks)[:, 30:, :].sum(-1)
    assert 1.5 < counts.mean() < 3.0, counts.mean()


@pytest.mark.slow
def test_transdim_hmc_pallas_mutation_matches_xla():
    """mutation='hmc_pallas' (per-chain-mask fused kernel, interpret mode)
    consumes the same PRNG stream as mutation='hmc', so the composed
    trans-d kernel must produce the same masks and float-close thetas."""
    img = make_mock_image(
        jax.random.key(1), jnp.array([5.0, 11.0]), jnp.array([8.0, 8.0]),
        jnp.array([80.0, 60.0]), SPEC
    )
    kw = dict(step_size=0.03, n_leapfrog=3, n_transdim_sweeps=1,
              transdim=TransDimConfig(lam_count=2.0))
    kern_x = make_transdim_kernel(SPEC, img, PRIOR,
                                  TransDimMCMCConfig(mutation="hmc", **kw))
    kern_p = make_transdim_kernel(SPEC, img, PRIOR,
                                  TransDimMCMCConfig(mutation="hmc_pallas", **kw),
                                  interpret=True)
    states = init_td_states(jax.random.key(7), SPEC, img, PRIOR, KMAX, 8, 2.0)

    sx, sp = states, states
    for _ in range(4):
        sx, ix = kern_x(sx, jnp.asarray(0.03))
        sp, ip = kern_p(sp, jnp.asarray(0.03))
    np.testing.assert_array_equal(np.asarray(sx.mask), np.asarray(sp.mask))
    np.testing.assert_allclose(np.asarray(sx.theta), np.asarray(sp.theta),
                               atol=5e-3)
    np.testing.assert_allclose(np.asarray(sx.loglik), np.asarray(sp.loglik),
                               rtol=1e-3, atol=0.3)


@pytest.mark.slow
def test_transdim_mcmc_matches_smc_star_count():
    """Two independent trans-dimensional samplers — tempered SMC and the
    trans-d MCMC chain — target the SAME slot-symmetrized posterior, so
    their star-count pmfs must agree (strong cross-validation: different
    kernels, different failure modes)."""
    from starcat.smc import SMCConfig, run_smc

    img = make_mock_image(
        jax.random.key(21), jnp.array([4.5, 11.5]), jnp.array([11.0, 5.0]),
        jnp.array([90.0, 70.0]), SPEC,
    )
    prior = PriorSpec(logf_mean=4.2, logf_sigma=0.5)
    td = TransDimConfig(lam_count=2.0, split_sigma=1.0)

    scfg = SMCConfig(n_particles=1024, mutation="hmc", n_mutation_steps=3,
                     n_leapfrog=8, n_transdim_sweeps=3, max_steps=60,
                     n_final_rounds=3, transdim=td)
    res_s = run_smc(jax.random.key(1), SPEC, img, prior, KMAX, scfg)
    n_s = np.asarray(res_s.mask).sum(-1).astype(int)

    mcfg = TransDimMCMCConfig(step_size=0.1, mutation="hmc", n_leapfrog=8,
                              n_transdim_sweeps=2, transdim=td)
    res_m, _ = run_transdim(jax.random.key(2), SPEC, img, prior, KMAX, 64,
                            400, 200, mcfg)
    n_m = np.asarray(res_m.masks)[:, 100:, :].sum(-1).reshape(-1).astype(int)

    pmf_s = np.bincount(n_s, minlength=KMAX + 1)[: KMAX + 1] / n_s.size
    pmf_m = np.bincount(n_m, minlength=KMAX + 1)[: KMAX + 1] / n_m.size
    assert pmf_s.argmax() == pmf_m.argmax(), (pmf_s, pmf_m)
    assert abs(n_s.mean() - n_m.mean()) < 0.35, (n_s.mean(), n_m.mean())
