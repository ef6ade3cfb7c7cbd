"""SMC tests (SURVEY.md §4.2): resampler unbiasedness, adaptive tempering,
posterior agreement with HMC on the single-star scene, trans-d SMC star
count recovery, and the sharded-vs-single-device invariance test."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import starcat
from starcat import diagnostics
from starcat.hmc import HMCConfig, run_hmc
from starcat.potential import PriorSpec, unconstrain
from starcat.scene import SceneSpec, make_mock_image
from starcat.smc import (
    SMCConfig,
    ess_from_logw,
    run_smc,
    systematic_resample,
)
from starcat.transdim import TransDimConfig


def test_systematic_resample_unbiased():
    """E[count of particle i] = P * w_i, and variance < multinomial."""
    logw = jnp.log(jnp.array([0.1, 0.4, 0.2, 0.05, 0.25]))
    n = logw.shape[0]
    counts = np.zeros(n)
    trials = 3000
    keys = jax.random.split(jax.random.key(0), trials)
    idxs = jax.vmap(lambda k: systematic_resample(k, logw))(keys)
    idxs = np.asarray(idxs)
    for i in range(n):
        counts[i] = (idxs == i).mean() * n
    w = np.exp(np.asarray(logw))
    np.testing.assert_allclose(counts, n * w, atol=0.05)
    # systematic: per-trial counts deviate < 1 from n*w
    per_trial = np.stack([(idxs == i).sum(1) for i in range(n)], 1)
    assert np.abs(per_trial - n * w).max() <= 1.0 + 1e-6


def test_ess_formula():
    logw = jnp.zeros(100)
    assert np.isclose(float(ess_from_logw(logw)), 100.0, rtol=1e-5)
    logw = jnp.array([0.0, -jnp.inf, -jnp.inf])
    assert np.isclose(float(ess_from_logw(logw)), 1.0, rtol=1e-5)


def _single_star_setup():
    spec = SceneSpec(16, 16, 1.5, 5.0)
    prior = PriorSpec(5.0, 1.0)
    x, y, f = jnp.array([8.3]), jnp.array([7.6]), jnp.array([300.0])
    img = make_mock_image(jax.random.key(7), x, y, f, spec)
    return spec, prior, img, (x, y, f)


@pytest.mark.slow
def test_smc_matches_hmc_single_star():
    """Config-3-style fixed-K SMC vs the HMC head: same posterior."""
    spec, prior, img, (x, y, f) = _single_star_setup()
    cfg = SMCConfig(
        n_particles=512, mutation="hmc", n_mutation_steps=4, n_leapfrog=10,
        step_size0=0.1,
    )
    res = run_smc(jax.random.key(1), spec, img, prior, 1, cfg)
    assert float(res.beta) if hasattr(res, "beta") else True
    assert int(res.n_steps) < cfg.max_steps
    d = np.asarray(res.theta)[:, 0, :]  # (P, 3) final equal-weight particles

    pg = starcat.make_potential_and_grad(spec, img, prior)
    gf = lambda th: pg(th, jnp.ones(1))
    theta0 = unconstrain(x, y, f, spec)[None] + 0.01 * jax.random.normal(
        jax.random.key(3), (16, 1, 3)
    )
    res_h, _ = run_hmc(
        jax.random.key(4), gf, theta0, jnp.ones(1), 800, 500,
        HMCConfig(step_size=0.05, n_leapfrog=15),
    )
    dh = np.asarray(res_h.thetas)[:, :, 0, :]
    # SMC particles are weakly correlated; treat as one chain with ESS ~ P/2
    for j, nm in enumerate(["ux", "uy", "s"]):
        mu_s, sd_s = d[:, j].mean(), d[:, j].std()
        s_h = diagnostics.summarize(dh[:, :, j])
        se = np.sqrt(sd_s**2 / (d.shape[0] / 4) + s_h["mcse"] ** 2)
        z = abs(mu_s - s_h["mean"]) / se
        assert z < 4.5, (nm, mu_s, s_h["mean"], z)
        assert abs(sd_s - s_h["sd"]) / s_h["sd"] < 0.25, (nm, sd_s, s_h["sd"])


@pytest.mark.slow
def test_smc_rhmc_diag_mutation_recovers_truth():
    """mutation="rhmc_diag" (diagonal-Fisher Riemannian): tempering completes
    and the injected truth is recovered — the cheap crowded-field mutation
    targets the same posterior as the full-metric one (exact MH)."""
    spec, prior, img, (x, y, f) = _single_star_setup()
    cfg = SMCConfig(
        n_particles=128, mutation="rhmc_diag", n_mutation_steps=2,
        n_leapfrog=5, fixed_point_iters=4, step_size0=0.3,
    )
    res = run_smc(jax.random.key(2), spec, img, prior, 1, cfg)
    assert float(res.beta) == 1.0
    assert float(res.mean_accept) > 0.3
    d = np.asarray(res.theta)[:, 0, :]
    xs = jax.nn.sigmoid(d[:, 0]) * spec.width
    fs = np.exp(d[:, 2])
    assert abs(xs.mean() - float(x[0])) < 4 * xs.std() + 0.05
    assert abs(fs.mean() - float(f[0])) < 4 * fs.std() + 5.0


@pytest.mark.slow
@pytest.mark.slow
def test_transdim_smc_recovers_star_count():
    """Config 3 (small): 2 bright stars, trans-d SMC concentrates n near 2."""
    spec = SceneSpec(16, 16, 1.5, 3.0)
    prior = PriorSpec(5.5, 0.5)
    x = jnp.array([5.0, 11.0])
    y = jnp.array([6.0, 10.0])
    f = jnp.array([400.0, 250.0])
    img = make_mock_image(jax.random.key(0), x, y, f, spec)
    cfg = SMCConfig(
        n_particles=512, mutation="hmc", n_mutation_steps=3, n_leapfrog=8,
        n_transdim_sweeps=2, step_size0=0.05,
        transdim=TransDimConfig(lam_count=2.0, split_sigma=1.0),
    )
    res = run_smc(jax.random.key(2), spec, img, prior, 6, cfg)
    ns = np.asarray(res.mask).sum(-1)
    # posterior on n should concentrate on >= 2 (two clearly-resolved stars),
    # and rarely overshoot wildly
    assert (ns >= 2).mean() > 0.9, ns.mean()
    assert ns.mean() < 3.5
    # total flux about right
    tot = np.asarray(jax.vmap(lambda t, m: (jnp.exp(t[:, 2]) * m).sum())(
        jnp.asarray(res.theta), jnp.asarray(res.mask)))
    assert abs(np.median(tot) - 650.0) / 650.0 < 0.2


@pytest.mark.slow
def test_smc_sharded_matches_single_device():
    """SURVEY.md §4.2 distributed test: the same SMC program on a sharded
    8-device particle axis gives the same moments (same seeds => nearly
    identical draws; collectives only reorder reductions)."""
    spec, prior, img, _ = _single_star_setup()
    cfg = SMCConfig(n_particles=256, mutation="hmc", n_mutation_steps=2, n_leapfrog=5)

    res1 = run_smc(jax.random.key(5), spec, img, prior, 1, cfg)

    from starcat.dist import make_mesh

    assert len(jax.devices()) == 8, "conftest must fake 8 CPU devices"
    mesh = make_mesh("chains")
    res2 = run_smc(jax.random.key(5), spec, img, prior, 1, cfg, mesh=mesh)
    # the sharded run actually splits the particle axis over 8 devices
    assert len(res2.theta.sharding.device_set) == 8
    # deterministic program, same key: identical modulo reduction order
    np.testing.assert_allclose(
        np.asarray(res1.theta).mean(0), np.asarray(res2.theta).mean(0), rtol=1e-4, atol=1e-4
    )
    np.testing.assert_allclose(float(res1.log_z), float(res2.log_z), rtol=1e-3)


@pytest.mark.slow
def test_smc_sharded_rhmc_diag_matches_single_device():
    """Sharded-vs-single invariance for the rhmc_diag mutation (pure XLA:
    GSPMD partitions it from the input shardings alone — no shard_map)."""
    from starcat.dist import make_mesh

    spec, prior, img, _ = _single_star_setup()
    cfg = SMCConfig(n_particles=256, mutation="rhmc_diag", n_mutation_steps=1,
                    n_leapfrog=4, fixed_point_iters=3, step_size0=0.3,
                    mutation_chunk=256)

    res1 = run_smc(jax.random.key(5), spec, img, prior, 1, cfg)
    assert len(jax.devices()) == 8, "conftest must fake 8 CPU devices"
    mesh = make_mesh("chains")
    res2 = run_smc(jax.random.key(5), spec, img, prior, 1, cfg, mesh=mesh)
    assert len(res2.theta.sharding.device_set) == 8
    np.testing.assert_allclose(
        np.asarray(res1.theta).mean(0), np.asarray(res2.theta).mean(0),
        rtol=1e-4, atol=1e-4,
    )
    np.testing.assert_allclose(float(res1.log_z), float(res2.log_z), rtol=1e-3)


def _tiny_cfg4(n_particles=64):
    """The cfg4 preset's SMC settings (diag-Riemannian mutation chunked over
    particles, residual-birth trans-d sweeps) on a tiny scene."""
    import dataclasses

    from starcat.configs import CONFIGS

    base = CONFIGS["cfg4_crowded"]
    smc = base.smc._replace(
        n_particles=n_particles, max_steps=3, plateau_window=0,
        n_final_rounds=0, n_transdim_sweeps=2, mutation_chunk=16,
        transdim=base.smc.transdim._replace(lam_count=3.0),
    )
    return dataclasses.replace(base, scene=SceneSpec(16, 16, 1.5, 5.0),
                               n_stars=3, kmax=6, smc=smc)


def test_cfg4_preset_mutation_runs_on_cpu():
    """The shipped cfg4 preset mutates with the XLA diagonal-Fisher
    trajectory (rhmc_diag), chunked below the particle count; a few
    temperature steps at a tiny shape give a finite logZ and star counts
    inside [0, kmax]."""
    from starcat.api import sample

    cfg = _tiny_cfg4()
    assert cfg.smc.mutation == "rhmc_diag"
    assert cfg.smc.mutation_chunk < cfg.smc.n_particles
    out = sample(cfg, seed=0)
    assert np.isfinite(out.stats["log_z"])
    assert out.stats["n_temp_steps"] == 3
    counts = np.asarray(out.masks).sum(-1)
    assert 0 <= counts.min() and counts.max() <= cfg.kmax
    assert np.isfinite(out.thetas).all()


def test_smc_sharded_rhmc_diag_mutation():
    """The cfg4 mutation on a SHARDED particle axis (fake 8-device CPU
    mesh): GSPMD partitions the chunked diag-Riemannian mutation, results
    live on every device and match the single-device run."""
    from starcat.dist import make_mesh

    cfg = _tiny_cfg4()
    truth, img = cfg.make_data()
    assert len(jax.devices()) == 8, "conftest must fake 8 CPU devices"
    res1 = run_smc(jax.random.key(3), cfg.scene, img, cfg.prior, cfg.kmax,
                   cfg.smc)
    res8 = run_smc(jax.random.key(3), cfg.scene, img, cfg.prior, cfg.kmax,
                   cfg.smc, mesh=make_mesh("chains"))
    assert len(res8.theta.sharding.device_set) == 8
    np.testing.assert_allclose(float(res1.log_z), float(res8.log_z), rtol=1e-3)
    np.testing.assert_allclose(np.asarray(res1.mask).sum(-1).mean(),
                               np.asarray(res8.mask).sum(-1).mean(), atol=0.5)


def test_plateau_stopped_final_rounds():
    """Plateau stopping rule (VERDICT round-3 item 1): with
    plateau_window > 0 the posterior rounds keep running after beta=1
    until the windowed mean star count stabilizes, then STOP before
    max_final_rounds; final_n_leapfrog switches the final-round step
    program.  Single-star scene: the count stabilizes immediately, so the
    loop must exit at exactly 2*window rounds."""
    spec, prior, img, _ = _single_star_setup()
    cfg = SMCConfig(
        n_particles=256, mutation="hmc", n_leapfrog=5, n_mutation_steps=2,
        n_transdim_sweeps=1, step_size0=0.1,
        transdim=TransDimConfig(lam_count=1.0),
        plateau_window=4, plateau_tol=0.5, max_final_rounds=60,
        final_n_leapfrog=10,
    )
    res = run_smc(jax.random.key(3), spec, img, prior, 4, cfg)
    assert float(res.beta) == 1.0
    done = int(res.final_done)
    assert 2 * cfg.plateau_window <= done < cfg.max_final_rounds
    # the single-star posterior is trivially stable -> earliest possible stop
    assert done == 2 * cfg.plateau_window


def test_island_resampling_stays_in_island_and_unbiased():
    """Island resampling (round 4): parent indices stay inside each
    island, expected offspring counts match the WITHIN-island weights, and
    n_islands=1 is the plain global plan."""
    key = jax.random.key(0)
    logw = jax.random.normal(jax.random.key(1), (32,))
    ni, m = 4, 8
    idx = np.asarray(systematic_resample(key, logw, n_islands=ni))
    for i in range(ni):
        blk = idx[i * m:(i + 1) * m]
        assert blk.min() >= i * m and blk.max() < (i + 1) * m
    # unbiasedness within one island over many trials
    trials = 2000
    keys = jax.random.split(jax.random.key(2), trials)
    idxs = np.asarray(jax.vmap(
        lambda k: systematic_resample(k, logw, n_islands=ni))(keys))
    w0 = np.asarray(jax.nn.softmax(logw[:m]))
    counts = np.array([(idxs[:, :m] == j).mean() * m for j in range(m)])
    np.testing.assert_allclose(counts, m * w0, atol=0.06)
    # n_islands=1 falls back to the global plan
    np.testing.assert_array_equal(
        np.asarray(systematic_resample(key, logw)),
        np.asarray(systematic_resample(key, logw, n_islands=1)))


def test_island_diag_first_class():
    """n_islands > 1 attaches between-island convergence stats to the
    result (VERDICT round-4 item 2a: previously an ad hoc study script);
    n_islands = 1 leaves island_diag None."""
    spec, prior, img, _ = _single_star_setup()
    cfg = SMCConfig(n_particles=128, mutation="hmc", n_mutation_steps=1,
                    n_leapfrog=3, n_islands=4)
    res = run_smc(jax.random.key(3), spec, img, prior, 1, cfg)
    d = res.island_diag
    assert d is not None and d["n_islands"] == 4
    assert np.isfinite(d["island_rhat_flux"]) and d["island_rhat_flux"] > 0.8
    assert np.isfinite(d["island_rhat_count"])
    assert 0 < d["island_ess_flux"] <= cfg.n_particles

    res1 = run_smc(jax.random.key(3), spec, img, prior, 1,
                   cfg._replace(n_islands=1))
    assert res1.island_diag is None


def test_smc_sharded_islands_matches_single_device():
    """Islands compose with device sharding (VERDICT round-4 item 2c): the
    per-island resampling gathers run under an 8-device particle mesh and
    reproduce the single-device result.  Deliberately cheap and UNMARKED so
    the fused single-program GSPMD path stays in the fast suite (ADVICE
    round-4: the other sharded-invariance cases are slow-marked)."""
    from starcat.dist import make_mesh

    spec, prior, img, _ = _single_star_setup()
    # island size 16 vs 8 particles/device: island boundaries deliberately
    # straddle device shards
    cfg = SMCConfig(n_particles=64, mutation="hmc", n_mutation_steps=1,
                    n_leapfrog=3, n_islands=4)
    res1 = run_smc(jax.random.key(5), spec, img, prior, 1, cfg)
    assert len(jax.devices()) == 8, "conftest must fake 8 CPU devices"
    mesh = make_mesh("chains")
    res2 = run_smc(jax.random.key(5), spec, img, prior, 1, cfg, mesh=mesh)
    assert len(res2.theta.sharding.device_set) == 8
    np.testing.assert_allclose(
        np.asarray(res1.theta).mean(0), np.asarray(res2.theta).mean(0),
        rtol=1e-4, atol=1e-4,
    )
    np.testing.assert_allclose(float(res1.log_z), float(res2.log_z),
                               rtol=1e-3)
    assert res2.island_diag is not None


def test_island_smc_recovers_truth():
    """Island SMC (n_islands > 1) still targets the same posterior: the
    single-star flux posterior matches the truth, and the plan partitions
    ancestry (final beta = 1)."""
    spec, prior, img, (x, y, f) = _single_star_setup()
    cfg = SMCConfig(n_particles=512, mutation="hmc", n_mutation_steps=2,
                    n_leapfrog=5, n_islands=8)
    res = run_smc(jax.random.key(5), spec, img, prior, 1, cfg)
    assert float(res.beta) == 1.0
    flux = np.exp(np.asarray(res.theta)[:, 0, 2])
    assert abs(np.median(flux) - 300.0) / 300.0 < 0.15


def test_smc_relocate_sweeps_preserve_posterior():
    """Round-5 relocate sweeps in the SMC mutation phase: an exact MH
    kernel over the tempered target, so the posterior must match a
    relocation-free run within MC error, masks must be untouched by the
    relocate phase, and the run must stay finite."""
    spec = SceneSpec(16, 16, 1.5, 5.0)
    prior = PriorSpec(5.0, 1.0)
    x, y, f = jnp.array([5.0, 11.0]), jnp.array([6.0, 10.0]), jnp.array([250.0, 180.0])
    img = make_mock_image(jax.random.key(7), x, y, f, spec)
    base = SMCConfig(n_particles=256, n_mutation_steps=1, n_leapfrog=5,
                     mutation="hmc", n_final_rounds=4)

    r0 = run_smc(jax.random.key(1), spec, img, prior, 2, base)
    r1 = run_smc(jax.random.key(1), spec, img, prior, 2,
                 base._replace(n_relocate_sweeps=2))
    f0 = (np.exp(np.asarray(r0.theta)[..., 2]) * np.asarray(r0.mask)).sum(-1)
    f1 = (np.exp(np.asarray(r1.theta)[..., 2]) * np.asarray(r1.mask)).sum(-1)
    assert np.isfinite(np.asarray(r1.theta)).all()
    np.testing.assert_array_equal(np.asarray(r1.mask),
                                  np.ones_like(np.asarray(r1.mask)))
    # moment gate: same posterior within MC error of the two populations
    se = np.hypot(f0.std() / np.sqrt(50), f1.std() / np.sqrt(50))
    assert abs(f0.mean() - f1.mean()) < 4 * se, (f0.mean(), f1.mean())
