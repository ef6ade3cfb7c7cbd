"""HMC head tests (SURVEY.md §4.2): leapfrog reversibility/energy error,
exactness on a tractable Gaussian target, dead-slot freezing, and the
config-0 oracle integration test (SURVEY.md §3.6 validate())."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import starcat
from starcat import diagnostics
from starcat.hmc import HMCConfig, init_chain_state, run_hmc
from starcat.integrators import leapfrog
from starcat.potential import PriorSpec, constrain, sample_prior, unconstrain
from starcat.scene import SceneSpec, make_mock_image


def _gaussian_grad_fn(mu, sigma):
    def grad_fn(theta):
        z = (theta - mu) / sigma
        u = 0.5 * jnp.sum(z * z)
        return u, z / sigma
    return grad_fn


def test_leapfrog_reversibility_and_energy():
    """Run forward then backward with negated momentum -> back to start;
    energy error O(eps^2)."""
    mu = jnp.zeros((2, 3))
    sigma = jnp.ones((2, 3))
    gf = _gaussian_grad_fn(mu, sigma)
    theta0 = jnp.array([[0.3, -0.5, 1.0], [0.1, 0.2, -0.7]])
    p0 = jnp.array([[1.0, -0.2, 0.4], [-0.3, 0.8, 0.1]])
    u0, g0 = gf(theta0)
    inv_m = jnp.ones_like(theta0)

    for eps, tol in [(0.1, 1e-2), (0.05, 2.5e-3)]:
        fwd = leapfrog(gf, theta0, p0, u0, g0, eps, 20, inv_m)
        h0 = float(u0 + 0.5 * jnp.sum(p0 * p0))
        h1 = float(fwd.u + 0.5 * jnp.sum(fwd.p * fwd.p))
        assert abs(h1 - h0) < tol  # O(eps^2) energy error

        u1, g1 = gf(fwd.theta)
        back = leapfrog(gf, fwd.theta, -fwd.p, u1, g1, eps, 20, inv_m)
        np.testing.assert_allclose(np.asarray(back.theta), np.asarray(theta0), atol=1e-4)


def test_hmc_exact_on_gaussian():
    """Sample a known diagonal Gaussian; moments match within MC error."""
    mu = jnp.array([[1.0, -2.0, 0.5]])
    sigma = jnp.array([[0.5, 2.0, 1.0]])
    gf = _gaussian_grad_fn(mu, sigma)
    n_chains, n_samples = 16, 1000
    theta0 = mu + 0.1 * jax.random.normal(jax.random.key(0), (n_chains, 1, 3))
    res, wr = run_hmc(
        jax.random.key(1), gf, theta0, jnp.ones(1), n_samples, 500,
        HMCConfig(step_size=0.2, n_leapfrog=10),
    )
    draws = np.asarray(res.thetas)  # (C, N, 1, 3)
    assert np.asarray(res.accept_prob).mean() > 0.5
    for j in range(3):
        ch = draws[:, :, 0, j]
        s = diagnostics.summarize(ch)
        z_mean = abs(s["mean"] - float(mu[0, j])) / s["mcse"]
        assert z_mean < 4.5, (j, s)
        # sd correct to 10%
        assert abs(s["sd"] - float(sigma[0, j])) / float(sigma[0, j]) < 0.1
        assert s["rhat"] < 1.05


def test_hmc_dead_slots_frozen():
    """Dead catalog slots must not move during sampling."""
    spec = SceneSpec(16, 16, 1.5, 5.0)
    prior = PriorSpec(4.0, 1.0)
    img = make_mock_image(
        jax.random.key(0), jnp.array([8.0]), jnp.array([8.0]), jnp.array([100.0]), spec
    )
    pg = starcat.make_potential_and_grad(spec, img, prior)
    gf = lambda th: pg(th, jnp.array([1.0, 0.0]))
    theta0 = jnp.tile(sample_prior(jax.random.key(1), 2, prior)[None], (4, 1, 1))
    res, _ = run_hmc(
        jax.random.key(2), gf, theta0, jnp.array([1.0, 0.0]), 50, 50,
        HMCConfig(step_size=0.05, n_leapfrog=5),
    )
    draws = np.asarray(res.thetas)  # (4, 50, 2, 3)
    # dead slot (index 1) identical to its initial value in every draw
    np.testing.assert_array_equal(
        draws[:, :, 1, :], np.broadcast_to(np.asarray(theta0)[:, None, 1, :], draws[:, :, 1, :].shape)
    )
    # alive slot moved
    assert np.std(draws[:, :, 0, 2]) > 0


def test_config0_matches_oracle():
    """Config 0 (BASELINE.json:7): JAX HMC vs NumPy oracle on the single-star
    scene — flux/position posterior moments within MC error."""
    from oracle.numpy_sampler import run_oracle

    spec = SceneSpec(16, 16, 1.5, 5.0)
    prior = PriorSpec(logf_mean=5.0, logf_sigma=1.0)
    x_t, y_t, f_t = jnp.array([8.3]), jnp.array([7.6]), jnp.array([300.0])
    img = make_mock_image(jax.random.key(7), x_t, y_t, f_t, spec)
    theta_t = unconstrain(x_t, y_t, f_t, spec)

    # oracle: 4 chains on CPU (the reference call stack, SURVEY.md §3.1)
    orc = run_oracle(
        np.asarray(img), 1.5, 5.0, 5.0, 1.0, n_chains=4, n_samples=1200,
        n_warmup=400, step_size=0.05, n_leapfrog=15, seed=1,
        theta0=np.asarray(theta_t),
    )

    # JAX head: same scene, same priors, more chains
    pg = starcat.make_potential_and_grad(spec, img, prior)
    gf = lambda th: pg(th, jnp.ones(1))
    n_chains = 16
    theta0 = theta_t[None] + 0.01 * jax.random.normal(
        jax.random.key(3), (n_chains, 1, 3)
    )
    res, wr = run_hmc(
        jax.random.key(4), gf, theta0, jnp.ones(1), 1000, 500,
        HMCConfig(step_size=0.05, n_leapfrog=15),
    )
    draws = np.asarray(res.thetas)[:, :, 0, :]  # (C, N, 3) unconstrained

    orc_draws = orc["samples"].reshape(4, -1, 3)  # unconstrained
    for j, name in enumerate(["ux", "uy", "s"]):
        cmp = diagnostics.compare_moments(draws[:, :, j], orc_draws[:, :, j], name)
        assert cmp["z"] < 4.0, cmp

    # and in constrained space on the physical quantities
    x_jax = spec.width / (1 + np.exp(-draws[:, :, 0]))
    f_jax = np.exp(draws[:, :, 2])
    x_orc = orc["x"].reshape(4, -1)
    f_orc = orc["flux"].reshape(4, -1)
    assert diagnostics.compare_moments(x_jax, x_orc)["z"] < 4.0
    assert diagnostics.compare_moments(f_jax, f_orc)["z"] < 4.0


@pytest.mark.slow
def test_thinning_matches_unthinned_subsample():
    """thin=k records exactly every k-th state of the unthinned chain
    (same kernel stream; per-chain keys live in ChainState)."""
    import starcat
    from starcat.hmc import HMCConfig, run_hmc
    from starcat.potential import PriorSpec, make_potential_and_grad, sample_prior
    from starcat.scene import SceneSpec, make_mock_image

    spec = SceneSpec(12, 12, 1.5, 4.0)
    prior = PriorSpec(3.5, 0.6)
    truth = sample_prior(jax.random.key(0), 1, prior)
    x, y, f = starcat.constrain(truth, spec)
    img = make_mock_image(jax.random.key(1), x, y, f, spec)
    pg = make_potential_and_grad(spec, img, prior)
    gf = lambda th: pg(th, jnp.ones(1))
    theta0 = truth[None] + 0.01 * jax.random.normal(jax.random.key(2), (4, 1, 3))
    kw = dict(config=HMCConfig(step_size=0.05, n_leapfrog=5))

    res_a, _ = run_hmc(jax.random.key(3), gf, theta0, jnp.ones(1), 15, 10, **kw)
    res_b, _ = run_hmc(jax.random.key(3), gf, theta0, jnp.ones(1), 5, 10,
                       thin=3, **kw)
    np.testing.assert_array_equal(
        np.asarray(res_a.thetas)[:, 2::3], np.asarray(res_b.thetas)
    )


def test_warmup_blocked_equals_warmup():
    """warmup_blocked (chunked jit programs, the capped-program routing) is
    bitwise-identical to the one-program warmup: a scan split at chunk
    boundaries runs the same op sequence."""
    from starcat.driver import init_chain_states, warmup, warmup_blocked
    from starcat.hmc import HMCConfig, make_hmc_kernel

    sigma = jnp.array([[0.5, 1.0, 2.0]])

    def gf(theta):
        z = theta / sigma
        return 0.5 * jnp.sum(z * z), z / sigma

    theta0 = 0.5 * jax.random.normal(jax.random.key(0), (8, 2, 3))
    mask = jnp.ones(2)
    kern = make_hmc_kernel(gf, mask, HMCConfig(step_size=0.2, n_leapfrog=5))
    states = init_chain_states(jax.random.key(1), theta0, gf)

    wr_a = warmup(states, kern, 57, step_size=0.2, divergence_penalty=1.0)
    wr_b = warmup_blocked(states, kern, 57, step_size=0.2,
                          divergence_penalty=1.0, block=10)
    np.testing.assert_array_equal(np.asarray(wr_a.states.theta),
                                  np.asarray(wr_b.states.theta))
    assert float(wr_a.step_size) == float(wr_b.step_size)
    np.testing.assert_array_equal(np.asarray(wr_a.inv_mass),
                                  np.asarray(wr_b.inv_mass))
    np.testing.assert_array_equal(np.asarray(wr_a.phase_accept),
                                  np.asarray(wr_b.phase_accept))
