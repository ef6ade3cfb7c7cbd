"""Fused GPU leapfrog kernel tests (Pallas interpreter on the CPU at small
shapes; the compiled kernel is compared with the XLA path on the card by
chip_smoke.py and the gpu-marked test)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import starcat
from starcat.integrators import leapfrog
from starcat.pallas_kernels import fused_supported, make_pallas_leapfrog
from starcat.potential import PriorSpec, make_potential_and_grad, sample_prior
from starcat.scene import SceneSpec, make_mock_image

PRIOR = PriorSpec(4.0, 0.8)


def _setup(spec=SceneSpec(12, 20, 1.5, 6.0), k=5, c=6):
    """Scene and chains; K, C, H and W are not powers of two (padding)."""
    truth = sample_prior(jax.random.key(0), k, PRIOR)
    x, y, f = starcat.constrain(truth, spec)
    img = make_mock_image(jax.random.key(1), x, y, f, spec)
    pg = make_potential_and_grad(spec, img, PRIOR)
    theta = truth[None] + 0.05 * jax.random.normal(jax.random.key(2), (c, k, 3))
    p = jax.random.normal(jax.random.key(3), theta.shape)
    return spec, img, pg, theta, p


def _xla(pg, theta, p, eps, inv_mass, masks, n):
    """Per-chain XLA leapfrog (each chain with its own mask and eps)."""
    def one(t, q, m, e):
        u0, g0 = pg(t, m)
        return leapfrog(lambda th: pg(th, m), t, q, u0, g0, e, n, inv_mass)

    return jax.vmap(one)(theta, p, masks, eps)


def _entry_grad(pg, theta, masks):
    return jax.vmap(pg)(theta, masks)[1]


def _assert_close(out, ref):
    th, p, u, g = (np.asarray(a) for a in out)
    np.testing.assert_allclose(th, np.asarray(ref.theta), atol=3e-4)
    np.testing.assert_allclose(p, np.asarray(ref.p), atol=5e-3)
    np.testing.assert_allclose(u, np.asarray(ref.u), atol=0.3)
    rel = np.abs(g - np.asarray(ref.grad)) / (1.0 + np.abs(np.asarray(ref.grad)))
    assert rel.max() < 5e-3, rel.max()


@pytest.mark.parametrize("spec,k,c", [
    (SceneSpec(12, 20, 1.5, 6.0), 5, 6),
    (SceneSpec(16, 16, 1.2, 4.0), 16, 3),
    (SceneSpec(9, 33, 1.8, 8.0), 1, 1),
])
def test_fused_leapfrog_matches_xla_path(spec, k, c):
    """Kernel == XLA leapfrog for K, C, H and W that need padding."""
    spec, img, pg, theta, p = _setup(spec, k, c)
    mask = jnp.ones(k)
    masks = jnp.broadcast_to(mask, (c, k))
    inv_mass = jnp.full((k, 3), 0.7)
    fused = make_pallas_leapfrog(spec, img, PRIOR, k, interpret=True)
    out = fused(theta, p, 0.01, inv_mass, mask, 4,
                _entry_grad(pg, theta, masks))
    _assert_close(out, _xla(pg, theta, p, jnp.full((c,), 0.01), inv_mass,
                            masks, 4))


def test_fused_leapfrog_per_chain_eps():
    """A per-chain eps vector must match the per-chain XLA runs."""
    spec, img, pg, theta, p = _setup()
    c, k = theta.shape[:2]
    masks = jnp.ones((c, k))
    inv_mass = jnp.ones((k, 3))
    eps = jnp.linspace(0.002, 0.02, c)
    fused = make_pallas_leapfrog(spec, img, PRIOR, k, interpret=True)
    out = fused(theta, p, eps, inv_mass, jnp.ones(k), 3,
                _entry_grad(pg, theta, masks))
    _assert_close(out, _xla(pg, theta, p, eps, inv_mass, masks, 3))


def test_fused_leapfrog_per_chain_masks():
    """(C, K) per-chain masks: each chain matches its own XLA run, and dead
    slots stay frozen with exactly zero gradient."""
    spec, img, pg, theta, p = _setup()
    c, k = theta.shape[:2]
    masks = (jax.random.uniform(jax.random.key(5), (c, k)) > 0.4
             ).astype(jnp.float32)
    p = p * masks[..., None]  # masked momenta, as the HMC kernel does
    inv_mass = jnp.ones((k, 3))
    fused = make_pallas_leapfrog(spec, img, PRIOR, k, interpret=True)
    out = fused(theta, p, 0.01, inv_mass, masks, 3,
                _entry_grad(pg, theta, masks))
    _assert_close(out, _xla(pg, theta, p, jnp.full((c,), 0.01), inv_mass,
                            masks, 3))
    dead = np.asarray(masks) == 0.0
    np.testing.assert_array_equal(np.asarray(out[0])[dead],
                                  np.asarray(theta)[dead])
    np.testing.assert_array_equal(np.asarray(out[3])[dead], 0.0)


def test_fused_leapfrog_mask_freezes():
    spec, img, pg, theta, p = _setup()
    k = theta.shape[1]
    inv_mass = jnp.ones((k, 3))
    mask2 = jnp.ones(k).at[3].set(0.0)
    p = p * mask2[None, :, None]  # masked momenta, as the HMC kernel does
    fused = make_pallas_leapfrog(spec, img, PRIOR, k, interpret=True)
    g0 = jax.vmap(lambda t: pg(t, mask2))(theta)[1]
    th2, p2, u2, g2 = fused(theta, p, 0.002, inv_mass, mask2, 4, g0)
    np.testing.assert_array_equal(np.asarray(th2)[:, 3, :], np.asarray(theta)[:, 3, :])
    np.testing.assert_array_equal(np.asarray(g2)[:, 3, :], 0.0)


def test_zero_steps_returns_potential():
    """One step at eps = 0 leaves theta in place and returns the kernel's
    own U and gradient there: the in-kernel evaluator against the XLA one."""
    spec, img, pg, theta, p = _setup()
    k = theta.shape[1]
    mask = jnp.ones(k)
    fused = make_pallas_leapfrog(spec, img, PRIOR, k, interpret=True)
    uref, gref = jax.vmap(lambda t: pg(t, mask))(theta)
    th2, p2, u2, g2 = fused(theta, p, 0.0, jnp.ones((k, 3)), mask, 1,
                            jnp.zeros_like(theta))
    np.testing.assert_array_equal(np.asarray(th2), np.asarray(theta))
    np.testing.assert_allclose(np.asarray(u2), np.asarray(uref), atol=0.3)
    np.testing.assert_allclose(np.asarray(g2), np.asarray(gref), rtol=1e-3, atol=2e-2)


def test_fused_leapfrog_dyn_matches_static():
    """A traced trip count under jit gives the same trajectory as the
    Python-integer one, for every n in 1..4 (one compiled kernel serves all
    lengths), and each matches the XLA leapfrog of that length."""
    spec, img, pg, theta, p = _setup()
    c, k = theta.shape[:2]
    mask = jnp.ones(k)
    masks = jnp.broadcast_to(mask, (c, k))
    inv_mass = jnp.full((k, 3), 0.9)
    g0 = _entry_grad(pg, theta, masks)
    fused = make_pallas_leapfrog(spec, img, PRIOR, k, interpret=True)
    dyn = jax.jit(lambda n: fused(theta, p, 0.01, inv_mass, mask, n, g0))
    for n in range(1, 5):
        out_d = dyn(jnp.asarray(n))
        out_s = fused(theta, p, 0.01, inv_mass, mask, n, g0)
        for a, b in zip(out_s, out_d):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-6, atol=1e-5)
        _assert_close(out_d, _xla(pg, theta, p, jnp.full((c,), 0.01),
                                  inv_mass, masks, n))


def test_fused_supported_bounds():
    """Small scenes fit the kernel's tiles; the crowded field does not."""
    assert fused_supported(SceneSpec(32, 32, 1.5, 10.0), 10)
    assert fused_supported(SceneSpec(16, 16, 1.5, 5.0), 1)
    assert not fused_supported(SceneSpec(128, 128, 1.5, 20.0), 64)
    assert not fused_supported(SceneSpec(32, 32, 1.5, 10.0), 64)


def test_pallas_hmc_kernel_sharded_matches_single_device():
    """shard_map-wrapped fused HMC kernel on the fake 8-device mesh must
    reproduce the unsharded kernel (same keys -> same transition)."""
    from starcat.dist import make_mesh, shard_chains
    from starcat.driver import init_chain_states
    from starcat.hmc import HMCConfig, make_pallas_hmc_kernel

    spec, img, pg, theta, p = _setup(c=16)
    mask = jnp.ones(theta.shape[1])
    grad_fn = lambda th: pg(th, mask)
    hcfg = HMCConfig(step_size=0.02, n_leapfrog=3)
    mesh = make_mesh()
    inv_mass = jnp.ones(theta.shape[1:])

    states = init_chain_states(jax.random.key(11), theta, grad_fn)
    k_single = make_pallas_hmc_kernel(spec, img, PRIOR, mask, hcfg,
                                      interpret=True)
    k_shard = make_pallas_hmc_kernel(spec, img, PRIOR, mask, hcfg,
                                     interpret=True, mesh=mesh)
    out_a, info_a = k_single(states, jnp.asarray(0.02), inv_mass)
    out_b, info_b = k_shard(shard_chains(states, mesh), jnp.asarray(0.02),
                            inv_mass)
    assert len(out_b.theta.sharding.device_set) == len(mesh.devices.flat)
    np.testing.assert_allclose(np.asarray(out_a.theta), np.asarray(out_b.theta),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(info_a.accept_prob),
                               np.asarray(info_b.accept_prob), atol=1e-5)


@pytest.mark.gpu
def test_pallas_hmc_matches_hmc_gpu():
    """Statistical agreement of the kernel-HMC head with the XLA head; only
    meaningful on a GPU (the interpreter is too slow for sampling)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: the compiled Triton kernel has no CPU "
                    "lowering (chip_smoke.py runs this comparison on the card)")
    from starcat import diagnostics
    from starcat.configs import CONFIGS
    from starcat.hmc import HMCConfig, run_hmc, run_hmc_pallas

    cfg = CONFIGS["cfg6_chees"]
    truth, img = cfg.make_data()
    mask = jnp.ones(cfg.kmax)
    pg = make_potential_and_grad(cfg.scene, img, cfg.prior)
    grad_fn = lambda th: pg(th, mask)
    theta0 = truth[None] + 0.02 * jax.random.normal(jax.random.key(0),
                                                     (128,) + truth.shape)
    hcfg = HMCConfig(step_size=0.02, n_leapfrog=10)
    res_x, _ = run_hmc(jax.random.key(4), grad_fn, theta0, mask, 300, 300, hcfg)
    res_p, _ = run_hmc_pallas(jax.random.key(5), cfg.scene, img, cfg.prior,
                              theta0, mask, 300, 300, hcfg)
    tot_x = np.exp(np.asarray(res_x.thetas)[..., 2]).sum(-1)
    tot_p = np.exp(np.asarray(res_p.thetas)[..., 2]).sum(-1)
    cmp = diagnostics.compare_moments(tot_p, tot_x, "total_flux")
    assert cmp["z"] < 4.5, cmp
