"""Runtime knob tests: the program-size limit
(runtime.max_program_steps / STARCAT_MAX_PROGRAM_STEPS) and the
compile-cache location rule (runtime.configure_compile_cache)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from starcat.runtime import cap_block, max_program_steps


def test_max_program_steps_env_override(monkeypatch):
    # unset: unlimited on CPU (this suite's backend)
    monkeypatch.delenv("STARCAT_MAX_PROGRAM_STEPS", raising=False)
    assert max_program_steps() is None
    # explicit cap
    monkeypatch.setenv("STARCAT_MAX_PROGRAM_STEPS", "40")
    assert max_program_steps() == 40
    # <= 0 means unlimited
    monkeypatch.setenv("STARCAT_MAX_PROGRAM_STEPS", "0")
    assert max_program_steps() is None
    monkeypatch.setenv("STARCAT_MAX_PROGRAM_STEPS", "-1")
    assert max_program_steps() is None


def test_cap_block(monkeypatch):
    monkeypatch.delenv("STARCAT_MAX_PROGRAM_STEPS", raising=False)
    assert cap_block(None, 500) == 500
    assert cap_block(250, 500) == 250
    monkeypatch.setenv("STARCAT_MAX_PROGRAM_STEPS", "100")
    assert cap_block(None, 500) == 100
    assert cap_block(250, 500) == 100
    assert cap_block(50, 500) == 50


def test_smc_routes_stepwise_under_cap(monkeypatch):
    """With a cap set, run_smc must take the stepwise host loop instead of
    the single-program
    smc_tempering pass — and produce the same result."""
    import starcat.smc as smc_mod
    from starcat.potential import PriorSpec
    from starcat.scene import SceneSpec, make_mock_image
    from starcat.smc import SMCConfig, run_smc

    spec = SceneSpec(16, 16, 1.5, 5.0)
    prior = PriorSpec(5.0, 1.0)
    img = make_mock_image(jax.random.key(7), jnp.array([8.3]),
                          jnp.array([7.6]), jnp.array([300.0]), spec)
    cfg = SMCConfig(n_particles=64, mutation="hmc", n_mutation_steps=1,
                    n_leapfrog=3)

    monkeypatch.delenv("STARCAT_MAX_PROGRAM_STEPS", raising=False)
    res_fused = run_smc(jax.random.key(5), spec, img, prior, 1, cfg)

    calls = {"tempering": 0}
    real = smc_mod.smc_tempering

    def spy(*a, **k):
        calls["tempering"] += 1
        return real(*a, **k)

    monkeypatch.setattr(smc_mod, "smc_tempering", spy)
    monkeypatch.setenv("STARCAT_MAX_PROGRAM_STEPS", "100")
    res_step = run_smc(jax.random.key(5), spec, img, prior, 1, cfg)
    assert calls["tempering"] == 0  # stepwise host loop, not the fused pass
    np.testing.assert_allclose(np.asarray(res_fused.theta).mean(0),
                               np.asarray(res_step.theta).mean(0),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(res_fused.log_z), float(res_step.log_z),
                               rtol=1e-3)


def test_warmup_block_respects_cap(monkeypatch):
    """run_mcmc's warmup chunks through cap_block: a 30-step phase-2 under
    a 7-step cap must compile chunks of at most 7 steps (sizes differing by
    at most 1 within a phase — ADVICE round-4)."""
    import starcat.driver as drv

    seen = []
    real = drv._warmup_chunk

    def spy(states, kernel, da, wf, inv_mass, acc, n_steps, *a, **k):
        seen.append(n_steps)
        return real(states, kernel, da, wf, inv_mass, acc, n_steps, *a, **k)

    monkeypatch.setattr(drv, "_warmup_chunk", spy)
    monkeypatch.setenv("STARCAT_MAX_PROGRAM_STEPS", "7")

    from starcat.driver import run_mcmc
    from starcat.hmc import HMCConfig, make_hmc_kernel

    def gf(theta):
        return 0.5 * jnp.sum(theta * theta), theta

    theta0 = 0.1 * jax.random.normal(jax.random.key(0), (8, 1, 3))
    kernel = make_hmc_kernel(gf, jnp.ones(1), HMCConfig(step_size=0.2,
                                                        n_leapfrog=3))
    run_mcmc(jax.random.key(1), kernel, gf, theta0, n_samples=4, n_warmup=50)
    assert seen and max(seen) <= 7
    # per-phase chunk sizes differ by at most 1 (phases are 7/30/13 steps)
    assert set(seen) <= {7, 6, 5, 4}


def test_compile_cache_dir_rule(monkeypatch):
    """JAX_COMPILATION_CACHE_DIR set: nothing is set in code.  Unset: a
    fixed .jax_cache/ at the checkout root (no pid, time or temp name)."""
    import os

    from starcat import runtime

    calls = []
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.append((k, v)))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    assert runtime.configure_compile_cache() == "/elsewhere/cache"
    assert calls == []

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    first = runtime.configure_compile_cache()
    assert first == runtime.configure_compile_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert first == os.path.join(repo, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", first)] * 2
