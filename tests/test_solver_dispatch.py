"""Round-4 additions (VERDICT round-3 items 4 & 5):

1. Implicit-solver failure detection: the generalized leapfrog reports the
   final Picard-sweep residual; rhmc_step force-rejects non-converged
   transitions (solver_fail), the driver surfaces them separately from
   Delta-H divergences, and a divergence-penalized dual averaging drives
   the adapted step size down until failures are rare.
2. Kernel dispatch: RunConfig.kernel = auto|pallas|xla resolves to the
   fused GPU leapfrog kernel or the XLA path (api._select_kernel).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import starcat
from starcat.api import _select_kernel
from starcat.integrators import riemannian_leapfrog
from starcat.metric import make_metric_fn
from starcat.potential import PriorSpec, make_potential, make_potential_and_grad, sample_prior
from starcat.rhmc import RHMCConfig, make_rhmc_functions, rhmc_step, run_rhmc
from starcat.scene import SceneSpec, make_mock_image

SPEC = SceneSpec(16, 16, 1.5, 5.0)
PRIOR = PriorSpec(4.0, 1.0)


def _setup(k=3):
    truth = sample_prior(jax.random.key(0), k, PRIOR)
    x, y, f = starcat.constrain(truth, SPEC)
    img = make_mock_image(jax.random.key(1), x, y, f, SPEC)
    return truth, img


def test_riemannian_leapfrog_reports_residual():
    """Small eps: the Picard iteration contracts and the reported residual
    is small.  Huge eps: the fixed point diverges and the residual blows
    past any reasonable solver_tol."""
    truth, img = _setup()
    mask = jnp.ones(3)
    pfn = make_potential(SPEC, img, PRIOR)
    metric = make_metric_fn(SPEC, PRIOR)
    ham, dhdt, dhdp = make_rhmc_functions(pfn, metric)
    th0 = truth.reshape(-1)
    p0 = 0.1 * jnp.ones_like(th0)
    dt = lambda t, p: dhdt(t, p, mask)
    dp = lambda t, p: dhdp(t, p, mask)

    res_small = riemannian_leapfrog(dt, dp, th0, p0, jnp.asarray(0.01), 3, 6)
    assert float(res_small.solver_resid) < 0.05
    assert np.all(np.isfinite(np.asarray(res_small.theta)))

    res_big = riemannian_leapfrog(dt, dp, th0, p0, jnp.asarray(50.0), 3, 6)
    assert not (float(res_big.solver_resid) < 0.05)  # NaN or large


def test_rhmc_step_solver_fail_forces_rejection():
    """A transition whose solver residual exceeds solver_tol must have
    accept_prob == 0 and solver_fail True; a converged one must not."""
    truth, img = _setup()
    mask = jnp.ones(3)
    pfn = make_potential(SPEC, img, PRIOR)
    pg = make_potential_and_grad(SPEC, img, PRIOR)
    metric = make_metric_fn(SPEC, PRIOR)
    ham, dhdt, dhdp = make_rhmc_functions(pfn, metric)
    from starcat.driver import ChainState

    u0, g0 = pg(truth, mask)
    st = ChainState(truth, u0, g0, jax.random.key(3))

    _, info_ok = rhmc_step(st, pfn, metric, ham, dhdt, dhdp,
                           jnp.asarray(0.02), 3, 6, mask, solver_tol=0.05)
    assert not bool(info_ok.solver_fail)

    _, info_bad = rhmc_step(st, pfn, metric, ham, dhdt, dhdp,
                            jnp.asarray(50.0), 3, 6, mask, solver_tol=0.05)
    assert bool(info_bad.solver_fail)
    assert float(info_bad.accept_prob) == 0.0


def test_run_rhmc_surfaces_solver_rejections():
    """The driver carries solver_fail through sampling and the divergence-
    penalized dual averaging keeps the adapted step below the failure
    regime (solver failures rare at the adapted eps)."""
    truth, img = _setup()
    mask = jnp.ones(3)
    pfn = make_potential(SPEC, img, PRIOR)
    pg = make_potential_and_grad(SPEC, img, PRIOR)
    metric = make_metric_fn(SPEC, PRIOR)
    grad_fn = lambda th: pg(th, mask)
    theta0 = truth[None] + 0.01 * jax.random.normal(jax.random.key(4), (8, 3, 3))
    cfg = RHMCConfig(step_size=0.3, n_leapfrog=4, fixed_point_iters=5)
    res, wr = run_rhmc(jax.random.key(5), pfn, metric, grad_fn, theta0, mask,
                       n_samples=50, n_warmup=100, config=cfg)
    assert res.solver_fail is not None
    assert res.solver_fail.shape == res.diverged.shape
    frac = float(np.asarray(res.solver_fail).mean())
    assert frac < 0.05, f"solver failures not controlled: {frac}"


def test_select_kernel_cost_model(monkeypatch):
    """auto: the kernel exactly on a GPU with a feasible scene; xla: never;
    pallas: only where it can run, else an error (no silent substitute)."""
    with pytest.raises(ValueError):
        _select_kernel("nope", True)
    # this suite's CPU backend: auto and xla take XLA, pallas refuses
    assert not _select_kernel("auto", True)
    assert not _select_kernel("xla", True)
    with pytest.raises(ValueError, match="needs a GPU"):
        _select_kernel("pallas", True)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert _select_kernel("auto", True)
    assert not _select_kernel("auto", False)
    assert not _select_kernel("xla", True)
    assert _select_kernel("pallas", True)
    with pytest.raises(ValueError):
        _select_kernel("pallas", False)  # e.g. the crowded field


@pytest.mark.parametrize("backend,pref,head,expect", [
    ("gpu", "auto", "chees", "pallas_triton_leapfrog"),
    ("gpu", "xla", "chees", "xla"),
    ("cpu", "auto", "chees", "xla"),
    ("gpu", "auto", "hmc", "pallas_triton_leapfrog"),
    ("cpu", "auto", "hmc", "xla"),
    ("gpu", "auto", "rhmc", "xla"),
    ("cpu", "pallas", "chees", ValueError),
    ("gpu", "pallas", "rhmc", ValueError),
])
def test_sample_kernel_dispatch(monkeypatch, backend, pref, head, expect):
    """sample() hands each head to the kernel path exactly where the
    decision says so.  The backend is faked and the run stubbed at the head
    driver, so the decision is tested without a GPU."""
    import dataclasses

    import starcat.api as api
    import starcat.chees as chees_mod
    import starcat.hmc as hmc_mod
    from starcat.api import sample
    from starcat.configs import CONFIGS

    seen = {}

    class Stop(Exception):
        pass

    def stub(name):
        def run(*a, **k):
            seen["ran"] = name
            seen["impl"] = k.get("leapfrog_impl")
            raise Stop

        return run

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    monkeypatch.setattr(api, "run_hmc", stub("xla"))
    monkeypatch.setattr(hmc_mod, "run_hmc_pallas", stub("pallas"))
    monkeypatch.setattr(chees_mod, "run_chees", stub("chees"))
    monkeypatch.setattr(api, "run_rhmc", stub("xla"))
    cfg = dataclasses.replace(CONFIGS["cfg6_chees"], head=head, kernel=pref,
                              n_chains=4, n_samples=2, n_warmup=2)
    if expect is ValueError:
        with pytest.raises(ValueError):
            sample(cfg)
        return
    with pytest.raises(Stop):
        sample(cfg)
    on_kernel = expect != "xla"
    if head == "chees":
        assert (seen["impl"] is not None) == on_kernel
    elif head == "hmc":
        assert seen["ran"] == ("pallas" if on_kernel else "xla")
    else:
        assert seen["ran"] == "xla"


def test_transdim_head_reports_solver_rejections():
    """cfg5's head: solver_fail flows through TDInfo/TDSampleResult into
    the api stats."""
    import dataclasses

    from starcat.api import sample
    from starcat.configs import CONFIGS

    cfg = dataclasses.replace(
        CONFIGS["cfg5_transdim_mcmc"], n_chains=8, n_samples=20, n_warmup=20,
        scene=SPEC, n_stars=2, kmax=3,
    )
    out = sample(cfg, seed=0)
    assert "solver_rejections" in out.stats
    assert out.stats["solver_rejections"] >= 0
