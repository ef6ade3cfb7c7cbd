#!/usr/bin/env python
"""Benchmark harness (SURVEY.md ⑲; BASELINE.json:2).  Needs a GPU: on any
other backend it exits non-zero without printing a result.

Prints ONE JSON line (always the LAST line of output):
  {"metric": "leapfrog_grad_evals_per_sec_per_chip", "value": N,
   "unit": "evals/s", "path": "...", "vs_baseline": R, "device": {...}}

The workload is the flagship 10-star 32x32 scene: vmapped chains timing
L-step leapfrog trajectories (the hot loop of every head — SURVEY.md §3.1
"HOTTEST"), scan-amortized.  The headline runs the path the samplers take
(api._select_kernel): the fused GPU leapfrog kernel where the scene fits it,
XLA otherwise.  vs_baseline is the speedup over the in-repo NumPy oracle's
gradient-evaluation rate on the same scene — the reference's
implementation technology (single-process CPU NumPy, BASELINE.json:7),
pinned so it does not drift run to run; re-measure with --retime-baseline.

`--full` also measures the XLA leapfrog, the diagonal-Riemannian XLA
trajectory, NUTS and ChEES ESS/sec, and the crowded field, as ONE JSON
document on the line before the headline.  Every JSON line names the
device it ran on.  Cells and metrics of the benchmark proper are not
defined here yet.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

# Pinned reference-technology baseline: oracle/numpy_sampler.OracleModel
# grad_potential on the config-2 scene, one CPU core, best of 5 x 2000
# evals (uncontended).
NUMPY_BASELINE_EVALS_PER_SEC = 7472.0


def device_info() -> dict:
    import jax

    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d)}


def _best_time(fn, repeats, *args):
    """Warm (compile) once, then the best of `repeats` synchronized runs."""
    import jax

    jax.block_until_ready(fn(*args))
    best = np.inf
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def _bench_setup(n_chains: int):
    import jax
    import jax.numpy as jnp
    from starcat.configs import CONFIGS

    cfg = CONFIGS["cfg2_nuts"]
    truth, img = cfg.make_data()
    mask = jnp.ones(cfg.kmax)
    theta0 = truth[None] + 0.01 * jax.random.normal(
        jax.random.key(0), (n_chains,) + truth.shape
    )
    p0 = jax.random.normal(jax.random.key(1), theta0.shape)
    inv_mass = jnp.ones(truth.shape)
    return cfg, truth, img, mask, theta0, p0, inv_mass


def bench_kernel_grad_evals(n_chains: int, n_leapfrog: int, n_scan: int, repeats: int):
    """The fused GPU leapfrog kernel (starcat/pallas_kernels.py)."""
    import jax
    from starcat.pallas_kernels import make_pallas_leapfrog

    import starcat

    cfg, truth, img, mask, theta0, p0, inv_mass = _bench_setup(n_chains)
    fused = make_pallas_leapfrog(cfg.scene, img, cfg.prior, cfg.kmax)
    pg = starcat.make_potential_and_grad(cfg.scene, img, cfg.prior)
    _, grad0 = jax.jit(jax.vmap(lambda th: pg(th, mask)))(theta0)

    @jax.jit
    def many(theta, p, grad):
        # The entry gradient is carried between trajectories (as in the HMC
        # chain state), so each fused call costs exactly n_leapfrog evals.
        def body(carry, _):
            th, pp, g = carry
            th, pp, _, g = fused(th, pp, 0.002, inv_mass, mask, n_leapfrog, g)
            return (th, pp, g), None

        return jax.lax.scan(body, (theta, p, grad), None, length=n_scan)[0]

    best = _best_time(many, repeats, theta0, p0, grad0)
    return n_chains * n_leapfrog * n_scan / best, best


def bench_xla_grad_evals(n_chains: int, n_leapfrog: int, n_scan: int, repeats: int):
    """The pure-XLA leapfrog path (float32 products pinned to "highest")."""
    import jax
    import jax.numpy as jnp
    import starcat
    from starcat.integrators import leapfrog

    cfg, truth, img, mask, theta0, p0, inv_mass = _bench_setup(n_chains)
    pg = starcat.make_potential_and_grad(cfg.scene, img, cfg.prior)
    grad_fn = lambda th: pg(th, mask)

    @jax.jit
    def many(theta, p):
        us, gs = jax.vmap(grad_fn)(theta)

        def body(carry, _):
            res = jax.vmap(
                lambda t, q, uu, gg: leapfrog(
                    grad_fn, t, q, uu, gg, jnp.asarray(0.002), n_leapfrog, inv_mass
                )
            )(*carry)
            return tuple(res), None

        return jax.lax.scan(body, (theta, p, us, gs), None, length=n_scan)[0][:2]

    best = _best_time(many, repeats, theta0, p0)
    return n_chains * n_leapfrog * n_scan / best, best


def _diag_riemannian_steps(cfg, img, mask, theta0, n_steps, fpi, n_scan,
                           repeats):
    """Scan-amortized diagonal-Fisher generalized-leapfrog steps/s (XLA
    autodiff, metric.make_diag_metric_fn)."""
    import jax
    import jax.numpy as jnp
    import starcat
    from starcat.integrators import riemannian_leapfrog
    from starcat.metric import make_diag_metric_fn
    from starcat.rhmc import make_rhmc_diag_functions

    n_chains = theta0.shape[0]
    pfn = starcat.make_potential(cfg.scene, img, cfg.prior)
    _, dhdt, dhdp = make_rhmc_diag_functions(
        pfn, make_diag_metric_fn(cfg.scene, cfg.prior))
    tf = theta0.reshape(n_chains, -1)
    pf = jax.random.normal(jax.random.key(7), tf.shape)

    @jax.jit
    def f(t, p):
        def one(t1, p1):
            return riemannian_leapfrog(
                lambda th, pp: dhdt(th, pp, mask),
                lambda th, pp: dhdp(th, pp, mask),
                t1, p1, jnp.asarray(0.02), n_steps, fpi,
            ).theta

        return jax.lax.scan(lambda tt, _: (jax.vmap(one)(tt, p), None), t,
                            None, length=n_scan)[0]

    best = _best_time(f, repeats, tf, pf)
    return n_chains * n_steps * n_scan / best


def bench_rhmc_diag_steps(n_chains: int = 1024, n_steps: int = 10,
                          fpi: int = 6, repeats: int = 3):
    """Diagonal-Fisher Riemannian steps/s at the config-1/2 shape."""
    cfg, truth, img, mask, theta0, p0, inv_mass = _bench_setup(n_chains)
    return _diag_riemannian_steps(cfg, img, mask, theta0, n_steps, fpi, 10,
                                  repeats)


def bench_rhmc_diag_crowded(n_chains: int = 256, repeats: int = 3):
    """cfg4's mutation workload (K=64, 128x128, cfg4 leapfrog/fpi) on the
    XLA diagonal-Fisher trajectory: Riemannian steps/s."""
    import jax
    import jax.numpy as jnp
    import starcat
    from starcat.configs import CONFIGS

    cfg = CONFIGS["cfg4_crowded"]
    truth, img = cfg.make_data()
    mask = jnp.concatenate(
        [jnp.ones(cfg.n_stars), jnp.zeros(cfg.kmax - cfg.n_stars)])
    theta0 = starcat.sample_prior(jax.random.key(5), cfg.kmax, cfg.prior)[None] \
        + 0.01 * jax.random.normal(jax.random.key(6), (n_chains, cfg.kmax, 3))
    return _diag_riemannian_steps(cfg, img, mask, theta0, cfg.smc.n_leapfrog,
                                  cfg.smc.fixed_point_iters, 5, repeats)


def bench_numpy_baseline(n_evals: int = 2000, repeats: int = 3):
    """Re-measure the reference-technology baseline (--retime-baseline)."""
    from starcat.configs import CONFIGS
    from oracle.numpy_sampler import OracleModel

    cfg = CONFIGS["cfg2_nuts"]
    truth, img = cfg.make_data()
    model = OracleModel(
        image=np.asarray(img, np.float64),
        height=cfg.scene.height,
        width=cfg.scene.width,
        psf_sigma=cfg.scene.psf_sigma,
        background=cfg.scene.background,
        logf_mean=cfg.prior.logf_mean,
        logf_sigma=cfg.prior.logf_sigma,
    )
    theta = np.asarray(truth, np.float64).reshape(-1)
    for _ in range(200):
        model.grad_potential(theta)
    best = np.inf
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(n_evals):
            model.grad_potential(theta)
        best = min(best, time.perf_counter() - t0)
    return n_evals / best


def bench_ess_per_sec(n_chains: int = 256, n_samples: int = 200, n_warmup: int = 300):
    """Secondary metric (BASELINE.json:2): NUTS ESS/sec on the 10-star
    32x32 scene (ESS of the permutation-invariant total flux, pooled
    across chains, divided by post-warmup wall time)."""
    import jax
    import starcat
    from starcat import diagnostics
    from starcat.driver import init_chain_states, sample as drv_sample, warmup
    from starcat.nuts import NUTSConfig, make_nuts_kernel

    cfg, truth, img, mask, theta0, p0, inv_mass = _bench_setup(n_chains)
    pg = starcat.make_potential_and_grad(cfg.scene, img, cfg.prior)
    grad_fn = lambda th: pg(th, mask)
    kernel = make_nuts_kernel(grad_fn, mask, NUTSConfig(step_size=0.05, max_depth=8))
    states = init_chain_states(jax.random.key(2), theta0, grad_fn)
    wr = warmup(states, kernel, n_warmup, step_size=0.05)
    r = drv_sample(wr.states, kernel, n_samples, wr.step_size, wr.inv_mass)
    jax.block_until_ready(r.thetas)
    t0 = time.perf_counter()
    r = drv_sample(r.final_states, kernel, n_samples, wr.step_size, wr.inv_mass)
    jax.block_until_ready(r.thetas)
    dt = time.perf_counter() - t0
    tot_flux = np.exp(np.asarray(r.thetas)[..., 2]).sum(-1)
    ess = diagnostics.ess(tot_flux)
    return ess / dt, ess, dt


def bench_ess_chees(n_chains: int = 256, n_samples: int = 200, n_warmup: int = 300):
    """ChEES ESS/sec on the same workload/protocol as bench_ess_per_sec,
    on the path the chees head takes (the fused kernel on a GPU)."""
    import jax
    import starcat
    from starcat import diagnostics
    from starcat.api import _select_kernel
    from starcat.chees import (ChEESConfig, chees_sample,
                               make_fused_leapfrog_impl, run_chees)
    from starcat.pallas_kernels import fused_supported

    cfg, truth, img, mask, theta0, p0, inv_mass = _bench_setup(n_chains)
    pg = starcat.make_potential_and_grad(cfg.scene, img, cfg.prior)
    grad_fn = lambda th: pg(th, mask)
    impl = None
    if _select_kernel("auto", fused_supported(cfg.scene, cfg.kmax)):
        impl = make_fused_leapfrog_impl(cfg.scene, img, cfg.prior, cfg.kmax)
    ccfg = ChEESConfig(step_size=0.05)
    # adapt (eps, mass, T) once, then time a sampling-only continuation —
    # the same protocol as the NUTS ESS bench (warmup excluded from timing)
    res, ad = run_chees(jax.random.key(2), grad_fn, theta0, mask,
                        n_samples, n_warmup, ccfg, leapfrog_impl=impl)
    args = (grad_fn, mask, n_samples, ad["step_size"], ad["inv_mass"],
            ad["traj_length"], ccfg, impl)
    r = chees_sample(res.final_states, *args)
    jax.block_until_ready(r.thetas)
    t0 = time.perf_counter()
    r = chees_sample(r.final_states, *args)
    jax.block_until_ready(r.thetas)
    dt = time.perf_counter() - t0
    tot_flux = np.exp(np.asarray(r.thetas)[..., 2]).sum(-1)
    ess = diagnostics.ess(tot_flux)
    return ess / dt, ess, dt, float(ad["traj_length"])


def bench_crowded_field(n_chains: int = 1024, n_leapfrog: int = 10,
                        n_scan: int = 10, repeats: int = 3):
    """Config-4 scene (50 stars, 128x128) leapfrog grad-evals/s on XLA —
    the crowded field does not fit the fused kernel's tiles."""
    import jax
    import jax.numpy as jnp
    import starcat
    from starcat.configs import CONFIGS
    from starcat.integrators import leapfrog

    cfg = CONFIGS["cfg4_crowded"]
    truth, img = cfg.make_data()
    mask = jnp.ones(cfg.n_stars)
    pg = starcat.make_potential_and_grad(cfg.scene, img, cfg.prior)
    grad_fn = lambda th: pg(th, mask)
    theta0 = truth[None] + 0.01 * jax.random.normal(
        jax.random.key(0), (n_chains,) + truth.shape
    )
    p0 = jax.random.normal(jax.random.key(1), theta0.shape)
    inv_mass = jnp.ones(truth.shape)

    @jax.jit
    def many(theta, p):
        us, gs = jax.vmap(grad_fn)(theta)

        def body(carry, _):
            res = jax.vmap(
                lambda t, q, uu, gg: leapfrog(
                    grad_fn, t, q, uu, gg, jnp.asarray(0.0005), n_leapfrog,
                    inv_mass)
            )(*carry)
            return tuple(res), None

        return jax.lax.scan(body, (theta, p, us, gs), None, length=n_scan)[0]

    return n_chains * n_leapfrog * n_scan / _best_time(many, repeats, theta0, p0)


def bench_cfg6_wall(order=("auto", "xla", "xla", "auto", "auto", "xla"),
                    n_warmup: int = 200, n_samples: int = 200) -> dict:
    """cfg6 through starcat.sample, kernel=auto (the fused kernel on a GPU)
    against kernel=xla, alternated in one process after one warm-up call
    per path: seconds per call with the trajectory length each call adapted
    (the trajectory cost scales with T / eps, which adaptation sets)."""
    from starcat.api import sample
    from starcat.configs import CONFIGS, apply_overrides

    cfgs = {k: apply_overrides(CONFIGS["cfg6_chees"],
                               {"kernel": k, "n_warmup": n_warmup,
                                "n_samples": n_samples})
            for k in set(order)}
    first = {}
    for k, cfg in cfgs.items():
        t0 = time.perf_counter()
        sample(cfg, seed=0)
        first[k] = time.perf_counter() - t0
    calls = []
    for k in order:
        t0 = time.perf_counter()
        out = sample(cfgs[k], seed=0)
        calls.append({"kernel": out.stats["kernel"],
                      "seconds": time.perf_counter() - t0,
                      "traj_length": out.stats["traj_length"],
                      "step_size": out.stats["step_size"]})
    return {"metric": "cfg6_sample_seconds", "n_warmup": n_warmup,
            "n_samples": n_samples, "first_call_s": first, "calls": calls}


def bench_cfg6_leg(order=("kernel", "xla", "xla", "kernel", "kernel", "xla"),
                   n_warmup: int = 200, n_samples: int = 200) -> dict:
    """cfg6's sampling leg (ChEES with relocation, 1024 chains) at ONE
    adapted (eps, mass, T) and one start state, on the fused kernel and on
    XLA alternately: both paths do the same number of gradient
    evaluations, so the ratio is the kernel's end-to-end effect after
    warmup."""
    import jax
    import jax.numpy as jnp
    import starcat
    from starcat.api import _init_chains
    from starcat.chees import (chees_sample, make_chees_relocate,
                               make_fused_leapfrog_impl, run_chees)
    from starcat.configs import CONFIGS

    cfg = CONFIGS["cfg6_chees"]
    truth, img = cfg.make_data()
    mask = jnp.ones(cfg.kmax)
    pg = starcat.make_potential_and_grad(cfg.scene, img, cfg.prior)
    grad_fn = lambda th: pg(th, mask)
    key = jax.random.key(0)
    reloc = make_chees_relocate(cfg.scene, img, cfg.prior)
    res, ad = run_chees(jax.random.fold_in(key, 1), grad_fn,
                        _init_chains(key, cfg, truth), mask, 10, n_warmup,
                        cfg.chees, relocate_fn=reloc)
    impls = {"kernel": make_fused_leapfrog_impl(cfg.scene, img, cfg.prior,
                                                cfg.kmax),
             "xla": None}

    def leg(name):
        r = chees_sample(res.final_states, grad_fn, mask, n_samples,
                         ad["step_size"], ad["inv_mass"], ad["traj_length"],
                         cfg.chees, impls[name], relocate_fn=reloc)
        jax.block_until_ready(r.thetas)
        return float(jnp.mean(r.accept_prob))

    for name in impls:
        leg(name)  # compile
    secs = {name: [] for name in impls}
    accept = {}
    for name in order:
        t0 = time.perf_counter()
        accept[name] = leg(name)
        secs[name].append(time.perf_counter() - t0)
    return {"metric": "cfg6_sampling_leg_seconds", "n_samples": n_samples,
            "step_size": float(ad["step_size"]),
            "traj_length": float(ad["traj_length"]), "seconds": secs,
            "accept": accept}


def bench_scaling(device_counts=None, n_chains: int = 1024,
                  n_samples: int = 100, n_leapfrog: int = 10,
                  verify: bool = False):
    """Turn-key multi-chip/multi-host scaling harness (VERDICT round-4
    item 5; BASELINE.json:5 "samples/s at 1 chip, 1 host and N hosts").

    Protocol (SURVEY.md §7.3 "multi-host jitter and benchmark honesty"):
    for each device count d, shard the chain axis of the flagship config-2
    HMC workload over a d-device mesh, synchronize every device with a
    psum-of-ones BARRIER, then time a fixed sampling scan end to end and
    report samples/s (= chains x draws / wall).  Efficiency is measured
    against the 1-device row's per-device rate, so a multi-host run's
    >=95% target (BASELINE.json:5) reads directly off the output.

    On one card the run emits the 1-device row; the same function runs on
    the fake 8-device CPU mesh
    (conftest/XLA_FLAGS trick) where `verify=True` additionally asserts
    the PLUMBING — per-device work (the sampled draws actually live on d
    devices) and collective counts (the pooled-warmup program contains
    cross-device all-reduces exactly when d > 1) — wall-clock numbers on
    the fake mesh are meaningless and not asserted.  On a multi-card host:
        python bench.py --scaling
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    import starcat
    from starcat.configs import CONFIGS
    from starcat.dist import make_mesh, shard_chains
    from starcat.driver import (
        _warmup_chunk, init_chain_states, sample as drv_sample,
    )
    from starcat.adapt import da_init, welford_init
    from starcat.hmc import HMCConfig, make_hmc_kernel

    cfg, truth, img, mask, _, _, _ = _bench_setup(max(n_chains, 128))
    pg = starcat.make_potential_and_grad(cfg.scene, img, cfg.prior)
    grad_fn = lambda th: pg(th, mask)
    kernel = make_hmc_kernel(
        grad_fn, mask, HMCConfig(step_size=0.02, n_leapfrog=n_leapfrog))

    n_avail = len(jax.devices())
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8, 16, 32, 64) if d <= n_avail]
    rows = []
    for d in device_counts:
        mesh = make_mesh("chains", n_devices=d)
        c = max(n_chains // d, 1) * d  # divisible chain count
        theta0 = truth[None] + 0.01 * jax.random.normal(
            jax.random.key(0), (c,) + truth.shape)
        theta0 = shard_chains(theta0, mesh)
        states = init_chain_states(jax.random.key(1), theta0, grad_fn)
        eps = jnp.asarray(0.02)
        inv_mass = jnp.ones(truth.shape, jnp.float32)

        if verify:
            # collective count: the pooled-warmup chunk (per-iteration
            # cross-chain mean feeding dual averaging) must lower to
            # cross-device all-reduces exactly when the mesh has > 1 device
            da = da_init(0.02)
            wf = welford_init(truth.shape)
            hlo = _warmup_chunk.lower(
                states, kernel, da, wf, inv_mass, jnp.zeros(()), 5, True,
                0.8, 0.0,
            ).compile().as_text()
            n_ar = hlo.count("all-reduce")
            assert (n_ar > 0) == (d > 1), (d, n_ar)

        # psum-of-ones barrier over the mesh: every device aligned before
        # the timer starts (SURVEY.md §7.3 benchmark honesty)
        ones = shard_chains(jnp.ones((d,), jnp.float32), mesh)
        barrier = jax.jit(jax.shard_map(
            lambda x: jax.lax.psum(jnp.sum(x), "chains"),
            mesh=mesh, in_specs=P("chains"), out_specs=P()))
        jax.block_until_ready(barrier(ones))

        # warm the sampling program, then barrier + time it
        r = drv_sample(states, kernel, n_samples, eps, inv_mass)
        jax.block_until_ready(r.thetas)
        jax.block_until_ready(barrier(ones))
        t0 = time.perf_counter()
        r = drv_sample(r.final_states, kernel, n_samples, eps, inv_mass)
        jax.block_until_ready(r.thetas)
        dt = time.perf_counter() - t0
        if verify:  # per-device work: the draws really live on d devices
            assert len(r.thetas.sharding.device_set) == d, r.thetas.sharding
        rows.append({
            "devices": d,
            "chains": c,
            "samples_per_sec": round(c * n_samples / dt, 1),
            "sec": round(dt, 4),
        })
    base = rows[0]["samples_per_sec"] / rows[0]["devices"]
    for row in rows:
        row["efficiency_vs_1dev"] = round(
            row["samples_per_sec"] / (base * row["devices"]), 4)
    return {
        "metric": "hmc_samples_per_sec_scaling",
        "unit": "chains*draws/s",
        "workload": f"cfg2 scene, {n_leapfrog}-leapfrog HMC, "
                    f"{n_samples} draws, barrier-synced",
        "device": device_info(),
        "points": rows,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--chains", type=int, default=32768)
    ap.add_argument("--leapfrog", type=int, default=20)
    ap.add_argument("--scan", type=int, default=50)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--scaling", action="store_true",
                    help="barrier-synchronized samples/s over 1..N-device "
                         "meshes (BASELINE.json:5 scaling points) and exit")
    ap.add_argument("--cfg6-wall", action="store_true",
                    help="cfg6 seconds, kernel=auto vs kernel=xla, through "
                         "sample() and on a fixed sampling leg, and exit")
    ap.add_argument("--retime-baseline", action="store_true",
                    help="re-measure the NumPy baseline instead of the pin")
    args = ap.parse_args()

    from starcat.runtime import configure_compile_cache

    configure_compile_cache()
    dev = device_info()
    if dev["platform"] != "gpu":
        raise SystemExit(f"bench.py measures the GPU; JAX found {dev}")
    if args.scaling:
        print(json.dumps(bench_scaling()))
        raise SystemExit(0)
    if args.cfg6_wall:
        print(json.dumps({"sample": bench_cfg6_wall(), "leg": bench_cfg6_leg(),
                          "device": dev}, default=float))
        raise SystemExit(0)

    from starcat.api import _select_kernel
    from starcat.configs import CONFIGS
    from starcat.pallas_kernels import fused_supported

    cfg = CONFIGS["cfg2_nuts"]
    on_kernel = _select_kernel("auto", fused_supported(cfg.scene, cfg.kmax))
    headline_fn = bench_kernel_grad_evals if on_kernel else bench_xla_grad_evals
    rate, best = headline_fn(args.chains, args.leapfrog, args.scan,
                             args.repeats)
    np_rate = (bench_numpy_baseline() if args.retime_baseline
               else NUMPY_BASELINE_EVALS_PER_SEC)

    if args.full:
        full = {
            "headline_evals_per_sec": round(rate, 1),
            "headline_best_ms": round(best * 1e3, 2),
            "chains": args.chains,
        }
        xla_rate, _ = bench_xla_grad_evals(args.chains, args.leapfrog,
                                           args.scan, args.repeats)
        full["xla_leapfrog_evals_per_sec"] = round(xla_rate, 1)
        if on_kernel:
            full["kernel_vs_xla"] = round(rate / xla_rate, 2)
            sweep = {}
            for c in (1024, 8192):
                r, _ = bench_kernel_grad_evals(c, args.leapfrog, args.scan, 2)
                sweep[str(c)] = round(r, 1)
            sweep[str(args.chains)] = round(rate, 1)
            full["kernel_chain_sweep_evals_per_sec"] = sweep
        full["rhmc_diag_steps_per_sec"] = round(
            bench_rhmc_diag_steps(min(args.chains, 1024)), 1)
        full["crowded_rhmc_diag_steps_per_sec"] = round(
            bench_rhmc_diag_crowded(), 1)
        ess_rate, ess, dt = bench_ess_per_sec()
        full["nuts_ess_per_sec"] = round(ess_rate, 1)
        full["nuts_ess"] = round(float(ess), 1)
        for n_chains, tag in ((256, ""), (1024, "_1024")):
            ch_rate, ch_ess, _, traj = bench_ess_chees(n_chains=n_chains)
            full["chees_ess_per_sec" + tag] = round(ch_rate, 1)
            full["chees_ess" + tag] = round(float(ch_ess), 1)
            full["chees_traj_length" + tag] = round(traj, 3)
        full["crowded_field_xla_evals_per_sec"] = round(bench_crowded_field(), 1)
        full["numpy_baseline_evals_per_sec"] = round(np_rate, 1)
        print(json.dumps({"bench_full": full, "device": dev}))

    print(json.dumps({
        "metric": "leapfrog_grad_evals_per_sec_per_chip",
        "value": round(rate, 1),
        "unit": "evals/s",
        "path": "pallas_triton_leapfrog" if on_kernel else "xla",
        "vs_baseline": round(rate / np_rate, 2),
        "device": dev,
    }))


if __name__ == "__main__":
    main()
