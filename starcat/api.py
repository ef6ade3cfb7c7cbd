"""High-level API (SURVEY.md §1.2 "API / drivers"): one entry point that
builds the scene/potential and dispatches to any head by name — the
`sample(cfg)` surface of the target design (SURVEY.md §3.3).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from . import diagnostics
from .advi import fit_advi
from .configs import RunConfig
from .hmc import run_hmc
from .metric import make_metric_fn
from .nuts import run_nuts
from .potential import (
    constrain,
    make_potential,
    make_potential_and_grad,
    sample_prior,
)
from .rhmc import run_rhmc
from .smc import run_smc


KERNEL_NAME = "pallas_triton_leapfrog"


def _select_kernel(pref: str, feasible: bool) -> bool:
    """Resolve RunConfig.kernel: does the fused GPU leapfrog kernel run?

    auto: on a GPU when the head has a kernel and the scene fits it; XLA
    everywhere else.  xla: never.  pallas: always — where it cannot run
    (no GPU, or a head/scene the kernel does not cover) this raises rather
    than quietly substituting the XLA path."""
    if pref not in ("auto", "pallas", "xla"):
        raise ValueError(f"kernel must be 'auto'|'pallas'|'xla', got {pref!r}")
    on_gpu = jax.default_backend() == "gpu"
    if pref == "pallas" and not (on_gpu and feasible):
        raise ValueError(
            "kernel='pallas' needs a GPU backend and a head/scene the fused "
            f"leapfrog kernel covers (backend={jax.default_backend()!r}, "
            f"feasible={feasible}); use kernel='auto' or 'xla'"
        )
    return pref != "xla" and on_gpu and feasible


@dataclass
class SampleOutput:
    config: RunConfig
    thetas: np.ndarray          # (C, N, K, 3) draws (or (P, 1, K, 3) for SMC/ADVI)
    masks: np.ndarray           # (K,) or per-particle (P, K)
    stats: dict[str, Any] = field(default_factory=dict)


def sample(cfg: RunConfig, seed: int = 0, image=None, mesh=None,
           metrics_path: str | None = None,
           checkpoint_path: str | None = None, resume: bool = False) -> SampleOutput:
    """Run the configured head on the config's mock scene (or a given image).

    metrics_path: optional JSONL sink for run metrics (SURVEY.md §5.5).
    checkpoint_path/resume: block checkpoints for the MCMC heads; with
    resume=True a crashed run continues from its last completed block and
    the output contains only the remaining draws (SURVEY.md §5.3/§5.4)."""
    truth_theta, mock_img = cfg.make_data()
    img = mock_img if image is None else jnp.asarray(image)
    spec, prior = cfg.scene, cfg.prior
    mask = jnp.ones(cfg.kmax)
    key = jax.random.key(seed)

    pg = make_potential_and_grad(spec, img, prior)
    grad_fn = lambda th: pg(th, mask)

    # long runs sample in 250-draw jit blocks (driver.sample_blocked):
    # bitwise-identical and robust for long device programs
    block = 250 if cfg.n_samples > 300 else None
    if checkpoint_path is not None and block is None:
        block = max(1, cfg.n_samples // 4)  # checkpointing implies blocks
    logger = None
    if metrics_path is not None:
        from .metrics import MetricsLogger

        logger = MetricsLogger(metrics_path, cfg.name)
    ck = dict(checkpoint_path=checkpoint_path, resume=resume, logger=logger)
    if cfg.head in ("hmc", "oracle", "nuts", "rhmc"):
        ck["thin"] = cfg.thin  # record every thin-th transition

    t_start = time.perf_counter()
    # what ran: the fused GPU kernel where a head takes it, XLA otherwise
    stats: dict[str, Any] = {"kernel": "xla"}

    # Chain-axis sharding is uniform across the MCMC heads: shard theta0
    # over the mesh and GSPMD partitions the vmapped kernels, turning the
    # pooled-warmup reductions into psums (SURVEY.md §5.8).  The fused
    # leapfrog kernel additionally runs per-shard under shard_map
    # (pallas_call has no GSPMD rule); the pure-XLA heads need nothing else.
    theta0 = None
    if cfg.head in ("hmc", "oracle", "nuts", "rhmc", "chees"):
        theta0 = _init_chains(key, cfg, truth_theta)
        if mesh is not None:
            from .dist import shard_chains

            theta0 = shard_chains(theta0, mesh, mesh.axis_names[0])

    if cfg.head in ("hmc", "oracle"):
        from .pallas_kernels import fused_supported

        if _select_kernel(cfg.kernel, fused_supported(spec, cfg.kmax)):
            from .hmc import run_hmc_pallas

            stats["kernel"] = KERNEL_NAME
            res, wr = run_hmc_pallas(
                jax.random.fold_in(key, 1), spec, img, prior, theta0, mask,
                cfg.n_samples, cfg.n_warmup, cfg.hmc, block_size=block,
                mesh=mesh, **ck,
            )
        else:
            res, wr = run_hmc(
                jax.random.fold_in(key, 1), grad_fn, theta0, mask,
                cfg.n_samples, cfg.n_warmup, cfg.hmc, block_size=block, **ck,
            )
        stats["devices"] = _n_devices(res.thetas)
        thetas = np.asarray(res.thetas)
        stats.update(step_size=float(wr.step_size),
                     accept=float(np.asarray(res.accept_prob).mean()),
                     divergences=int(np.asarray(res.diverged).sum()))
        masks = np.asarray(mask)
    elif cfg.head == "nuts":
        res, wr = run_nuts(
            jax.random.fold_in(key, 1), grad_fn, theta0, mask,
            cfg.n_samples, cfg.n_warmup, cfg.nuts, block_size=block, **ck,
        )
        stats["devices"] = _n_devices(res.thetas)
        thetas = np.asarray(res.thetas)
        stats.update(step_size=float(wr.step_size),
                     accept=float(np.asarray(res.accept_prob).mean()),
                     divergences=int(np.asarray(res.diverged).sum()))
        masks = np.asarray(mask)
    elif cfg.head == "rhmc":
        pfn = make_potential(spec, img, prior)
        if cfg.rhmc.metric not in ("full", "diag"):
            raise ValueError(
                f"rhmc.metric must be 'full' or 'diag', got {cfg.rhmc.metric!r}"
            )
        if cfg.rhmc.metric == "diag":
            from .metric import make_diag_metric_fn

            metric = make_diag_metric_fn(spec, prior)
        else:
            metric = make_metric_fn(spec, prior)
        # no fused kernel covers the Riemannian trajectory: XLA only
        _select_kernel(cfg.kernel, feasible=False)
        from .runtime import max_program_steps

        blk = block
        if max_program_steps() is not None:
            blk = min(block or cfg.n_samples, max_program_steps())
        res, wr = run_rhmc(
            jax.random.fold_in(key, 1), pfn, metric, grad_fn, theta0,
            mask, cfg.n_samples, cfg.n_warmup, cfg.rhmc,
            block_size=blk, **ck,
        )
        stats["devices"] = _n_devices(res.thetas)
        thetas = np.asarray(res.thetas)
        stats.update(step_size=float(wr.step_size),
                     accept=float(np.asarray(res.accept_prob).mean()),
                     divergences=int(np.asarray(res.diverged).sum()))
        if res.solver_fail is not None:
            # fixed-point solver force-rejections, separate from Delta-H
            # divergences (VERDICT round-3 item 5)
            stats["solver_rejections"] = int(np.asarray(res.solver_fail).sum())
        masks = np.asarray(mask)
    elif cfg.head == "chees":
        from .chees import (ChEESConfig, make_chees_relocate,
                            make_fused_leapfrog_impl, run_chees)
        from .pallas_kernels import fused_supported

        impl = None
        if _select_kernel(cfg.kernel, fused_supported(spec, cfg.kmax)):
            # the adapted trip count is a kernel operand, so ChEES stays on
            # one compiled kernel; under a mesh it runs per chain shard
            impl = make_fused_leapfrog_impl(spec, img, prior, cfg.kmax,
                                            mesh=mesh)
            stats["kernel"] = KERNEL_NAME
        # configuration-hop relocation (round 5): the scene is known here,
        # so the metastability cure is on by default (chees.relocate_every)
        reloc = (make_chees_relocate(spec, img, prior)
                 if cfg.chees.relocate_every > 0 else None)
        res, ad = run_chees(
            jax.random.fold_in(key, 1), grad_fn, theta0, mask,
            cfg.n_samples, cfg.n_warmup, cfg.chees, leapfrog_impl=impl,
            block_size=block, relocate_fn=reloc, **ck,
        )
        stats["devices"] = _n_devices(res.thetas)
        thetas = np.asarray(res.thetas)
        stats.update(step_size=float(ad["step_size"]),
                     traj_length=float(ad["traj_length"]),
                     accept=float(np.asarray(res.accept_prob).mean()),
                     divergences=int(np.asarray(res.diverged).sum()),
                     warmup_divergences=int(ad["warmup_divergences"]))
        if "traj_converged" in ad:
            # adapted-T sanity band (VERDICT round-4 item 1c): drift of the
            # log-T ascent over the last two warmup windows; a resumed run
            # restores T from its checkpoint and has no drift to report
            stats.update(traj_drift=ad["traj_drift"],
                         traj_converged=ad["traj_converged"],
                         warmup_extensions=ad["warmup_extensions"],
                         t_probe_factor=ad.get("t_probe_factor", 1.0),
                         eq_stages=ad.get("eq_stages", 0),
                         eq_disagreement=ad.get("eq_disagreement"))
        masks = np.asarray(mask)
    elif cfg.head == "transdim":
        from .pallas_kernels import fused_supported
        from .transdim_mcmc import run_transdim

        tdm = cfg.tdm
        # the within-model HMC move rides the fused kernel (per-chain
        # masks); the Riemannian moves have none.  Under a mesh the XLA
        # mutations are used: GSPMD partitions them from the sharded TDState.
        if _select_kernel(cfg.kernel,
                          mesh is None and tdm.mutation == "hmc"
                          and fused_supported(spec, cfg.kmax)):
            tdm = tdm._replace(mutation="hmc_pallas")
        stats["kernel"] = tdm.mutation
        res, eps = run_transdim(
            jax.random.fold_in(key, 1), spec, img, prior, cfg.kmax,
            cfg.n_chains, cfg.n_samples, cfg.n_warmup, tdm,
            block_size=block, mesh=mesh, **ck,
        )
        stats["devices"] = _n_devices(res.thetas)
        thetas = np.asarray(res.thetas)
        masks = np.asarray(res.masks)  # (C, N, K) per-draw alive masks
        stats.update(step_size=float(eps),
                     accept=float(np.asarray(res.accept_prob).mean()),
                     td_accept=float(np.asarray(res.td_accept).mean()),
                     divergences=int(np.asarray(res.diverged).sum()),
                     solver_rejections=int(np.asarray(res.solver_fail).sum()))
    elif cfg.head == "smc":
        res = run_smc(
            jax.random.fold_in(key, 1), spec, img, prior, cfg.kmax, cfg.smc,
            mesh=mesh, **ck,
        )
        stats["devices"] = _n_devices(res.theta)
        thetas = np.asarray(res.theta)[:, None, :, :]
        masks = np.asarray(res.mask)
        stats.update(log_z=float(res.log_z), n_temp_steps=int(res.n_steps),
                     accept=float(res.mean_accept), step_size=float(res.eps),
                     beta=float(res.beta))
        if res.final_done is not None:
            # posterior rounds actually run (plateau-stopped when
            # smc.plateau_window > 0 — VERDICT round-3 item 1)
            stats["final_rounds"] = int(res.final_done)
        if res.island_diag is not None:
            # between-island convergence gate (VERDICT round-4 item 2):
            # islands are independent ancestries, so their R̂ measures true
            # population spread where pooled split-R̂ understates it
            stats.update(res.island_diag)
        if float(res.beta) < 1.0:
            stats["warning"] = (
                f"tempering capped at beta={float(res.beta):.4f} "
                f"(max_steps={cfg.smc.max_steps}); raise smc.max_steps"
            )
    elif cfg.head == "advi":
        # ADVI intentionally skips mesh/checkpoint/blocked sampling: the
        # fit is a seconds-scale deterministic optax loop on one device (no
        # long-run durability surface to protect), and its "draws" are
        # 1000 iid samples from q in the SMC-style (P, 1, K, 3) layout
        # (summarize_output moves particles onto the draw axis).  The
        # logger still gets per-window ELBO records (SURVEY.md §5.5).
        mu0 = sample_prior(jax.random.fold_in(key, 2), cfg.kmax, prior)
        if cfg.advi.full_rank:
            from .advi import advi_sample_fullrank, fit_advi_fullrank

            res = fit_advi_fullrank(jax.random.fold_in(key, 1), grad_fn,
                                    mu0, cfg.advi)
            draws = advi_sample_fullrank(jax.random.fold_in(key, 3), res, 1000)
            stats["family"] = "full_rank"
        else:
            from .advi import advi_sample

            res = fit_advi(jax.random.fold_in(key, 1), grad_fn, mu0, mask,
                           cfg.advi)
            draws = advi_sample(jax.random.fold_in(key, 3), res, mask, 1000)
            stats["family"] = "mean_field"
        thetas = np.asarray(draws)[:, None, :, :]
        masks = np.asarray(mask)
        stats.update(elbo=float(np.asarray(res.elbo_trace)[-50:].mean()))
        if logger is not None:
            tr = np.asarray(res.elbo_trace)
            n_win = 5
            for i in range(n_win):
                lo, hi = i * len(tr) // n_win, (i + 1) * len(tr) // n_win
                if lo < hi:
                    logger.log("advi_window", window=i, step_lo=lo,
                               step_hi=hi, elbo=float(tr[lo:hi].mean()))
    else:
        raise ValueError(f"unknown head {cfg.head!r}")

    jax.block_until_ready(jnp.zeros(()))
    stats["wall_seconds"] = time.perf_counter() - t_start
    if logger is not None:
        logger.log("run_complete", head=cfg.head,
                   **{k: v for k, v in stats.items() if isinstance(v, (int, float))})
        logger.close()
    stats["truth"] = {
        k: np.asarray(v)
        for k, v in zip("xyf", constrain(truth_theta, spec))
    }
    return SampleOutput(cfg, thetas, masks, stats)


def _n_devices(x) -> int:
    """How many devices hold the result array (the sharded-run check)."""
    return len(x.sharding.device_set) if isinstance(x, jax.Array) else 1


def _init_chains(key: jax.Array, cfg: RunConfig, truth_theta: jax.Array) -> jax.Array:
    """Chains initialized near the truth with small jitter (mock-data runs)."""
    jit = 0.01 * jax.random.normal(
        jax.random.fold_in(key, 7), (cfg.n_chains,) + truth_theta.shape
    )
    return truth_theta[None] + jit


def summarize_output(out: SampleOutput) -> dict[str, Any]:
    """Permutation-safe posterior summaries (SURVEY.md ⑱): total flux,
    per-slot moments for fixed-K runs, and the star-count posterior
    (mode / mean / histogram) for trans-dimensional runs."""
    th = out.thetas  # (C, N, K, 3)
    mask = out.masks
    if mask.ndim == 1:
        alive = mask[None, None, :]
    elif mask.ndim == 2:  # per-particle (SMC)
        alive = mask[:, None, :]
    else:                 # per-draw (trans-d MCMC): (C, N, K)
        alive = mask
    def _series(a: np.ndarray) -> np.ndarray:
        # SMC/ADVI outputs are (P, 1): put particles on the draw axis so
        # sd/MCSE are computed across particles instead of degenerating
        return a.T if (a.shape[1] == 1 and a.shape[0] > 1) else a

    tot_flux = _series((np.exp(th[..., 2]) * alive).sum(-1))  # (C, N)
    summ = {"total_flux": diagnostics.summarize(tot_flux)}
    if mask.ndim >= 2:  # trans-dimensional: star-count posterior over n
        counts = alive.sum(-1).reshape(-1).astype(int)  # particles or draws
        kmax = th.shape[2]
        hist = np.bincount(counts, minlength=kmax + 1)[: kmax + 1]
        pn = hist / max(counts.size, 1)
        summ["star_count"] = {
            "mode": int(np.argmax(hist)),
            "mean": float(counts.mean()),
            "sd": float(counts.std()),
            "pmf": {str(i): round(float(p), 4) for i, p in enumerate(pn) if p > 0},
        }
    if mask.ndim == 1 and th.shape[2] == 1:
        w = out.config.scene.width
        h = out.config.scene.height
        summ["x"] = diagnostics.summarize(_series(w / (1 + np.exp(-th[:, :, 0, 0]))))
        summ["y"] = diagnostics.summarize(_series(h / (1 + np.exp(-th[:, :, 0, 1]))))
        summ["flux"] = diagnostics.summarize(_series(np.exp(th[:, :, 0, 2])))
    return summ
