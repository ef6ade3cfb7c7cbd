"""Typed configs + the five canonical presets (SURVEY.md ⑳, §5.6;
BASELINE.json:6-12).

Each preset bundles a scene, priors, a mock-truth recipe and a sampler
head.  Overrides are simple key=value strings on the CLI (`__main__.py`)
— no heavyweight flag framework (SURVEY.md §5.6).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from .advi import ADVIConfig
from .chees import ChEESConfig
from .hmc import HMCConfig
from .nuts import NUTSConfig
from .potential import PriorSpec, constrain, sample_prior
from .rhmc import RHMCConfig
from .scene import SceneSpec, make_mock_image
from .smc import SMCConfig
from .transdim import TransDimConfig
from .transdim_mcmc import TransDimMCMCConfig


@dataclasses.dataclass(frozen=True)
class RunConfig:
    name: str
    scene: SceneSpec
    prior: PriorSpec
    n_stars: int            # true star count of the mock scene
    kmax: int               # catalog capacity (== n_stars for fixed-K heads)
    head: str               # "hmc" | "rhmc" | "nuts" | "smc" | "advi" | "transdim" | "oracle"
    n_chains: int = 64
    n_samples: int = 1000    # recorded draws
    n_warmup: int = 500
    # Kernel selection for the hmc/chees heads and the trans-d HMC move
    # (api._select_kernel; stats["kernel"] reports what ran):
    #   "auto"   — the fused GPU leapfrog kernel on a GPU when the scene
    #              fits it, XLA everywhere else
    #   "pallas" — require the fused kernel (raises where it cannot run)
    #   "xla"    — force the XLA reference path
    kernel: str = "auto"
    thin: int = 1            # transitions per recorded draw (MCMC heads)
    truth_seed: int = 11
    data_seed: int = 12
    hmc: HMCConfig = HMCConfig()
    nuts: NUTSConfig = NUTSConfig()
    rhmc: RHMCConfig = RHMCConfig()
    smc: SMCConfig = SMCConfig()
    tdm: TransDimMCMCConfig = TransDimMCMCConfig()
    chees: ChEESConfig = ChEESConfig()
    advi: ADVIConfig = ADVIConfig()
    notes: str = ""

    def make_truth(self):
        """Deterministic mock truth: params drawn from the prior."""
        theta = sample_prior(jax.random.key(self.truth_seed), self.n_stars, self.prior)
        return theta

    def make_data(self):
        """(truth_theta, image) for this config's mock scene."""
        theta = self.make_truth()
        x, y, f = constrain(theta, self.scene)
        img = make_mock_image(jax.random.key(self.data_seed), x, y, f, self.scene)
        return theta, img


# ---------------------------------------------------------------------------
# The five canonical presets (BASELINE.json:7-11)
# ---------------------------------------------------------------------------

CONFIGS: dict[str, RunConfig] = {}


def _register(cfg: RunConfig) -> RunConfig:
    CONFIGS[cfg.name] = cfg
    return cfg


# config 0: "single star, fixed PSF, 2D position+flux posterior via plain
# HMC, 4 chains on CPU (reference NumPy sampler)"
cfg0_single_star = _register(RunConfig(
    name="cfg0_single_star",
    scene=SceneSpec(16, 16, 1.5, 5.0),
    prior=PriorSpec(5.0, 1.0),
    n_stars=1, kmax=1,
    head="oracle",
    n_chains=4, n_samples=2000, n_warmup=500,
    hmc=HMCConfig(step_size=0.05, n_leapfrog=15),
    notes="NumPy oracle; the validation golden target (BASELINE.json:7)",
))

# config 1: "10-star 32x32 scene, RHMC with Riemannian mass matrix, 64 chains"
cfg1_rhmc = _register(RunConfig(
    name="cfg1_rhmc",
    scene=SceneSpec(32, 32, 1.5, 10.0),
    prior=PriorSpec(5.0, 0.7),
    n_stars=10, kmax=10,
    head="rhmc",
    n_chains=64, n_samples=1000, n_warmup=400,
    # n_leapfrog 16 (round 4): the divergence-penalized dual averaging
    # (RHMCConfig.divergence_penalty) settles eps ~0.010 where divergences
    # and solver failures are < 2% (vs 6.7-8.7% at round 3's eps 0.027) —
    # and at that eps the 16-step trajectory gives ~1.8x the ESS of the
    # old 8-step one (round-4 solver probe: ESS/200 draws 72.8 vs 41.3).
    rhmc=RHMCConfig(step_size=0.3, n_leapfrog=16, fixed_point_iters=6),
))

# config 2: "10-star scene, NUTS with dual-averaging step-size adaptation,
# 1024 vmapped chains on 1 device"
cfg2_nuts = _register(RunConfig(
    name="cfg2_nuts",
    scene=SceneSpec(32, 32, 1.5, 10.0),
    prior=PriorSpec(5.0, 0.7),
    n_stars=10, kmax=10,
    head="nuts",
    n_chains=1024, n_samples=1000, n_warmup=500,
    nuts=NUTSConfig(step_size=0.05, max_depth=8),
))

# config 3: "trans-dimensional cataloging: birth/death/split-merge moves +
# RHMC within SMC, 4096 particles sharded across 1 host"
cfg3_transdim_smc = _register(RunConfig(
    name="cfg3_transdim_smc",
    scene=SceneSpec(32, 32, 1.5, 10.0),
    prior=PriorSpec(5.0, 0.7),
    n_stars=10, kmax=16,
    head="smc",
    smc=SMCConfig(
        n_particles=4096, mutation="rhmc", n_mutation_steps=2, n_leapfrog=6,
        fixed_point_iters=4, n_transdim_sweeps=2, step_size0=0.3,
        transdim=TransDimConfig(lam_count=8.0, split_sigma=1.0),
    ),
))

# config 4: "50-star 128x128 crowded-field scene, SMC+RHMC across N>=2 hosts
# with collective resampling (stretch)"
cfg4_crowded = _register(RunConfig(
    name="cfg4_crowded",
    scene=SceneSpec(128, 128, 1.5, 20.0),
    prior=PriorSpec(5.0, 0.7),
    n_stars=50, kmax=64,
    head="smc",
    smc=SMCConfig(
        # Diagonal-Fisher mutation (XLA, chunked by mutation_chunk): the
        # closed-form diag metric is far cheaper per step than the full
        # metric at this shape and gave a better-mixed posterior (higher
        # star-count mode and logZ) in the round-3 comparison.
        n_particles=4096, mutation="rhmc_diag", n_mutation_steps=2,
        n_leapfrog=6,
        fixed_point_iters=4, n_transdim_sweeps=12, step_size0=0.2,
        max_steps=250,  # crowded-field likelihood needs many more temper steps
        # Plateau-stopped posterior rounds (VERDICT round-3 item 1): the
        # star-count budget curve saturates ON the 50-star truth (round
        # 3), so a bare run now keeps
        # taking cheap posterior rounds until the windowed mean count stops
        # moving instead of shipping a fixed too-small budget (round 3's
        # n_final_rounds=12 returned a known-unconverged mode 41).
        # final_n_leapfrog deliberately NOT raised, n_islands deliberately
        # 1: population-flux diversity measured FLAT across 16x trajectory
        # lengths and 4x trans-d sweeps (round 4).  Round-5 measured
        # islands surface (7 cfg4 runs, 2 seeds): between-island R-hat at
        # a matched 300-round budget is a
        # function of TOTAL population only — ~1.000 at P=8192 for EVERY
        # geometry tested (4x2048 / 16x512 / 32x256, +45 nats logZ,
        # identical moments) vs 1.41-1.56 at P=4096 (16x256 / 8x512).
        # The round-4 "~100 islands x >=1024" extrapolation is
        # superseded: the convergence lever is total particles (>=8192
        # at this budget) and island geometry is free for the device
        # layout (islands never communicate at resampling).  At the
        # preset's single-device P=4096, the honest gate remains cross-seed
        # replication; set n_particles>=8192 n_islands=8 (or any
        # geometry) where memory allows an in-run R-hat gate.
        plateau_window=50, plateau_tol=0.25, max_final_rounds=1500,
        mutation_chunk=256,
        transdim=TransDimConfig(lam_count=40.0, split_sigma=1.0,
                                birth_proposal="residual"),
    ),
    notes="stretch config; shard particles over all hosts (SURVEY.md §3.4)",
))


# config 5: the reference's own sampler shape (SURVEY.md §3.2): a plain
# trans-dimensional MCMC chain — birth/death/split-merge sweeps interleaved
# with within-model RHMC transitions, per-chain alive masks
cfg5_transdim_mcmc = _register(RunConfig(
    name="cfg5_transdim_mcmc",
    scene=SceneSpec(32, 32, 1.5, 10.0),
    prior=PriorSpec(5.0, 0.7),
    n_stars=10, kmax=16,
    head="transdim",
    n_chains=256, n_samples=1000, n_warmup=400,
    tdm=TransDimMCMCConfig(
        # Diagonal-Fisher mutation: a statistically identical posterior to
        # the full metric (star-count mode 10 both, similar flux ESS, round
        # 3) at a fraction of the per-step cost.
        step_size=0.15, mutation="rhmc_diag", n_leapfrog=6,
        fixed_point_iters=4,
        n_transdim_sweeps=2, target_accept=0.8,
        # penalty 8 (not the rhmc-head default 5): at target 0.8 the
        # equilibrium failure bound is (1-target)/penalty — 2.5% here vs 4%
        # at penalty 5 — which is what drives the round-3 8.5% divergence
        # waste under 2% (VERDICT round-3 item 5)
        divergence_penalty=8.0,
        transdim=TransDimConfig(lam_count=8.0, split_sigma=1.0),
    ),
    notes="trans-d RHMC chain (SURVEY.md §3.2 reference call stack)",
))


# config 6: the recommended head for the flagship scene — ChEES-HMC
# (lockstep adaptive trajectories; on a GPU the fused leapfrog kernel runs
# the adapted trip count).
cfg6_chees = _register(RunConfig(
    name="cfg6_chees",
    scene=SceneSpec(32, 32, 1.5, 10.0),
    prior=PriorSpec(5.0, 0.7),
    n_stars=10, kmax=10,
    head="chees",
    n_chains=1024, n_samples=1000, n_warmup=500,
    chees=ChEESConfig(step_size=0.05),
    notes="ChEES-HMC on the flagship scene (fused leapfrog kernel on a GPU)",
))


# config 7: ADVI on the flagship 10-star scene — the deterministic
# variational baseline head (SURVEY.md ⑯; VERDICT round-4 item 7: ADVI was
# reachable only via a head=advi override and had no committed record).
# Mean-field by default (advi.full_rank=true switches to N(mu, L L^T));
# the fit is a seconds-scale optax loop, so n_chains/n_samples are unused
# and the output is 1000 iid draws from the fitted q.
cfg7_advi = _register(RunConfig(
    name="cfg7_advi",
    scene=SceneSpec(32, 32, 1.5, 10.0),
    prior=PriorSpec(5.0, 0.7),
    n_stars=10, kmax=10,
    head="advi",
    advi=ADVIConfig(n_steps=3000),
    notes="variational baseline on the cfg2 scene",
))


def _coerce(cur: Any, val: Any) -> Any:
    """Cast a CLI string to the type of the current value."""
    if isinstance(cur, bool):
        return str(val).lower() in ("1", "true", "yes")
    return type(cur)(val) if cur is not None else val


def _set_dotted(obj: Any, path: list[str], val: Any) -> Any:
    """Immutably set a (possibly nested) field on a dataclass/NamedTuple."""
    field, rest = path[0], path[1:]
    cur = getattr(obj, field)
    new = _set_dotted(cur, rest, val) if rest else _coerce(cur, val)
    if isinstance(obj, tuple) and hasattr(obj, "_replace"):  # NamedTuple
        return obj._replace(**{field: new})
    return dataclasses.replace(obj, **{field: new})


def apply_overrides(cfg: RunConfig, overrides: dict[str, Any]) -> RunConfig:
    """key=value overrides; dotted keys reach nested configs to any depth
    (e.g. smc.n_particles=1024, tdm.transdim.lam_count=3.0)."""
    for key, val in overrides.items():
        cfg = _set_dotted(cfg, key.split("."), val)
    return cfg
