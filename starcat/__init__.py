"""starcat — probabilistic cataloging inference engine in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
`jaekor91/HMC-stellar-toy-model` (see SURVEY.md): Poisson-likelihood
PSF-convolved scene model, sampled with HMC / RHMC / NUTS / SMC / ADVI heads
that share one potential, vmapped over thousands of chains and sharded over
device meshes.
"""

from .scene import SceneSpec, render_scene, make_mock_image, pixel_centers  # noqa: F401
from .potential import (  # noqa: F401
    PriorSpec,
    constrain,
    unconstrain,
    log_prior,
    log_likelihood,
    make_potential,
    make_potential_and_grad,
    make_tempered_potential_and_grad,
    sample_prior,
)
from .hmc import HMCConfig, run_hmc  # noqa: F401
from .nuts import NUTSConfig, run_nuts  # noqa: F401
from .rhmc import RHMCConfig, run_rhmc  # noqa: F401
from .smc import SMCConfig, run_smc  # noqa: F401
from .advi import ADVIConfig, fit_advi  # noqa: F401
from .chees import ChEESConfig, run_chees  # noqa: F401
from .metric import make_diag_metric_fn, make_metric_fn  # noqa: F401
from .transdim import TransDimConfig  # noqa: F401
from .transdim_mcmc import TransDimMCMCConfig, run_transdim  # noqa: F401
from .configs import CONFIGS, RunConfig, apply_overrides  # noqa: F401
from .api import sample, summarize_output  # noqa: F401
from .catalogs import (  # noqa: F401
    catalog_report,
    completeness_purity,
    condense,
    extract_catalogs,
    match_catalogs,
)

__version__ = "0.1.0"
