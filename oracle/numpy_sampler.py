"""NumPy oracle sampler (SURVEY.md ⑰; BASELINE.json:7 config 0).

This module *is* the in-repo stand-in for the reference
`jaekor91/HMC-stellar-toy-model` NumPy sampler (the reference mount was empty
at survey time — SURVEY.md §0 — so this reimplements the behavior pinned by
BASELINE.json:7: "single star, fixed PSF, 2D position+flux posterior via
plain HMC, 4 chains on CPU (reference NumPy sampler)").

It is deliberately written in plain single-process NumPy — scalar loops,
no JAX — and samples the *same* unconstrained density as
starcat.potential (same sigmoid/log transforms, same priors), so posterior
moments of (x, y, flux) from the JAX heads must match these within
Monte-Carlo error (SURVEY.md §3.6 validate()).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np


@dataclass
class OracleModel:
    """Single-image Poisson PSF model, mirroring starcat.scene/potential."""

    image: np.ndarray  # (H, W) counts
    height: int
    width: int
    psf_sigma: float
    background: float
    logf_mean: float
    logf_sigma: float

    def __post_init__(self):
        self.cx = np.arange(self.width) + 0.5
        self.cy = np.arange(self.height) + 0.5

    # -- forward model ------------------------------------------------------
    def _profiles(self, x, y):
        sig = self.psf_sigma
        norm = 1.0 / (math.sqrt(2 * math.pi) * sig)
        gx = np.exp(-0.5 * ((self.cx[None, :] - x[:, None]) / sig) ** 2) * norm
        gy = np.exp(-0.5 * ((self.cy[None, :] - y[:, None]) / sig) ** 2) * norm
        return gy, gx

    def render(self, x, y, f):
        gy, gx = self._profiles(x, y)
        return self.background + (gy * f[:, None]).T @ gx

    # -- transforms ---------------------------------------------------------
    def constrain(self, theta):
        th = theta.reshape(-1, 3)
        x = self.width / (1.0 + np.exp(-th[:, 0]))
        y = self.height / (1.0 + np.exp(-th[:, 1]))
        f = np.exp(th[:, 2])
        return x, y, f

    # -- potential & gradient ----------------------------------------------
    def potential(self, theta):
        th = theta.reshape(-1, 3)
        x, y, f = self.constrain(theta)
        lam = self.render(x, y, f)
        loglik = float(np.sum(self.image * np.log(lam) - lam))
        u = th[:, :2]
        lp_pos = float(np.sum(-np.logaddexp(0.0, u) - np.logaddexp(0.0, -u)))
        z = (th[:, 2] - self.logf_mean) / self.logf_sigma
        lp_flux = float(
            np.sum(-0.5 * z * z - math.log(self.logf_sigma) - 0.5 * math.log(2 * math.pi))
        )
        return -(loglik + lp_pos + lp_flux)

    def grad_potential(self, theta):
        th = theta.reshape(-1, 3)
        x, y, f = self.constrain(theta)
        sig2 = self.psf_sigma**2
        gy, gx = self._profiles(x, y)
        lam = self.background + (gy * f[:, None]).T @ gx
        resid = self.image / lam - 1.0
        dgx = gx * (self.cx[None, :] - x[:, None]) / sig2
        dgy = gy * (self.cy[None, :] - y[:, None]) / sig2

        k = th.shape[0]
        g = np.zeros_like(th)
        for i in range(k):
            d_f = gy[i] @ resid @ gx[i]
            d_x = f[i] * (gy[i] @ resid @ dgx[i])
            d_y = f[i] * (dgy[i] @ resid @ gx[i])
            sx = x[i] / self.width
            sy = y[i] / self.height
            # chain rule to unconstrained; plus prior grads
            g[i, 0] = d_x * self.width * sx * (1 - sx) + (1.0 - 2.0 * sx)
            g[i, 1] = d_y * self.height * sy * (1 - sy) + (1.0 - 2.0 * sy)
            g[i, 2] = d_f * f[i] - (th[i, 2] - self.logf_mean) / self.logf_sigma**2
        return -g.reshape(theta.shape)


def leapfrog(model: OracleModel, theta, p, step_size, n_steps):
    g = model.grad_potential(theta)
    for _ in range(n_steps):
        p = p - 0.5 * step_size * g
        theta = theta + step_size * p
        g = model.grad_potential(theta)
        p = p - 0.5 * step_size * g
    return theta, p


def run_hmc_chain(
    model: OracleModel,
    theta0: np.ndarray,
    n_samples: int,
    n_warmup: int,
    step_size: float,
    n_leapfrog: int,
    rng: np.random.Generator,
    adapt: bool = True,
    target_accept: float = 0.8,
):
    """One plain-HMC chain with simple dual-averaging warmup.

    Returns (samples[n_samples, d], accept_rate).
    """
    theta = theta0.copy()
    u = model.potential(theta)
    d = theta.size

    # dual averaging (Hoffman & Gelman 2014 defaults)
    mu = math.log(10 * step_size)
    log_eps = math.log(step_size)
    log_eps_bar, h_bar = 0.0, 0.0
    gamma, t0, kappa = 0.05, 10.0, 0.75

    samples = np.empty((n_samples, d))
    n_accept = 0
    total = n_warmup + n_samples
    for it in range(total):
        eps = math.exp(log_eps)
        p = rng.standard_normal(d)
        h0 = u + 0.5 * p @ p
        # Divergent trajectories overflow exp() transiently; the isfinite
        # guard below rejects them, so those numpy warnings are benign noise.
        with np.errstate(over="ignore", invalid="ignore"):
            theta_new, p_new = leapfrog(model, theta, p, eps, n_leapfrog)
            u_new = model.potential(theta_new)
        h1 = u_new + 0.5 * p_new @ p_new
        log_alpha = min(0.0, h0 - h1) if np.isfinite(h1) else -np.inf
        accept = math.log(rng.uniform()) < log_alpha
        if accept:
            theta, u = theta_new, u_new
        if it < n_warmup and adapt:
            alpha = math.exp(log_alpha) if np.isfinite(log_alpha) else 0.0
            m = it + 1
            h_bar = (1 - 1 / (m + t0)) * h_bar + (target_accept - alpha) / (m + t0)
            log_eps = mu - math.sqrt(m) / gamma * h_bar
            eta = m**-kappa
            log_eps_bar = eta * log_eps + (1 - eta) * log_eps_bar
            if it == n_warmup - 1:
                log_eps = log_eps_bar
        if it >= n_warmup:
            samples[it - n_warmup] = theta
            n_accept += int(accept)
    return samples, n_accept / max(n_samples, 1)


def run_oracle(
    image: np.ndarray,
    psf_sigma: float,
    background: float,
    logf_mean: float,
    logf_sigma: float,
    n_stars: int = 1,
    n_chains: int = 4,
    n_samples: int = 2000,
    n_warmup: int = 500,
    step_size: float = 0.02,
    n_leapfrog: int = 20,
    seed: int = 0,
    theta0: np.ndarray | None = None,
):
    """Run `n_chains` serial CPU chains (reference call stack, SURVEY.md §3.1).

    Returns dict with 'samples' (chains, n_samples, 3*n_stars) in
    unconstrained space, plus constrained-space posterior summaries.
    """
    h, w = image.shape
    model = OracleModel(
        image=image.astype(np.float64),
        height=h,
        width=w,
        psf_sigma=psf_sigma,
        background=background,
        logf_mean=logf_mean,
        logf_sigma=logf_sigma,
    )
    rng = np.random.default_rng(seed)
    d = 3 * n_stars
    all_samples = np.empty((n_chains, n_samples, d))
    rates = []
    for c in range(n_chains):
        if theta0 is not None:
            t0 = theta0.reshape(-1).astype(np.float64).copy()
            t0 += 0.01 * rng.standard_normal(d)  # jitter chains apart
        else:
            t0 = rng.standard_normal(d) * 0.5
            t0[2::3] += logf_mean
        s, rate = run_hmc_chain(
            model, t0, n_samples, n_warmup, step_size, n_leapfrog, rng
        )
        all_samples[c] = s
        rates.append(rate)

    flat = all_samples.reshape(-1, d).reshape(-1, n_stars, 3)
    x = w / (1 + np.exp(-flat[:, :, 0]))
    y = h / (1 + np.exp(-flat[:, :, 1]))
    f = np.exp(flat[:, :, 2])
    return {
        "samples": all_samples,
        "accept_rates": np.array(rates),
        "x": x,
        "y": y,
        "flux": f,
        "model": model,
    }
