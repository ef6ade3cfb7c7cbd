"""Trans-dimensional catalog moves (SURVEY.md ⑪; BASELINE.json:10):
birth/death and flux-conserving split/merge on a fixed-capacity masked
catalog — the static-shape answer to RJMCMC under XLA's static shapes
(SURVEY.md §7.3: K_max slots + alive mask; dead slots contribute exactly 0).

Target measure over the slot representation (K_max slots, n alive):

    pi(mask, theta) ∝ [ p(n) / C(K_max, n) ] * prod_alive p(theta_i) * L(D|theta)

with p(n) = Poisson(n; Lambda) truncated to [0, K_max] (the truncation
constant cancels in every ratio).  The 1/C(K_max, n) symmetrization makes
all slot assignments of the same physical catalog equally weighted, so the
marginal over physical catalogs has the intended p(n).

Acceptance ratios (derived in-line below; the slot-choice combinatorics
cancel exactly against the C(K_max, n) factors):

    birth (prior-draw proposal, uniform dead slot):
        A = LR * Lambda / (n+1)
    death (uniform alive slot):
        A = LR * n / Lambda
    split (parent j, dead slot d, u~U(0,1), delta~N(0, sig_split^2 I2)):
        children: f1 = u f, f2 = (1-u) f,
                  pos1 = pos + (1-u) delta, pos2 = pos - u delta
        A = LR * Lambda/(n+1) * [p_c(c1) p_c(c2) / p_c(parent)]
               * f / ( q(u) q(delta) )          (|Jacobian| = f)
    merge (ordered alive pair (a, b), merged into a):
        exact reciprocal of the matching split.

All densities in the split/merge ratio are evaluated in CONSTRAINED
coordinates (x, y, f) — self-consistent because the proposal is specified
there; reparameterization Jacobians cancel between target and proposal.

Moves are static-shape, per-chain, vmap/jit-safe; slot selection uses the
Gumbel-argmax trick over the mask.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from .potential import PriorSpec, constrain, unconstrain
from .scene import SceneSpec


class TransDimConfig(NamedTuple):
    lam_count: float = 5.0       # Poisson prior intensity Lambda on n
    split_sigma: float = 1.0     # sd of the split displacement (pixels)
    p_birth_death: float = 0.5   # prob of attempting birth/death vs split/merge
    fmin: float = 1e-3           # floor used only to keep logs finite
    # "prior": positions of birth proposals drawn uniform over the image
    #          (proposal cancels the prior — the reference-style move).
    # "residual": positions drawn ∝ max(D − λ(current model), 0) per pixel —
    #          the PCAT-style data-driven proposal.  In a crowded 128×128
    #          field a uniform birth lands near an unexplained star ~1.5% of
    #          the time; the residual proposal concentrates exactly there
    #          (measured on cfg4: star-count recovery 30 → ~truth).  The
    #          death acceptance carries the exact reverse-proposal density
    #          (from the post-death residual), so detailed balance is exact
    #          for ANY data — prior-recovery tests pass with real images.
    birth_proposal: str = "prior"
    resid_floor: float = 1e-2    # per-pixel floor of the residual weights


class MoveInfo(NamedTuple):
    accepted: jax.Array
    log_alpha: jax.Array
    move_type: jax.Array  # 0 birth, 1 death, 2 split, 3 merge, 4 relocate


def _gumbel_choice(key: jax.Array, weights: jax.Array) -> jax.Array:
    """Uniform choice among slots where weights > 0 (static shape)."""
    g = jax.random.gumbel(key, weights.shape)
    scores = jnp.where(weights > 0, g, -jnp.inf)
    return jnp.argmax(scores)


def _log_flux_prior_constrained(f: jax.Array, prior: PriorSpec) -> jax.Array:
    """log p_c(f) for the log-normal flux prior (density w.r.t. df)."""
    s = jnp.log(f)
    z = (s - prior.logf_mean) / prior.logf_sigma
    return (
        -0.5 * z * z
        - jnp.log(prior.logf_sigma)
        - 0.5 * math.log(2.0 * math.pi)
        - s  # 1/f Jacobian: LogNormal density
    )


def birth_death_step(
    key: jax.Array,
    theta: jax.Array,   # (K, 3) unconstrained
    mask: jax.Array,    # (K,)
    loglik: jax.Array,  # cached log-likelihood at (theta, mask)
    loglik_fn: Callable,  # (theta, mask) -> loglik
    prior: PriorSpec,
    cfg: TransDimConfig,
):
    """One birth-or-death proposal (0.5/0.5; impossible moves auto-reject)."""
    k_move, k_slot, k_draw, k_acc = jax.random.split(key, 4)
    kmax = mask.shape[0]
    n = jnp.sum(mask)
    do_birth = jax.random.bernoulli(k_move)

    # ---- birth branch quantities ---------------------------------------
    dead_slot = _gumbel_choice(k_slot, 1.0 - mask)
    from .potential import sample_prior  # local import avoids cycle at module load

    theta_star = sample_prior(k_draw, 1, prior)[0]
    theta_b = theta.at[dead_slot].set(theta_star)
    mask_b = mask.at[dead_slot].set(1.0)
    # A_birth = LR * Lambda/(n+1): prior proposal cancels the prior density,
    # and the uniform dead/alive slot choices cancel the C(K_max, n) factors.
    loglik_b = loglik_fn(theta_b, mask_b)
    log_alpha_b = (loglik_b - loglik) + jnp.log(cfg.lam_count) - jnp.log(n + 1.0)
    log_alpha_b = jnp.where(n < kmax, log_alpha_b, -jnp.inf)

    # ---- death branch quantities ---------------------------------------
    alive_slot = _gumbel_choice(k_slot, mask)
    mask_d = mask.at[alive_slot].set(0.0)
    loglik_d = loglik_fn(theta, mask_d)
    log_alpha_d = (loglik_d - loglik) + jnp.log(jnp.maximum(n, 1.0)) - jnp.log(cfg.lam_count)
    log_alpha_d = jnp.where(n > 0, log_alpha_d, -jnp.inf)

    log_alpha = jnp.where(do_birth, log_alpha_b, log_alpha_d)
    accept = jnp.log(jax.random.uniform(k_acc)) < log_alpha

    theta_new = jnp.where(accept & do_birth, theta_b, theta)
    mask_new = jnp.where(accept, jnp.where(do_birth, mask_b, mask_d), mask)
    loglik_new = jnp.where(accept, jnp.where(do_birth, loglik_b, loglik_d), loglik)
    info = MoveInfo(accept, log_alpha, jnp.where(do_birth, 0, 1))
    return theta_new, mask_new, loglik_new, info


def _residual_log_q(theta, mask, spec: SceneSpec, image, floor: float):
    """Per-pixel log proposal density (pixel area = 1) of the data-driven
    birth position: q ∝ max(D − λ(current model), 0) + floor."""
    from .scene import render_scene

    x, y, f = constrain(theta, spec)
    lam = render_scene(x, y, f, mask, spec)
    logw = jnp.log(jnp.maximum(image - lam, 0.0) + floor)
    return logw - jax.nn.logsumexp(logw)  # (H, W)


def birth_death_step_residual(
    key: jax.Array,
    theta: jax.Array,
    mask: jax.Array,
    loglik: jax.Array,
    loglik_fn: Callable,
    prior: PriorSpec,
    spec: SceneSpec,
    image: jax.Array,
    cfg: TransDimConfig,
):
    """Birth/death with PCAT-style residual-driven birth positions.

    Birth: pixel ~ Categorical(q), sub-pixel uniform, flux from the prior.
    The acceptance carries  p(pos)/q(pos) = (1/WH) / q_pix  (flux prior
    cancels; slot combinatorics cancel against the C(K_max, n) factors as
    in birth_death_step).  Death: uniform alive slot; the REVERSE move is a
    birth from the post-death state, so the acceptance carries the reverse
    density q'(pos_j) computed from the post-death residual — detailed
    balance is exact for any data.
    """
    k_move, k_slot, k_pix, k_sub, k_flux, k_acc = jax.random.split(key, 6)
    kmax = mask.shape[0]
    h, w = spec.height, spec.width
    n = jnp.sum(mask)
    do_birth = jax.random.bernoulli(k_move)
    log_area = math.log(float(w * h))

    # ---- birth: position ∝ current residual ------------------------------
    logq = _residual_log_q(theta, mask, spec, image, cfg.resid_floor)
    pix = jax.random.categorical(k_pix, logq.reshape(-1))
    py = (pix // w).astype(theta.dtype)
    px = (pix % w).astype(theta.dtype)
    u2 = jax.random.uniform(k_sub, (2,), minval=1e-4, maxval=1.0 - 1e-4)
    x_new = px + u2[0]
    y_new = py + u2[1]
    s_new = prior.logf_mean + prior.logf_sigma * jax.random.normal(k_flux)
    th_star = unconstrain(x_new[None], y_new[None], jnp.exp(s_new)[None], spec)[0]
    dead_slot = _gumbel_choice(k_slot, 1.0 - mask)
    theta_b = theta.at[dead_slot].set(th_star)
    mask_b = mask.at[dead_slot].set(1.0)
    loglik_b = loglik_fn(theta_b, mask_b)
    log_alpha_b = (
        (loglik_b - loglik)
        + jnp.log(cfg.lam_count) - jnp.log(n + 1.0)
        - log_area                       # + log p(pos) = -log(WH)
        - logq.reshape(-1)[pix]          # - log q(pos)
    )
    log_alpha_b = jnp.where(n < kmax, log_alpha_b, -jnp.inf)

    # ---- death: uniform alive slot; reverse-q from post-death state -------
    alive_slot = _gumbel_choice(k_slot, mask)
    mask_d = mask.at[alive_slot].set(0.0)
    loglik_d = loglik_fn(theta, mask_d)
    logq_rev = _residual_log_q(theta, mask_d, spec, image, cfg.resid_floor)
    xj, yj, _ = constrain(theta[alive_slot], spec)
    pxj = jnp.clip(jnp.floor(xj), 0, w - 1).astype(jnp.int32)
    pyj = jnp.clip(jnp.floor(yj), 0, h - 1).astype(jnp.int32)
    log_alpha_d = (
        (loglik_d - loglik)
        + jnp.log(jnp.maximum(n, 1.0)) - jnp.log(cfg.lam_count)
        + log_area                       # - log p(pos_j)
        + logq_rev[pyj, pxj]             # + log q'(pos_j)
    )
    log_alpha_d = jnp.where(n > 0, log_alpha_d, -jnp.inf)

    log_alpha = jnp.where(do_birth, log_alpha_b, log_alpha_d)
    accept = jnp.log(jax.random.uniform(k_acc)) < log_alpha

    theta_new = jnp.where(accept & do_birth, theta_b, theta)
    mask_new = jnp.where(accept, jnp.where(do_birth, mask_b, mask_d), mask)
    loglik_new = jnp.where(accept, jnp.where(do_birth, loglik_b, loglik_d), loglik)
    info = MoveInfo(accept, log_alpha, jnp.where(do_birth, 0, 1))
    return theta_new, mask_new, loglik_new, info


def _matched_filter_maps(theta, mask, spec: SceneSpec, image,
                         fmin: float = 1.0):
    """Matched-filter maps of the current residual, each (H, W):

      ŝ  — log flux estimate for a hypothetical star centered at each
           pixel: f̂ = Σ_p resid_p·psf_p / Σ_p psf_p² (the ML flux for a
           fixed-position star; the separable unit-integral PSF gives the
           numerator as two 1-D contractions and Σpsf² factorizes),
           floored at fmin so empty regions propose faint, not -inf;
      x̂,ŷ — PSF-weighted centroids of the POSITIVE residual around each
           pixel: x̂(c) = Σ_p resid⁺_p psf_c(p) p_x / Σ_p resid⁺_p psf_c(p)
           — the sub-pixel refinement the relocate proposal needs (a
           uniform-in-pixel placement costs ~f·dx²/(2σ_psf²) ≈ 6 nats at
           flux 300, which killed the acceptance rate of the first two
           proposal variants: 0.36% prior-flux, 0.74% flux-only)."""
    from .scene import gaussian_profile_1d, pixel_centers, render_scene

    x, y, f = constrain(theta, spec)
    lam = render_scene(x, y, f, mask, spec)
    resid = image - lam
    rpos = jnp.maximum(resid, 0.0) + 1e-3
    cw = pixel_centers(spec.width, resid.dtype)
    ch = pixel_centers(spec.height, resid.dtype)
    gx = gaussian_profile_1d(cw, cw, spec.psf_sigma)  # (W, W)
    gy = gaussian_profile_1d(ch, ch, spec.psf_sigma)  # (H, H)
    mm = lambda a, b: jnp.matmul(a, b, precision="highest")
    num = mm(mm(gy, resid), gx.T)                     # (H, W)
    mid = gaussian_profile_1d(ch[ch.shape[0] // 2][None], ch,
                              spec.psf_sigma)[0]
    norm1d = jnp.sum(mid * mid)
    den = mm(mm(gy, rpos), gx.T)
    xhat = mm(mm(gy, rpos), (gx * cw[None, :]).T) / den
    yhat = mm(mm(gy * ch[None, :], rpos), gx.T) / den
    # Gaussian-PSF debias: for a residual that is a star at s seen through
    # the matched window at pixel center c, the raw centroid lands at the
    # MIDPOINT (c+s)/2 (product of two equal-width Gaussians) and the raw
    # flux decays as exp(-|c-s|²/(4σ²)).  Both invert algebraically:
    # s = 2·x̂_raw − c, and log f̂ gains |c-s|²/(4σ²).  Without the debias
    # a proposal from any pixel but the star's own lands halfway off and
    # under-fluxed — measured 1.8% acceptance on the single-star scene.
    xhat = 2.0 * xhat - cw[None, :]
    yhat = 2.0 * yhat - ch[:, None]
    d2 = (xhat - cw[None, :]) ** 2 + (yhat - ch[:, None]) ** 2
    s4 = 4.0 * spec.psf_sigma * spec.psf_sigma
    shat = jnp.log(jnp.maximum(num / (norm1d * norm1d), fmin)) + d2 / s4
    return shat, xhat, yhat


def _tn_logpdf(x, mu, sigma, lo, hi):
    """log density of N(mu, sigma^2) truncated to (lo, hi) at x; mu may be
    an array (vectorized over mixture components)."""
    from jax.scipy.stats import norm

    z = norm.cdf((hi - mu) / sigma) - norm.cdf((lo - mu) / sigma)
    return norm.logpdf(x, mu, sigma) - jnp.log(jnp.maximum(z, 1e-12))


def _tn_sample(key, mu, sigma, lo, hi):
    """Draw from N(mu, sigma^2) truncated to (lo, hi) by inverse CDF."""
    from jax.scipy.special import ndtri
    from jax.scipy.stats import norm

    a = norm.cdf((lo - mu) / sigma)
    b = norm.cdf((hi - mu) / sigma)
    u = jax.random.uniform(key)
    u = a + (b - a) * jnp.clip(u, 1e-6, 1.0 - 1e-6)
    return jnp.clip(mu + sigma * ndtri(u), lo + 1e-4, hi - 1e-4)


def relocate_step(
    key: jax.Array,
    theta: jax.Array,
    mask: jax.Array,
    loglik: jax.Array,
    loglik_fn: Callable,
    prior: PriorSpec,
    spec: SceneSpec,
    image: jax.Array,
    resid_floor: float = 1e-2,
    flux_sigma: float | None = None,
    pos_sigma: float = 0.12,
):
    """Dimension-PRESERVING configuration hop: a death and a residual-driven
    birth fused into one MH move (round 5).  Pick a uniform alive slot j,
    virtually remove it, and propose replacement params from the post-
    removal residual (position ~ Categorical(max(D − λ₋ⱼ, 0) + floor),
    sub-pixel uniform, flux from the prior) — the within-model counterpart
    of birth_death_step_residual for samplers whose K is fixed (ChEES /
    NUTS / HMC heads).  This is the move the round-5 ChEES study calls
    for: chain populations split across METASTABLE star/flux
    configurations that no trajectory length can hop
    (docs/DESIGN.md round-5 section); relocation jumps them directly.

    Acceptance (exact): forward and reverse proposals share the SAME
    post-removal residual map q (θ₋ⱼ is identical), the uniform position
    priors cancel, and the slot choice (1/n alive) is symmetric.  With the
    default prior-draw flux (flux_sigma=None) the flux prior cancels too:
        log α = Δloglik + log q(pix_j) − log q(pix*).
    With flux_sigma set (the DATA-DRIVEN mode), the replacement (x, y, s)
    is drawn from a residual-weighted MIXTURE: component pix (weight =
    the residual categorical q) proposes x ~ TN₍₀,W₎(x̂(pix), pos_sigma),
    y ~ TN₍₀,H₎(ŷ(pix), pos_sigma), s ~ N(ŝ(pix), flux_sigma), with the
    debiased matched-filter maps from _matched_filter_maps on the
    post-removal residual.  The acceptance evaluates the FULL mixture
    density both ways (one O(HW) logsumexp per direction — vectorized,
    trivial next to the likelihood render):
        log α = Δloglik + [log q₃(x_j, y_j, s_j) − log q₃(x*, y*, s*)]
                + [log p_prior(s*) − log p_prior(s_j)]
    (position priors cancel; the flux prior is explicit).  Evaluating the
    mixture rather than the drawn component is what keeps the move exact
    AND effective: every component's TN points at the same debiased
    estimate, so any pixel draw lands the proposal on the residual peak —
    the earlier per-pixel-truncated variant wasted every pixel whose box
    did not contain the estimate (measured 2-4% acceptance vs ~50%
    single-star for this design).
    The unconstrained-space sigmoid/identity Jacobians of slot j appear
    once in π and once in the proposal density and cancel (the proposal is
    drawn in constrained space and mapped through the same unconstrain the
    potential inverts).  Single chain — vmap over (key, theta, mask,
    loglik)."""
    k_slot, k_pix, k_sub, k_flux, k_acc = jax.random.split(key, 5)
    h, w = spec.height, spec.width
    n = jnp.sum(mask)

    j = _gumbel_choice(k_slot, mask)       # uniform alive slot
    mask_d = mask.at[j].set(0.0)
    logq = _residual_log_q(theta, mask_d, spec, image, resid_floor)  # (H, W)

    pix = jax.random.categorical(k_pix, logq.reshape(-1))
    py = (pix // w).astype(theta.dtype)
    px = (pix % w).astype(theta.dtype)
    u2 = jax.random.uniform(k_sub, (2,), minval=1e-4, maxval=1.0 - 1e-4)

    xj, yj, _ = constrain(theta[j], spec)
    pxj = jnp.clip(jnp.floor(xj), 0, w - 1).astype(jnp.int32)
    pyj = jnp.clip(jnp.floor(yj), 0, h - 1).astype(jnp.int32)
    s_j = theta[j, 2]

    z = jax.random.normal(k_flux)
    if flux_sigma is None:  # flux from the prior: density cancels exactly
        s_new = prior.logf_mean + prior.logf_sigma * z
        x_new, y_new = px + u2[0], py + u2[1]
        th_star = unconstrain(x_new[None], y_new[None],
                              jnp.exp(s_new)[None], spec)[0]
        theta_p = theta.at[j].set(th_star)
        loglik_p = loglik_fn(theta_p, mask)
        log_alpha = ((loglik_p - loglik) + logq[pyj, pxj]
                     - logq.reshape(-1)[pix])
    else:
        shat, xhat, yhat = _matched_filter_maps(theta, mask_d, spec, image)
        mu_x = xhat.reshape(-1)[pix]
        mu_y = yhat.reshape(-1)[pix]
        kx, ky = jax.random.split(k_sub)
        x_new = _tn_sample(kx, mu_x, pos_sigma, 0.0, float(w))
        y_new = _tn_sample(ky, mu_y, pos_sigma, 0.0, float(h))
        s_new = shat.reshape(-1)[pix] + flux_sigma * z

        def q3_log(xq, yq, sq):
            # full mixture density over all HW components (logq weights)
            lx = _tn_logpdf(xq, xhat, pos_sigma, 0.0, float(w))
            ly = _tn_logpdf(yq, yhat, pos_sigma, 0.0, float(h))
            from jax.scipy.stats import norm

            ls = norm.logpdf(sq, shat, flux_sigma)
            return jax.nn.logsumexp(logq + lx + ly + ls)

        th_star = unconstrain(x_new[None], y_new[None],
                              jnp.exp(s_new)[None], spec)[0]
        theta_p = theta.at[j].set(th_star)
        loglik_p = loglik_fn(theta_p, mask)
        prior_ratio = -((s_new - prior.logf_mean) ** 2
                        - (s_j - prior.logf_mean) ** 2) / (
            2.0 * prior.logf_sigma * prior.logf_sigma)
        log_alpha = ((loglik_p - loglik)
                     + q3_log(xj, yj, s_j) - q3_log(x_new, y_new, s_new)
                     + prior_ratio)
    log_alpha = jnp.where(n > 0, log_alpha, -jnp.inf)
    accept = jnp.log(jax.random.uniform(k_acc)) < log_alpha

    theta_new = jnp.where(accept, theta_p, theta)
    loglik_new = jnp.where(accept, loglik_p, loglik)
    info = MoveInfo(accept, log_alpha, jnp.full((), 4, jnp.int32))
    return theta_new, mask, loglik_new, info


def split_merge_step(
    key: jax.Array,
    theta: jax.Array,
    mask: jax.Array,
    loglik: jax.Array,
    loglik_fn: Callable,
    prior: PriorSpec,
    spec: SceneSpec,
    cfg: TransDimConfig,
):
    """One split-or-merge proposal (flux-conserving, centroid-preserving)."""
    k_move, k_j, k_d, k_u, k_delta, k_acc = jax.random.split(key, 6)
    kmax = mask.shape[0]
    n = jnp.sum(mask)
    do_split = jax.random.bernoulli(k_move)
    sig = cfg.split_sigma
    log_q_norm = -math.log(2.0 * math.pi * sig * sig)  # log N2(delta;0,sig^2 I) const
    log_area = math.log(spec.width * spec.height)

    x, y, f = constrain(theta, spec)
    f = jnp.maximum(f, cfg.fmin)

    # ---- split ----------------------------------------------------------
    j = _gumbel_choice(k_j, mask)          # parent (alive)
    d = _gumbel_choice(k_d, 1.0 - mask)    # child-2 slot (dead)
    u = jax.random.uniform(k_u, minval=1e-4, maxval=1.0 - 1e-4)
    delta = sig * jax.random.normal(k_delta, (2,))
    xj, yj, fj = x[j], y[j], f[j]
    x1, y1 = xj + (1.0 - u) * delta[0], yj + (1.0 - u) * delta[1]
    x2, y2 = xj - u * delta[0], yj - u * delta[1]
    f1, f2 = u * fj, (1.0 - u) * fj

    in_bounds = (
        (x1 > 0.0) & (x1 < spec.width) & (x2 > 0.0) & (x2 < spec.width)
        & (y1 > 0.0) & (y1 < spec.height) & (y2 > 0.0) & (y2 < spec.height)
        # child fluxes must stay above the log floor, else the clamp below
        # would break split<->merge bijectivity (reject instead)
        & (f1 > cfg.fmin) & (f2 > cfg.fmin)
    )
    xc1, yc1 = jnp.clip(x1, 1e-3, spec.width - 1e-3), jnp.clip(y1, 1e-3, spec.height - 1e-3)
    xc2, yc2 = jnp.clip(x2, 1e-3, spec.width - 1e-3), jnp.clip(y2, 1e-3, spec.height - 1e-3)
    th1 = unconstrain(xc1[None], yc1[None], jnp.maximum(f1, cfg.fmin)[None], spec)[0]
    th2 = unconstrain(xc2[None], yc2[None], jnp.maximum(f2, cfg.fmin)[None], spec)[0]
    theta_s = theta.at[j].set(th1).at[d].set(th2)
    mask_s = mask.at[d].set(1.0)
    loglik_s = loglik_fn(theta_s, mask_s)

    # prior ratio (constrained): one extra uniform position + flux factorization
    log_prior_ratio_s = (
        -log_area
        + _log_flux_prior_constrained(f1, prior)
        + _log_flux_prior_constrained(f2, prior)
        - _log_flux_prior_constrained(fj, prior)
    )
    log_q_delta = log_q_norm - 0.5 * jnp.sum((delta / sig) ** 2)
    log_alpha_s = (
        (loglik_s - loglik)
        + jnp.log(cfg.lam_count) - jnp.log(n + 1.0)
        + log_prior_ratio_s
        + jnp.log(fj)          # |Jacobian| = parent flux
        - log_q_delta          # q(u) = 1
    )
    log_alpha_s = jnp.where((n >= 1) & (n < kmax) & in_bounds, log_alpha_s, -jnp.inf)

    # ---- merge ----------------------------------------------------------
    a = _gumbel_choice(k_j, mask)  # surviving slot
    # dying slot: alive, not a
    b = _gumbel_choice(k_d, mask * (1.0 - jax.nn.one_hot(a, kmax)))
    fa, fb = f[a], f[b]
    fm = fa + fb
    xm = (fa * x[a] + fb * x[b]) / fm
    ym = (fa * y[a] + fb * y[b]) / fm
    um = fa / fm
    delta_m = jnp.stack([x[a] - x[b], y[a] - y[b]])
    thm = unconstrain(
        jnp.clip(xm, 1e-3, spec.width - 1e-3)[None],
        jnp.clip(ym, 1e-3, spec.height - 1e-3)[None],
        jnp.maximum(fm, cfg.fmin)[None],
        spec,
    )[0]
    theta_m = theta.at[a].set(thm)
    mask_m = mask.at[b].set(0.0)
    loglik_m = loglik_fn(theta_m, mask_m)

    log_prior_ratio_m = (
        log_area
        + _log_flux_prior_constrained(fm, prior)
        - _log_flux_prior_constrained(fa, prior)
        - _log_flux_prior_constrained(fb, prior)
    )
    log_q_delta_m = log_q_norm - 0.5 * jnp.sum((delta_m / sig) ** 2)
    # reciprocal of the matching split from (n-1) alive:
    log_alpha_m = (
        (loglik_m - loglik)
        - jnp.log(cfg.lam_count) + jnp.log(jnp.maximum(n, 1.0))
        + log_prior_ratio_m
        - jnp.log(jnp.maximum(fm, cfg.fmin))
        + log_q_delta_m
    )
    # need n >= 2, and the implied reverse-split draw u_m must lie inside the
    # truncated U(1e-4, 1-1e-4) support used by the forward split
    um_ok = (um > 1e-4) & (um < 1.0 - 1e-4)
    log_alpha_m = jnp.where((n >= 2) & um_ok, log_alpha_m, -jnp.inf)

    log_alpha = jnp.where(do_split, log_alpha_s, log_alpha_m)
    accept = jnp.log(jax.random.uniform(k_acc)) < log_alpha

    theta_new = jnp.where(accept, jnp.where(do_split, theta_s, theta_m), theta)
    mask_new = jnp.where(accept, jnp.where(do_split, mask_s, mask_m), mask)
    loglik_new = jnp.where(accept, jnp.where(do_split, loglik_s, loglik_m), loglik)
    info = MoveInfo(accept, log_alpha, jnp.where(do_split, 2, 3))
    return theta_new, mask_new, loglik_new, info


def transdim_sweep(
    key: jax.Array,
    theta: jax.Array,
    mask: jax.Array,
    loglik: jax.Array,
    loglik_fn: Callable,
    prior: PriorSpec,
    spec: SceneSpec,
    cfg: TransDimConfig,
    image: jax.Array | None = None,
):
    """One trans-dimensional move: birth/death w.p. p_birth_death, else
    split/merge.  Single chain — vmap over (key, theta, mask, loglik).

    image: required when cfg.birth_proposal == "residual" (the data-driven
    birth positions need the raw counts image; loglik_fn may be tempered)."""
    k_sel, k_bd, k_sm = jax.random.split(key, 3)
    if cfg.birth_proposal == "residual":
        if image is None:
            raise ValueError("residual birth proposal needs the image")
        bd = birth_death_step_residual(
            k_bd, theta, mask, loglik, loglik_fn, prior, spec, image, cfg
        )
    else:
        bd = birth_death_step(k_bd, theta, mask, loglik, loglik_fn, prior, cfg)
    sm = split_merge_step(k_sm, theta, mask, loglik, loglik_fn, prior, spec, cfg)
    pick_bd = jax.random.bernoulli(k_sel, cfg.p_birth_death)
    out = jax.tree.map(lambda a, b: jnp.where(pick_bd, a, b), bd, sm)
    return out
