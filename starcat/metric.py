"""Fisher / Riemannian metric (SURVEY.md ④; BASELINE.json:8 "RHMC with
Riemannian mass matrix").

The metric is the Fisher information of the Poisson likelihood in the
unconstrained parameterization, plus the prior information, plus a small
jitter — a smooth, position-dependent PD matrix:

    G(theta) = J^T diag(1/lam) J  +  diag(prior_info)  +  jitter * I

where J[p, a] = d lam_p / d theta_a.  (For a Poisson field, the Fisher
information is E[grad grad^T log L] = sum_p (d lam/d a)(d lam/d b)/lam_p;
e.g. the flux-flux block reduces to the classic sum_p PSF_p^2 / lam_p —
SURVEY.md ④.)

Shape: J is assembled from the separable PSF profiles and contracted as
one (3K, P) @ (P, 3K) matmul, batched over chains by vmap.

Dead catalog slots get exact identity rows/columns (their J rows are zero
because d lam / d theta_dead = 0, and their prior term is masked), so the
metric stays PD and the Riemannian flow freezes them.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .potential import PriorSpec, constrain
from .scene import (
    SceneSpec,
    gaussian_profile_1d,
    gaussian_profile_1d_grad,
    pixel_centers,
)


def scene_jacobian(theta: jax.Array, mask: jax.Array, spec: SceneSpec):
    """(lam, J): lam (H, W); J (K, 3, H, W) = d lam / d theta (unconstrained)."""
    x, y, f = constrain(theta, spec)
    cx = pixel_centers(spec.width, theta.dtype)
    cy = pixel_centers(spec.height, theta.dtype)
    gx = gaussian_profile_1d(x, cx, spec.psf_sigma)        # (K, W)
    gy = gaussian_profile_1d(y, cy, spec.psf_sigma)        # (K, H)
    dgx = gaussian_profile_1d_grad(x, cx, spec.psf_sigma)  # d gx / d x
    dgy = gaussian_profile_1d_grad(y, cy, spec.psf_sigma)
    w = f * mask
    lam = spec.background + jnp.einsum("kh,kw->hw", gy * w[:, None], gx, precision="highest")

    sx = jax.nn.sigmoid(theta[..., 0])
    sy = jax.nn.sigmoid(theta[..., 1])
    dx_dux = spec.width * sx * (1.0 - sx)    # (K,)
    dy_duy = spec.height * sy * (1.0 - sy)

    # outer products per star: (K, H, W)
    j_ux = (w * dx_dux)[:, None, None] * gy[:, :, None] * dgx[:, None, :]
    j_uy = (w * dy_duy)[:, None, None] * dgy[:, :, None] * gx[:, None, :]
    j_s = w[:, None, None] * gy[:, :, None] * gx[:, None, :]  # d lam/d s = f*psf
    j = jnp.stack([j_ux, j_uy, j_s], axis=1)  # (K, 3, H, W)
    return lam, j


def prior_information(theta: jax.Array, mask: jax.Array, prior: PriorSpec) -> jax.Array:
    """Negative Hessian of the log prior, diagonal, shape (K, 3)."""
    u_pos = theta[..., :2]
    s_pos = jax.nn.sigmoid(u_pos)
    info_pos = 2.0 * s_pos * (1.0 - s_pos)          # -d2/du2 of the logit-uniform
    info_flux = jnp.full(theta.shape[:-1], 1.0 / prior.logf_sigma**2, theta.dtype)
    info = jnp.concatenate([info_pos, info_flux[..., None]], axis=-1)
    return info * mask[..., None]


def make_metric_fn(spec: SceneSpec, prior: PriorSpec, jitter: float = 1e-3):
    """Return metric(theta, mask) -> G, a (3K, 3K) PD matrix (single chain;
    vmap outside — mask may vary per chain for trans-dimensional heads)."""

    def metric(theta: jax.Array, mask: jax.Array, beta=1.0) -> jax.Array:
        # beta tempers the likelihood Fisher block (SMC mutation target);
        # beta=1 is the posterior metric used by the RHMC head.
        k = theta.shape[0]
        d = 3 * k
        lam, j = scene_jacobian(theta, mask, spec)
        jf = j.reshape(d, -1)                          # (3K, P)
        fisher = jnp.einsum("ap,bp->ab", jf / lam.reshape(-1), jf, precision="highest")         # (3K, 3K) matmul
        info = prior_information(theta, mask, prior).reshape(d)
        mask_p = jnp.repeat(mask, 3)                   # per-param alive mask
        g = beta * fisher + jnp.diag(info)
        # exact identity rows/cols for dead slots (fisher rows already zero)
        g = g * jnp.outer(mask_p, mask_p) + jnp.diag(1.0 - mask_p)
        return g + jitter * jnp.eye(d, dtype=theta.dtype)

    return metric


def make_diag_metric_fn(spec: SceneSpec, prior: PriorSpec, jitter: float = 1e-3):
    """Diagonal-Fisher metric: diag(theta, mask) -> g, a (3K,) vector equal
    to the DIAGONAL of make_metric_fn's full matrix (exactly — tested).

    Rationale (measured, round 2): the full-metric RHMC mutation at the
    crowded-field shape (K=50, 128x128) is dominated by the (3K, P)@(P, 3K)
    Fisher contraction and the autodiff through it + the Cholesky, repeated
    every Picard sweep.  The diagonal g_a = sum_p J[a,p]^2 / lam_p keeps the
    metric position-dependent (the Hamiltonian is still non-separable and
    still adapts to per-star flux/position information) but costs O(3K*P)
    instead of O((3K)^2 * P), needs no Cholesky (momenta ~ N(0, diag g)),
    and its dH/dtheta is one cheap reverse-mode grad.  MH acceptance is
    exact for whichever metric is used — the metric choice only affects
    mixing, not the invariant distribution.
    """

    def diag_metric(theta: jax.Array, mask: jax.Array, beta=1.0) -> jax.Array:
        # Separable bilinear form: every diagonal Fisher entry is
        #   sum_hw (row_k[h] * col_k[w])^2 / lam[h,w]
        # with row/col the 1-D PSF profiles (or their derivatives), so
        #   g[k] = coef_k^2 * (row_k^2 @ (1/lam) @ col_k^2)
        # — two (K,H)@(H,W) matmuls shared across the three parameter
        # types, never materializing the (K,3,H,W) Jacobian (the J-form
        # moves several times more bytes at the 128x128 crowded field).
        x, y, f = constrain(theta, spec)
        cx = pixel_centers(spec.width, theta.dtype)
        cy = pixel_centers(spec.height, theta.dtype)
        gx = gaussian_profile_1d(x, cx, spec.psf_sigma)        # (K, W)
        gy = gaussian_profile_1d(y, cy, spec.psf_sigma)        # (K, H)
        dgx = gaussian_profile_1d_grad(x, cx, spec.psf_sigma)
        dgy = gaussian_profile_1d_grad(y, cy, spec.psf_sigma)
        w = f * mask
        lam = spec.background + jnp.einsum(
            "kh,kw->hw", gy * w[:, None], gx, precision="highest"
        )
        r = 1.0 / lam                                          # (H, W)
        p1 = jnp.einsum("kh,hw->kw", gy * gy, r, precision="highest")
        p2 = jnp.einsum("kh,hw->kw", dgy * dgy, r, precision="highest")

        sx = jax.nn.sigmoid(theta[..., 0])
        sy = jax.nn.sigmoid(theta[..., 1])
        dx_dux = spec.width * sx * (1.0 - sx)
        dy_duy = spec.height * sy * (1.0 - sy)

        f_ux = (w * dx_dux) ** 2 * jnp.sum(p1 * dgx * dgx, axis=-1)
        f_uy = (w * dy_duy) ** 2 * jnp.sum(p2 * gx * gx, axis=-1)
        f_s = w**2 * jnp.sum(p1 * gx * gx, axis=-1)
        fisher = jnp.stack([f_ux, f_uy, f_s], axis=-1)         # (K, 3)

        info = prior_information(theta, mask, prior)           # (K, 3)
        g = beta * fisher + info
        m3 = mask[:, None]
        g = g * m3 + (1.0 - m3)                                # dead slots exactly 1
        return g.reshape(-1) + jitter                          # (3K,)

    return diag_metric
