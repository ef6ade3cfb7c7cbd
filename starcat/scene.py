"""Scene / PSF model (SURVEY.md §2 component ①).

The forward model is a pixel-grid intensity ("scene")

    lam[h, w] = background + sum_k alive_k * flux_k * PSF(w - x_k, h - y_k)

with a symmetric Gaussian PSF of fixed width ``psf_sigma`` (the reference's
fixed-PSF toy model; reference is unavailable — see SURVEY.md §0 — so the
spec is BASELINE.json:5,7: "PSF-convolved scene model", "fixed PSF").

Design
------
The Gaussian PSF is *separable*: PSF(dx, dy) = g(dx) g(dy).  Rendering is
therefore a matrix product rather than a per-star scatter:

    Gy : (K, H)   per-star column profiles   g(h + 0.5 - y_k)
    Gx : (K, W)   per-star row    profiles   g(w + 0.5 - x_k)
    lam = background + (Gy * w[:, None]).T @ Gx        # (H,K) @ (K,W) matmul

which batches over chains as a batched matmul.  Gradients of the Poisson log-likelihood reduce to two more
matmuls of the same shape (see potential.py) — the whole hot path is
matmul-shaped by construction.

Conventions: x runs along the width axis (columns, index ``w``), y along the
height axis (rows, index ``h``); pixel (h, w) is centered at
(w + 0.5, h + 0.5).  The PSF is point-evaluated at pixel centers (standard
for toy models) so a star well inside the image has total flux ≈ ``flux_k``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp


class SceneSpec(NamedTuple):
    """Static description of the image / PSF (hashable; safe to close over)."""

    height: int
    width: int
    psf_sigma: float
    background: float


def pixel_centers(n: int, dtype=jnp.float32) -> jax.Array:
    """Coordinates of pixel centers along one axis: 0.5, 1.5, ..., n - 0.5."""
    return jnp.arange(n, dtype=dtype) + jnp.asarray(0.5, dtype)


def gaussian_profile_1d(centers: jax.Array, coords: jax.Array, sigma: float) -> jax.Array:
    """Normalized 1-D Gaussian profiles.

    Args:
      centers: (K,) star coordinates along this axis.
      coords:  (N,) pixel-center coordinates.
      sigma:   PSF width (pixels).

    Returns:
      (K, N) array; row k is g(coords - centers[k]) with unit integral over
      an infinite unit-spaced grid (so a 2-D product of two profiles carries
      total flux ≈ 1).
    """
    z = (coords[None, :] - centers[:, None]) / sigma
    norm = 1.0 / (math.sqrt(2.0 * math.pi) * sigma)
    return jnp.exp(-0.5 * z * z) * norm


def gaussian_profile_1d_grad(centers: jax.Array, coords: jax.Array, sigma: float) -> jax.Array:
    """d/d center of :func:`gaussian_profile_1d` — (K, N)."""
    g = gaussian_profile_1d(centers, coords, sigma)
    return g * (coords[None, :] - centers[:, None]) / (sigma * sigma)


def render_profiles(x: jax.Array, y: jax.Array, spec: SceneSpec):
    """Per-star separable profiles (Gy, Gx): shapes (K, H) and (K, W)."""
    gx = gaussian_profile_1d(x, pixel_centers(spec.width, x.dtype), spec.psf_sigma)
    gy = gaussian_profile_1d(y, pixel_centers(spec.height, y.dtype), spec.psf_sigma)
    return gy, gx


def render_scene(
    x: jax.Array,
    y: jax.Array,
    flux: jax.Array,
    mask: jax.Array,
    spec: SceneSpec,
) -> jax.Array:
    """Render the expected-counts image lam, shape (H, W).

    Dead slots (mask == 0) contribute exactly zero (SURVEY.md §7.3:
    masked fixed-capacity catalog for trans-dimensionality under static
    shapes).
    """
    gy, gx = render_profiles(x, y, spec)
    w = flux * mask  # (K,)
    # (H,K) @ (K,W); XLA batches this under vmap over chains.
    img = jnp.einsum("kh,kw->hw", gy * w[:, None], gx, precision="highest")
    return spec.background + img


def make_mock_image(
    key: jax.Array,
    x: jax.Array,
    y: jax.Array,
    flux: jax.Array,
    spec: SceneSpec,
    mask: jax.Array | None = None,
) -> jax.Array:
    """Draw a Poisson mock observation from the scene (counts image, float)."""
    if mask is None:
        mask = jnp.ones_like(flux)
    lam = render_scene(x, y, flux, mask, spec)
    return jax.random.poisson(key, lam).astype(lam.dtype)
