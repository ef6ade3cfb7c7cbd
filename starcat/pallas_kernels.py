"""Fused leapfrog trajectory kernel for the GPU (Pallas, Triton route).

Why a kernel: under XLA each leapfrog step of the vmapped potential is a
handful of small kernels inside a while loop, and each writes per-chain
(H, W) fields (the rendered scene lam, the Poisson residual) to device
memory and reads them back.  A whole trajectory only needs the image (4 KB
at 32x32) and ~30 parameters per chain, so it can stay on the chip for all
L steps: device memory sees theta/p/grad in and theta/p/U/grad out, once
per trajectory.

Design (one program = one chain, the grid runs over chains, so any chain
count works):
  - the per-star profiles are built as (W, K) and (H, K) tiles, K padded to
    16 and the image to powers of two (>= 16), padding masked;
  - render and gradient are three in-kernel products per evaluation:
    lam = bg + gy (H,K) @ gxw^T (K,W), then rgx = R (H,W) @ gxw (W,K) and
    the same against the position-weighted profiles, with R = D/lam - 1;
    the flux/x/y gradients are column sums of (H, K) tiles;
  - the products run at float32 ("ieee" input precision, no TF32) on the
    CUDA cores; they are far too small to gain from the tensor cores;
  - the trip count is an operand: one compiled kernel serves the static-L
    hmc head and ChEES's adapted length alike, and the entry gradient is
    reused, so a trajectory of n steps costs exactly n evaluations;
  - the math mirrors potential.make_potential_and_grad (same unconstrained
    parameterization and priors), so the MH accept on kernel U values is
    exact; tests cross-check against the XLA path to float tolerance.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .potential import PriorSpec
from .scene import SceneSpec

# the smallest dimension Triton's dot takes
MIN_DIM = 16
# image tiles beyond 64x64 (or more than 32 catalog slots) would spill a
# program's registers: the crowded field stays on the XLA path
MAX_PIXELS = 64 * 64
MAX_K = 32
_PRECISION = lax.Precision.HIGHEST  # float32 products, no TF32


def _pow2(n: int) -> int:
    return max(1 << max(int(n) - 1, 0).bit_length(), MIN_DIM)


def fused_supported(spec: SceneSpec, kmax: int) -> bool:
    """Does the scene fit the kernel's per-program tiles?"""
    return (_pow2(spec.height) * _pow2(spec.width) <= MAX_PIXELS
            and _pow2(kmax) <= MAX_K)


def num_warps(spec: SceneSpec) -> int:
    """One warp per 32x32 image tile (measured fastest at the cfg6 shape)."""
    return max(1, _pow2(spec.height) * _pow2(spec.width) // 1024)


def _grad_eval(ux, uy, s, mask, img, spec: SceneSpec, prior: PriorSpec,
               hp: int, wp: int, with_u: bool):
    """U and dU/dtheta for one chain.

    ux, uy, s, mask: (1, Kp) rows.  img: (Hp, Wp) zero-padded image.
    Returns (u scalar, (gux, guy, gs) each (1, Kp))."""
    h, w = spec.height, spec.width
    sig = spec.psf_sigma
    norm = 1.0 / (math.sqrt(2.0 * math.pi) * sig)

    sx = 1.0 / (1.0 + jnp.exp(-ux))
    sy = 1.0 / (1.0 + jnp.exp(-uy))
    wk = jnp.exp(s) * mask                                   # masked flux
    cx = lax.broadcasted_iota(jnp.int32, (wp, 1), 0)
    cy = lax.broadcasted_iota(jnp.int32, (hp, 1), 0)
    zx = (cx.astype(jnp.float32) + 0.5 - w * sx) / sig       # (Wp, Kp)
    zy = (cy.astype(jnp.float32) + 0.5 - h * sy) / sig       # (Hp, Kp)
    gxw = jnp.exp(-0.5 * zx * zx) * norm * (cx < w).astype(jnp.float32) * wk
    gy = jnp.exp(-0.5 * zy * zy) * norm

    lam = spec.background + pl.dot(gy, gxw, trans_b=True,
                                   precision=_PRECISION)     # (Hp, Wp)
    valid = ((cy < h) & (lax.broadcasted_iota(jnp.int32, (1, wp), 1) < w)
             ).astype(jnp.float32)
    r = (img / lam - 1.0) * valid
    rg = pl.dot(r, gxw, precision=_PRECISION)                # (Hp, Kp)
    rgz = pl.dot(r, gxw * zx, precision=_PRECISION)
    d_s = jnp.sum(gy * rg, axis=0, keepdims=True)            # dloglik/ds
    d_x = jnp.sum(gy * rgz, axis=0, keepdims=True) / sig     # dloglik/dx
    d_y = jnp.sum(gy * zy * rg, axis=0, keepdims=True) / sig

    # chain rule to unconstrained coordinates + priors (potential.py)
    zf = (s - prior.logf_mean) / prior.logf_sigma
    gux = -(d_x * w * sx * (1.0 - sx) + (1.0 - 2.0 * sx)) * mask
    guy = -(d_y * h * sy * (1.0 - sy) + (1.0 - 2.0 * sy)) * mask
    gs = -(d_s - zf / prior.logf_sigma) * mask
    if not with_u:
        return None, (gux, guy, gs)
    ll = jnp.sum((img * jnp.log(lam) - lam) * valid)
    # softplus(u) + softplus(-u) = |u| + 2 log1p(exp(-|u|))
    lp_pos = -(jnp.abs(ux) + 2.0 * jnp.log1p(jnp.exp(-jnp.abs(ux)))
               + jnp.abs(uy) + 2.0 * jnp.log1p(jnp.exp(-jnp.abs(uy))))
    lp_flux = (-0.5 * zf * zf - math.log(prior.logf_sigma)
               - 0.5 * math.log(2.0 * math.pi))
    return -(ll + jnp.sum((lp_pos + lp_flux) * mask)), (gux, guy, gs)


def _leapfrog_kernel(n_ref, img_ref, eps_ref, invm_ref, mask_ref, *refs,
                     spec, prior, hp, wp):
    ins, outs = refs[:9], refs[9:]
    n = n_ref[()]
    eps = eps_ref[...]                                       # (1, 1)
    img = img_ref[...]
    invm = tuple(invm_ref[pl.ds(j, 1), :] for j in range(3))  # (1, Kp) each
    mask = mask_ref[...]
    th, p, g = (tuple(r[...] for r in ins[j:j + 3]) for j in (0, 3, 6))

    def evaluate(th, with_u):
        return _grad_eval(*th, mask, img, spec, prior, hp, wp, with_u)

    def drift(th, p, g):
        ph = tuple(pj - 0.5 * eps * gj for pj, gj in zip(p, g))
        th = tuple(tj + eps * mj * phj for tj, mj, phj in zip(th, invm, ph))
        return th, ph

    def kick(ph, g):
        return tuple(phj - 0.5 * eps * gj for phj, gj in zip(ph, g))

    def step(_, carry):
        th, p, g = carry
        th, ph = drift(th, p, g)
        _, g = evaluate(th, with_u=False)
        return th, kick(ph, g), g

    # n - 1 steps without the log-likelihood; the last one also returns U
    th, p, g = lax.fori_loop(0, n - 1, step, (th, p, g))
    th, ph = drift(th, p, g)
    u, g = evaluate(th, with_u=True)
    p = kick(ph, g)

    for ref, val in zip(outs[0:6] + outs[7:10], th + p + g):
        ref[...] = val
    outs[6][...] = jnp.broadcast_to(u, (1, 1))


def _split(a: jax.Array, kp: int):
    """(C, K, 3) -> three zero-padded (C, Kp) planes."""
    a = jnp.pad(a.astype(jnp.float32), ((0, 0), (0, kp - a.shape[1]), (0, 0)))
    return a[..., 0], a[..., 1], a[..., 2]


def make_pallas_leapfrog(
    spec: SceneSpec,
    image: jax.Array,
    prior: PriorSpec,
    kmax: int,
    interpret: bool = False,
):
    """Build fused(theta (C,K,3), p (C,K,3), eps, inv_mass (K,3),
    mask (K,) or (C,K), n_steps, grad (C,K,3)) -> (theta', p', u' (C,),
    grad' (C,K,3)).

    eps is a scalar or a per-chain (C,) vector (step-size jitter); mask is
    shared (K,) or per-chain (C,K) (the trans-dimensional head).  n_steps is
    a traced or Python integer >= 1; ``grad`` is dU/dtheta at the entry
    theta, so the trajectory costs exactly n_steps gradient evaluations.
    interpret=True runs the Pallas interpreter (tests on the CPU).
    """
    kp, hp, wp = _pow2(kmax), _pow2(spec.height), _pow2(spec.width)
    img = jnp.pad(jnp.asarray(image, jnp.float32),
                  ((0, hp - spec.height), (0, wp - spec.width)))

    def body(*refs):
        _leapfrog_kernel(*refs, spec=spec, prior=prior, hp=hp, wp=wp)

    def fused(theta, p, eps, inv_mass, mask, n_steps, grad):
        c = theta.shape[0]
        eps_c = jnp.broadcast_to(
            jnp.asarray(eps, jnp.float32).reshape(-1), (c,)).reshape(c, 1)
        mask_c = jnp.pad(
            jnp.broadcast_to(jnp.asarray(mask, jnp.float32), (c, kmax)),
            ((0, 0), (0, kp - kmax)))
        invm = jnp.pad(jnp.asarray(inv_mass, jnp.float32).T,
                       ((0, 1), (0, kp - kmax)))             # (4, Kp)
        chain = pl.BlockSpec((1, kp), lambda i: (i, 0))
        scalar = pl.BlockSpec((1, 1), lambda i: (i, 0))
        plane = jax.ShapeDtypeStruct((c, kp), jnp.float32)
        out = pl.pallas_call(
            body,
            grid=(c,),
            in_specs=[pl.BlockSpec((), lambda i: ()),
                      pl.BlockSpec((hp, wp), lambda i: (0, 0)), scalar,
                      pl.BlockSpec((4, kp), lambda i: (0, 0))]
            + [chain] * 10,
            out_specs=[chain] * 6 + [scalar] + [chain] * 3,
            out_shape=[plane] * 6 + [jax.ShapeDtypeStruct((c, 1), jnp.float32)]
            + [plane] * 3,
            compiler_params=plgpu.CompilerParams(num_warps=num_warps(spec),
                                                 num_stages=1),
            interpret=interpret,
            name="starcat_leapfrog",
        )(jnp.asarray(n_steps, jnp.int32), img, eps_c, invm, mask_c,
          *_split(theta, kp), *_split(p, kp), *_split(grad, kp))
        unpad = lambda planes: jnp.stack(planes, axis=-1)[:, :kmax]
        return unpad(out[0:3]), unpad(out[3:6]), out[6][:, 0], unpad(out[7:10])

    return fused
