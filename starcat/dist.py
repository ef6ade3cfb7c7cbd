"""Distributed runtime / comms backend (SURVEY.md ⑭, §5.8).

The reference has no parallelism at all (single-process NumPy — SURVEY.md
§0/§2).  The scaling layer is GSPMD: one logical program, a named device
mesh, sharding annotations, and XLA-inserted collectives — reached
exclusively through jax.lax collectives inside jit (psum/all_gather),
which XLA hands to NCCL on GPUs.  The mesh is 1-D: every card of a host
reaches every other at the same rate, so no topology-shaped mesh is
needed.

Usage:
    init_distributed()                       # per-host, multi-host runs only
    mesh = make_mesh("chains")               # 1-D mesh over all devices
    theta = shard_chains(theta, mesh)        # chain/particle axis sharded
    ... jit-ed sampler runs unchanged; chain-axis means/logsumexps become
    psum collectives; resampling gathers become all-to-alls.

Chains/particles are embarrassingly parallel; the only communication is
pooled warmup adaptation (one scalar mean per iteration) and SMC
resampling (one logsumexp + one gather per temperature step), which is why
>=95% scaling efficiency is the acceptance target (BASELINE.json:5).
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Initialize jax.distributed for a multi-host run (no-op if single)."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def make_mesh(axis_name: str = "chains", n_devices: int | None = None) -> Mesh:
    """1-D mesh over (the first n of) all visible devices."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis_name,))


def chain_sharding(mesh: Mesh, ndim: int, axis_name: str = "chains") -> NamedSharding:
    """NamedSharding that splits the leading (chain/particle) axis."""
    return NamedSharding(mesh, P(axis_name, *([None] * (ndim - 1))))


def shard_chains(tree, mesh: Mesh, axis_name: str = "chains"):
    """device_put every leaf: leading (chain/particle) axis sharded over the
    mesh; 0-d leaves (step counters, temperatures, scalar PRNG keys — e.g.
    in an SMCState) replicated, so whole-state trees get a consistent
    mesh placement (jit refuses mixing single-device-committed scalars
    with sharded arrays)."""
    def put(x):
        if getattr(x, "ndim", None) == 0:
            return jax.device_put(x, NamedSharding(mesh, P()))
        return jax.device_put(x, chain_sharding(mesh, x.ndim, axis_name))

    return jax.tree.map(put, tree)


def constrain_chains(tree, mesh: Mesh, axis_name: str = "chains"):
    """with_sharding_constraint version for use inside jit."""
    return jax.tree.map(
        lambda x: jax.lax.with_sharding_constraint(
            x, chain_sharding(mesh, x.ndim, axis_name)
        ),
        tree,
    )


def make_pixel_sharded_loglik(spec, image, mesh: Mesh, axis_name: str = "pixels"):
    """Pixel-axis sharding escape hatch (SURVEY.md §5.7).

    Configs 0-4 fit per device and shard only chains/particles; when a
    scene ever exceeds one device's memory, the answer is to shard the
    PIXEL axis: each device renders its row block of the image
    (the separable likelihood needs no halo exchange — the PSF is evaluated
    analytically per pixel) and a single psum combines the per-shard
    partial log-likelihood sums.

    Returns loglik(theta, mask) -> scalar, differentiable (jax.grad flows
    through shard_map and the psum), with `image` pre-sharded by rows.
    Requires spec.height % n_devices == 0.
    """
    from functools import partial

    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    shard_map = jax.shard_map

    from .potential import constrain
    from .scene import gaussian_profile_1d, pixel_centers

    n_dev = mesh.devices.size
    assert spec.height % n_dev == 0, (spec.height, n_dev)
    img_sharded = jax.device_put(
        jnp.asarray(image), NamedSharding(mesh, P(axis_name, None))
    )

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(axis_name, None)),
        out_specs=P(),
    )
    def ll(theta, mask, img_block):
        h_blk = img_block.shape[0]
        row0 = jax.lax.axis_index(axis_name) * h_blk
        x, y, f = constrain(theta, spec)
        cx = pixel_centers(spec.width, theta.dtype)
        cy = jnp.arange(h_blk, dtype=theta.dtype) + (row0.astype(theta.dtype) + 0.5)
        gx = gaussian_profile_1d(x, cx, spec.psf_sigma)
        gy = gaussian_profile_1d(y, cy, spec.psf_sigma)  # local rows only
        w = f * mask
        lam = spec.background + jnp.einsum(
            "kh,kw->hw", gy * w[:, None], gx, precision="highest"
        )
        partial_sum = jnp.sum(img_block * jnp.log(lam) - lam)
        return jax.lax.psum(partial_sum, axis_name)

    def loglik(theta, mask):
        return ll(theta, mask, img_sharded)

    return loglik
