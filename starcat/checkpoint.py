"""Checkpoint / resume (SURVEY.md ㉑, §5.4) of sampler-state pytrees
(positions, PRNG keys, adaptation state, SMC weights/temperature).

A checkpoint is one NumPy ``.npz`` archive holding the flattened pytree's leaves as
host arrays; the structure comes from a template on restore.  PRNG keys are
stored as their raw key data.  MCMC is trivially restartable: a checkpoint
plus a fresh process gives checkpoint-restart recovery (SURVEY.md §5.3).
"""
from __future__ import annotations

import os
from typing import Any

import jax
import numpy as np


def save_state(path: str, state: Any) -> None:
    """Save a sampler-state pytree (ChainState, SMCState, ...) to `path`.

    The file is written next to its target and renamed into place, so a
    crash mid-save leaves the previous checkpoint intact."""
    target = os.path.abspath(os.fspath(path))
    os.makedirs(os.path.dirname(target), exist_ok=True)
    leaves = jax.tree.leaves(jax.tree.map(_key_to_data, state))
    tmp = target + ".tmp"
    with open(tmp, "wb") as fh:  # a file object: np.savez adds no suffix
        np.savez(fh, *[np.asarray(jax.device_get(x)) for x in leaves])
    os.replace(tmp, target)


def restore_state(path: str, like: Any) -> Any:
    """Restore a pytree saved by save_state; `like` supplies the structure
    (a state with the same shapes/dtypes, e.g. a freshly-initialized one).

    Every restored leaf is device_put to the corresponding `like` leaf's
    sharding, so restoring into a NamedSharding-sharded template
    (dist.shard_chains over a mesh) yields a state that resumes directly on
    the mesh.  A file whose leaves do not match the template raises."""
    flat_like, treedef = jax.tree.flatten(like)
    with np.load(os.path.abspath(os.fspath(path))) as data:
        flat = [data[f"arr_{i}"] for i in range(len(data.files))]
    if len(flat) != len(flat_like):
        raise ValueError(
            f"checkpoint {path!r} holds {len(flat)} leaves, the template "
            f"{len(flat_like)}"
        )
    out = []
    for l, r in zip(flat_like, flat):
        want = np.shape(jax.random.key_data(l)) if _is_key(l) else np.shape(l)
        if r.shape != want:
            raise ValueError(
                f"checkpoint {path!r}: leaf shape {r.shape} != template {want}"
            )
        if _is_key(l):
            r = jax.random.wrap_key_data(r, impl=jax.random.key_impl(l))
        if isinstance(l, jax.Array):
            r = jax.device_put(r, l.sharding)
        out.append(r)
    return jax.tree.unflatten(treedef, out)


def _is_key(x):
    return isinstance(x, jax.Array) and jax.dtypes.issubdtype(x.dtype, jax.dtypes.prng_key)


def _key_to_data(x):
    return jax.random.key_data(x) if _is_key(x) else x
