"""Runtime program-size limit and compile-cache location.

    STARCAT_MAX_PROGRAM_STEPS=<n>   cap scan/loop bodies at n steps per
                                    compiled program (n <= 0 or unset:
                                    unlimited)

Unset, whole passes fuse into one program (the GSPMD multi-device reference
path); a cap splits warmup and SMC tempering into smaller programs.

The persistent compile cache goes where ``JAX_COMPILATION_CACHE_DIR`` says;
otherwise the entry points (``python -m starcat``, ``bench.py``,
``chip_smoke.py``) put it in ``.jax_cache/`` at the checkout root — a fixed
path, so the cache hits across processes.
"""
from __future__ import annotations

import os

import jax

_ENV_VAR = "STARCAT_MAX_PROGRAM_STEPS"
CACHE_ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def max_program_steps() -> int | None:
    """Per-program step cap for scan/loop-heavy device programs.

    None means unlimited (fuse whole passes into one program).  Reads
    STARCAT_MAX_PROGRAM_STEPS on every call so tests and long-lived
    processes can adjust it.
    """
    env = os.environ.get(_ENV_VAR, "").strip()
    if env:
        v = int(env)
        return None if v <= 0 else v
    return None


def cap_block(block: int | None, fallback: int) -> int:
    """Resolve a block size against the program-step cap.

    block=None means "one program" (use fallback as its length); the cap,
    when set, bounds the result.
    """
    n = fallback if block is None else block
    cap = max_program_steps()
    return n if cap is None else min(n, cap)


def configure_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory.

    Where JAX_COMPILATION_CACHE_DIR is set JAX reads it itself and nothing
    is set here; otherwise the cache goes to the fixed in-checkout
    DEFAULT_CACHE_DIR.  Returns the directory in use."""
    env = os.environ.get(CACHE_ENV_VAR, "").strip()
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
