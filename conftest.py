"""Root conftest: force CPU + a fake 8-device mesh for all tests.

Tests exercise sharding/collective code paths on a virtual 8-device CPU
backend (`--xla_force_host_platform_device_count=8`), the standard JAX trick
for testing multi-device code without a cluster (SURVEY.md §4.2).  The GPU
kernel runs in the Pallas interpreter here; on the card it is checked by
`python chip_smoke.py`.

jax.config.update pins the platform before any backend initializes
(backends are lazy and pytest imports conftest first), so the suite stays
on the CPU even where a GPU is visible.
"""
import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
