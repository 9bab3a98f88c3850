"""Test configuration: force the CPU with 8 virtual devices.

Tests run on the CPU so they stay deterministic and parallel-safe; the 8
virtual devices exercise the sharded code paths (SURVEY.md section 4: the
same code runs unchanged on several GPUs).  What runs only on the card is
checked by ``chip_smoke.py``.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

from sdpcutsel_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)
enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

assert jax.default_backend() == "cpu", "tests must run on CPU"

