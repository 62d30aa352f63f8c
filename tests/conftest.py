"""Test configuration: force CPU backend with 8 virtual devices.

Multi-device sharding tests run on a virtual 8-device CPU mesh, the
answer to multi-device testing without a cluster (SURVEY.md §4).
"""

import os
import tempfile

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("FGK_INTEGRAL_CACHE",
                      os.path.join(tempfile.gettempdir(),
                                   "fgk_integral_cache"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
