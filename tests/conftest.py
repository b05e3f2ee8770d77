"""Test configuration: force an 8-device CPU mesh so sharding paths are
exercised without accelerator hardware, and keep x64 on for 64-bit k-mer
words.

jax.config is updated as well as the env var, so a host with a GPU still
runs the suite on the CPU. Tests marked `chip` (tests/test_chip.py) need
the card and skip here; chip_smoke.py runs them on it."""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import bronko_tpu  # noqa: F401,E402  (enables jax x64)
