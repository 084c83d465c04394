"""Test configuration: run JAX on a virtual 8-device CPU mesh.

The tests run on the CPU: the keyword kernel in interpret mode, every other
program through XLA's CPU backend, and multi-device sharding paths on
emulated CPU devices (SURVEY.md §4). jax.config.update pins the platform
even when JAX was imported before this file; XLA_FLAGS is read when the CPU
client first initializes. The GPU path is exercised by chip_smoke.py.
"""

import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
