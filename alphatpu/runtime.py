"""Process-wide settings and device facts shared by the entry points
(``cli.main``, ``bench.main``, ``chip_smoke.py`` and the test
configuration)."""
from __future__ import annotations

import os
import subprocess

# The checkout's own cache: a fixed path, so that a later process on the
# same checkout finds what an earlier one compiled (the path is part of
# the cache key).  Listed in .gitignore.
CHECKOUT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def setup_compile_cache() -> str:
    """Point JAX's persistent compilation cache (before the first compile)
    at ``JAX_COMPILATION_CACHE_DIR`` when it is set, else at
    ``.jax_cache/`` at the root of the checkout; return the directory."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or CHECKOUT_CACHE
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def card_info() -> str:
    """nvidia-smi's name and power limit of each card, one line per card
    (read by a child process that stays off JAX)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
