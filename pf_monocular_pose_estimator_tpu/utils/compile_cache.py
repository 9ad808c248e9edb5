"""Persistent XLA compilation cache.

The reference node starts instantly (pf_mpe/src/node.cpp:28-37 — C++ is
ahead-of-time compiled); this engine's flagship step is compiled by XLA
at first use.  JAX's persistent compilation cache serialises compiled
executables to an on-disk directory keyed by (HLO, compile options,
backend), so a start after the first deserialises instead of compiling.

One rule picks the directory: `JAX_COMPILATION_CACHE_DIR` when it is set
(JAX reads it itself, and nothing here sets another), otherwise the fixed
`<checkout>/.jax_cache`, which `.gitignore` lists.  The CLI, bench.py,
chip_smoke.py and the test suite all call `enable_persistent_cache`.
Opt out with --no-cache / PFMPE_NO_COMPILE_CACHE=1.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_persistent_cache() -> str | None:
    """Point JAX at the on-disk compilation cache.  Returns the directory
    used, or None when disabled via PFMPE_NO_COMPILE_CACHE."""
    if os.environ.get("PFMPE_NO_COMPILE_CACHE", "") not in ("", "0"):
        return None
    import jax

    path = os.environ.get(ENV_VAR) or DEFAULT_DIR
    if not os.environ.get(ENV_VAR):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    # cache every entry regardless of size that took meaningful compile
    # time (the tracker step takes seconds to minutes; small helper jits
    # are cheap either way)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
