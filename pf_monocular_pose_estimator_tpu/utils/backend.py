"""The one place that maps the JAX platform to an implementation.

Every stage runs as plain XLA except the PF propagate+weight step, which
has a hand-written kernel for the GPU (pf/pallas_step.py, Pallas through
Triton).  Callers ask `pf_route()` instead of testing the backend
themselves; a platform with no route is an error, never a fallback.
"""

from __future__ import annotations

import jax

_PF_ROUTES = {"gpu": "triton", "cpu": "xla"}


def pf_route(platform: str | None = None) -> str:
    """Implementation of the PF propagate+weight step on `platform`
    (default: `jax.default_backend()`): "triton" or "xla"."""
    platform = jax.default_backend() if platform is None else platform
    try:
        return _PF_ROUTES[platform]
    except KeyError:
        raise ValueError(
            f"no implementation for platform {platform!r} "
            f"(supported: {', '.join(sorted(_PF_ROUTES))})"
        ) from None


def require_gpu():
    """The devices of a measurement run: JAX's devices when they are
    GPUs; otherwise SystemExit(1) — a measurement never falls back to
    the CPU."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"error: no GPU found (JAX platform: {devices[0].platform}); "
            "this measurement runs on the card only"
        )
    return devices


def card_label() -> str:
    """The card's name and power limit as `nvidia-smi` reports them
    (one line per card): every number measured on the card is printed
    beside this label."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()
