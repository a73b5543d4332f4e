"""Device runtime management (role of ``gpu_comp.c``).

The reference's L1 layer does four things (``/root/reference/gpu_comp.c``):
platform/device discovery with an accelerator-then-CPU preference
(``:35-44``), capability validation (double-precision support, ``:55-63``),
fatal-error context setup (``diequick``, ``:15-19``), and a cleanup-callback
registry (``register_cleanup``/``gpu_cleanup``, ``:93-114``).  JAX owns
context/teardown, so the equivalents here are thinner but the capability
surface is preserved: discovery + preference order, dtype capability
validation (float64 needs the x64 flag), the one accelerator-or-CPU
question callers ask (:func:`on_accelerator`), memory bounds taken from
the device (:func:`memory_budget`), the persistent compile
cache (:func:`enable_compile_cache`), and an atexit-backed cleanup
registry for resources the library hands out (mmap'd datasets, trace
sessions).
"""

from __future__ import annotations

import atexit
import os
from pathlib import Path
from typing import Callable

# The checkout (or install) root: the compile cache's fixed home when
# JAX_COMPILATION_CACHE_DIR is unset.  Listed in .gitignore.
COMPILE_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"

_cleanups: list[Callable[[], None]] = []
_registered = False


def device_init(prefer: str | None = None, require_dtype=None):
    """Discover and return the compute device (role of ``gpu_init``).

    prefer: 'gpu' | 'cpu' | None.  None = accelerator if present,
    CPU otherwise — the reference's GPU|ACCELERATOR-then-CPU scan order
    (``gpu_comp.c:35-44``).  require_dtype validates capability up front
    (the reference refuses devices without double support in double mode,
    ``gpu_comp.c:55-63``); float64 here requires ``jax_enable_x64``.
    """
    import jax

    if prefer:
        devs = jax.devices(prefer)  # raises RuntimeError if absent
        dev = devs[0]
    else:
        dev = jax.devices()[0]  # jax orders accelerators first
    if require_dtype is not None:
        import jax.numpy as jnp

        dt = jnp.dtype(require_dtype)
        if dt == jnp.dtype("float64") and not jax.config.jax_enable_x64:
            raise RuntimeError(
                "float64 requested but jax_enable_x64 is off; call "
                "jax.config.update('jax_enable_x64', True) first "
                "(role of the reference's double-support check)"
            )
    return dev


def on_accelerator(devices) -> bool:
    """Whether work on ``devices`` (e.g. ``array.devices()`` or
    ``mesh.devices.flat``) runs on an accelerator rather than the CPU
    backend: where it does, the tuners time their trials; on the CPU they
    rank by a deterministic cost proxy."""
    return all(d.platform != "cpu" for d in devices)


def memory_budget(share: float, no_limit_bytes: int, device=None) -> int:
    """``share`` of ``device``'s ``memory_stats()["bytes_limit"]`` (default:
    JAX's first device), or ``no_limit_bytes`` where the device reports
    no limit (the CPU backend)."""
    import jax

    device = jax.devices()[0] if device is None else device
    limit = (device.memory_stats() or {}).get("bytes_limit")
    return int(share * limit) if limit else int(no_limit_bytes)


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its
    directory: ``$JAX_COMPILATION_CACHE_DIR`` when set (and no other),
    else the fixed :data:`COMPILE_CACHE_DIR`.  Every compile is cached
    (minimum compile time 0).  Call before the first compile."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(COMPILE_CACHE_DIR)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path


def register_cleanup(fn: Callable[[], None]) -> None:
    """Run ``fn`` at interpreter exit (role of ``register_cleanup``,
    ``gpu_comp.c:93-101``).  Callbacks run LIFO, exceptions suppressed."""
    global _registered
    _cleanups.append(fn)
    if not _registered:
        atexit.register(cleanup)
        _registered = True


def cleanup() -> None:
    """Run and clear all registered cleanups (role of ``gpu_cleanup``)."""
    while _cleanups:
        fn = _cleanups.pop()
        try:
            fn()
        except Exception:
            pass


def device_summary() -> dict:
    """Inventory of the visible platform (diagnostics)."""
    import jax

    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "device_count": len(devs),
        "process_count": jax.process_count(),
        "devices": [str(d) for d in devs],
    }
