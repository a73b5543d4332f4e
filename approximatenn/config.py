"""Global numeric configuration.

The analogue of the reference's compile-time float switch
(``/root/reference/ftype.h:3-9``): the reference selects double (default) or
float via ``-DUSE_FLOAT`` at compile time.  Here the element type is a runtime
configuration value (JAX retraces per dtype, which is the moral equivalent of
recompiling), defaulting to float32 — the accelerators' native width.  float64 is
available for oracle/parity work when ``jax.config.jax_enable_x64`` is on.
"""

from __future__ import annotations

import os

import jax.numpy as jnp

_FTYPES = {
    "float32": jnp.float32,
    "float64": jnp.float64,
    "bfloat16": jnp.bfloat16,
}

_ftype = _FTYPES.get(os.environ.get("ANN_FTYPE", "float32"), jnp.float32)


def set_ftype(dtype) -> None:
    """Set the default element type ('float32' | 'float64' | 'bfloat16')."""
    global _ftype
    if isinstance(dtype, str):
        dtype = _FTYPES[dtype]
    _ftype = dtype


def ftype():
    """Default floating element type (reference: ``ftype.h:3-9``)."""
    return _ftype


# Index ids are int32 (the reference uses size_t, `ann.h:10`); n < 2**31 is
# assumed and asserted at build time.  int32 halves id gather bandwidth.
itype = jnp.int32
