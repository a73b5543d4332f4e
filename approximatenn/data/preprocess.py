"""Metric preprocessing.

The reference is L2-only (its distance kernel is squared euclidean,
``/root/reference/compute.cl:135-151``).  Angular/cosine search reduces to
L2 on unit-normalized vectors: for unit u, v,  ``|u - v|^2 = 2 - 2 cos``,
a monotone map — so one normalization pass up front turns the whole L2
engine into a cosine engine (how GloVe-style corpora are searched;
the GloVe-1.2M angular corpus).
"""

from __future__ import annotations

import numpy as np

METRICS = ("l2", "angular")


def normalize(x, eps: float = 1e-30):
    """Unit-normalize rows.  Works on numpy and jax arrays alike."""
    if isinstance(x, np.ndarray):
        nrm = np.sqrt((x.astype(np.float64) ** 2).sum(-1, keepdims=True))
        return (x / np.maximum(nrm, eps)).astype(x.dtype)
    import jax.numpy as jnp

    nrm = jnp.sqrt(jnp.sum(x * x, axis=-1, keepdims=True))
    return x / jnp.maximum(nrm, jnp.asarray(eps, x.dtype))


def prepare_points(points, metric: str):
    """Apply the metric's preprocessing to a point/query matrix."""
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}; want one of {METRICS}")
    return normalize(points) if metric == "angular" else points
