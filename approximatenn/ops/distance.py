"""Candidate distances and the exact k-NN engine.

Role of ``compute_diffs_squared`` + ``add_cols_step``
(``/root/reference/compute.cl:135-167``) and the ``compdists`` driver
(``alg.c:233-242``).  The reference materializes an (n, L, d) diff tensor and
tree-reduces it; here the gather+square+reduce is a single fused XLA
expression, blocked over rows to bound device-resident transients.  Sentinel
candidates (id >= n) and — during build — self-matches get +inf distance,
replacing the reference's branchless ``1.0/c - 1`` trick
(``compute.cl:144-149``) with explicit masks.

Distances are **squared** L2 on the *raw* (uncentered) coordinates: the
reference computes distances against the original points buffer
(``alg.c:410-411`` build, ``alg.c:503-512`` query); centering only affects
hashing.

The exact engine (:func:`exact_search`) is plain XLA: per query block one
``(block, d) @ (d, n)`` cross-term product (a cuBLAS GEMM on the GPU) in
the corpus's storage tier, ``qn + pn - 2 q.p``, then :func:`~.topk.topk_iter`.
It is the recall oracle, the exact serving mode and the exact-graph build.
"""

from __future__ import annotations

import functools
import math
from functools import partial

import jax
import jax.numpy as jnp

from ..config import itype
from .topk import topk_iter

# Byte budget of the (block, n) distance matrix one query block of the exact
# engine materializes.  XLA keeps that matrix and a few same-sized
# temporaries of the cross term and the top-k passes live at once, so the
# engine's transient footprint is a small multiple of this: a corpus the
# device holds leaves room for it at any n.
DIST_BLOCK_BYTES = 1 << 30

MATMUL_PRECISIONS = ("highest", "split3", "default")


def candidate_dists(
    q: jax.Array,
    points: jax.Array,
    cand: jax.Array,
    *,
    exclude_self: jax.Array | None = None,
    method: str = "diff",
    point_sqnorms: jax.Array | None = None,
) -> jax.Array:
    """Squared L2 distances from each row of ``q`` to its candidate ids.

    q: (m, d); points: (n, d); cand: (m, L) int ids with sentinel >= n.
    exclude_self: optional (m,) row ids — candidates equal to them get +inf
    (the build's self-exclusion, ``compute.cl:145-146``).
    method: 'diff' = exact sum((q - p)^2); 'dot' = ||q||^2 + ||p||^2 - 2 q.p
    (needs ``point_sqnorms``).
    Returns (m, L) distances with +inf at masked entries.
    """
    n = points.shape[0]
    valid = cand < n
    if exclude_self is not None:
        valid = valid & (cand != exclude_self[:, None])
    safe = jnp.where(valid, cand, 0)
    pc = points[safe]  # (m, L, d)
    if method == "dot":
        if point_sqnorms is None:
            point_sqnorms = jnp.sum(points * points, axis=-1)
        qn = jnp.sum(q * q, axis=-1)
        dots = jnp.einsum("mld,md->ml", pc, q, preferred_element_type=q.dtype,
                          precision=jax.lax.Precision.HIGHEST)
        dd = qn[:, None] + point_sqnorms[safe] - 2.0 * dots
    else:
        diff = q[:, None, :] - pc
        dd = jnp.sum(diff * diff, axis=-1)
    return jnp.where(valid, dd, jnp.asarray(jnp.inf, dd.dtype))


def pick_block(m: int, l: int, d: int, itemsize: int = 4, budget_bytes: int = 128 << 20) -> int:
    """Row-block size keeping the (B, L, d) gather transient under budget."""
    per_row = max(1, l * d * itemsize)
    b = max(1, budget_bytes // per_row)
    return min(m, b)


def query_block(m: int, n: int, itemsize: int = 4) -> int:
    """Query rows per block of the exact engine: the most that keep the
    (block, n) distance matrix of ``itemsize``-byte entries within
    :data:`DIST_BLOCK_BYTES` (at least 1, at most m)."""
    return max(1, min(m, DIST_BLOCK_BYTES // (itemsize * max(n, 1))))


def blocked_over_rows(fn, m: int, block: int, *row_args, pad_values):
    """Apply ``fn(*blocks) -> (out0, ...)`` over row-blocks of the leading
    axis via ``lax.map`` (sequential blocks — bounds transient memory while
    XLA pipelines within a block).  Inputs are padded to a block multiple
    with ``pad_values``; outputs are un-padded."""
    nb = math.ceil(m / block)
    mp = nb * block

    def pad(a, v):
        if mp == m:
            return a
        w = [(0, mp - m)] + [(0, 0)] * (a.ndim - 1)
        return jnp.pad(a, w, constant_values=v)

    padded = [
        pad(a, v).reshape((nb, block) + a.shape[1:])
        for a, v in zip(row_args, pad_values)
    ]
    outs = jax.lax.map(lambda xs: fn(*xs), tuple(padded))
    single = not isinstance(outs, tuple)
    if single:
        outs = (outs,)
    outs = tuple(o.reshape((mp,) + o.shape[2:])[:m] for o in outs)
    return outs[0] if single else outs


def _dot_split3(a, b, dims):
    """3-pass split-factor f32 dot: each factor splits into hi = bf16(x)
    and lo = bf16(x - hi), and the product keeps the three significant
    cross terms (hi*hi + hi*lo + lo*hi; the dropped lo*lo term is
    ~2^-16 relative).  Three bf16 dots with f32 accumulation: ~16+
    effective mantissa bits, so neighbor ranking matches full f32 (gated
    against a float64 oracle in tests/test_exact.py)."""
    f32 = jnp.float32
    ah = a.astype(jnp.bfloat16)
    al = (a - ah.astype(f32)).astype(jnp.bfloat16)
    bh = b.astype(jnp.bfloat16)
    bl = (b - bh.astype(f32)).astype(jnp.bfloat16)

    def dot(x, y):
        return jax.lax.dot_general(
            x, y, dimension_numbers=dims, preferred_element_type=f32
        )

    return dot(ah, bh) + dot(ah, bl) + dot(al, bh)


def _compute_dtype(points_dtype):
    """Dtype the cross term multiplies in: the storage dtype for the
    bf16/f16/int8 tiers and float64, float32 otherwise."""
    dt = jnp.dtype(points_dtype)
    if dt in (jnp.bfloat16, jnp.float16, jnp.int8, jnp.float64):
        return dt
    return jnp.dtype(jnp.float32)


@partial(jax.jit, static_argnames=("k", "matmul_precision", "block"))
def _exact_knn(points, queries, exclude, scale, *, k, matmul_precision,
               block):
    n = points.shape[0]
    cdt = points.dtype
    quant = cdt == jnp.int8
    # norms and distances accumulate in int32 (int8 tier: exact), float64
    # (x64 corpora) or float32 (everything else)
    acc = (jnp.int32 if quant
           else jnp.float64 if cdt == jnp.float64 else jnp.float32)
    if quant:
        # same-scale quantization keeps the quantized-domain distance an
        # exact scale^2 multiple of the dequantized one
        queries = jnp.clip(jnp.round(queries.astype(jnp.float32) / scale),
                           -127, 127)
    queries = queries.astype(cdt)
    pn = jnp.sum(jnp.square(points.astype(acc)), axis=-1)
    dims = (((1,), (1,)), ((), ()))
    if matmul_precision == "split3" and cdt == jnp.float32:
        cross = functools.partial(_dot_split3, dims=dims)
    else:
        # bf16/f16/int8 products are exact at storage width, so only the
        # f32 (and f64) tiers have a precision choice
        wide = cdt in (jnp.float32, jnp.float64)
        prec = (jax.lax.Precision.HIGHEST
                if wide and matmul_precision != "default"
                else jax.lax.Precision.DEFAULT)
        cross = functools.partial(jax.lax.dot_general, dimension_numbers=dims,
                                  precision=prec, preferred_element_type=acc)
    cols = jnp.arange(n, dtype=jnp.int32)

    def one(qb, eb):
        qn = jnp.sum(jnp.square(qb.astype(acc)), axis=-1)
        dd = qn[:, None] + pn[None, :] - 2 * cross(qb, points)
        if quant:
            dd = dd.astype(jnp.float32)
        if eb is not None:
            dd = jnp.where(cols[None, :] == eb[:, None], jnp.inf, dd)
        pos, dk = topk_iter(dd, k)
        # +inf = past the real candidates (k > n, or only excluded left)
        return jnp.where(jnp.isinf(dk), n, pos).astype(itype), dk

    m = queries.shape[0]
    if exclude is None:
        ids, dd = blocked_over_rows(lambda qb: one(qb, None), m, block,
                                    queries, pad_values=(0,))
    else:
        ids, dd = blocked_over_rows(one, m, block, queries, exclude,
                                    pad_values=(0, -1))
    if quant:
        dd = dd * (scale * scale).astype(jnp.float32)
    return ids, dd


def exact_search(points, queries, k: int, *, exclude=None, scale=None,
                 matmul_precision: str = "highest", block: int | None = None):
    """Exact k nearest neighbors of each query row: (ids (m, k) int32
    ascending by distance, squared distances (m, k)); sentinel id n with
    +inf distance past the real candidates (k > n).

    The corpus's dtype is its storage tier:

    - float32: the cross term runs at ``matmul_precision`` — "highest"
      (default; true float32 products), "split3" (:func:`_dot_split3`:
      three bf16 dots with f32 accumulation, f32-faithful ranking) or
      "default" (the backend's fastest float32 product, which on an NVIDIA
      GPU since Ampere is TF32 with a 10-bit mantissa and misranks near
      ties — speed-first callers only).
    - bfloat16 / float16: multiplied at storage width, queries cast to it,
      float32 accumulation — exact over the rounded values.
    - int8 (from :func:`quantize_corpus`; ``scale`` required): queries are
      quantized with the same scale, the whole distance runs in int32
      (exact over the quantized values, ranking equal to a dequantized
      oracle up to ties), and outputs are rescaled by scale^2.
    - float64 (x64 mode): float64 throughout.

    ``exclude`` (m,) int: a point id each query must skip (the kNN-graph
    self-exclusion; -1 = none).  ``block``: query rows per block, default
    from :data:`DIST_BLOCK_BYTES` via :func:`query_block`.  k > 128 selects
    through ``lax.top_k`` (see :func:`~.topk.topk_iter`)."""
    if matmul_precision not in MATMUL_PRECISIONS:
        raise ValueError(
            f"matmul_precision must be one of {MATMUL_PRECISIONS}, "
            f"got {matmul_precision!r}"
        )
    points = jnp.asarray(points)
    points = points.astype(_compute_dtype(points.dtype))
    queries = jnp.asarray(queries)
    if points.dtype == jnp.int8:
        if scale is None:
            raise ValueError(
                "int8 corpus requires its quantization scale "
                "(see quantize_corpus)"
            )
        scale = jnp.asarray(scale, jnp.float32)
    else:
        scale = None
    if exclude is not None:
        exclude = jnp.asarray(exclude, jnp.int32)
    m, n = queries.shape[0], points.shape[0]
    if block is None:
        block = query_block(m, n, 8 if points.dtype == jnp.float64 else 4)
    return _exact_knn(points, queries, exclude, scale, k=k,
                      matmul_precision=matmul_precision,
                      block=max(1, min(block, m)))


def brute_force_knn(points: jax.Array, queries: jax.Array, k: int,
                    block: int | None = None) -> tuple[jax.Array, jax.Array]:
    """Exact kNN of queries against points at full float32 precision — the
    recall oracle (role of the harness brute force,
    ``test_correctness.c:207-227``); :func:`exact_search` with defaults."""
    return exact_search(points, queries, k, block=block)


def brute_force_knn_self(points: jax.Array, k: int, block: int | None = None):
    """Exact kNN graph of a point set against itself, self-match excluded
    (role of ``compute_score``'s oracle, ``test_correctness.c:169-187``)."""
    n = jnp.shape(points)[0]
    return exact_search(points, points, k, exclude=jnp.arange(n),
                        block=block)


@jax.jit
def _absmax(x):
    return jnp.max(jnp.abs(x.astype(jnp.float32)))


@jax.jit
def _quantize_block(x, scale):
    # one fused program: no eager divide/round/clip chain, each of which
    # would materialize a corpus-width f32 transient
    return jnp.clip(jnp.round(x.astype(jnp.float32) / scale),
                    -127, 127).astype(jnp.int8)


@functools.partial(jax.jit, donate_argnums=(0,))
def _quantize_fill(buf, x, scale, row0):
    return jax.lax.dynamic_update_slice(
        buf, _quantize_block(x, scale), (row0, jnp.int32(0)))


_QUANT_CHUNKED_MIN_BYTES = 1 << 30  # patchable in tests


def quantize_corpus(points, scale=None, chunk_rows: int = 2_000_000):
    """Symmetric int8 quantization of a corpus for the exact engine's
    int8 storage tier: returns (rows int8 (n, d), scale () f32) with
    rows = round(x / scale) clipped to [-127, 127] and scale =
    max|x| / 127 by default (the grid covers the corpus; same convention
    as the packed int8 tier, ``index._quantize_points``).  Feed both to
    :func:`exact_search` — 1/4 the f32 bytes, so 4x the corpus per device.

    Corpora past ~1 GB quantize in ``chunk_rows`` blocks written into the
    output through donated updates, each completed before the next is
    queued, so no corpus-width float32 transient is ever live."""
    points = jnp.asarray(points)
    n, d = points.shape
    big = n * d * 4 > _QUANT_CHUNKED_MIN_BYTES
    if scale is None:
        if big:
            mx = jnp.float32(0)
            for lo in range(0, n, chunk_rows):
                mx = jax.block_until_ready(
                    jnp.maximum(mx, _absmax(points[lo: lo + chunk_rows])))
            scale = mx / 127.0
        else:
            scale = _absmax(points) / 127.0
    scale = jnp.asarray(scale, jnp.float32)
    if not big:
        return _quantize_block(points, scale), scale
    buf = jax.block_until_ready(jnp.zeros((n, d), jnp.int8))
    for lo in range(0, n, chunk_rows):
        buf = jax.block_until_ready(_quantize_fill(
            buf, points[lo: lo + chunk_rows], scale, jnp.int32(lo)))
    return buf, scale
