"""Random structured-orthogonal transforms.

Reimplements the transform family of the reference
(``/root/reference/alg.c:154-183`` ``run_initial`` and
``/root/reference/rand_pr.c:10-30``): a chain of

    ``rots_before`` Givens-rotation layers in dim ``d``
    -> permutation-embed ``d -> d_max`` (next power of two)
    -> orthonormal fast Walsh-Hadamard transform
    -> ``rots_after`` Givens-rotation layers in dim ``d_max``
    -> inverse-permutation projection ``d_max -> d_short``

Every stage is orthogonal (embed/project are partial isometries), so the
composite is a ``d_short x d`` matrix with orthonormal rows.  Parameters are
explicit arrays sampled from a ``jax.random`` key (the reference samples from
libc ``random()``, ``rand_pr.c:8``); keeping them as data makes both backends
(CPU oracle / accelerator) consume identical transforms — the same determinism device
the reference's ``compare_results.c:122-130`` relies on via re-seeding.

Note: the hot path never replays this chain over the dataset.
Instead :func:`materialize_basis` pushes the identity through the chain once
(the reference proves chain == materialized-matmul equivalence in
``save_vecs``, ``alg.c:189-217``) and both build and query hash points with a
single matmul against the materialized bases.  The chain form is kept as
an O(d log d) alternative and for parity tests.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import itype


class OrthoParams(NamedTuple):
    """Parameters of one table's random orthogonal transform.

    Mirrors ``ortho_info`` (``/root/reference/alg.c:18-22``). All leaves may
    carry an extra leading ``tries`` axis when stacked (see
    :func:`sample_ortho_params_batch`).
    """

    rb_i: jax.Array  # (rots_b, rot_len_b) int32 — first coords, pre-WHT
    rb_j: jax.Array  # (rots_b, rot_len_b) int32 — second coords
    rb_a: jax.Array  # (rots_b, rot_len_b) ftype — angles in [0, pi)
    perm_b: jax.Array  # (d_max,) int32 — embed permutation d -> d_max
    ra_i: jax.Array  # (rots_a, rot_len_a) int32 — post-WHT rotation coords
    ra_j: jax.Array  # (rots_a, rot_len_a) int32
    ra_a: jax.Array  # (rots_a, rot_len_a) ftype
    perm_ai: jax.Array  # (d_max,) int32 — projection permutation d_max -> d_short


def next_pow2(d: int) -> int:
    """Smallest power of two >= d (reference: ``alg.c:348-355``)."""
    return 1 if d <= 1 else 1 << (d - 1).bit_length()


def derive_dims(n: int, k: int, d: int) -> tuple[int, int]:
    """Derive (d_short, d_max) from problem size.

    ``d_short = ceil(log2(n/k))`` clamped to ``d_max`` (``alg.c:347-357``).
    The reference computes the ceil in a size_t, so a negative log (n < k)
    wraps and is clamped to ``d_max``; we reproduce that outcome explicitly.
    """
    d_max = next_pow2(d)
    if n < k:
        d_short = d_max
    else:
        d_short = max(0, math.ceil(math.log2(n / k)))
        d_short = min(d_short, d_max)
    return d_short, d_max


def _sample_rot_layer(key: jax.Array, rot_len: int, dim: int, dtype) -> tuple:
    """One Givens layer: 2*rot_len distinct coordinates + rot_len angles.

    Role of ``rand_rot`` (``rand_pr.c:10-16``): disjoint coordinate planes,
    uniform angles in [0, pi).
    """
    kp, ka = jax.random.split(key)
    coords = jax.random.permutation(kp, dim)[: 2 * rot_len]
    i = coords[0::2].astype(itype)
    j = coords[1::2].astype(itype)
    a = jax.random.uniform(ka, (rot_len,), dtype=dtype, maxval=math.pi)
    return i, j, a


def sample_ortho_params(
    key: jax.Array,
    d: int,
    d_max: int,
    rots_before: int,
    rot_len_before: int,
    rots_after: int,
    rot_len_after: int,
    dtype=jnp.float32,
) -> OrthoParams:
    """Sample one table's transform (role of ``make_ortho_info``, ``alg.c:59-74``)."""
    if rots_before > 0 and 2 * rot_len_before > d:
        raise ValueError(f"rot_len_before={rot_len_before} needs 2*len <= d={d}")
    if rots_after > 0 and 2 * rot_len_after > d_max:
        raise ValueError(f"rot_len_after={rot_len_after} needs 2*len <= d_max={d_max}")
    kb, ka, kpb, kpa = jax.random.split(key, 4)

    def layer_batch(k, rots, rot_len, dim):
        if rots == 0:
            z = jnp.zeros((0, rot_len), itype)
            return z, z, jnp.zeros((0, rot_len), dtype)
        keys = jax.random.split(k, rots)
        return jax.vmap(lambda kk: _sample_rot_layer(kk, rot_len, dim, dtype))(keys)

    rb_i, rb_j, rb_a = layer_batch(kb, rots_before, rot_len_before, d)
    ra_i, ra_j, ra_a = layer_batch(ka, rots_after, rot_len_after, d_max)
    # Reference uses a prefix-Fisher-Yates shuffle (`rand_perm`,
    # `rand_pr.c:17-30`); a full uniform shuffle has the same downstream
    # semantics (which input coordinate feeds each output slot) and is the
    # idiomatic JAX sampler.
    perm_b = jax.random.permutation(kpb, d_max).astype(itype)
    perm_ai = jax.random.permutation(kpa, d_max).astype(itype)
    return OrthoParams(rb_i, rb_j, rb_a, perm_b, ra_i, ra_j, ra_a, perm_ai)


def sample_ortho_params_batch(
    key: jax.Array,
    tries: int,
    d: int,
    d_max: int,
    rots_before: int,
    rot_len_before: int,
    rots_after: int,
    rot_len_after: int,
    dtype=jnp.float32,
) -> OrthoParams:
    """Stack `tries` independent transforms along a leading axis."""
    keys = jax.random.split(key, tries)
    return jax.vmap(
        lambda k: sample_ortho_params(
            k, d, d_max, rots_before, rot_len_before, rots_after, rot_len_after, dtype
        )
    )(keys)


def apply_rotation(x: jax.Array, i: jax.Array, j: jax.Array, a: jax.Array) -> jax.Array:
    """Rotate disjoint coordinate planes (i[p], j[p]) by angles a[p].

    Role of the ``apply_rotation`` kernel (``compute.cl:55-68``); planes are
    disjoint by construction so the scatter is conflict-free.
    """
    c = jnp.cos(a).astype(x.dtype)
    s = jnp.sin(a).astype(x.dtype)
    xi = x[..., i]
    xj = x[..., j]
    x = x.at[..., i].set(xi * c - xj * s)
    x = x.at[..., j].set(xi * s + xj * c)
    return x


def apply_permutation(x: jax.Array, perm: jax.Array, d_pre: int) -> jax.Array:
    """Embed ``(..., d_pre) -> (..., d_post)``: out[..., y] = x[..., perm[y]],
    zero where perm[y] >= d_pre.  Role of ``apply_permutation``
    (``compute.cl:77-85``)."""
    src = jnp.clip(perm, 0, d_pre - 1)
    vals = x[..., src]
    return jnp.where(perm < d_pre, vals, jnp.zeros((), x.dtype))


def apply_perm_inv(x: jax.Array, perm: jax.Array, d_post: int) -> jax.Array:
    """Project ``(..., d_pre) -> (..., d_post)``: out[..., perm[y]] = x[..., y]
    for perm[y] < d_post.  Role of ``apply_perm_inv`` (``compute.cl:88-96``).

    Since ``perm`` is a permutation, each surviving output coordinate c has a
    unique source ``argsort(perm)[c]`` — a plain gather, no scatter needed.
    """
    inv = jnp.argsort(perm)
    return x[..., inv[:d_post]]


def walsh(x: jax.Array) -> jax.Array:
    """Orthonormal fast Walsh-Hadamard transform over the last axis.

    Role of ``apply_walsh_step`` (``compute.cl:101-122``); the reference's
    per-stage normalization nets to 1/sqrt(d_max), applied here as one final
    scale (better fp behaviour, identical operator).  Width must be a power
    of two; width 1 is the identity (``alg.c:114-115``).
    """
    d = x.shape[-1]
    if d & (d - 1):
        raise ValueError(f"walsh width must be a power of two, got {d}")
    if d == 1:
        return x
    shape = x.shape
    x = x.reshape(-1, d)
    h = 1
    while h < d:
        y = x.reshape(-1, d // (2 * h), 2, h)
        a = y[:, :, 0, :]
        b = y[:, :, 1, :]
        x = jnp.stack((a + b, a - b), axis=2).reshape(-1, d)
        h *= 2
    x = x * jnp.asarray(1.0 / math.sqrt(d), x.dtype)
    return x.reshape(shape)


def apply_ortho(x: jax.Array, p: OrthoParams, d_short: int) -> jax.Array:
    """Full chain ``(..., d) -> (..., d_short)`` (role of ``run_initial``'s
    transform section, ``alg.c:161-178``)."""
    d = x.shape[-1]
    rots_b = p.rb_i.shape[0]
    rots_a = p.ra_i.shape[0]
    for r in range(rots_b):
        x = apply_rotation(x, p.rb_i[r], p.rb_j[r], p.rb_a[r])
    x = apply_permutation(x, p.perm_b, d)
    x = walsh(x)
    for r in range(rots_a):
        x = apply_rotation(x, p.ra_i[r], p.ra_j[r], p.ra_a[r])
    return apply_perm_inv(x, p.perm_ai, d_short)


def materialize_basis(p: OrthoParams, d: int, d_short: int, dtype) -> jax.Array:
    """Materialize the chain as an explicit ``(d_short, d)`` matrix.

    Role of ``save_vecs`` (``alg.c:189-217``), which pushes the identity
    through the inverse chain; we push it through the forward chain instead
    (equivalent: B = T(I)^T) so one code path defines the operator.
    """
    eye = jnp.eye(d, dtype=dtype)
    cols = apply_ortho(eye, p, d_short)  # (d, d_short): column i = T(e_i)
    return cols.T  # (d_short, d), orthonormal rows


def materialize_bases(params: OrthoParams, d: int, d_short: int, dtype) -> jax.Array:
    """Materialize stacked per-table bases ``(tries, d_short, d)``
    (role of ``save->bases``, ``ann.h:11``, filled at ``alg.c:402-404``)."""
    return jax.vmap(lambda p: materialize_basis(p, d, d_short, dtype))(params)
