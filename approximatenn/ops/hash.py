"""Sign-bit bucket codes and multiprobe code expansion.

Role of ``compute_signs`` (``/root/reference/compute.cl:223-231``) and the
probe-code computation inside ``compute_which`` (``compute.cl:238-246``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import itype


def pack_signs(x: jax.Array) -> jax.Array:
    """Pack sign bits of the last axis into an int32 code, MSB-first.

    The reference reads the raw IEEE sign bit by integer reinterpretation
    (``compute.cl:228-230``), so -0.0 counts as negative; ``jnp.signbit``
    has exactly that semantic.  First coordinate becomes the most
    significant bit, matching ``r = r << 1 | sign(coord_i)``.

    Codes are int32 (reference: size_t); d_short <= 31 is enforced by the
    build (bucket-table memory makes larger d_short impractical anyway).
    """
    d_short = x.shape[-1]
    if d_short == 0:
        return jnp.zeros(x.shape[:-1], itype)
    bits = jnp.signbit(x).astype(itype)
    weights = (jnp.ones((), itype) << jnp.arange(d_short - 1, -1, -1, dtype=itype))
    return jnp.sum(bits * weights, axis=-1, dtype=itype)


def query_codes(row_means, bases, x) -> tuple[jax.Array, jax.Array]:
    """Center rows against the stored means, project against EVERY table's
    basis in one matmul, pack sign codes.

    THE single definition of the hashing convention (center -> project ->
    :func:`pack_signs`, MSB-first, -0.0 negative) — the build chunker, all
    three query pipelines, the chunked-query driver and streaming updates
    delegate here, so a convention change lands in one place.

    x (m, d); bases (tries, d_short, d).  Returns (codes (m, tries) int32,
    proj (m, tries, d_short)) — proj feeds query-directed multiprobe.
    """
    tries, d_short, d = bases.shape
    m = x.shape[0]
    if d_short == 0:
        return (jnp.zeros((m, tries), itype),
                jnp.zeros((m, tries, 0), bases.dtype))
    xc = x.astype(bases.dtype) - row_means
    # HIGHEST: a default-precision f32 matmul may round its factors
    # (TF32 on NVIDIA GPUs), flipping signs of near-zero projections —
    # harmless statistically but a source of accelerator-vs-CPU hash
    # parity diffs; the projection matmul is tiny, so full precision is
    # effectively free
    proj = jnp.matmul(
        xc, bases.reshape(tries * d_short, d).T,
        precision=jax.lax.Precision.HIGHEST,
    ).reshape(m, tries, d_short)
    return pack_signs(proj), proj


def probe_codes(codes: jax.Array, d_short: int) -> jax.Array:
    """Expand each code to its multiprobe set: itself plus all Hamming-1
    neighbors, shape ``(..., d_short + 1)``.

    Probe 0 is the code itself; probe y >= 1 flips bit (y-1)
    (``wi_rev[x] ^ (!!y << (y - 1))``, ``compute.cl:244``).
    """
    flips = jnp.concatenate(
        [jnp.zeros((1,), itype), jnp.ones((d_short,), itype) << jnp.arange(d_short, dtype=itype)]
    )
    return codes[..., None] ^ flips


def probe_codes_directed(
    codes: jax.Array, proj: jax.Array, n_probes: int
) -> jax.Array:
    """Query-directed multiprobe (extension over the reference's blind
    Hamming-1 set): rank perturbations by how likely they are to hold the
    true neighbor and take the best ``n_probes``.

    A sign bit is uncertain when its projection is near zero, so a flip's
    "cost" is |proj| for single-bit flips and |proj_i|+|proj_j| for 2-bit
    flips (Lv et al., multi-probe LSH).  The candidate set is the own
    bucket (cost 0) + all 1-bit flips + all 2-bit flips, selected by
    k-pass argmin — static shapes throughout.

    codes (..., ): packed sign codes; proj (..., d_short): the signed
    projections that produced them (MSB-first, as pack_signs).  Returns
    (..., n_probes) probe codes; the first is always the code itself.
    """
    from .topk import topk_iter

    d_short = proj.shape[-1]
    a = jnp.abs(proj)
    # bit b (MSB-first) corresponds to coordinate index d_short-1-b in the
    # packed code; build flip masks aligned to coordinate order
    bit_of_coord = jnp.arange(d_short - 1, -1, -1, dtype=itype)
    single_masks = (jnp.ones((), itype) << bit_of_coord)  # (ds,)
    iu, ju = jnp.triu_indices(d_short, k=1)
    pair_masks = single_masks[iu] | single_masks[ju]  # (ds*(ds-1)/2,)
    single_cost = a  # (..., ds)
    pair_cost = a[..., iu] + a[..., ju]  # (..., npairs)
    costs = jnp.concatenate([single_cost, pair_cost], axis=-1)
    masks = jnp.concatenate([single_masks, pair_masks])  # (ncand,)
    n_extra = min(n_probes - 1, masks.shape[0])
    pos, _ = topk_iter(costs, n_extra)  # (..., n_extra) cheapest flips
    sel = masks[pos]
    probes = jnp.concatenate(
        [jnp.zeros(sel.shape[:-1] + (1,), itype), sel], axis=-1
    )
    out = codes[..., None] ^ probes
    if n_extra + 1 < n_probes:  # n_probes exceeds candidate set: repeat own
        pad = jnp.broadcast_to(
            codes[..., None], codes.shape + (n_probes - n_extra - 1,)
        )
        out = jnp.concatenate([out, pad], axis=-1)
    return out
