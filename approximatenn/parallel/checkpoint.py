"""Sharded-index and sharded-packed-view checkpointing.

The reference's only persistence is the in-memory ``save_t`` (``ann.h:8-12``
— no serialization exists).  Single-device indexes serialize via
``ANNIndex.save/load`` (npz).  This module persists the distributed
artifacts: a :class:`~.sharded.ShardedIndex` (the build output) and a
:class:`~.sharded.ShardedPacked` (the scale-out *serving* artifact — without
persistence every serving restart would re-pack per shard).  Array leaves go
via Orbax (which handles multi-host sharded arrays natively) when available,
npz otherwise (single-host only); static metadata via JSON; restore
re-applies the row-sharding layout that ``build_sharded``/``packed_sharded``
produce on a caller-provided mesh, so an index built on one topology can be
served from a compatible one (same shard count).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .sharded import AXIS, ShardedIndex, ShardedPacked

_ARRAY_FIELDS = ("row_means", "bases", "tables", "counts", "graph")
_SHARDED_FIELDS = {"tables", "counts", "graph"}  # leading shard axis
_META_FIELDS = (
    "n", "n_local", "k", "d", "d_short", "tries", "tmax", "n_shards",
)


def _specs():
    return {
        f: P(AXIS, *([None] * r))
        for f, r in (("tables", 3), ("counts", 2), ("graph", 2))
    } | {"row_means": P(), "bases": P()}


def save_sharded_index(sidx: ShardedIndex, path: str | Path) -> None:
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    meta = {f: getattr(sidx, f) for f in _META_FIELDS}
    meta["metric"] = sidx.metric
    meta["has_points"] = sidx.points is not None
    arrays = {f: getattr(sidx, f) for f in _ARRAY_FIELDS}
    if sidx.points is not None:
        # the metric-preprocessed sharded corpus (always stored for
        # angular — serving needs the normalized vectors, not the raw ones)
        arrays["points"] = sidx.points
        meta["points_dtype"] = str(np.dtype(sidx.points.dtype))
    try:
        import orbax.checkpoint as ocp

        ckptr = ocp.StandardCheckpointer()
        ckptr.save((path / "arrays").absolute(), arrays, force=True)
        ckptr.wait_until_finished()
        meta["format"] = "orbax"
    except ImportError:
        if jax.process_count() > 1:
            raise RuntimeError("multi-host checkpointing requires orbax")
        np.savez(
            path / "arrays.npz", **{f: np.asarray(v) for f, v in arrays.items()}
        )
        meta["format"] = "npz"
    (path / "meta.json").write_text(json.dumps(meta))


def load_sharded_index(path: str | Path, mesh: Mesh) -> ShardedIndex:
    path = Path(path)
    meta = json.loads((path / "meta.json").read_text())
    s = mesh.shape[AXIS]
    if s != meta["n_shards"]:
        raise ValueError(
            f"mesh has {s} shards but index was built with {meta['n_shards']}"
        )
    specs = _specs()
    has_points = meta.get("has_points", False)
    fields = _ARRAY_FIELDS + (("points",) if has_points else ())
    if has_points:
        specs["points"] = P(AXIS, None)
    if meta["format"] == "orbax":
        import orbax.checkpoint as ocp

        # restore directly into the target shardings
        shapes = _abstract_shapes(meta)
        target = {
            f: jax.ShapeDtypeStruct(
                shapes[f][0], shapes[f][1], sharding=NamedSharding(mesh, specs[f])
            )
            for f in fields
        }
        ckptr = ocp.StandardCheckpointer()
        arrays = ckptr.restore(
            (path / "arrays").absolute(), target
        )
    else:
        z = np.load(path / "arrays.npz")
        arrays = {
            f: jax.device_put(z[f], NamedSharding(mesh, specs[f]))
            for f in fields
        }
    kw = {f: meta[f] for f in _META_FIELDS}
    return ShardedIndex(**arrays, metric=meta.get("metric", "l2"), **kw)


# ---------------------------------------------------------------------------
# ShardedPacked — the scale-out serving artifact (the single-device
# PackedIndex persists, the sharded form didn't, so every
# serving restart re-packed per shard).
# ---------------------------------------------------------------------------

_PK_ARRAY_FIELDS = ("point_rows", "ids", "starts")  # sharded, leading axis
_PK_META_FIELDS = ("n_pad_l", "d_pad", "window", "super_width")


def _pk_specs(has_scale: bool):
    specs = {f: P(AXIS, None, None) for f in _PK_ARRAY_FIELDS}
    if has_scale:
        specs["scale"] = P()  # one replicated quantization scale
    return specs


def save_sharded_packed(spk: ShardedPacked, path: str | Path) -> None:
    """Persist a :class:`~.sharded.ShardedPacked` (Orbax when available,
    npz fallback single-host).  bf16/f16 rows npz-serialize as raw uint16
    words + a dtype tag (npz cannot represent half floats — same encoding
    as ``PackedIndex.save``)."""
    from ..index import _stash

    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    has_scale = spk.scale is not None
    meta = {f: getattr(spk, f) for f in _PK_META_FIELDS}
    meta["has_scale"] = has_scale
    arrays = {f: getattr(spk, f) for f in _PK_ARRAY_FIELDS}
    if has_scale:
        arrays["scale"] = spk.scale
    import jax.numpy as jnp

    meta["shapes"] = {
        f: [list(v.shape), str(jnp.dtype(v.dtype))] for f, v in arrays.items()
    }
    try:
        import orbax.checkpoint as ocp

        ckptr = ocp.StandardCheckpointer()
        ckptr.save((path / "arrays").absolute(), arrays, force=True)
        ckptr.wait_until_finished()
        meta["format"] = "orbax"
    except ImportError:
        if jax.process_count() > 1:
            raise RuntimeError("multi-host checkpointing requires orbax")
        out = {}
        for f, v in arrays.items():
            _stash(out, f, v)
        np.savez(path / "arrays.npz", **out)
        meta["format"] = "npz"
    (path / "meta.json").write_text(json.dumps(meta))


def load_sharded_packed(path: str | Path, mesh: Mesh) -> ShardedPacked:
    """Restore a :class:`~.sharded.ShardedPacked` onto ``mesh`` (same shard
    count as at save time), ready to serve through
    ``search_packed_sharded``."""
    import jax.numpy as jnp

    from ..index import _unstash

    path = Path(path)
    meta = json.loads((path / "meta.json").read_text())
    s = mesh.shape[AXIS]
    saved_s = meta["shapes"]["point_rows"][0][0]
    if s != saved_s:
        raise ValueError(
            f"mesh has {s} shards but the packed view was saved with {saved_s}"
        )
    has_scale = meta["has_scale"]
    specs = _pk_specs(has_scale)
    if meta["format"] == "orbax":
        import orbax.checkpoint as ocp

        target = {
            f: jax.ShapeDtypeStruct(
                tuple(shape), jnp.dtype(dt),
                sharding=NamedSharding(mesh, specs[f]),
            )
            for f, (shape, dt) in meta["shapes"].items()
        }
        arrays = ocp.StandardCheckpointer().restore(
            (path / "arrays").absolute(), target
        )
    else:
        z = np.load(path / "arrays.npz")
        arrays = {
            f: jax.device_put(_unstash(z, f), NamedSharding(mesh, specs[f]))
            for f in meta["shapes"]
        }
    kw = {f: meta[f] for f in _PK_META_FIELDS}
    return ShardedPacked(
        scale=arrays.get("scale"),
        **{f: arrays[f] for f in _PK_ARRAY_FIELDS}, **kw,
    )


def _abstract_shapes(meta):
    import jax.numpy as jnp

    s, tries, ds, tmax = (
        meta["n_shards"], meta["tries"], meta["d_short"], meta["tmax"],
    )
    nb = 1 << ds
    f = jnp.float32
    shapes = {
        "row_means": ((meta["d"],), f),
        "bases": ((tries, ds, meta["d"]), f),
        "tables": ((s, tries, nb, tmax), jnp.int32),
        "counts": ((s, tries, nb), jnp.int32),
        "graph": ((s, meta["n_local"], meta["k"]), jnp.int32),
    }
    if meta.get("has_points"):
        shapes["points"] = (
            (s * meta["n_local"], meta["d"]),
            jnp.dtype(meta.get("points_dtype", "float32")),
        )
    return shapes
