"""Dataset file formats of the standard ANN benchmark corpora.

The reference generates all test data in-process (``genRand``,
``/root/reference/test_correctness.c:10-13``) and has no loaders; this module
is the new capability the public benchmarks' config ladder needs (SIFT-1M,
GloVe-1.2M, Deep-10M): readers/writers for the ``.fvecs`` / ``.ivecs`` /
``.bvecs`` formats used by the TEXMEX/BIGANN corpora, plus ``.npy``.

Format: every vector is stored as a little-endian int32 dimension ``d``
followed by ``d`` components (float32 for fvecs, int32 for ivecs, uint8 for
bvecs).  All rows must share one dimension; readers validate that and
support mmap-backed slicing so multi-GB corpora never fully materialize in
host memory unless asked.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

_COMPONENT = {".fvecs": np.float32, ".ivecs": np.int32, ".bvecs": np.uint8}


def _vec_layout(path: str | os.PathLike) -> tuple[np.dtype, int, int, int]:
    """Return (component dtype, d, row_bytes, n) for a *vecs file."""
    path = Path(path)
    comp = _COMPONENT.get(path.suffix)
    if comp is None:
        raise ValueError(f"unknown vector format {path.suffix!r} (want .fvecs/.ivecs/.bvecs)")
    size = path.stat().st_size
    if size < 4:
        raise ValueError(f"{path}: too short for a *vecs header")
    d = int(np.fromfile(path, np.int32, 1)[0])
    if d <= 0:
        raise ValueError(f"{path}: bad leading dimension {d}")
    row_bytes = 4 + d * np.dtype(comp).itemsize
    if size % row_bytes:
        raise ValueError(
            f"{path}: size {size} is not a multiple of row size {row_bytes} (d={d})"
        )
    return np.dtype(comp), d, row_bytes, size // row_bytes


def read_vecs(
    path: str | os.PathLike,
    *,
    count: int | None = None,
    offset: int = 0,
    dtype=np.float32,
    mmap: bool = True,
) -> np.ndarray:
    """Read an (n, d) array from a .fvecs/.ivecs/.bvecs file.

    ``offset``/``count`` select a row range without reading the rest (the
    file is mmapped).  The per-row leading dimension fields are validated
    against the first row's.
    """
    comp, d, row_bytes, n = _vec_layout(path)
    if offset < 0 or offset > n:
        raise ValueError(f"offset {offset} out of range (n={n})")
    count = n - offset if count is None else min(count, n - offset)
    raw = np.memmap(path, np.uint8, mode="r", offset=offset * row_bytes,
                    shape=(count, row_bytes))
    dims = raw[:, :4].view(np.int32).ravel()
    if count and not (dims == d).all():
        bad = int(np.argmin(dims == d))
        raise ValueError(f"{path}: row {offset + bad} has d={dims[bad]}, expected {d}")
    vecs = raw[:, 4:].view(comp).reshape(count, d)
    out = np.asarray(vecs, dtype=dtype)
    if not mmap or out is vecs:
        out = np.array(out, copy=True)
    return out


def write_vecs(path: str | os.PathLike, arr: np.ndarray) -> None:
    """Write an (n, d) array in the *vecs format matching the suffix."""
    path = Path(path)
    comp = _COMPONENT.get(path.suffix)
    if comp is None:
        raise ValueError(f"unknown vector format {path.suffix!r}")
    arr = np.asarray(arr)
    if arr.ndim != 2:
        raise ValueError(f"want (n, d), got shape {arr.shape}")
    n, d = arr.shape
    row = np.empty((n, 4 + d * np.dtype(comp).itemsize), np.uint8)
    row[:, :4] = np.full((n, 1), d, np.int32).view(np.uint8)
    row[:, 4:] = np.ascontiguousarray(arr, comp).view(np.uint8).reshape(n, -1)
    row.tofile(path)


def vecs_info(path: str | os.PathLike) -> dict:
    """Shape/dtype of a *vecs file without reading it."""
    comp, d, _, n = _vec_layout(path)
    return {"n": n, "d": d, "component": str(comp)}


def read_any(path: str | os.PathLike, *, dtype=np.float32, **kw) -> np.ndarray:
    """Read vectors from .fvecs/.ivecs/.bvecs/.npy by suffix."""
    path = Path(path)
    if path.suffix == ".npy":
        arr = np.load(path, mmap_mode="r" if kw.get("mmap", True) else None)
        count, offset = kw.get("count"), kw.get("offset", 0)
        arr = arr[offset: None if count is None else offset + count]
        return np.asarray(arr, dtype=dtype)
    return read_vecs(path, dtype=dtype, **kw)
