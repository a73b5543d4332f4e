"""Named benchmark datasets with ground truth (the config ladder of the public ANN benchmarks).

Role in the reference: none — it only ever searches in-process Gaussian data
(``genRand``, ``/root/reference/test_correctness.c:10-13``).  This module
adds the dataset layer a production framework needs: the standard corpora
(SIFT-1M, GloVe-1.2M, Deep*) resolved from a local directory (the benchmark
environment has no network egress, so files must be pre-staged), and
deterministic synthetic stand-ins at the same operating points so every
config in the ladder runs everywhere.

Directory convention (``$ANN_DATA`` or ``~/datasets``):

    <root>/<name>/base.{fvecs,bvecs,npy}     database vectors
    <root>/<name>/query.{fvecs,bvecs,npy}    query vectors
    <root>/<name>/groundtruth.{ivecs,npy}    true top-k ids (optional)

Ground truth, when absent, is computed exactly on-device with the blocked
brute-force oracle and cached next to the data.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from pathlib import Path

import numpy as np

from .formats import read_any, write_vecs
from .synthetic import clustered_gaussian, gaussian

# name -> (n, d, n_queries, metric) of the standard corpora; synthetic
# stand-ins replicate the shapes when the real files are absent.
SPECS = {
    "sift-1m": dict(n=1_000_000, d=128, nq=10_000, metric="l2"),
    "glove-1.2m": dict(n=1_183_514, d=100, nq=10_000, metric="angular"),
    "deep-10m": dict(n=10_000_000, d=96, nq=10_000, metric="l2"),
    "gaussian-10k": dict(n=10_000, d=32, nq=1_000, metric="l2"),
    "gaussian-100k": dict(n=100_000, d=128, nq=1_000, metric="l2"),
    # adversarial stress case: few huge zipf clusters -> extreme bucket
    # skew (one bucket can hold >5% of the corpus); exercises the capacity
    # overflow path at its worst
    "clustered-hard-1m": dict(n=1_000_000, d=128, nq=1_000, metric="l2"),
}


@dataclasses.dataclass
class Dataset:
    name: str
    base: np.ndarray  # (n, d) float32
    queries: np.ndarray  # (nq, d) float32
    metric: str  # "l2" | "angular"
    groundtruth: np.ndarray | None = None  # (nq, >=k) int32 true neighbors
    synthetic: bool = False

    @property
    def n(self) -> int:
        return self.base.shape[0]

    @property
    def d(self) -> int:
        return self.base.shape[1]


def data_root() -> Path:
    return Path(os.environ.get("ANN_DATA", os.path.expanduser("~/datasets")))


def _find(dirpath: Path, stem: str) -> Path | None:
    for suffix in (".fvecs", ".bvecs", ".ivecs", ".npy"):
        p = dirpath / (stem + suffix)
        if p.exists():
            return p
    return None


def load(
    name: str,
    *,
    max_n: int | None = None,
    max_queries: int | None = None,
    allow_synthetic: bool = True,
) -> Dataset:
    """Load a named dataset, falling back (with a warning) to a
    deterministic synthetic stand-in with the same (n, d, metric) when
    files are absent."""
    spec = SPECS.get(name)
    dirpath = data_root() / name
    base_p = _find(dirpath, "base")
    if base_p is not None:
        query_p = _find(dirpath, "query")
        gt_p = _find(dirpath, "groundtruth")
        base = read_any(base_p, count=max_n)
        queries = (
            read_any(query_p, count=max_queries)
            if query_p is not None
            else base[: max_queries or 1000].copy()
        )
        gt = None
        if gt_p is not None and max_n is None:
            # ground truth ids are only valid against the full base
            gt = read_any(gt_p, dtype=np.int32, count=max_queries)
        metric = (spec or {}).get("metric", "l2")
        return Dataset(name, base, queries, metric, gt, synthetic=False)
    if spec is None:
        raise FileNotFoundError(
            f"dataset {name!r}: no files under {dirpath} and no synthetic spec"
        )
    if not allow_synthetic:
        raise FileNotFoundError(f"dataset {name!r}: no files under {dirpath}")
    warnings.warn(
        f"dataset {name!r}: no files under {dirpath} (set $ANN_DATA to the "
        "directory holding them); using the seeded synthetic stand-in",
        stacklevel=2)
    n = min(spec["n"], max_n) if max_n else spec["n"]
    nq = min(spec["nq"], max_queries) if max_queries else spec["nq"]
    return synthesize(name, n, spec["d"], nq, spec["metric"])


def synthesize(name: str, n: int, d: int, nq: int, metric: str = "l2") -> Dataset:
    """Deterministic synthetic dataset at a named operating point.

    Clustered Gaussian (not iid) so bucket occupancies are realistically
    skewed — iid Gaussian makes every hash bucket uniform, which hides
    capacity/overflow bugs and flatters recall.  Stand-ins for real corpora
    use many fine-grained, mildly-skewed clusters (real SIFT/GloVe bucket
    statistics); the ``clustered-hard-*`` names use few huge zipf clusters,
    the adversarial regime where sign-hash buckets can't split a cluster.
    """
    # seed must be stable across processes (hash() is salted per process)
    seed = int.from_bytes(name.encode()[:4].ljust(4, b"_"), "little")
    rng = np.random.default_rng(seed)
    if name.startswith("clustered-hard"):
        base = clustered_gaussian(rng, n, d, n_clusters=max(64, n // 10_000),
                                  spread=4.0, zipf=1.2)
    elif n >= 50_000:
        base = clustered_gaussian(rng, n, d, n_clusters=max(256, n // 1_000),
                                  spread=2.0, zipf=1.05)
    else:
        base = gaussian(rng, n, d)
    queries = base[rng.integers(0, n, nq)] + 0.1 * gaussian(rng, nq, d)
    return Dataset(name, base, queries.astype(np.float32), metric, None, synthetic=True)


def ensure_groundtruth(ds: Dataset, k: int, *, cache: bool = True) -> np.ndarray:
    """Exact top-k ids for ds.queries, computing (and caching) if missing.

    Uses the on-device blocked brute-force oracle; for angular metrics the
    ground truth is computed on normalized vectors (cosine order).
    """
    if ds.groundtruth is not None and ds.groundtruth.shape[1] >= k:
        return ds.groundtruth[:, :k]
    import jax.numpy as jnp

    from ..ops.distance import brute_force_knn
    from .preprocess import normalize

    base, queries = ds.base, ds.queries
    if ds.metric == "angular":
        base, queries = normalize(base), normalize(queries)
    ids, _ = brute_force_knn(jnp.asarray(base), jnp.asarray(queries), k)
    gt = np.asarray(ids, np.int32)
    ds.groundtruth = gt
    if cache and not ds.synthetic:
        out = data_root() / ds.name / "groundtruth.ivecs"
        try:
            write_vecs(out, gt)
        except OSError:
            pass
    return gt
