"""approximatenn — an approximate-nearest-neighbor framework in JAX.

A from-scratch JAX/XLA re-design with the capabilities of the
reference C/OpenCL library (marcusrussi/approximateNN, mounted at
``/root/reference``): randomized structured-orthogonal-projection sign
hashing with multiprobe lookup, multi-table merge, and one round of
graph-based "supercharge" refinement.

Public API (mirrors ``/root/reference/ann.h:46-65``):

    index, graph, dists = build(points, k, tries=..., key=...)   # precomp
    ids, dists = search(index, points, queries)                  # query
    ids, dists = brute_force_knn(points, queries, k)             # exact oracle

`precomp` / `query` aliases with reference-shaped signatures are provided
for users coming from the C API.
"""

from .config import ftype, itype, set_ftype
from .engine.build import build, build_graph_only
from .engine.search import search, search_packed
from .engine.serving import Server
from .engine.tuning import TuneReport, tune
from .index import ANNIndex, PackedIndex
from .ops.distance import (
    brute_force_knn,
    brute_force_knn_self,
    exact_search,
    quantize_corpus,
)

__version__ = "0.1.0"


def precomp(
    points,
    k: int,
    *,
    tries: int = 10,
    rots_before: int = 6,
    rot_len_before: int = 1,
    rots_after: int = 1,
    rot_len_after: int = 1,
    key=None,
    seed: int = 0,
    save: bool = True,
    **kw,
):
    """Reference-shaped build (``ann.h:46-49``).

    Returns ``(graph, dists, index)``; ``index`` is None when ``save`` is
    False (the reference's ``save == NULL`` mode).
    """
    index, graph, dists = build(
        points, k, tries=tries, rots_before=rots_before,
        rot_len_before=rot_len_before, rots_after=rots_after,
        rot_len_after=rot_len_after, key=key, seed=seed, **kw,
    )
    return graph, dists, (index if save else None)


def query(index: ANNIndex, points, y, **kw):
    """Reference-shaped batch query (``ann.h:61-62``): returns (ids, dists)."""
    return search(index, points, y, **kw)


__all__ = [
    "ANNIndex", "PackedIndex", "Server", "build", "build_graph_only",
    "search", "search_packed", "precomp", "query",
    "brute_force_knn", "brute_force_knn_self", "exact_search",
    "quantize_corpus", "ftype", "itype", "set_ftype", "tune", "TuneReport",
]
