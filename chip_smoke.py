#!/usr/bin/env python3
"""Smoke run of the search main path on an NVIDIA GPU, at SIFT-1M scale.

Run from the repository root:

    python3 chip_smoke.py           # one GPU: every phase below
    python3 chip_smoke.py --four    # four GPUs: the ShardedServer phase only

The corpus is the ann-benchmarks SIFT-1M shape (1,000,000 x 128 float32,
L2, k=10, 10,000 queries) from the seeded stand-in
``data.datasets.load("sift-1m")``.  Phases, all in this one process (a
second JAX process on the card would find no memory left):

- device: fail unless JAX's first device is a GPU; print what it is;
- oracle: exact top-k of a fixed 200-query sample on the host, in float64
  numpy — independent of the engines under test;
- exact serving: ``Server.build`` in auto mode over all queries, then the
  bf16 and int8 storage tiers and one k=100 and one k=256 call;
- hash build and search: ``ann.build`` at its default bucket capacity
  (the reference's exact max while its tables fit a share of the card's
  memory, else "auto": on this clustered corpus the exact max would need
  ~51 GiB of tables), ``ann.search`` and a packed-layout hash ``Server``;
- parity: ``harness/compare_results`` GPU against CPU at its gate config.

``--four`` builds ``ShardedServer`` over a 4-GPU mesh with 4,000,000 x 128
points (SIFT-1M's per-card share x4), exact and hash/packed, checks the
row shards sit on four distinct devices and compares with the host oracle.

Each phase prints one JSON line with its compile and steady seconds, its
recall against the oracle and device memory (see ``DeviceMemory``).  The
line before the last is ``nvidia-smi``'s name and power limit; the last is
``{"ok": ..., "device": {"platform", "kind", "count"}}``.  A failed phase
fails the run: exit code 1 and ``"ok": false``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

K = 10
N_QUERIES = 10_000
BATCH = 1_000
SAMPLE = 200
SEED = 0
FOUR_N = 4_000_000

# Gates.  f32 at matmul_precision="highest" is true float32 arithmetic: its
# recall@10 against the float64 oracle may lose only float32 near-ties, and
# each returned distance, computed as qn + pn - 2 q.p, may differ from the
# float64 distance of the same id by float32 rounding of the three terms,
# bounded here as DIST_REL_TOL * (|q|^2 + |p|^2).
F32_RECALL_MIN = 0.999
DIST_REL_TOL = 2.0 ** -20
# bf16/int8 tiers are exact over their stored grid values: against a
# float64 oracle on the same grid every returned id must lie within the
# oracle's k-th distance (ties allowed).  Against the float32 corpus their
# recall is a property of the rounding; the floors below are the band
# measured on an H100 (bf16 0.994, int8 0.9365 on this corpus) less a
# margin.
GRID_TIE_RECALL_MIN = 0.999
BF16_RECALL_MIN = 0.98
INT8_RECALL_MIN = 0.90
# hash recall@10 floors (tries=10, capacity "auto", which the default
# resolves to on this corpus): one card measured
# 0.974 (table) and 0.978 (packed) on an H100; the 4-card mesh, whose
# shards each build tables and a graph over 1M of the 4M rows, measured
# 0.9035
HASH_RECALL_MIN = 0.95
FOUR_HASH_RECALL_MIN = 0.88
# GPU-vs-CPU parity at compare_results' gate config: the share of graph
# ids that differ for a reason other than a float32 or float64 tie.  An
# H100 measured 0 differing ids of 20,000 in both graph modes; the band
# leaves room for GEMM algorithm choices that change the last bits
PARITY_ARGV = ["-n", "2000", "-d", "64", "-k", "10", "-t", "4", "-o", "1",
               "--seed", "11", "--arbitrate"]
PARITY_MAX_REAL_DIFF_FRAC = 0.001


def log(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


def gpu_name_power() -> str:
    """``nvidia-smi``'s name and power limit of every visible card, read
    by a child process that does not touch JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return "; ".join(line.strip() for line in out.splitlines() if line.strip())


class DeviceMemory:
    """Device memory by phase.  JAX keeps one running peak per device and
    cannot reset it, so a phase reports that running peak (the maximum
    over the devices), whether the phase raised it (then it is the phase's
    own peak) and the bytes in use at the phase's end."""

    def __init__(self):
        self.peak = 0

    def read(self) -> dict:
        import jax

        stats = [d.memory_stats() or {} for d in jax.devices()]
        peak = max(s.get("peak_bytes_in_use", 0) for s in stats)
        rec = {"peak_bytes_in_use": peak, "peak_set_in_phase": peak > self.peak,
               "bytes_in_use": max(s.get("bytes_in_use", 0) for s in stats)}
        self.peak = max(self.peak, peak)
        return rec


MEMORY = DeviceMemory()


def phase_device(min_count: int = 1) -> dict:
    """JAX's devices, which must be (at least ``min_count``) GPUs."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(f"no GPU: JAX's first device is {devs[0]!r}")
    if len(devs) < min_count:
        raise RuntimeError(f"{len(devs)} GPUs, {min_count} needed")
    return {
        "phase": "device", "kind": devs[0].device_kind, "count": len(devs),
        "jax": jax.__version__,
        "bytes_limit": (devs[0].memory_stats() or {}).get("bytes_limit"),
        "nvidia_smi": gpu_name_power(),
    }


# ------------------------------------------------------------------ oracle
def host_oracle(base, queries, k: int, block: int = 1 << 17):
    """Exact top-k of ``queries`` over ``base`` in float64 numpy: (ids,
    squared distances), both (m, k), ascending, ties by id."""
    q = np.asarray(queries, np.float64)
    qn = (q * q).sum(1)
    best_d = np.empty((q.shape[0], 0))
    best_i = np.empty((q.shape[0], 0), np.int64)
    for lo in range(0, base.shape[0], block):
        p = np.asarray(base[lo: lo + block], np.float64)
        d = qn[:, None] + (p * p).sum(1)[None, :] - 2.0 * (q @ p.T)
        cand_d = np.concatenate([best_d, d], 1)
        cand_i = np.concatenate(
            [best_i, np.broadcast_to(np.arange(lo, lo + p.shape[0]),
                                     d.shape)], 1)
        sel = np.argpartition(cand_d, k - 1, axis=1)[:, :k]
        best_d = np.take_along_axis(cand_d, sel, 1)
        best_i = np.take_along_axis(cand_i, sel, 1)
    order = np.lexsort((best_i, best_d), axis=1)
    return (np.take_along_axis(best_i, order, 1),
            np.take_along_axis(best_d, order, 1))


def exact_d64(base, queries, ids):
    """float64 squared distances of each query to its returned ids (inf
    for sentinel ids >= n)."""
    n = base.shape[0]
    safe = np.where(ids < n, ids, 0)
    diff = (np.asarray(queries, np.float64)[:, None, :]
            - base[safe].astype(np.float64))
    return np.where(ids < n, (diff * diff).sum(-1), np.inf)


def recall(ids, true_ids, k: int) -> float:
    return float(np.mean([len(set(a[:k].tolist()) & set(b[:k].tolist())) / k
                          for a, b in zip(ids, true_ids)]))


def tie_recall(base, queries, ids, true_d, k: int) -> float:
    """Share of returned ids whose float64 distance is within the oracle's
    k-th distance: 1.0 means exact up to ties."""
    d = exact_d64(base, queries, ids[:, :k])
    kth = true_d[:, k - 1: k]
    return float(np.mean(d <= kth * (1 + 1e-9) + 1e-12))


# ------------------------------------------------------------- serving
def serve_all(search, query_batches):
    """All query batches through ``search``: the first call compiles and
    is timed alone, then every batch is dispatched and waited on once.
    Returns (ids, dists) over all queries and the timings."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(search(query_batches[0]))
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    outs = jax.block_until_ready([search(qb) for qb in query_batches])
    steady_s = (time.perf_counter() - t0) / len(query_batches)
    ids = np.concatenate([np.asarray(o[0]) for o in outs])
    dd = np.concatenate([np.asarray(o[1]) for o in outs])
    m = ids.shape[0]
    return ids, dd, {"compile_s": compile_s, "steady_s_per_batch": steady_s,
                     "batch": query_batches[0].shape[0],
                     "qps": query_batches[0].shape[0] / steady_s, "queries": m}


def _batches(queries, batch: int):
    import jax

    if queries.shape[0] % batch:
        raise ValueError("query count must be a multiple of the batch")
    return [jax.device_put(queries[lo: lo + batch])
            for lo in range(0, queries.shape[0], batch)]


def check(name: str, value: float, floor: float, rec: dict) -> None:
    rec[name] = value
    if not value >= floor:
        raise AssertionError(f"{rec.get('phase')}: {name} {value} < {floor}")


def phase_exact(base, queries, sample, oracle, *, batch: int = BATCH,
                k: int = K) -> list[dict]:
    """Exact ``Server`` (auto mode) in float32, then the bf16 and int8
    tiers, then one k=100 and one k=256 call, each against the oracle."""
    import jax
    import jax.numpy as jnp

    from approximatenn import Server

    true_i, true_d = oracle
    qs = queries[sample]
    qb = _batches(queries, batch)
    recs = []

    t0 = time.perf_counter()
    srv = Server.build(base, k=k)
    jax.block_until_ready(srv.points)
    build_s = time.perf_counter() - t0
    if srv.mode != "exact":
        raise AssertionError(f"auto mode chose {srv.mode!r} at n={base.shape[0]}")
    ids, dd, rec = serve_all(srv.search, qb)
    rec = {"phase": "exact_f32", "build_s": build_s, **rec}
    check("recall_at_10", recall(ids[sample], true_i, k), F32_RECALL_MIN, rec)
    d64 = exact_d64(base, qs, ids[sample])
    norms = (np.square(qs.astype(np.float64)).sum(1)[:, None]
             + np.square(base[ids[sample]].astype(np.float64)).sum(-1))
    rel = float(np.max(np.abs(dd[sample] - d64) / norms))
    rec["dist_err_rel"] = rel
    if not rel <= DIST_REL_TOL:
        raise AssertionError(f"exact_f32: distance error {rel} > {DIST_REL_TOL}")
    rec.update(MEMORY.read())
    recs.append(rec)
    log(rec)

    # large k: one call each at k=100 and k=256 on the sample
    qsd = jax.device_put(qs)
    big_k = true_i.shape[1]
    for kk in (100, big_k):
        t0 = time.perf_counter()
        ids_k, _ = jax.block_until_ready(srv.search(qsd, k=kk))
        rec = {"phase": f"exact_k{kk}", "call_s": time.perf_counter() - t0,
               "queries": len(sample)}
        check(f"tie_recall_at_{kk}",
              tie_recall(base, qs, np.asarray(ids_k), true_d, kk),
              GRID_TIE_RECALL_MIN, rec)
        rec.update(MEMORY.read())
        recs.append(rec)
        log(rec)
    del srv

    for name, dt, floor in (("bf16", jnp.bfloat16, BF16_RECALL_MIN),
                            ("int8", jnp.int8, INT8_RECALL_MIN)):
        t0 = time.perf_counter()
        srv = Server.build(base, k=k, storage_dtype=dt)
        jax.block_until_ready(srv.points)
        build_s = time.perf_counter() - t0
        ids, _, rec = serve_all(srv.search, qb)
        rec = {"phase": f"exact_{name}", "build_s": build_s, **rec}
        # the stored grid, and the queries as the engine sees them
        grid = np.asarray(srv.points.astype(jnp.float32), np.float64)
        if name == "int8":
            s = np.float32(srv._search_kw["scale"])
            grid = grid * np.float64(s)
            gq = np.clip(np.round(qs.astype(np.float32) / s), -127, 127)
            gq = gq.astype(np.float64) * np.float64(s)
        else:
            gq = np.asarray(jnp.asarray(qs).astype(dt).astype(jnp.float32))
        _, grid_d = host_oracle(grid, gq, k)
        check("grid_tie_recall_at_10",
              tie_recall(grid, gq, ids[sample], grid_d, k),
              GRID_TIE_RECALL_MIN, rec)
        check("recall_at_10", recall(ids[sample], true_i, k), floor, rec)
        rec.update(MEMORY.read())
        recs.append(rec)
        log(rec)
        del srv, grid
    return recs


def phase_hash(base, queries, sample, oracle, *, batch: int = BATCH,
               k: int = K, tries: int = 10, seed: int = SEED,
               floor: float = HASH_RECALL_MIN) -> list[dict]:
    """``ann.build`` + ``ann.search`` (table layout), then a packed-layout
    hash ``Server``, each against the oracle."""
    import jax

    import approximatenn as ann
    from approximatenn import Server

    true_i, _ = oracle
    qb = _batches(queries, batch)
    recs = []
    t0 = time.perf_counter()
    index, graph, _ = ann.build(base, k, tries=tries, seed=seed)
    jax.block_until_ready(graph)
    build_s = time.perf_counter() - t0

    base_d = jax.device_put(base)
    ids, _, rec = serve_all(lambda q: ann.search(index, base_d, q), qb)
    rec = {"phase": "hash_table", "build_s": build_s, "tries": tries,
           "capacity": index.tmax, **rec}
    check("recall_at_10", recall(ids[sample], true_i, k), floor, rec)
    rec.update(MEMORY.read())
    recs.append(rec)
    log(rec)
    del index, graph, base_d

    t0 = time.perf_counter()
    srv = Server.build(base, k=k, mode="hash", layout="packed", tries=tries,
                       seed=seed)
    jax.block_until_ready(srv.packed.point_rows)
    build_s = time.perf_counter() - t0
    ids, _, rec = serve_all(srv.search, qb)
    rec = {"phase": "hash_packed", "build_s": build_s, "tries": tries, **rec}
    check("recall_at_10", recall(ids[sample], true_i, k), floor, rec)
    rec.update(MEMORY.read())
    recs.append(rec)
    log(rec)
    return recs


def phase_parity(platform: str = "gpu", argv=PARITY_ARGV,
                 max_frac: float = PARITY_MAX_REAL_DIFF_FRAC) -> dict:
    """GPU-vs-CPU parity through ``harness/compare_results``: identical
    keys build on both backends and the graph ids are compared; fails when
    the accelerator found is not ``platform`` or the real-diff share
    exceeds ``max_frac``."""
    from approximatenn.harness import compare_results

    t0 = time.perf_counter()
    rc = compare_results.main(list(argv) + ["--platform", platform,
                                            "--max-diff-frac", str(max_frac)])
    rec = {"phase": "parity", "rc": rc, "secs": time.perf_counter() - t0,
           "max_real_diff_frac": max_frac}
    if rc != 0:
        raise AssertionError(f"parity: compare_results exited {rc}")
    log(rec)
    return rec


def phase_four(base, queries, sample, oracle, *, n_devices: int = 4,
               batch: int = BATCH, k: int = K, tries: int = 10,
               seed: int = SEED,
               hash_floor: float = FOUR_HASH_RECALL_MIN) -> list[dict]:
    """``ShardedServer`` over an ``n_devices`` mesh, exact and hash/packed,
    each against the oracle; the exact corpus's row shards must sit on
    ``n_devices`` distinct devices."""
    import jax

    from approximatenn.parallel.serving import ShardedServer
    from approximatenn.parallel.sharded import make_mesh

    true_i, _ = oracle
    mesh = make_mesh(n_devices)
    qb = _batches(queries, batch)
    recs = []
    t0 = time.perf_counter()
    srv = ShardedServer.build(base, k, mesh=mesh)
    jax.block_until_ready(srv.points)
    build_s = time.perf_counter() - t0
    if srv.mode != "exact":
        raise AssertionError(f"auto mode chose {srv.mode!r}")
    shard_devs = {s.device for s in srv.points.addressable_shards}
    if len(shard_devs) != n_devices:
        raise AssertionError(f"row shards on {len(shard_devs)} devices")
    ids, _, rec = serve_all(srv.search, qb)
    rec = {"phase": "four_exact", "build_s": build_s,
           "shard_devices": sorted(str(d) for d in shard_devs), **rec}
    check("recall_at_10", recall(ids[sample], true_i, k), F32_RECALL_MIN, rec)
    rec.update(MEMORY.read())
    recs.append(rec)
    log(rec)
    del srv

    t0 = time.perf_counter()
    srv = ShardedServer.build(base, k, mesh=mesh, mode="hash", tries=tries,
                              seed=seed, capacity="auto")
    jax.block_until_ready(srv.spk.point_rows)
    build_s = time.perf_counter() - t0
    ids, _, rec = serve_all(srv.search, qb)
    rec = {"phase": "four_hash_packed", "build_s": build_s, "tries": tries,
           **rec}
    check("recall_at_10", recall(ids[sample], true_i, k), hash_floor, rec)
    rec.update(MEMORY.read())
    recs.append(rec)
    log(rec)
    return recs


def run(four: bool) -> dict:
    """Every phase of one run; returns the device as JAX reports it."""
    import jax

    dev = phase_device(4 if four else 1)
    log(dev)
    from approximatenn.utils.runtime import enable_compile_cache

    log({"phase": "compile_cache", "dir": enable_compile_cache()})
    from approximatenn.data import datasets

    t0 = time.perf_counter()
    if four:
        ds = datasets.synthesize("sift-1m", FOUR_N, 128, N_QUERIES)
    else:
        ds = datasets.load("sift-1m")
    base, queries = ds.base, ds.queries
    sample = np.sort(np.random.default_rng(SEED).choice(
        queries.shape[0], SAMPLE, replace=False))
    oracle = host_oracle(base, queries[sample], K if four else 256)
    log({"phase": "oracle", "n": base.shape[0], "d": base.shape[1],
         "queries": queries.shape[0], "sample": SAMPLE,
         "synthetic": ds.synthetic, "secs": time.perf_counter() - t0})
    if four:
        phase_four(base, queries, sample, oracle)
    else:
        phase_exact(base, queries, sample, oracle)
        phase_hash(base, queries, sample, oracle)
        phase_parity()
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the ShardedServer phase on four GPUs")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    result: dict = {"ok": False}
    try:
        result["device"] = run(args.four)
        result["ok"] = True
    except Exception as e:  # the run's boundary: report and fail
        traceback.print_exc()
        result["error"] = f"{type(e).__name__}: {e}"[:500]
    try:
        print(f"gpu: {gpu_name_power()}", flush=True)
    except (OSError, subprocess.SubprocessError) as e:
        print(f"gpu: nvidia-smi unavailable ({type(e).__name__})", flush=True)
    log(result)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
