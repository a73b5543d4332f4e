"""Statistical-correctness harness (role of
``/root/reference/test_correctness.c``).

Index mode (default): per repetition, generate Gaussian points, build the
kNN graph, score against the exact oracle.  Query mode (``-y``/``-z``): one
build with save, then per repetition generate queries and score the search.
Prints the reference's three metrics (``test_correctness.c:134-140``).

Run: ``python -m approximatenn.harness.test_correctness [-n ...]``
"""

from __future__ import annotations

import sys
import time

import numpy as np

from .common import gen_gaussian, make_parser, np_dtype, resolve_backend
from .scoring import score_guesses


def main(argv=None) -> int:
    p = make_parser("test_correctness", __doc__.splitlines()[0])
    args = p.parse_args(argv)
    if args.z and args.ycnt is None:
        args.ycnt = 50
    use_y = args.ycnt is not None

    import jax

    if args.dtype == "float64":
        jax.config.update("jax_enable_x64", True)
    import approximatenn as ann

    dev = resolve_backend(args.use_cpu)
    rng = np.random.default_rng(args.seed if args.seed is not None else time.time_ns())
    dt = np_dtype(args.dtype)
    kw = dict(
        tries=args.tries, rots_before=args.rots_before,
        rot_len_before=args.rot_len_before, rots_after=args.rots_after,
        rot_len_after=args.rot_len_after,
        dtype={"float32": "float32", "float64": "float64", "bfloat16": "bfloat16"}[args.dtype],
    )
    ann.set_ftype(kw.pop("dtype"))

    score = scb = scc = 0.0
    if use_y:
        points = gen_gaussian(rng, args.n, args.d, dt)
        pd = jax.device_put(points, dev)
        key = jax.device_put(jax.random.key(int(rng.integers(2**63))), dev)
        idx, _, _ = ann.build(pd, args.k, key=key, **kw)
        if args.verbose:
            print("Precomputation finished.")
        for i in range(args.average_over):
            y = gen_gaussian(rng, args.ycnt, args.d, dt)
            ids, _ = ann.search(idx, pd, jax.device_put(y, dev))
            s = score_guesses(points, y, np.asarray(ids), args.k)
            score += s.mean_excess_rank
            scb += 1 - s.prob_correct
            scc += s.max_rank_over_k
            if args.verbose:
                print(i + 1, end=" ", flush=True)
    else:
        for i in range(args.average_over):
            points = gen_gaussian(rng, args.n, args.d, dt)
            pd = jax.device_put(points, dev)
            key = jax.device_put(jax.random.key(int(rng.integers(2**63))), dev)
            graph, _ = ann.build_graph_only(pd, args.k, key=key, **kw)
            s = score_guesses(points, None, np.asarray(graph), args.k)
            score += s.mean_excess_rank
            scb += 1 - s.prob_correct
            scc += s.max_rank_over_k
            if args.verbose:
                print(i + 1, end=" ", flush=True)
    if args.verbose:
        print()
    o = args.average_over
    print(
        f"Average index score for {'query' if use_y else 'comp'} "
        f"(on {'C' if args.use_cpu else 'T'}PU): {score / o:g}.\n"
        f"Prob correct: {1 - scb / o:g}.\n"
        f"Max index score: {scc / o:g}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
