"""Wall-clock benchmark harness (role of ``/root/reference/time_results.c``).

Times ``build`` (with or without save, ``-z``) or batched ``search``
(``-y N``), averaged over ``-o`` repetitions; prints mean seconds exactly as
the reference does (``time_results.c:138-141``).  Each timed region ends
in ``jax.block_until_ready`` so XLA's async dispatch doesn't flatter the
numbers; the first repetition is reported separately as compile+run (JIT
warmup).

Run: ``python -m approximatenn.harness.time_results [-n ...]``
"""

from __future__ import annotations

import sys
import time

import numpy as np

from .common import gen_gaussian, make_parser, np_dtype, resolve_backend


def main(argv=None) -> int:
    p = make_parser("time_results", __doc__.splitlines()[0])
    p.add_argument("--save", action="store_true",
                   help="alias of -z: build with save structure")
    args = p.parse_args(argv)
    save_test = args.z or args.save
    ycnt = args.ycnt or 0

    import jax

    if args.dtype == "float64":
        jax.config.update("jax_enable_x64", True)
    import approximatenn as ann

    ann.set_ftype("float32" if args.dtype == "bfloat16" else args.dtype)
    if args.dtype == "bfloat16":
        ann.set_ftype("bfloat16")
    dev = resolve_backend(args.use_cpu)
    rng = np.random.default_rng(args.seed if args.seed is not None else time.time_ns())
    dt = np_dtype(args.dtype)
    kw = dict(
        tries=args.tries, rots_before=args.rots_before,
        rot_len_before=args.rot_len_before, rots_after=args.rots_after,
        rot_len_after=args.rot_len_after,
    )

    time_used = 0.0
    first = None
    if ycnt:
        points = gen_gaussian(rng, args.n, args.d, dt)
        pd = jax.device_put(points, dev)
        key = jax.device_put(jax.random.key(int(rng.integers(2**63))), dev)
        idx, _, _ = ann.build(pd, args.k, key=key, **kw)
        if args.verbose:
            print("Precomputation finished.")
        for i in range(args.average_over + 1):
            y = jax.device_put(gen_gaussian(rng, ycnt, args.d, dt), dev)
            t0 = time.perf_counter()
            out = ann.search(idx, pd, y)
            jax.block_until_ready(out)
            dt_s = time.perf_counter() - t0
            if i == 0:
                first = dt_s  # compile + run
            else:
                time_used += dt_s
            if args.verbose:
                print(i + 1, end=" ", flush=True)
        mode = "query"
    else:
        # fixed capacity => static shapes => the timed loop reuses one
        # compiled executable, mirroring the reference's steady-state cost
        cap = None
        for i in range(args.average_over + 1):
            points = jax.device_put(gen_gaussian(rng, args.n, args.d, dt), dev)
            key = jax.device_put(jax.random.key(int(rng.integers(2**63))), dev)
            t0 = time.perf_counter()
            idx, graph, gd = ann.build(points, args.k, key=key, capacity=cap, **kw)
            jax.block_until_ready((graph, gd) if not save_test else (idx, graph, gd))
            dt_s = time.perf_counter() - t0
            if i == 0:
                first = dt_s
                cap = idx.tmax + 4  # headroom so later draws rarely overflow
            else:
                time_used += dt_s
            if args.verbose:
                print(i + 1, end=" ", flush=True)
        mode = "comp (with save)" if save_test else "comp (no save)"
    if args.verbose:
        print()
    print(
        f"Average time for {mode} (on {'C' if args.use_cpu else 'T'}PU): "
        f"{time_used / args.average_over:g}s  "
        f"(first run incl. compile: {first:g}s)"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
