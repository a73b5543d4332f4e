"""float64 end-to-end gate — the reference's DEFAULT dtype.

The reference computes in double unless -DUSE_FLOAT (``ftype.h:3-9``;
``test_correctness.c:24-25`` runs double).  This framework's equivalent is
``ANN_FTYPE=float64`` + ``jax_enable_x64``.  x64 flips jax-wide default
dtypes, so the full f64 build+search runs in a subprocess, keeping the rest
of the suite at the f32 default.
"""

import json
import os
import subprocess
import sys

import pytest

pytestmark = pytest.mark.slow  # subprocess gate
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

SCRIPT = r"""
import json
import numpy as np
import jax
# pin the CPU platform through jax.config, like tests/conftest.py does
jax.config.update("jax_platforms", "cpu")
assert jax.config.jax_enable_x64
import jax.numpy as jnp
import approximatenn as ann
from approximatenn.config import ftype

assert ftype() == jnp.float64  # ANN_FTYPE=float64 took effect
rng = np.random.default_rng(42)
X = rng.standard_normal((2000, 32))           # float64
Y = rng.standard_normal((50, 32))
index, graph, gdists = ann.build(jnp.asarray(X), 10, tries=6, seed=3,
                                 graph_mode="hash")
ids, dists = ann.search(index, jnp.asarray(X), jnp.asarray(Y))
assert index.bases.dtype == jnp.float64, index.bases.dtype
assert np.asarray(gdists).dtype == np.float64
assert np.asarray(dists).dtype == np.float64

# recall vs the f64 numpy oracle, and distance agreement at f64 precision
d2 = ((X[None, :, :] - Y[:, None, :]) ** 2).sum(-1)
want = np.argsort(d2, axis=1)[:, :10]
got = np.asarray(ids)
recall = np.mean([len(set(got[i]) & set(want[i])) / 10 for i in range(50)])
fin = got < 2000
ref_d = np.take_along_axis(d2, np.where(fin, got, 0), axis=1)
dist_err = float(np.abs(np.where(fin, ref_d, 0) - np.where(fin, np.asarray(dists), 0)).max())
print(json.dumps({"recall": float(recall), "dist_err": dist_err}))
"""


def test_float64_build_search_end_to_end():
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        JAX_ENABLE_X64="true",
        ANN_FTYPE="float64",
        PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""),
    )
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT], env=env, cwd=REPO,
        capture_output=True, text=True, timeout=420,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["recall"] >= 0.8, rec
    # f64 distances must match the numpy double oracle to ~1e-9 relative
    assert rec["dist_err"] < 1e-8, rec
