"""chip_smoke.py on the CPU: the run refuses to start without a GPU, and
each phase works at a tiny size (the --four phase on 4 of the virtual
mesh's devices).  The real run, on a GPU, is the ``gpu``-marked test."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import chip_smoke as cs
from approximatenn.data import datasets

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def tiny():
    ds = datasets.synthesize("sift-1m", 3000, 16, 64)
    sample = np.sort(np.random.default_rng(0).choice(64, 16, replace=False))
    oracle = cs.host_oracle(ds.base, ds.queries[sample], 256)
    return ds.base, ds.queries, sample, oracle


def test_main_fails_without_gpu(capsys):
    assert cs.main([]) != 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["ok"] is False and "GPU" in last["error"]
    assert cs.main(["--four"]) != 0


def test_phase_device_requires_gpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        cs.phase_device()


def test_host_oracle_matches_argsort(tiny):
    base, queries, sample, (ids, dd) = tiny
    q = queries[sample].astype(np.float64)
    d = ((q[:, None, :] - base[None].astype(np.float64)) ** 2).sum(-1)
    np.testing.assert_array_equal(ids, np.argsort(d, 1, kind="stable")[:, :256])
    np.testing.assert_allclose(dd, np.sort(d, 1)[:, :256], rtol=1e-9)
    assert cs.recall(ids, ids, 10) == 1.0
    assert cs.tie_recall(base, queries[sample], ids, dd, 10) == 1.0
    wrong = ids[:, ::-1].copy()  # the 256 farthest of the oracle's list
    assert cs.tie_recall(base, queries[sample], wrong, dd, 10) == 0.0


def test_device_memory_max_over_devices(monkeypatch):
    """Each reading takes the maximum over every device and says whether
    the phase raised the process's running peak."""
    import jax

    class Dev:
        def __init__(self, peak, used):
            self.stats = {"peak_bytes_in_use": peak, "bytes_in_use": used}

        def memory_stats(self):
            return self.stats

    devs = [Dev(10, 4), Dev(30, 2), Dev(20, 9)]
    monkeypatch.setattr(jax, "devices", lambda *a: devs)
    mem = cs.DeviceMemory()
    assert mem.read() == {"peak_bytes_in_use": 30, "peak_set_in_phase": True,
                          "bytes_in_use": 9}
    assert mem.read()["peak_set_in_phase"] is False  # peak unchanged
    devs[0].stats["peak_bytes_in_use"] = 40
    assert mem.read()["peak_bytes_in_use"] == 40
    assert mem.peak == 40


def test_phase_exact_tiny(tiny):
    base, queries, sample, oracle = tiny
    recs = cs.phase_exact(base, queries, sample, oracle, batch=16)
    names = [r["phase"] for r in recs]
    assert names == ["exact_f32", "exact_k100", "exact_k256", "exact_bf16",
                     "exact_int8"]
    assert recs[0]["recall_at_10"] == 1.0 and recs[0]["queries"] == 64
    assert recs[3]["grid_tie_recall_at_10"] == 1.0
    assert recs[4]["grid_tie_recall_at_10"] == 1.0


def test_phase_exact_fails_loudly(tiny, monkeypatch):
    """A phase never swallows its own failure."""
    base, queries, sample, oracle = tiny
    monkeypatch.setattr(cs, "F32_RECALL_MIN", 1.5)
    with pytest.raises(AssertionError, match="recall_at_10"):
        cs.phase_exact(base, queries, sample, oracle, batch=16)


def test_phase_hash_tiny(tiny):
    base, queries, sample, oracle = tiny
    recs = cs.phase_hash(base, queries, sample, oracle, batch=32, tries=3,
                         floor=0.5)
    assert [r["phase"] for r in recs] == ["hash_table", "hash_packed"]


def test_phase_parity(capsys):
    argv = ["-n", "200", "-d", "16", "-k", "5", "-t", "3", "-o", "1",
            "--seed", "11", "--arbitrate"]
    assert cs.phase_parity("cpu", argv=argv)["rc"] == 0
    # the card run must find the GPU: on the CPU it fails, never
    # degrading to a CPU-vs-CPU comparison
    with pytest.raises(AssertionError, match="exited 3"):
        cs.phase_parity("gpu", argv=argv)


def test_phase_four_virtual_mesh(tiny):
    base, queries, sample, (ids, dd) = tiny
    recs = cs.phase_four(base, queries, sample, (ids[:, :10], dd[:, :10]),
                         batch=32, tries=3, hash_floor=0.5)
    assert recs[0]["phase"] == "four_exact"
    assert len(recs[0]["shard_devices"]) == 4
    assert recs[0]["recall_at_10"] == 1.0


@pytest.mark.gpu
def test_chip_smoke_on_gpu():
    """The whole smoke run in its own process, which must be the only JAX
    process on the card (this one stays on the CPU)."""
    if shutil.which("nvidia-smi") is None:
        pytest.skip("needs an NVIDIA GPU (nvidia-smi not found)")
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=1500)
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert proc.returncode == 0 and last["ok"], proc.stderr[-3000:]
    assert last["device"]["platform"] == "gpu"
