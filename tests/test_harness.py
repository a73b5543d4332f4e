"""CLI harness tests (gates 1-3 of SURVEY.md §4, driven programmatically)."""

import numpy as np
import pytest

from approximatenn.harness import compare_results, test_correctness, time_results
from approximatenn.harness.compare_results import diffcount, ulp_units
from approximatenn.harness.scoring import Score, score_guesses, true_ranks


class TestScoring:
    def test_true_ranks_self_mode(self, rng):
        X = rng.standard_normal((20, 4)).astype(np.float32)
        inv = true_ranks(X, None)
        # self is pushed to worst rank
        assert all(inv[i, i] == 19 for i in range(20))

    def test_perfect_guess_scores_zero_excess(self, rng):
        X = rng.standard_normal((50, 8)).astype(np.float32)
        dd = ((X[:, None, :] - X[None, :, :]) ** 2).sum(-1)
        np.fill_diagonal(dd, np.inf)
        guess = np.argsort(dd, 1)[:, :5]
        s = score_guesses(X, None, guess, 5)
        assert s.mean_excess_rank == pytest.approx(0.0)
        assert s.prob_correct == 1.0

    def test_sentinel_guess_scored_worst(self, rng):
        X = rng.standard_normal((10, 4)).astype(np.float32)
        guess = np.full((10, 3), 10)  # all sentinels
        s = score_guesses(X, None, guess, 3)
        assert s.prob_correct == 0.0


class TestCompareHelpers:
    def test_ulp_units_zero_for_identical(self):
        a = np.array([1.0, -2.5, 0.0], np.float32)
        assert ulp_units(a, a.copy()) == 0.0

    def test_ulp_units_counts_large_gaps(self):
        a = np.array([1.0], np.float32)
        b = np.array([1.001], np.float32)
        assert ulp_units(a, b) > 0

    def test_ulp_units_sign_crossing_monotonic(self):
        a = np.array([-1e-30], np.float32)
        b = np.array([1e-30], np.float32)
        assert ulp_units(a, b) < ulp_units(np.float32([-1.0]), np.float32([1.0]))

    def test_diffcount(self):
        assert diffcount(np.array([1, 2, 3]), np.array([1, 9, 3])) == 1


class TestCLIs:
    def test_test_correctness_index_mode(self, capsys):
        rc = test_correctness.main(
            ["-n", "200", "-k", "5", "-d", "16", "-o", "2", "--seed", "0", "-c"]
        )
        out = capsys.readouterr().out
        assert rc == 0 and "Prob correct" in out
        prob = float(out.split("Prob correct: ")[1].split(".\n")[0])
        assert prob > 0.8

    def test_test_correctness_query_mode(self, capsys):
        rc = test_correctness.main(
            ["-n", "200", "-k", "5", "-d", "16", "-o", "2", "-z", "--seed", "0", "-c"]
        )
        assert rc == 0 and "query" in capsys.readouterr().out

    def test_time_results_modes(self, capsys):
        rc = time_results.main(
            ["-n", "128", "-k", "4", "-d", "8", "-o", "2", "--seed", "0", "-c"]
        )
        assert rc == 0 and "Average time for comp" in capsys.readouterr().out
        rc = time_results.main(
            ["-n", "128", "-k", "4", "-d", "8", "-o", "2", "-y", "16", "--seed", "0", "-c"]
        )
        assert rc == 0 and "query" in capsys.readouterr().out

    def test_compare_results_parity(self, capsys):
        """Backend parity gate (role of compare_results.c): identical keys
        => identical graphs.  On the CPU-only test rig this degenerates to
        CPU-vs-CPU, which must be exactly zero diff; on a GPU
        (chip_smoke.py's parity phase) it exercises true cross-backend
        parity."""
        rc = compare_results.main(
            ["-n", "200", "-k", "5", "-d", "16", "-o", "2", "--seed", "0"]
        )
        out = capsys.readouterr().out
        assert rc == 0
        # one row per graph_mode: the hash pipeline (divergence-prone path
        # the gate exists for) and the exact-graph path
        rows = out.split("graph diff count: ")[1:]
        assert len(rows) == 2 and "[graph_mode=hash]" in out
        for row in rows:
            assert float(row.split(" ")[0]) == 0.0

    def test_compare_results_query_mode(self, capsys):
        rc = compare_results.main(
            ["-n", "200", "-k", "5", "-d", "16", "-o", "2", "-z", "--seed", "0"]
        )
        out = capsys.readouterr().out
        assert rc == 0
        qdiff = float(out.split("query diff count: ")[1].split(" ")[0])
        assert qdiff == 0.0

    def test_compare_results_arbitration_and_band(self, capsys):
        """--arbitrate attributes graph diffs with the f64 oracle and
        --max-diff-frac turns the gate into a pass/fail check (round-2
        VERDICT item 4).  CPU-vs-CPU: zero diffs, identical oracle
        recalls, band trivially satisfied."""
        rc = compare_results.main(
            ["-n", "200", "-k", "5", "-d", "16", "-o", "2", "--seed", "0",
             "--arbitrate", "--max-diff-frac", "0.01"]
        )
        out = capsys.readouterr().out
        assert rc == 0
        assert out.count("arbitration (f64 oracle)") == 2
        for row in out.splitlines():
            if "arbitration" in row:
                acc = float(row.split("acc=")[1].split(" ")[0])
                cpu = float(row.split("cpu=")[1].split(";")[0])
                assert acc == cpu  # same backend twice -> identical sets
                assert acc > 0.9  # exhaustive/hash graphs near the oracle
                assert float(row.split("real=")[1]) == 0.0

    def test_compare_results_band_fails_loudly(self, capsys):
        """An impossible band must FAIL (exit 2) — the gate can now
        regress noisily instead of recording drift silently."""
        rc = compare_results.main(
            ["-n", "200", "-k", "5", "-d", "16", "-o", "1", "--seed", "0",
             "--max-diff-frac", "-0.1"]
        )
        out = capsys.readouterr().out
        assert rc == 2
        assert "FAIL" in out

    def test_arbitrate_f64_classifies_ties(self, rng):
        """Unit gate for the classifier: identical sets -> no diffs; a
        swap between two exactly-equidistant points -> tie_f64; a swap to
        a strictly-farther point -> real."""
        from approximatenn.harness.compare_results import arbitrate_f64

        pts = rng.standard_normal((64, 8)).astype(np.float64)
        pts[1] = pts[0] + (pts[2] - pts[0]) * 0.5  # general position stays
        # exact duplicate distances: reflect point 3 about point 0 so
        # d(0,3) == d(0,40)
        pts[40] = 2 * pts[0] - pts[3]
        import approximatenn as ann

        ga, _ = ann.brute_force_knn_self(pts.astype(np.float32), 4)
        ga = np.asarray(ga)
        a = arbitrate_f64(pts, ga, ga, 4)
        assert a["diff_tie_f64"] == a["diff_tie_f32"] == a["diff_real"] == 0
        assert a["recall_acc"] == a["recall_cpu"]
        gc = ga.copy()
        row = 0
        # swap 3 <-> 40 in row 0 if present (equidistant twins)
        where3 = np.nonzero(gc[row] == 3)[0]
        if where3.size:
            gc[row, where3[0]] = 40
            b = arbitrate_f64(pts, ga, gc, 4)
            assert b["diff_real"] == 0, b
        # now a genuinely wrong id: replace row 5's nearest with the
        # farthest point
        gd = ga.copy()
        far = int(np.argmax(((pts - pts[5]) ** 2).sum(1)))
        gd[5, 0] = far
        c = arbitrate_f64(pts, ga, gd, 4)
        assert c["diff_real"] >= 1, c
