"""Unit tests for the bench.py measurement helpers (CPU)."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bench import median_of  # noqa: E402


def test_median_of_odd():
    vals = iter([3.0, 1.0, 2.0, 5.0, 4.0])
    med, spread = median_of(lambda: next(vals), 5)
    assert med == 3.0
    assert abs(spread - 4.0 / 3.0) < 1e-12


def test_median_of_even():
    vals = iter([4.0, 2.0])
    med, spread = median_of(lambda: next(vals), 2)
    assert med == 3.0
    assert abs(spread - 2.0 / 3.0) < 1e-12


def test_median_of_constant_zero():
    med, spread = median_of(lambda: 0.0, 3)
    assert med == 0.0 and spread == 0.0


def test_median_of_spread_is_relative_range():
    vals = iter([2.0, 6.0, 4.0])
    med, spread = median_of(lambda: next(vals), 3)
    assert med == 4.0 and spread == 1.0


def test_no_gpu_exits_nonzero_without_a_result(capsys):
    """The harness measures on a GPU or not at all: no CPU fallback."""
    import bench
    assert bench.main([]) == 2
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "GPU" in captured.err
