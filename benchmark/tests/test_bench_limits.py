"""The rule each limit of `correct` is set by, and the limits files that
follow from it."""

from __future__ import annotations

import json

import pytest

from benchmark import calibrate, correctness, spec


def test_the_control_gives_the_upper_where_three_times_the_lower():
    got = calibrate.limit_for(1e-7, 4e-6, {"half_batch": 1e-4,
                                           "state_unchanged": 1.0})
    assert got["upper"] == 4e-6
    assert got["limit"] == pytest.approx(1e-7 ** (1 / 3) * 4e-6 ** (2 / 3),
                                         rel=0.05)
    assert 1e-7 < got["limit"] < 4e-6
    # more room above the lower than below the upper
    assert got["limit"] / 1e-7 > 4e-6 / got["limit"]


def test_a_fault_counts_at_ten_times_and_a_frozen_state_at_three():
    got = calibrate.limit_for(1e-6, 2e-6, {"half_batch": 9e-6,
                                           "state_unchanged": 3.5e-6})
    assert got["upper"] == 3.5e-6
    assert calibrate.limit_for(1e-6, 2e-6, {"half_batch": 9e-6})[
        "limit"] is None


def test_every_cell_names_numbers_that_exist_with_limits():
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        limits = spec.load_cell(w["name"]).limits
        assert set(limits) <= set(correctness.NUMBERS)
        assert "grad1_gap" in limits
        assert all(v >= 0 for v in limits.values())
        if w["traffic"] == "sampled":
            assert limits["sample_bad"] == 0
