"""``portbench/spread.py`` on synthetic result lines: the medians, the
quartile spreads, the spread with the farthest run out and the bound of
three times the widest."""

import json
import statistics

import pytest

from portbench import spread

CELL = "cell-a"


def _write(directory, seed, rate, setup, stage=None):
    line = {"correct": True, "attempted": 10, "failed": 0,
            "metrics": {"queries_per_s.map": {"value": rate,
                                              "unit": "queries/s"},
                        "setup_s": {"value": setup, "unit": "s"}},
            "device": {}, "checks": {}}
    with open(directory / f"{CELL}@{seed}.out", "w") as f:
        f.write("a line printed before the result\n" + json.dumps(line) + "\n")
    if stage is not None:
        with open(directory / f"{CELL}@{seed}.err", "w") as f:
            f.write(f"setup stage model: {stage} s\ncheck bad_rows: 0 "
                    "(limit 0)\n")


def test_quartile_spread_and_farthest_out():
    values = [100.0, 101.0, 99.0, 100.0, 102.0, 130.0]
    q1, q2, q3 = statistics.quantiles(values, n=4)
    assert spread.quartile_spread(values) == pytest.approx((q3 - q1) / q2)
    assert spread.farthest_out(values) == [100.0, 101.0, 99.0, 100.0, 102.0]
    assert spread.rule_bound(0.03) == 0.09
    assert spread.rule_bound(0.0301) == 0.10


def test_sets_read_into_a_table(tmp_path):
    a, b = tmp_path / "A", tmp_path / "B"
    a.mkdir()
    b.mkdir()
    rates_a = [100.0, 104.0, 96.0, 100.0, 101.0, 99.0]
    rates_b = [100.0, 110.0, 90.0, 100.0, 105.0, 95.0]
    for i, (ra, rb) in enumerate(zip(rates_a, rates_b)):
        _write(a, 10 + i, ra, 10.0 + i, stage=1.0 + 0.1 * i)
        _write(b, 10 + i, rb, 10.0, stage=None)
    sets = {"A": spread.read_set(str(a)), "B": spread.read_set(str(b))}
    assert sets["A"][("queries_per_s.map", CELL)] == rates_a
    assert sets["A"][("setup:model", CELL)] == pytest.approx(
        [1.0 + 0.1 * i for i in range(6)])
    assert ("setup:model", CELL) not in sets["B"]
    out = spread.table(sets)
    widest = spread.quartile_spread(rates_b)
    assert f"| {100 * widest:.3f}% ({CELL}, B) | " in out
    assert f"| {spread.rule_bound(widest):.2f} |" in out
    assert "Set A: 6 of 6 runs correct." in out
    # set B's runs all read alike: set A's spread is the widest
    sp = spread.quartile_spread([10.0 + i for i in range(6)])
    assert f"| `setup_s` | {100 * sp:.3f}% ({CELL}, A) | " in out
