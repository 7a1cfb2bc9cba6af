"""The traffic generator: the same seed gives the same pool, another seed
another pool over the same spread of lengths."""

import numpy as np

import driver
import harness
import mixes

SEEDS = (7, 2**31 + 11)


def small_mix(**kw):
    _, _, mix = harness.cell_parts(harness.benchmark(), "primary-batch")
    return dict(mix, **{"calls": 3, "rows_per_call": 5, **kw})


def test_same_seed_same_pool():
    mix = small_mix()
    for seed in SEEDS:
        a, b = mixes.pool(mix, seed, "cpu"), mixes.pool(mix, seed, "cpu")
        assert len(a) == 3 and all(len(c) == 5 for c in a)
        for ca, cb in zip(a, b):
            for wa, wb in zip(ca, cb):
                assert wa.dtype == np.int16 and np.array_equal(wa, wb)


def test_other_seed_other_pool_same_spread():
    mix = small_mix()
    la, lb = mixes.lengths(mix, SEEDS[0]), mixes.lengths(mix, SEEDS[1])
    assert not np.array_equal(la, lb)
    a, b = mixes.pool(mix, SEEDS[0], "cpu"), mixes.pool(mix, SEEDS[1], "cpu")
    assert not np.array_equal(a[0][0][:1000], b[0][0][:1000])
    # one length from each of calls * rows equal strata of [min_s, max_s]
    n = mix["calls"] * mix["rows_per_call"]
    for lens in (la, lb):
        strata = np.sort((lens.ravel() / mix["sample_rate"] - mix["min_s"])
                         / (mix["max_s"] - mix["min_s"]) * n).astype(int)
        assert np.array_equal(strata, np.arange(n))


def test_every_call_spans_the_range():
    mix = small_mix(calls=4, rows_per_call=16)
    lens = mixes.lengths(mix, SEEDS[1]) / mix["sample_rate"]
    assert lens.min() >= mix["min_s"] and lens.max() <= mix["max_s"]
    for row in lens:
        assert row.min() < mix["min_s"] + 0.5 and row.max() > mix["max_s"] - 0.5


def test_mixes_on_disk_are_whole():
    bench = harness.benchmark()
    for cell in bench["workloads"]:
        _, config, mix = harness.cell_parts(bench, cell["name"])
        assert issubclass(driver.load(mix["driver"]), driver.Driver)
        assert 0 < mix["min_s"] < mix["max_s"] and mix["check_requests"] >= 16
        assert config["limits"]["max_logit_gap"] > 0
