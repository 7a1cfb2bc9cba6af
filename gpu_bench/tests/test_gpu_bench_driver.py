"""The harness runs any driver through its interface alone: the window, the
metrics read by name, the comparison the driver gives, and ``setup_s``
without the seconds the driver spent in the benchmark's reference."""

import time

import pytest

import driver
import harness


class Counting(driver.Driver):
    """A stand-in entry point: each call counts its entry's samples, half a
    second of set-up goes to a reference, and the comparison reads ``gap``."""

    gap = 0.0

    def __init__(self, config, mix, seed, device):
        super().__init__(config, mix, seed, device)
        self.pool = [[[0] * 1600] * 4, [[0] * 3200] * 2]
        t = time.perf_counter()
        time.sleep(0.5)
        self.reference_s = time.perf_counter() - t

    def call(self, entry):
        time.sleep(0.01)
        return sum(len(w) for w in entry)

    def release(self):
        Counting.released = True

    def compare(self, records, outputs):
        assert Counting.released
        return {"gap": {"value": self.gap, "limit": 1.0}}


@pytest.fixture
def counting(monkeypatch):
    monkeypatch.setattr(driver, "load", lambda name: Counting)
    Counting.released = False
    return Counting


def run(traced=False):
    _, config, mix = harness.cell_parts(harness.benchmark(), "primary-batch")
    return harness.run_cell("primary-batch", 5, 0.3, traced, device="cpu", config=config,
                            mix=mix)


def test_any_driver_runs_through_the_interface(counting):
    t = time.perf_counter()
    result = run()
    wall = time.perf_counter() - t
    assert result["correct"] and result["failed"] == 0
    assert set(result["metrics"]) == {"batch_audio_s_per_s", "setup_s"}
    # the half second in the reference is not set-up
    assert result["metrics"]["setup_s"]["value"] < wall - 0.5 - 0.3
    # 0.4 audio seconds a call, both entries alike, a call every 10 ms or more
    assert 0 < result["metrics"]["batch_audio_s_per_s"]["value"] < 0.4 / 0.01
    assert result["attempted"] % 6 in (0, 4)
    assert list(result)[-1] == "compared" and "gap" in result["compared"]


def test_the_drivers_comparison_decides(counting, monkeypatch):
    monkeypatch.setattr(Counting, "gap", 2.0)
    assert not run()["correct"]


def test_a_failing_call_is_counted(counting, monkeypatch):
    def fails(self, entry):
        raise RuntimeError("planted")

    monkeypatch.setattr(Counting, "call", fails)
    monkeypatch.setattr(Counting, "warm", lambda self: None)
    result = run()
    assert result["failed"] == result["attempted"] > 0 and not result["correct"]
