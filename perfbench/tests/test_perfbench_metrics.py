"""The frozen metric arithmetic: the step tail over all steps, whole-window
rates, the work formulas against hand counts, the trace summary, the
readers on given readings, and the names and units of BENCHMARK.json."""

import math
import re
import time

import pytest
import torch

from perfbench.lib import bench, devtime, peaks, stats
from perfbench.lib.stepclock import StepClock

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def metric(name):
    return bench.load_module("metrics", name)


def test_p95_over_every_step_moves_with_a_stall():
    steps = [20.0] * 1000
    assert stats.p95(steps) == 20.0
    stalled = list(steps)
    for i in range(0, 1000, 16):  # 63 stalls: past the 5 % tail
        stalled[i] = 120.0
    assert stats.p95(stalled) == 120.0
    few = list(steps)
    few[500] = 120.0  # one stall among 1000 steps stays under the p95
    assert stats.p95(few) == 20.0


def test_p95_interpolates_and_takes_one_value():
    assert stats.p95([5.0]) == 5.0
    assert stats.p95(list(range(1, 102))) == pytest.approx(96.0)
    with pytest.raises(ValueError):
        stats.p95([])


def test_whole_window_rates():
    # every row of the window over all of its seconds
    assert stats.rate(4 * 8192, 0.5) == 65536.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_peaks_and_shares():
    assert peaks.least_seconds(67e12, 0) == pytest.approx(1.0)
    assert peaks.least_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert peaks.least_seconds(67e12, 6.7e12) == pytest.approx(2.0)
    assert peaks.share(0, 3.35e9, 2e-3) == pytest.approx(50.0)
    assert peaks.share(1, 1, 0) is None


def test_fm_step_work_by_hand():
    mfu = metric("step_mfu.fm")
    # K = 1, one row, one entry, one id: 7 + 5 per entry, 3 + 13 per row,
    # 2 (K + 1) per id
    assert mfu.work(1, 1, 1, 1)[0] == 12 + 16 + 4
    # bytes, 4 each: value, id; offsets 2; label, weight; w and v read and
    # written; b read and written
    assert mfu.work(1, 1, 1, 1)[1] == 4 * (2 + 2 + 2 + 4 + 2)
    flops, nbytes = mfu.work(8192, 8192 * 39, 100_000, 8)
    assert flops == 8192 * 39 * 61 + 8192 * 37 + 2 * 100_000 * 9
    assert nbytes == 4 * (2 * 8192 * 39 + 8193 + 2 * 8192 + 18 * 100_000 + 2)


def test_segment_sum_work_by_hand():
    fss = metric("feature_segment_sum_roofline")
    assert fss.work(10, 8, 100) == (80, 4 * (80 + 10 + 800))
    coo = metric("coo_segment_sum_fm_roofline")
    assert coo.work(10, 17, 2) == (170, 4 * (170 + 10 + 34))


def test_gbdt_work_by_hand():
    mfu = metric("step_mfu.gbdt")
    assert [mfu.id_bytes(c) for c in (2, 64, 256, 257, 65536, 65537)] == \
        [1, 1, 1, 2, 2, 3]
    # one level: two adds a (row, feature); a byte a bin id, a byte a
    # node, 8 bytes of (g, h) a row, the float32 histogram written once
    assert mfu.level_work(1000, 28, 256, 32) == (
        2 * 1000 * 28, 1000 * (28 + 1 + 8) + 32 * 28 * 256 * 8)
    assert mfu.binning_work(10, 2, 256) == (10 * 2 * 9,
                                            10 * 2 * 5 + 4 * 2 * 255)
    # a depth-1 tree: gradients, one level (histogram, its search, the
    # descent), the leaves and the margin
    n, f, b = 100, 3, 4
    flops, nbytes = mfu.tree_work(n, f, b, 1)
    assert flops == 16 * n + (2 * n * f + 20 * f * b + 3 * n) + 4 * n
    assert nbytes == 16 * n + (n * (f + 1 + 8) + f * b * 8) + f * b * 8 \
        + n * 2 + 2 * n * 9


def test_mfu_readers_sum_the_window():
    fm = metric("step_mfu.fm")
    steps = [(8192, 319488, 120_000)] * 10
    want = 100 * 10 * peaks.least_seconds(*fm.work(8192, 319488, 120_000, 8))
    got = fm.read({"window_batches": steps, "num_factors": 8,
                   "window_s": 1.0})
    assert got == pytest.approx(want)
    assert fm.read({"window_batches": [], "window_s": 1.0}) is None
    gb = metric("step_mfu.gbdt")
    r = {"fits": 3, "rows": 1000, "features": 28, "num_bins": 256,
         "trees": 20, "max_depth": 6, "window_s": 2.0}
    per_fit = peaks.least_seconds(*gb.binning_work(1000, 28, 256)) + 20 * \
        peaks.least_seconds(*gb.tree_work(1000, 28, 256, 6))
    assert gb.read(r) == pytest.approx(100 * 3 * per_fit / 2.0)


def test_counter_and_trace_readers():
    stats_ = [{"host_wait_ns": 1e8, "pipeline": {"parse_ns": 4e8}},
              {"host_wait_ns": 3e8, "pipeline": {"parse_ns": 8e8}}]
    r = {"epoch_stats": stats_, "window_s": 2.0, "parse_threads": 2,
         "trace": {"busy_s": 1.5, "window_s": 2.0, "steps": 100}}
    assert metric("ingest_wait_share.fm").read(r) == pytest.approx(20.0)
    assert metric("parse_busy_share.fm").read(r) == pytest.approx(30.0)
    assert metric("fm_step_device_ms.fm").read(r) == pytest.approx(15.0)
    assert metric("device_idle_share.fm").read(r) == pytest.approx(25.0)
    assert metric("device_idle_share.gbdt").read(r) == pytest.approx(25.0)
    # nothing to read: nothing returned, never 0
    empty = {"epoch_stats": [{"host_wait_ns": 0}], "window_s": 1.0,
             "parse_threads": 2, "trace": {}}
    assert metric("parse_busy_share.fm").read(empty) is None
    assert metric("fm_step_device_ms.fm").read(empty) is None
    assert metric("device_idle_share.fm").read(empty) is None


def test_trace_summary_unions_busy_time_and_names_gaps():
    device = [(0, 10, "k1(int, float*)"), (5, 20, "k2"), (30, 40, "k1(int)"),
              (100, 110, "k3")]
    host = [(0, 200, "step"), (50, 90, "aten::copy_"), (22, 28, "inner")]
    out = devtime.summarize(device, host, window_s=200e-6)
    assert out["busy_s"] == pytest.approx(40e-6)  # [0, 20] [30, 40] [100, 110]
    assert out["ops"] == pytest.approx({"k1": 20e-6, "k2": 15e-6,
                                        "k3": 10e-6})
    gaps = out["breakdown"]["idle_gaps"]
    assert gaps[0] == ["aten::copy_", pytest.approx(60e-6)]
    assert gaps[1] == ["inner", pytest.approx(10e-6)]
    assert out["breakdown"]["device_ops"][0] == ["k1", pytest.approx(20e-6)]


def test_short_name_drops_the_argument_list():
    assert devtime.short_name(
        "void (anonymous namespace)::kern<float>(long const*, bool)") == \
        "void (anonymous namespace)::kern<float>"
    assert devtime.short_name("Memcpy HtoD (Pinned -> Device)") == \
        "Memcpy HtoD"
    assert devtime.short_name("aten::mm") == "aten::mm"


class FakeFeed:
    """A feed of ``n`` batches of 4 rows on the CPU."""

    def __init__(self, n, pause=0.0):
        self.n, self.pause = n, pause
        self.spec = "csr"
        self.device = torch.device("cpu")
        self.rewinds = 0

    def __iter__(self):
        for i in range(self.n):
            time.sleep(self.pause)
            yield {"num_rows": 4, "i": i}

    def stats(self):
        return {"host_wait_ns": 1}

    def before_first(self):
        self.rewinds += 1


def test_step_clock_marks_each_step_and_counts_rows():
    clock = StepClock(FakeFeed(5))
    clock.start()
    got = [b["i"] for b in clock]
    assert got == [0, 1, 2, 3, 4]
    clock.stop()
    times = clock.step_ms()
    assert len(times) == 5  # one a step: the zero, 4 handouts, the stop
    assert clock.rows == 20
    assert clock.window_positions == [0, 1, 2, 3, 4]


def test_step_clock_budget_continues_the_epoch_and_deadline_cuts():
    clock = StepClock(FakeFeed(6))
    clock.keep = 2
    clock.budget = 2
    assert [b["i"] for b in clock] == [0, 1]
    assert [b["i"] for b in clock] == [2, 3]
    clock.budget = None
    assert [b["i"] for b in clock] == [4, 5]
    assert len(clock.batches) == 2
    clock.close_epoch()
    assert clock.feed.rewinds == 1 and clock.position == 0
    slow = StepClock(FakeFeed(1000, pause=0.01))
    slow.deadline = time.perf_counter() + 0.1
    slow.start()
    n = len(list(slow))
    assert slow.cut and 2 <= n < 100


def test_step_clock_sums_a_digest_an_epoch_in_the_window_only():
    def digest(batch, position):
        return torch.tensor([batch["i"], position], dtype=torch.int64)

    clock = StepClock(FakeFeed(4), digest=digest)
    clock.budget = 1
    assert [b["i"] for b in clock] == [0]  # before the window: no digest
    clock.budget = None
    clock.close_epoch()
    clock.start()
    list(clock)
    clock.close_epoch()
    clock.budget = 2
    list(clock)
    clock.stop()
    got = [(m, d.tolist()) for m, d in clock.epoch_digests]
    assert got == [(4, [6, 6]), (2, [1, 1])]
    assert clock.window_positions == [0, 1, 2, 3, 0, 1]
    clock.close_epoch()  # after the window: nothing more is counted
    list(clock)
    assert len(clock.epoch_digests) == 2 and clock.rows == 24
    assert clock.window_positions == [0, 1, 2, 3, 0, 1]


def test_a_split_metric_name_reads_its_base():
    from perfbench import run

    values = {"rows_per_s": 5.0, "setup_s": 1.0, "step_mfu.fm": 2.0}
    assert run.value_of(values, "rows_per_s.text") == 5.0
    assert run.value_of(values, "step_mfu.fm") == 2.0
    assert run.value_of(values, "setup_s") == 1.0
    assert run.value_of(values, "step_ms_p95") is None


def test_names_and_units_keep_to_the_allowed_characters():
    spec = bench.benchmark()
    names = [c["name"] for c in spec["configs"]]
    names += [w["name"] for w in spec["workloads"]]
    names += [w["traffic"] for w in spec["workloads"]]
    names += [k for c in spec["configs"] for k in c["reduced"]]
    metrics = spec["end_to_end"] + spec["per_layer"]
    names += [m["name"] for m in metrics]
    assert all(NAME.match(n) for n in names), names
    assert len(set(m["name"] for m in metrics)) == len(metrics)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    for text in [w["why"] for w in spec["workloads"]] + \
            [c["why"] for c in spec["configs"]] + \
            [m["layer"] for m in spec["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_every_roofline_and_mfu_is_a_percent():
    for m in bench.benchmark()["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%" and m["better"] == "higher"


@pytest.mark.cuda
def test_time_alone_and_trace_read_the_card(card):
    x = torch.randn(1 << 24, device=card)
    ms = devtime.time_alone(lambda: x.mul_(1.0), [()], card, iters=5)
    assert 0 < ms < 100
    out = devtime.traced(lambda: [x.add_(1.0) for _ in range(10)], card)
    assert 0 < out["busy_s"] <= out["window_s"]
    assert out["breakdown"]["device_ops"]
    assert math.isfinite(out["busy_s"])
