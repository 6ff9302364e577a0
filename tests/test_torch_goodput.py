"""The port's goodput ledger, SLO watchdog and perf sentry
(``dmlc_tpu_torch/obs/{goodput,watchdog,sentry}.py``) against the JAX
package's, on the same inputs. Every comparison is exact: the verdicts,
tables and alerts are the same dicts and strings.

- ``attribute``, ``rolled`` and ``format_attribution`` on the same flat
  registry deltas (the peak ceilings passed in or set through
  ``DMLC_TPU_PEAK_FLOPS`` / ``DMLC_TPU_PEAK_HBM_GBPS``, so neither package
  probes its device);
- ``Watchdog`` on the same window sequences: the same alerts, fired once
  and re-armed the same way;
- ``sentry.gate`` on the reference's test records and canned history;
- both factories collapse to the shared no-op child under
  ``DMLC_TPU_METRICS=0``, allocation-free on the hot path.
"""

import gc
import sys
import time

import pytest

from dmlc_tpu.obs import goodput as ref_goodput
from dmlc_tpu.obs import sentry as ref_sentry
from dmlc_tpu.obs.metrics import Registry as RefRegistry
from dmlc_tpu.obs.watchdog import Watchdog as RefWatchdog
from dmlc_tpu_torch.obs import goodput, sentry
from dmlc_tpu_torch.obs.metrics import NOOP, Registry
from dmlc_tpu_torch.obs.watchdog import Watchdog, make_watchdog

CEILINGS = {"peak_flops": 5.0e11, "hbm_gbps": 100.0, "h2d_mbps": 2000.0,
            "step_mbps": 800.0}


def _delta(parse=0.0, h2d=0.0, wait=0.0, consume=0.0, coll=0.0, snap=0.0,
           epoch=0.0, rows=0, h2d_bytes=0, io_bytes=0, steps=0,
           recompiles=0, coll_bytes=0):
    """One window's flat-registry delta under the runtime's metric names
    (seconds → ns histogram sums)."""
    d = {}
    for name, v in (("dmlc_feed_host_batch_ns", parse),
                    ("dmlc_feed_dispatch_ns", h2d),
                    ("dmlc_feed_host_wait_ns", wait),
                    ("dmlc_feed_consume_ns", consume),
                    ("dmlc_collective_op_ns", coll),
                    ("dmlc_snap_capture_ns", snap),
                    ("dmlc_fit_epoch_ns", epoch)):
        if v:
            d['%s{feed="f0"}:sum' % name] = v * 1e9
            d['%s{feed="f0"}:count' % name] = 3.0
    for name, v in (('dmlc_feed_rows_total{feed="f0"}', rows),
                    ('dmlc_feed_h2d_bytes_total{feed="f0"}', h2d_bytes),
                    ('dmlc_io_read_bytes_total{source="input_split"}',
                     io_bytes),
                    ('dmlc_fit_steps_total{model="linear"}', steps),
                    ('dmlc_xla_recompiles_total{fn="linear.step"}',
                     recompiles),
                    ('dmlc_collective_moved_bytes_total{op="allreduce"}',
                     coll_bytes)):
        if v:
            d[name] = float(v)
    return d


#: (delta, wall seconds, current snapshot) — parse-bound, step-bound,
#: idle, feed-less GBDT, a collective-heavy window, and one with step
#: cost gauges (mfu, hbm_fraction and the compute block)
WINDOWS = {
    "parse_bound": (_delta(parse=4.0, wait=3.0, consume=0.5, h2d=0.2,
                           rows=100000, h2d_bytes=4e8, steps=10), 8.0,
                    None),
    "step_bound": (_delta(parse=0.5, consume=6.0, h2d=0.1, rows=200000,
                          io_bytes=3e8, steps=40), 7.0, None),
    "idle": (_delta(parse=0.1, consume=0.1, rows=10), 5.0, None),
    "gbdt": (_delta(epoch=2.5, steps=20), 3.0, None),
    "collective": (_delta(consume=1.0, coll=2.5, coll_bytes=5e9,
                          snap=0.3, steps=8, rows=8000), 4.0,
                   {'dmlc_job_straggler_rank': 1.0}),
    "xla_costs": (_delta(consume=2.0, h2d=0.5, rows=50000, h2d_bytes=2e8,
                         steps=16), 3.0,
                  {'dmlc_xla_flops{fn="linear.step"}': 1.5e9,
                   'dmlc_xla_bytes_accessed{fn="linear.step"}': 3.0e8,
                   'dmlc_xla_flops{fn="gbdt.grad"}': 9.0e12}),
}


@pytest.mark.parametrize("name", sorted(WINDOWS))
def test_attribute_equals_the_reference(name):
    delta, wall, current = WINDOWS[name]
    got = goodput.attribute(dict(delta), wall, CEILINGS, current=current)
    want = ref_goodput.attribute(dict(delta), wall, CEILINGS,
                                 current=current)
    assert got == want
    assert got["binding"] in goodput.STAGES
    assert goodput.format_attribution(got, label=name) == \
        ref_goodput.format_attribution(want, label=name)


def test_attribute_names_each_binding():
    verdicts = {name: goodput.attribute(d, w, CEILINGS, current=c)["binding"]
                for name, (d, w, c) in WINDOWS.items()}
    assert verdicts["parse_bound"] == "parse"
    assert verdicts["step_bound"] == "device_step"
    assert verdicts["idle"] == "idle"
    assert verdicts["gbdt"] == "device_step"
    assert verdicts["collective"] == "collective"
    xla = goodput.attribute(*WINDOWS["xla_costs"][:2], CEILINGS,
                            current=WINDOWS["xla_costs"][2])
    assert 0 < xla["mfu"] <= 1 and 0 < xla["hbm_fraction"] <= 1


@pytest.mark.parametrize("names", [("parse_bound", "step_bound"),
                                   ("collective", "idle", "gbdt"),
                                   ("xla_costs",)])
def test_rolled_equals_the_reference(names, monkeypatch):
    # rolled() takes the ceilings from the settings: pin the peaks, or
    # each package would probe its own device
    monkeypatch.setenv("DMLC_TPU_PEAK_FLOPS", "5e11")
    monkeypatch.setenv("DMLC_TPU_PEAK_HBM_GBPS", "100")
    atts = [goodput.attribute(dict(WINDOWS[n][0]), WINDOWS[n][1], CEILINGS,
                              current=WINDOWS[n][2]) for n in names]
    got = goodput.rolled(atts)
    want = ref_goodput.rolled(atts)
    assert got == want
    assert goodput.format_attribution(got, "job") == \
        ref_goodput.format_attribution(want, "job")


def test_flat_delta_and_stage_seconds_equal_the_reference():
    cur = _delta(parse=3.0, consume=2.0, rows=10)
    prev = _delta(parse=1.0, consume=2.5, rows=4)
    got = goodput.flat_delta(cur, prev)
    assert got == ref_goodput.flat_delta(cur, prev)
    assert goodput.stage_seconds(got) == ref_goodput.stage_seconds(got)
    assert goodput.progress_counters(got) == \
        ref_goodput.progress_counters(got)


def _win(rows_s=1000.0, mbps=0.0, steps=5, recompiles=0, straggler=-1,
         window_s=1.0, nonfinite=0, binding="device_step"):
    return {
        "window_s": window_s,
        "goodput": {"rows_s": rows_s, "mbps": mbps, "ratio": 0.5},
        "counters": {"steps": float(steps), "batches": float(steps),
                     "bytes": 0.0, "recompiles": float(recompiles)},
        "straggler_rank": straggler,
        "binding": binding,
        "nonfinite": nonfinite,
    }


#: window sequences that exercise every alert kind, its single firing per
#: excursion and its re-arm
SEQUENCES = {
    "collapse": [_win(rows_s=v) for v in (1000, 1005, 995, 10, 10, 10,
                                          1000, 10)],
    "mbps": [_win(rows_s=0, mbps=v) for v in (500, 500, 5, 500, 5)],
    "storm_straggler": [_win(recompiles=5, straggler=2),
                        _win(recompiles=5, straggler=2), _win(),
                        _win(recompiles=5, straggler=2)],
    "stall": [_win(steps=0, window_s=30.0), _win(steps=0, window_s=30.0),
              _win(steps=0, window_s=30.0), _win(steps=3),
              _win(steps=0, window_s=60.0)],
    "numeric": [_win(nonfinite=2), _win(nonfinite=1), _win(),
                _win(nonfinite=4)],
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_watchdog_fires_the_reference_alerts(name):
    port = Watchdog(reg=Registry(), stall_s=50.0)
    ref = RefWatchdog(reg=RefRegistry(), stall_s=50.0)
    for win in SEQUENCES[name]:
        assert port.observe(dict(win)) == ref.observe(dict(win))
    assert port.alerts == ref.alerts
    assert port.alerts  # every sequence fires something
    kinds = [a["kind"] for a in port.alerts]
    assert kinds.count(kinds[0]) >= 2  # re-armed after clearing


def _sentry_cases():
    base = {"m_mbps": [100.0, 400.0, 410.0, 420.0, 430.0]}
    return {
        "window": ({"m_mbps": 370.0}, base),
        "within": ({"m_mbps": 380.0}, base),
        "stall_up": ({"stall.host_wait_s": 1.0},
                     {"stall.host_wait_s": [0.5, 0.5, 0.5]}),
        "stall_down": ({"stall.host_wait_s": 0.01},
                       {"stall.host_wait_s": [0.5, 0.5, 0.5]}),
        "thin": ({"new_mbps": 1.0}, {"new_mbps": [500.0]}),
        "ranked": ({"a_mbps": 80.0, "b_mbps": 10.0},
                   {"a_mbps": [100.0] * 3, "b_mbps": [100.0] * 3}),
        "compiles": ({"compiles.linear.step": 3.0},
                     {"compiles.linear.step": [1.0, 1.0, 1.0]}),
    }


@pytest.mark.parametrize("name", sorted(_sentry_cases()))
def test_sentry_gate_equals_the_reference(name):
    fresh, series = _sentry_cases()[name]
    got = sentry.gate(fresh, series)
    assert got == ref_sentry.gate(fresh, series)
    if name in ("window", "stall_up", "ranked", "compiles"):
        assert got
    else:
        assert not got


def test_sentry_records_and_canned_history_equal_the_reference():
    hist = sentry.SMOKE_HISTORY
    assert hist == ref_sentry.SMOKE_HISTORY
    fresh = sentry.smoke_degraded()
    assert fresh == ref_sentry.smoke_degraded()
    series = sentry.metric_series(hist)
    assert series == ref_sentry.metric_series(ref_sentry.SMOKE_HISTORY)
    vals = sentry.record_values(fresh)
    assert vals == ref_sentry.record_values(fresh)
    regs = sentry.gate(vals, series)
    assert regs == ref_sentry.gate(vals, series)
    assert {r["metric"] for r in regs} == {"higgs_libsvm_ingest",
                                           "stall.host_wait_s"}
    assert sentry.format_report(regs, "x") == \
        ref_sentry.format_report(regs, "x")
    # the newest canned record passes against the rest
    assert sentry.gate(sentry.record_values(hist[-1]),
                       sentry.metric_series(hist[:-1])) == []


def test_ledger_window_and_gauge():
    reg = Registry()
    led = goodput.GoodputLedger(reg, ceilings=CEILINGS)
    reg.histogram("dmlc_feed_consume_ns", feed="f").observe(2e6)
    reg.counter("dmlc_feed_rows_total", feed="f").inc(64)
    led.note_step(3)
    win = led.tick(wall_ns=10_000_000)
    assert win["counters"]["steps"] == 3.0
    assert win["binding"] == "idle" and win["window_s"] == 0.01
    assert reg.gauge("dmlc_goodput_ratio_value").value == \
        win["goodput"]["ratio"] == 0.2
    assert list(led.windows) == [win]


class TestMetricsDisabled:
    def test_factories_collapse_to_shared_noop(self, monkeypatch):
        monkeypatch.setenv("DMLC_TPU_METRICS", "0")
        led = goodput.ledger()
        wd = make_watchdog()
        assert led is NOOP and wd is NOOP
        led.note_step()
        assert led.tick() is None
        assert led.windows == () and wd.alerts == ()

    def test_disabled_hot_path_allocation_free(self, monkeypatch):
        monkeypatch.setenv("DMLC_TPU_METRICS", "0")
        led = goodput.ledger()
        wd = make_watchdog()

        def burst(n=2000):
            for _ in range(n):
                led.note_step()
                wd.observe(None)

        burst()
        deltas = []
        for _ in range(5):
            gc.collect()
            before = sys.getallocatedblocks()
            burst()
            gc.collect()
            deltas.append(sys.getallocatedblocks() - before)
        assert min(deltas) <= 0

    def test_fit_loop_obs_runs_disabled(self, monkeypatch):
        monkeypatch.setenv("DMLC_TPU_METRICS", "0")
        from dmlc_tpu_torch.models.fitloop import FitLoopObs

        fl = FitLoopObs("t")
        fl.note_step()
        fl.sample_latency({})
        assert fl.end_epoch(0, 1, time.monotonic_ns(), 0.5) is None
