"""The port's utility layer (``dmlc_tpu_torch.utils``): the logging and
check layer, the managed threads of ``utils/thread_group.py`` and the
helpers of ``utils/common.py``, with the cases of the JAX package's
``tests/test_utils.py`` and ``tests/test_thread_group.py`` run on the port,
and the port held against ``dmlc_tpu.utils`` on the same inputs."""

import threading
import time

import numpy as np
import pytest

from dmlc_tpu_torch.utils import (
    BlockingQueueThread,
    ManualEvent,
    ThreadGroup,
    TimerThread,
    DMLCError,
    check,
    check_eq,
    check_lt,
    check_notnull,
    get_time,
    hash_combine,
    split_string,
    Timer,
)
from dmlc_tpu_torch.utils.logging import log_fatal, set_log_sink


def test_check_passes():
    check(True)
    check_eq(1, 1)
    check_lt(1, 2)
    assert check_notnull("x") == "x"


def test_check_raises():
    with pytest.raises(DMLCError):
        check(False, "boom %d", 42)
    with pytest.raises(DMLCError, match="=="):
        check_eq(1, 2)
    with pytest.raises(DMLCError):
        check_notnull(None)


def test_log_fatal_raises():
    with pytest.raises(DMLCError, match="fatal thing"):
        log_fatal("fatal thing")


def test_custom_sink():
    seen = []
    set_log_sink(lambda sev, msg: seen.append((sev, msg)))
    try:
        from dmlc_tpu_torch.utils import log_info

        log_info("hello %s", "world")
    finally:
        set_log_sink(None)
    assert seen == [("INFO", "hello world")]


def test_split_string():
    assert split_string("a;b;;c", ";") == ["a", "b", "c"]
    assert split_string("", ";") == []


def test_hash_combine_deterministic():
    a = hash_combine(0, 123)
    assert a == hash_combine(0, 123)
    assert a != hash_combine(1, 123)
    assert 0 <= a < (1 << 64)


def test_timer():
    t = Timer()
    with t:
        pass
    assert t.elapsed >= 0
    assert get_time() > 0

class TestManualEvent:
    def test_set_wakes_all_and_stays_signaled(self):
        ev = ManualEvent()
        results = []

        def waiter():
            ev.wait()
            results.append(1)

        threads = [threading.Thread(target=waiter) for _ in range(4)]
        for t in threads:
            t.start()
        ev.set()
        for t in threads:
            t.join(5)
        assert results == [1, 1, 1, 1]
        assert ev.wait(0)  # still signaled
        ev.reset()
        assert not ev.wait(0)


class TestThreadGroup:
    def test_named_lifecycle_auto_remove(self):
        group = ThreadGroup()
        done = ManualEvent()
        t = group.create("worker", lambda th: done.wait())
        assert group.size() == 1
        assert group.get("worker") is t
        done.set()
        assert t.join(5)
        deadline = time.monotonic() + 5
        while group.size() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert group.size() == 0  # auto-removed

    def test_duplicate_name_rejected(self):
        group = ThreadGroup()
        gate = ManualEvent()
        group.create("x", lambda th: gate.wait())
        with pytest.raises(DMLCError):
            group.create("x", lambda th: None)
        gate.set()
        assert group.join_all(5)

    def test_join_all_requests_shutdown(self):
        group = ThreadGroup()
        observed = []

        def loop(th):
            while not th.wait_for_shutdown(0.01):
                pass
            observed.append(th.name)

        for i in range(3):
            group.create(f"w{i}", loop)
        assert group.join_all(5)
        assert sorted(observed) == ["w0", "w1", "w2"]


class TestBlockingQueueThread:
    def test_pumps_in_order_then_drains_on_shutdown(self):
        got = []
        pump = BlockingQueueThread("pump", got.append)
        for i in range(100):
            pump.enqueue(i)
        assert pump.shutdown(5)
        assert got == list(range(100))


    def test_group_shutdown_terminates_pump(self):
        group = ThreadGroup()
        pump = BlockingQueueThread("pump", lambda item: None, group=group)
        assert group.join_all(5)  # must not hang without a sentinel
        assert not pump._thread.is_alive()


class TestTimerThread:
    def test_fires_periodically_until_stopped(self):
        hits = []
        timer = TimerThread("tick", 0.01, lambda: hits.append(1))
        time.sleep(0.2)
        assert timer.stop(5)
        count = len(hits)
        assert count >= 3
        time.sleep(0.05)
        assert len(hits) == count  # no post-stop firings

    def test_bad_interval(self):
        with pytest.raises(DMLCError):
            TimerThread("bad", 0.0, lambda: None)


def test_helpers_equal_the_jax_packages():
    from dmlc_tpu.utils import common as ref

    rng = np.random.RandomState(1)
    for _ in range(200):
        seed, value = (int(v) for v in rng.randint(0, 2**63, 2,
                                                   dtype=np.int64))
        assert hash_combine(seed, value) == ref.hash_combine(seed, value)
    for text in ("a,b,,c", ",,", "", "one", "x,y,"):
        assert split_string(text, ",") == ref.split_string(text, ",")


@pytest.mark.parametrize("op,x,y", [
    ("check_eq", 1, 2), ("check_ne", 3, 3), ("check_lt", 2, 1),
    ("check_le", 2, 1), ("check_gt", 1, 2), ("check_ge", 1, 2)])
def test_check_messages_equal_the_jax_packages(op, x, y, monkeypatch):
    import dmlc_tpu.utils.logging as ref
    import dmlc_tpu_torch.utils.logging as port

    monkeypatch.setenv("DMLC_LOG_STACK_TRACE", "0")
    with pytest.raises(port.DMLCError) as got:
        getattr(port, op)(x, y, "why")
    with pytest.raises(ref.DMLCError) as want:
        getattr(ref, op)(x, y, "why")
    assert str(got.value) == str(want.value)


def test_log_sink_and_log_once_per():
    from dmlc_tpu_torch.utils import LogOncePer, log_debug, log_error

    lines = []
    set_log_sink(lambda sev, msg: lines.append((sev, msg)))
    try:
        log_debug("d %d", 1)
        log_error("e")
        once = LogOncePer(period=60.0)
        assert once("first %s", "x") and not once("second")
    finally:
        set_log_sink(None)
    assert lines == [("DEBUG", "d 1"), ("ERROR", "e"), ("INFO", "first x")]

