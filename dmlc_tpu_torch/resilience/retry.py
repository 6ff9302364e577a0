"""Policy-driven retry and backoff, the port of
``dmlc_tpu/resilience/retry.py``: one copy of "try again" for the
tracker dials and the recovery loop.

- **Classification first.** :func:`classify_transient` splits transient
  errors (HTTP 5xx/429/408, ``URLError``, ``OSError``,
  ``HTTPException``, ``DMLCError``) from fatal ones (other 4xx, and
  :data:`CONFIG_ERRORS`, filesystem-shaped configuration mistakes such
  as ``FileNotFoundError``). A fatal error re-raises at once and spends
  nothing.
- **Decorrelated jitter:** ``sleep = min(cap, uniform(base, prev * 3))``,
  so retries of many threads and hosts do not run in lockstep.
- **Per-call deadline** (``deadline_s``, 0 = none): a wall-clock bound on
  one logical operation, sleeps included.
- **Retry budget** (``budget``, a :class:`RetryBudget` token bucket; none
  = unlimited): one bucket shared by several policies bounds what a
  systemic outage costs them together.

:meth:`RetryPolicy.call` (and :func:`retry_call`) wraps a closure;
:func:`backoff_sleep` is the jittered sleep of loops that retry outside
that shape (``collective.run_with_recovery``). Retries and give-ups are
counted per site in :func:`stats` (the reference keeps them as obs
metrics).
"""

from __future__ import annotations

import http.client
import random
import threading
import time
import urllib.error
from typing import Callable, Dict, Optional

from dmlc_tpu_torch.utils.logging import DMLCError, check

#: configuration mistakes dressed as OSError: retrying cannot fix a missing
#: file or a permission wall, and a bad checkpoint URI is not a peer
#: failure (``collective.run_with_recovery`` raises them at once too)
CONFIG_ERRORS = (
    FileNotFoundError,
    PermissionError,
    IsADirectoryError,
    NotADirectoryError,
    FileExistsError,
)

#: HTTP statuses below 500 that are still transient: request timeout and
#: throttling
TRANSIENT_HTTP_CODES = frozenset({408, 429})


def classify_transient(err: BaseException) -> bool:
    """True when retrying ``err`` can plausibly succeed."""
    if isinstance(err, CONFIG_ERRORS):
        return False
    if isinstance(err, urllib.error.HTTPError):
        return err.code >= 500 or err.code in TRANSIENT_HTTP_CODES
    return isinstance(err, (urllib.error.URLError, OSError,
                            http.client.HTTPException, DMLCError))


class RetryBudget:
    """Token bucket bounding retries: ``capacity`` tokens refilled at
    ``capacity`` per ``refill_s`` seconds."""

    def __init__(self, capacity: int, refill_s: float = 60.0):
        check(capacity >= 1, "a retry budget needs capacity >= 1, got %d",
              capacity)
        self.capacity = int(capacity)
        self._refill_s = float(refill_s)
        self._tokens = float(self.capacity)
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def take(self) -> bool:
        """Consume one retry token; False when the budget is spent."""
        now = time.monotonic()
        with self._lock:
            rate = self.capacity / self._refill_s
            self._tokens = min(float(self.capacity),
                               self._tokens + (now - self._last) * rate)
            self._last = now
            if self._tokens < 1.0:
                return False
            self._tokens -= 1.0
            return True


_stats_lock = threading.Lock()
_attempts: Dict[str, int] = {}
_giveups: Dict[str, int] = {}


def _count(table: Dict[str, int], site: str) -> None:
    with _stats_lock:
        table[site] = table.get(site, 0) + 1
    # the registry mirror (the reference's names); deferred: resilience
    # is below obs's dependencies
    from dmlc_tpu_torch import obs

    if table is _attempts:
        obs.registry().counter(
            "dmlc_retry_attempts_total", "retries performed, by call site",
            site=site).inc()
    else:
        obs.registry().counter(
            "dmlc_retry_giveups_total",
            "operations abandoned after exhausting retries",
            site=site).inc()


def stats() -> Dict[str, Dict[str, int]]:
    """Retries (``attempts``) and give-ups (``giveups``) by call site since
    the last :func:`reset_stats`."""
    with _stats_lock:
        return {"attempts": dict(_attempts), "giveups": dict(_giveups)}


def reset_stats() -> None:
    """Forget the counts of :func:`stats`."""
    with _stats_lock:
        _attempts.clear()
        _giveups.clear()


class RetryState:
    """One logical operation's retry bookkeeping inside
    :meth:`RetryPolicy.call`: :meth:`failed` either sleeps (a retry
    granted) or raises."""

    def __init__(self, policy: "RetryPolicy", site: str, display: str):
        self._policy = policy
        self.site = site
        self.display = display or site
        self.total_attempts = 0
        self._deadline = (policy.clock() + policy.deadline_s
                          if policy.deadline_s else None)
        self._prev_sleep = policy.base_s

    def _give_up(self, err: BaseException, why: str):
        _count(_giveups, self.site)
        # flight-recorder tail: the give-up is the moment whose preceding
        # seconds a post-mortem wants; an injected fault also dumps
        from dmlc_tpu_torch.obs import flight

        flight.record_event("retry.giveup", site=self.site, why=why,
                            error=str(err))
        flight.dump_if_injected(err)
        raise DMLCError(f"{self.display}: gave up after "
                        f"{self.total_attempts} attempt(s) ({why}): "
                        f"{err}") from err

    def failed(self, err: BaseException) -> None:
        """Record one failed attempt: re-raise a fatal error, give up when
        out of attempts, deadline or budget, else sleep with jitter."""
        policy = self._policy
        if not policy.classify(err):
            raise err
        self.total_attempts += 1
        if self.total_attempts >= policy.max_attempts:
            self._give_up(err, "attempts exhausted")
        if policy.budget is not None and not policy.budget.take():
            self._give_up(err, "retry budget exhausted")
        delay = policy.next_sleep(self._prev_sleep)
        self._prev_sleep = delay
        if (self._deadline is not None
                and policy.clock() + delay > self._deadline):
            self._give_up(err, f"deadline {policy.deadline_s}s")
        _count(_attempts, self.site)
        policy.sleep(delay)


class RetryPolicy:
    """One retry discipline; cheap to build per call.

    ``max_attempts`` counts tries (1 = no retry). ``base_s``/``cap_s``
    bound the jittered sleep. ``deadline_s`` bounds one call, sleeps
    included (0 = none). ``budget`` (None = unlimited) is a
    :class:`RetryBudget` the policy draws a token from for each retry.
    ``classify``, ``rng``, ``sleep`` and ``clock`` can be replaced
    (tests)."""

    def __init__(self, max_attempts: int = 3, base_s: float = 0.1,
                 cap_s: float = 2.0, deadline_s: float = 0.0,
                 budget: Optional[RetryBudget] = None,
                 classify: Callable[[BaseException], bool] =
                 classify_transient,
                 rng: Optional[random.Random] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 clock: Callable[[], float] = time.monotonic):
        check(max_attempts >= 1, "max_attempts must be >= 1, got %d",
              max_attempts)
        self.max_attempts = int(max_attempts)
        self.base_s = float(base_s)
        self.cap_s = max(float(cap_s), self.base_s)
        self.deadline_s = max(0.0, float(deadline_s))
        self.budget = budget
        self.classify = classify
        self._rng = rng or random
        self.sleep = sleep
        self.clock = clock

    def next_sleep(self, prev: float) -> float:
        """Decorrelated jitter: uniform over [base, prev * 3], capped."""
        return min(self.cap_s, self._rng.uniform(self.base_s, prev * 3))

    def call(self, fn: Callable, site: str, display: str = ""):
        """Run ``fn()`` under this policy; no sleep after the last
        failed attempt."""
        state = RetryState(self, site, display)
        while True:
            try:
                return fn()
            except Exception as err:  # noqa: BLE001 (classify decides)
                state.failed(err)


def retry_call(fn: Callable, site: str, display: str = "",
               max_attempts: int = 3, base_s: float = 0.1,
               cap_s: float = 2.0):
    """``RetryPolicy(max_attempts, base_s, cap_s).call(fn, site)``."""
    return RetryPolicy(max_attempts=max_attempts, base_s=base_s,
                       cap_s=cap_s).call(fn, site, display=display)


def backoff_sleep(attempt: int, site: str, base_s: float = 0.5,
                  cap_s: float = 5.0) -> None:
    """Jittered sleep for loops that retry outside the call/raise shape
    (the recover-rendezvous loop): counts a retry at ``site`` and sleeps
    uniform over [base, 3 · base · 2^(attempt-1)], capped."""
    _count(_attempts, site)
    prev = base_s * (2 ** max(0, attempt - 1))
    time.sleep(min(cap_s, random.uniform(base_s, max(base_s, prev * 3))))
