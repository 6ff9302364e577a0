"""Policy-driven retry and backoff, the port of
``dmlc_tpu/resilience/retry.py``: one copy of "try again" for the remote
filesystems' reads and writes, the tracker dials and the recovery loop.

- **Classification first.** :func:`classify_transient` splits transient
  errors (HTTP 5xx/429/408, ``URLError``, ``OSError``,
  ``HTTPException``, ``DMLCError``) from fatal ones (other 4xx, and
  :data:`CONFIG_ERRORS`, filesystem-shaped configuration mistakes such
  as ``FileNotFoundError``). A fatal error re-raises at once and spends
  nothing.
- **Decorrelated jitter:** ``sleep = min(cap, uniform(base, prev * 3))``,
  so retries of many threads and hosts do not run in lockstep.
- **Per-call deadline** (``deadline_s``; by default the job's
  ``DMLC_TPU_RETRY_DEADLINE_S``, 0 = none): a wall-clock bound on one
  logical operation, sleeps included.
- **Process-wide retry budget** (:func:`global_budget`, a
  :class:`RetryBudget` token bucket of ``DMLC_TPU_RETRY_BUDGET`` tokens,
  0 = unlimited, the default): every policy draws from it unless given
  its own, so a systemic outage costs O(budget) retries, not O(call
  sites × attempts).

:meth:`RetryPolicy.call` (and :func:`retry_call`) wraps a closure;
:meth:`RetryPolicy.start` hands a loop that keeps its own structure (the
remote range reads of ``io/filesystem.py``) a :class:`RetryState` whose
``failed(err, progressed)`` classifies, counts, sleeps or raises;
:func:`backoff_sleep` is the jittered sleep of loops that retry outside
both shapes (``collective.run_with_recovery``). Retries and give-ups are
counted per site as ``dmlc_retry_attempts_total{site=}`` and
``dmlc_retry_giveups_total{site=}`` in the obs registry, and in
:func:`stats`.
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
    ``capacity`` per ``refill_s`` seconds; ``capacity <= 0`` is
    unlimited."""

    def __init__(self, capacity: int = 0, refill_s: float = 60.0):
        self.capacity = int(capacity)
        self._refill_s = float(refill_s)
        self._tokens = float(self.capacity)
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def take(self) -> bool:
        """Consume one retry token; False when the budget is spent."""
        if self.capacity <= 0:
            return True
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


_GLOBAL_BUDGET: Optional[RetryBudget] = None
_GLOBAL_LOCK = threading.Lock()


def global_budget() -> RetryBudget:
    """The process-wide budget, ``DMLC_TPU_RETRY_BUDGET`` tokens (read at
    first use; 0, the default, is unlimited)."""
    global _GLOBAL_BUDGET
    with _GLOBAL_LOCK:
        if _GLOBAL_BUDGET is None:
            from dmlc_tpu_torch.params.env import get_env

            _GLOBAL_BUDGET = RetryBudget(
                max(0, get_env("DMLC_TPU_RETRY_BUDGET", 0)))
        return _GLOBAL_BUDGET


def reset_global_budget() -> None:
    """Read ``DMLC_TPU_RETRY_BUDGET`` again at the next use (tests, a
    fresh process state)."""
    global _GLOBAL_BUDGET
    with _GLOBAL_LOCK:
        _GLOBAL_BUDGET = None


def _env_deadline_s() -> float:
    from dmlc_tpu_torch.params.env import get_env

    return max(0.0, float(get_env("DMLC_TPU_RETRY_DEADLINE_S", 0.0)))


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
    """One logical operation's retry bookkeeping (see
    :meth:`RetryPolicy.start`): the owner loop calls :meth:`failed` on
    each error, which either sleeps (a retry granted) or raises.

    ``progressed=True`` refills the attempt count: a long transfer over a
    flaky link that keeps delivering bytes must not run out of attempts
    while it advances. An absolute ceiling of ten times ``max_attempts``
    still bounds a server that drips a byte a connection."""

    def __init__(self, policy: "RetryPolicy", site: str, display: str,
                 cancelled: Optional[Callable[[], bool]] = None):
        self._policy = policy
        self.site = site
        self.display = display or site
        self._cancelled = cancelled
        self.attempts_left = policy.max_attempts
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

    def failed(self, err: BaseException, progressed: bool = False) -> None:
        """Record one failed attempt: re-raise a fatal error, give up when
        cancelled or out of attempts, deadline or budget, else sleep with
        jitter."""
        policy = self._policy
        if not policy.classify(err):
            raise err
        if self._cancelled is not None and self._cancelled():
            raise DMLCError(f"{self.display}: cancelled") from err
        if progressed:
            self.attempts_left = policy.max_attempts
        self.attempts_left -= 1
        self.total_attempts += 1
        if self.attempts_left <= 0:
            self._give_up(err, "attempts exhausted")
        if self.total_attempts >= policy.max_attempts * 10:
            self._give_up(err, "absolute attempt ceiling")
        if not policy.budget.take():
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
    included (None: ``DMLC_TPU_RETRY_DEADLINE_S``; 0 = none). ``budget``
    is the :class:`RetryBudget` the policy draws a token from for each
    retry (None: :func:`global_budget`). ``classify``, ``rng``, ``sleep``
    and ``clock`` can be replaced (tests)."""

    def __init__(self, max_attempts: int = 3, base_s: float = 0.1,
                 cap_s: float = 2.0, deadline_s: Optional[float] = None,
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
        if deadline_s is None:
            deadline_s = _env_deadline_s()
        self.deadline_s = max(0.0, float(deadline_s))
        self.budget = budget if budget is not None else global_budget()
        self.classify = classify
        self._rng = rng or random
        self.sleep = sleep
        self.clock = clock

    def next_sleep(self, prev: float) -> float:
        """Decorrelated jitter: uniform over [base, prev * 3], capped."""
        return min(self.cap_s, self._rng.uniform(self.base_s, prev * 3))

    def start(self, site: str, display: str = "",
              cancelled: Optional[Callable[[], bool]] = None) -> RetryState:
        """A fresh :class:`RetryState` for a caller-owned loop."""
        return RetryState(self, site, display, cancelled)

    def call(self, fn: Callable, site: str, display: str = "",
             cancelled: Optional[Callable[[], bool]] = None):
        """Run ``fn()`` under this policy; no sleep after the last
        failed attempt."""
        state = self.start(site, display=display, cancelled=cancelled)
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
