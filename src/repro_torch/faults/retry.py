"""Bounded retry with deterministic backoff and a timeout budget.

The port's own copy of ``repro.faults.retry`` (stdlib only; the port
imports nothing of the reference). Hand-rolled ``while: try/except +
sleep`` loops hide unbounded attempts and untestable pacing;
:func:`with_retry` makes attempts, backoff, the total time budget, and the
clock/sleep functions explicit and injectable, so fault tests can drive it
with fake time. It wraps checkpoint I/O.
"""
from __future__ import annotations

import time
from typing import Callable, Optional, Tuple, Type

__all__ = ["RetryError", "with_retry"]


class RetryError(RuntimeError):
    """All attempts failed (or the time budget ran out). The final
    underlying exception is chained (``__cause__``) and kept on
    ``last_exception``."""

    def __init__(self, message: str, last_exception: BaseException):
        super().__init__(message)
        self.last_exception = last_exception


def with_retry(fn: Callable[[], object], *, attempts: int = 3,
               base_delay: float = 0.02, backoff: float = 2.0,
               max_delay: float = 1.0, timeout: Optional[float] = None,
               retry_on: Tuple[Type[BaseException], ...] = (OSError,),
               raise_last: bool = False, describe: str = "",
               sleep: Callable[[float], None] = time.sleep,
               clock: Callable[[], float] = time.monotonic):
    """Call ``fn()`` with at most ``attempts`` tries.

    Only exceptions in ``retry_on`` are retried; anything else propagates
    immediately (a corrupt checkpoint must not be re-read three times).
    Between tries sleeps ``min(base_delay * backoff**k, max_delay)`` —
    deterministic, no jitter, so fault tests can pin the exact schedule.
    ``timeout`` bounds the total budget: no retry starts if the next sleep
    would overrun it. On exhaustion raises :class:`RetryError`, or the
    last underlying exception unchanged with ``raise_last=True`` (used by
    checkpoint I/O so callers keep seeing ``FileNotFoundError`` etc.).
    ``sleep``/``clock`` are injectable for tests.
    """
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    start = clock()
    last: Optional[BaseException] = None
    for attempt in range(attempts):
        try:
            return fn()
        except retry_on as exc:
            last = exc
            if attempt == attempts - 1:
                break
            delay = min(base_delay * (backoff ** attempt), max_delay)
            if timeout is not None and (clock() - start) + delay > timeout:
                break
            sleep(delay)
    if raise_last:
        raise last
    name = describe or getattr(fn, "__name__", "operation")
    raise RetryError(
        f"{name} failed after {attempt + 1} attempt(s): {last!r}",
        last) from last
