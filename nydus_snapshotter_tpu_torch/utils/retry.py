"""Exponential-backoff retry (reference pkg/utils/retry/retry.go semantics:
bounded attempts, growing delay, last error surfaced), with optional
full-jitter and a wall-clock deadline so retries compose with per-request
HTTP timeouts instead of multiplying them.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional, Type, TypeVar

T = TypeVar("T")


class RetryError(Exception):
    def __init__(self, attempts: int, last: BaseException, deadline_exceeded: bool = False):
        why = " (deadline exceeded)" if deadline_exceeded else ""
        super().__init__(f"all {attempts} attempts failed{why}: {last}")
        self.attempts = attempts
        self.last = last
        self.deadline_exceeded = deadline_exceeded


def do(
    fn: Callable[[], T],
    attempts: int = 3,
    delay: float = 0.1,
    backoff: float = 2.0,
    max_delay: float = 5.0,
    retry_on: tuple[Type[BaseException], ...] = (Exception,),
    sleep: Callable[[float], None] = time.sleep,
    jitter: bool = False,
    deadline: Optional[float] = None,
    clock: Callable[[], float] = time.monotonic,
    rng: Callable[[], float] = random.random,
) -> T:
    """Run fn with retries; raises RetryError wrapping the final failure.

    ``jitter`` applies full jitter — each pause is uniform in
    [0, computed delay] — so synchronized retry storms decorrelate.
    ``deadline`` is a wall-clock budget in seconds from the first attempt:
    no retry is started if its pause would overrun the budget (the retry
    loop then surfaces RetryError with ``deadline_exceeded`` set).
    Defaults leave both off, preserving historical behavior.
    """
    if attempts < 1:
        raise ValueError("attempts must be >= 1")
    start = clock()
    cur = delay
    last: BaseException | None = None
    for i in range(attempts):
        try:
            return fn()
        except retry_on as e:  # noqa: PERF203
            last = e
            if i + 1 < attempts:
                pause = min(cur, max_delay)
                if jitter:
                    pause *= rng()
                if deadline is not None and (clock() - start) + pause >= deadline:
                    raise RetryError(i + 1, last, deadline_exceeded=True)
                sleep(pause)
                cur *= backoff
    raise RetryError(attempts, last)  # type: ignore[arg-type]


def do_with_deadline(
    fn: Callable[[], T],
    deadline: float,
    attempts: int = 3,
    delay: float = 0.1,
    backoff: float = 2.0,
    max_delay: float = 5.0,
    retry_on: tuple[Type[BaseException], ...] = (Exception,),
    sleep: Callable[[float], None] = time.sleep,
    clock: Callable[[], float] = time.monotonic,
    rng: Callable[[], float] = random.random,
) -> T:
    """Deadline- and jitter-aware retry: the call-site default for
    transport and daemon-client retries (retries must fit inside the
    request timeout, not stack on top of it)."""
    return do(
        fn,
        attempts=attempts,
        delay=delay,
        backoff=backoff,
        max_delay=max_delay,
        retry_on=retry_on,
        sleep=sleep,
        jitter=True,
        deadline=deadline,
        clock=clock,
        rng=rng,
    )
