"""Budgeted, jittered exponential backoff for host I/O that can fail
(the JAX package's ``resilience/retry.py``): checkpoint writes retry on
``OSError``. The jitter stream is seeded by the policy, so a retried run
is reproducible. Retries and give-ups count on ``resilience.retry.attempt``
and ``resilience.retry.give_up`` (the run report's resilience summary)."""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Any, Callable

from cst_captioning_tpu_torch.obs import metrics as obs_metrics


@dataclass(frozen=True)
class RetryPolicy:
    """``max_attempts`` tries; sleeps grow ``base_delay * factor**i``,
    capped at ``max_delay``, each scaled by +-``jitter``; their sum never
    exceeds ``budget`` seconds."""

    max_attempts: int = 4
    base_delay: float = 0.05
    max_delay: float = 2.0
    factor: float = 2.0
    jitter: float = 0.5
    budget: float = 30.0
    retry_on: tuple = (OSError,)
    seed: int = 0

    def delays(self) -> list[float]:
        """The whole backoff schedule before the budget applies."""
        rng = random.Random(self.seed)
        out = []
        for i in range(self.max_attempts - 1):
            d = min(self.max_delay, self.base_delay * self.factor ** i)
            out.append(d * (1.0 + self.jitter * (2.0 * rng.random() - 1.0)))
        return out


def retry_call(fn: Callable[..., Any], *args: Any,
               policy: RetryPolicy = RetryPolicy(),
               on_retry: Callable[[dict], None] | None = None,
               sleep: Callable[[float], None] = time.sleep,
               **kwargs: Any) -> Any:
    """Call ``fn`` and retry ``policy.retry_on`` errors by the policy;
    anything else propagates at once. ``on_retry`` gets a dict per retry,
    ready for ``EventLogger.log(**info)``."""
    delays = policy.delays()
    slept = 0.0
    for attempt in range(policy.max_attempts):
        try:
            return fn(*args, **kwargs)
        except policy.retry_on as e:
            if attempt >= len(delays) \
                    or slept + delays[attempt] > policy.budget:
                obs_metrics.counter("resilience.retry.give_up").inc()
                raise
            delay = delays[attempt]
            obs_metrics.counter("resilience.retry.attempt").inc()
            if on_retry is not None:
                on_retry({"attempt": attempt + 1, "delay": round(delay, 4),
                          "error": type(e).__name__, "detail": str(e)})
            sleep(delay)
            slept += delay
    raise AssertionError("unreachable")  # pragma: no cover
