"""Shared recovery policy: bounded retries, backoff, quarantine.

Counterpart of ``tpu_patterns/faults/retry.py`` for the checkpoint I/O
and the serve engine's kv tier of this package.  A failure carries a
SIGNATURE (exception type and message), and the SAME signature on two
consecutive attempts means the failure is deterministic: the caller
quarantines the work instead of burning the budget
(:class:`Quarantined`).  A signature that changes between attempts still
looks transient and keeps retrying up to ``max_attempts``.

Backoff is exponential with jitter; the jitter draw is seeded from
``seed`` when nonzero (reproducible chaos runs), else from the native
clock, so concurrent retriers de-correlate.  The JAX package also
counts retries and quarantines in its ``obs`` registry, which is not
ported.
"""

from __future__ import annotations

import dataclasses
import os
import random
import time
from typing import Callable


class Quarantined(RuntimeError):
    """Deterministic failure: same signature twice -- retries stopped."""

    def __init__(self, site: str, signature: str):
        super().__init__(
            f"{site}: failure signature repeated ({signature}) — "
            "deterministic, quarantined without burning the retry budget"
        )
        self.site = site
        self.signature = signature


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded-retry shape: ``max_attempts`` TOTAL tries (1 = no retry),
    exponential backoff (base * mult^(attempt-1), capped) with
    ``jitter_frac`` proportional jitter."""

    max_attempts: int = 2
    backoff_base_s: float = 0.05
    backoff_mult: float = 2.0
    backoff_max_s: float = 5.0
    jitter_frac: float = 0.25
    seed: int = 0

    def backoff_s(self, attempt: int) -> float:
        """Wait after failed attempt ``attempt`` (1-based)."""
        raw = min(
            self.backoff_base_s * self.backoff_mult ** (attempt - 1),
            self.backoff_max_s,
        )
        if self.jitter_frac <= 0:
            return raw
        if self.seed:
            entropy = f"{self.seed}:{attempt}"
        else:
            from tpu_patterns_torch.core.timing import clock_ns

            entropy = clock_ns()
        u = random.Random(entropy).random()  # [0, 1)
        return max(0.0, raw * (1.0 + self.jitter_frac * (2.0 * u - 1.0)))


def call_with_retry(
    fn: Callable,
    *,
    policy: RetryPolicy,
    site: str,
    retry_on: tuple = (OSError,),
    sleep: Callable[[float], None] = time.sleep,
):
    """Call ``fn()`` under ``policy``; returns its result.

    Only ``retry_on`` exceptions are retried (anything else propagates
    immediately).  The same signature on consecutive attempts raises
    :class:`Quarantined` from the last failure; budget exhaustion
    re-raises the failure itself.
    """
    last_sig: str | None = None
    for attempt in range(1, max(1, policy.max_attempts) + 1):
        try:
            return fn()
        except retry_on as e:
            sig = f"{type(e).__name__}: {e}"
            if sig == last_sig:
                raise Quarantined(site, sig) from e
            last_sig = sig
            if attempt >= policy.max_attempts:
                raise
            sleep(policy.backoff_s(attempt))


def _env_attempts(var: str, default: int) -> int:
    try:
        return max(1, int(os.environ.get(var, default)))
    except ValueError:
        return default


def serve_retry_policy() -> RetryPolicy:
    """Serve policy (the kv tier's copies): ``TPU_PATTERNS_SERVE_ATTEMPTS``
    total attempts (default 2), tiny backoff -- a transient failure
    clears at once or is deterministic, and the scheduler waits."""
    return RetryPolicy(
        max_attempts=_env_attempts("TPU_PATTERNS_SERVE_ATTEMPTS", 2),
        backoff_base_s=0.01,
        backoff_max_s=0.2,
    )


def ckpt_retry_policy() -> RetryPolicy:
    """Checkpoint-I/O policy: ``TPU_PATTERNS_CKPT_ATTEMPTS`` total
    attempts (default 2), short backoff -- a filesystem blip is either
    gone in milliseconds or not a blip."""
    return RetryPolicy(
        max_attempts=_env_attempts("TPU_PATTERNS_CKPT_ATTEMPTS", 2),
        backoff_base_s=0.02,
        backoff_max_s=0.5,
    )
