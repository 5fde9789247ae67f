"""Shared recovery policy: bounded retries, backoff, quarantine.

The port's copy of ``tpu_patterns/faults/retry.py``.

One :class:`RetryPolicy` shape serves every self-healing path —
checkpoint I/O, the serve engine's prefill, decode and verify launches
and its kv tier's copies, and the sweep's cell loop
(:func:`run_cell_attempts`, whose caller waits for ROADMAP.md Queue 1
step 10) — so "how many times, how long between, when to give up" is a
single tunable surface.

Classification rule (transient vs deterministic): a failure carries a
SIGNATURE (exception type+message, or a cell's exit code), and the SAME
signature on two consecutive attempts means the failure is
deterministic — retrying further only burns the budget, so the caller
QUARANTINES the work item instead (:class:`Quarantined`, or the
``quarantined`` flag from :func:`run_cell_attempts`).  A signature that
CHANGES between attempts still looks transient and keeps retrying up to
``max_attempts``.

Backoff is exponential with jitter; waits are computed from the policy
(never measured), and the jitter draw is seeded — from ``seed`` when
nonzero (reproducible chaos runs), else from ``timing.clock_ns`` so
concurrent retriers de-correlate instead of stampeding in lockstep.

Every retry/quarantine increments the obs metrics registry
(``tpu_patterns_faults_retries_total`` / ``..._quarantined_total``,
labeled by site), so a run that self-healed is visibly different from
a run that never faulted.
"""

from __future__ import annotations

import dataclasses
import os
import random
import time
from typing import Callable


class Quarantined(RuntimeError):
    """Deterministic failure: same signature twice — retries stopped."""

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


def _count_retry(site: str) -> None:
    from tpu_patterns_torch import obs

    obs.counter("tpu_patterns_faults_retries_total", site=site).inc()


def _count_quarantine(site: str) -> None:
    from tpu_patterns_torch import obs

    obs.counter("tpu_patterns_faults_quarantined_total", site=site).inc()


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
    immediately — a programming error is not a transient fault).  The
    same signature on consecutive attempts raises :class:`Quarantined`
    from the last failure; budget exhaustion re-raises the failure
    itself.
    """
    last_sig: str | None = None
    for attempt in range(1, max(1, policy.max_attempts) + 1):
        try:
            return fn()
        except retry_on as e:
            sig = f"{type(e).__name__}: {e}"
            if sig == last_sig:
                _count_quarantine(site)
                raise Quarantined(site, sig) from e
            last_sig = sig
            if attempt >= policy.max_attempts:
                raise
            _count_retry(site)
            sleep(policy.backoff_s(attempt))


def run_cell_attempts(
    run_attempt: Callable[[int], tuple[int, bool]],
    *,
    policy: RetryPolicy,
    cell: str,
    site: str = "cell.run",
    sleep: Callable[[float], None] = time.sleep,
    should_stop: Callable[[], bool] | None = None,
    progress: Callable[[str], None] | None = None,
) -> tuple[int, bool, int, bool]:
    """Retry loop for sweep cells, where failure is an (rc, completed)
    pair, not an exception.  Returns ``(rc, completed, attempts,
    quarantined)``.

    A COMPLETED cell — it reached a verdict, even an honest FAILURE one
    — is never retried: re-measuring a result would defeat both the
    checkpoint and the measurement.  Only timeouts/crashes (completed
    False) retry; the signature is the exit code, so two crashes with
    the same rc quarantine the cell.
    """
    rc, attempt = 1, 0
    last_sig: int | None = None
    for attempt in range(1, max(1, policy.max_attempts) + 1):
        rc, completed = run_attempt(attempt)
        if completed:
            return rc, True, attempt, False
        if rc == last_sig:
            _count_quarantine(site)
            if progress is not None:
                progress(
                    f"{cell}: crash signature rc={rc} repeated — "
                    "quarantined (deterministic failure)"
                )
            return rc, False, attempt, True
        last_sig = rc
        if attempt >= policy.max_attempts or (
            should_stop is not None and should_stop()
        ):
            break
        _count_retry(site)
        if progress is not None:
            progress(
                f"{cell}: attempt {attempt} did not complete (rc={rc}) "
                f"— retrying ({attempt + 1}/{policy.max_attempts})"
            )
        sleep(policy.backoff_s(attempt))
    return rc, False, attempt, False


def _env_attempts(var: str, default: int) -> int:
    try:
        return max(1, int(os.environ.get(var, default)))
    except ValueError:
        return default


def cell_retry_policy() -> RetryPolicy:
    """Sweep-cell policy: ``TPU_PATTERNS_CELL_ATTEMPTS`` total attempts
    (default 2 — one retry absorbs a transient crash/timeout)."""
    return RetryPolicy(
        max_attempts=_env_attempts("TPU_PATTERNS_CELL_ATTEMPTS", 2),
        backoff_base_s=0.1,
    )


def serve_retry_policy() -> RetryPolicy:
    """Serve launch policy: ``TPU_PATTERNS_SERVE_ATTEMPTS`` total
    attempts (default 2), tiny backoff — a transient dispatch failure
    either clears immediately or is deterministic, and the active batch
    is stalled while we wait."""
    return RetryPolicy(
        max_attempts=_env_attempts("TPU_PATTERNS_SERVE_ATTEMPTS", 2),
        backoff_base_s=0.01,
        backoff_max_s=0.2,
    )


def ckpt_retry_policy() -> RetryPolicy:
    """Checkpoint-I/O policy: ``TPU_PATTERNS_CKPT_ATTEMPTS`` total
    attempts (default 2), short backoff — a shared-filesystem blip is
    either gone in milliseconds or not a blip."""
    return RetryPolicy(
        max_attempts=_env_attempts("TPU_PATTERNS_CKPT_ATTEMPTS", 2),
        backoff_base_s=0.02,
        backoff_max_s=0.5,
    )
