"""Probe retry scheduling: the port's own copy of ``tpufd/sched.py``'s
``backoff_with_jitter`` and ``ProbeScheduler``.

The rule is the daemon's (``src/tfd/sched/``): base = min(max,
initial * 2^(n-1)), stretched by up to +25% jitter. The tests pin this
copy against ``tpufd.sched`` on a grid, so the two cannot drift.
"""

import time

from tpufd_torch import metrics


def backoff_with_jitter(consecutive_failures, initial_s, max_s,
                        unit_random):
    """sched::BackoffWithJitter: base = min(max, initial * 2^(n-1)),
    stretched by up to +25% jitter; inputs clamped the same way."""
    initial_s = max(1, initial_s)
    max_s = max(max_s, initial_s)
    exponent = max(0, consecutive_failures - 1)
    if exponent >= 31:
        base = float(max_s)
    else:
        base = min(float(max_s), float(initial_s) * (1 << exponent))
    jitter = min(max(unit_random, 0.0), 1.0)
    return base * (1.0 + 0.25 * jitter)


class ProbeScheduler:
    """Runs named probes with a per-probe retry budget and the shared
    backoff rule, recording ``tpufd_probe_attempts_total`` /
    ``tpufd_probe_retries_total`` (per probe) into a metrics registry.

    Synchronous by design: the probes are batch work, and what this
    shares with the daemon's broker is the retry/backoff/telemetry
    contract, not the threads.
    """

    def __init__(self, registry=None, retry_budget=2,
                 backoff_initial_s=0.5, backoff_max_s=4.0,
                 unit_random=0.5, sleep=time.sleep):
        self.registry = (metrics.default_registry() if registry is None
                         else registry)
        self.retry_budget = retry_budget
        self.backoff_initial_s = backoff_initial_s
        self.backoff_max_s = backoff_max_s
        self.unit_random = unit_random
        self.sleep = sleep

    def run(self, name, fn):
        """Runs ``fn`` with up to retry_budget re-attempts, sleeping the
        jittered backoff between failures. Returns fn's value; re-raises
        the last failure once the budget is spent."""
        failures = 0
        while True:
            self.registry.counter(
                "tpufd_probe_attempts_total",
                "Probe invocations, per probe (retries included).",
                labels={"probe": name}).inc()
            try:
                return fn()
            except Exception:
                failures += 1
                if failures > self.retry_budget:
                    raise
                self.registry.counter(
                    "tpufd_probe_retries_total",
                    "Probe re-attempts after a raise, per probe.",
                    labels={"probe": name}).inc()
                # Sub-second backoff: the daemon's rule with seconds
                # scaled down, so a retry never stalls the exec past the
                # daemon's health budget.
                scale = self.backoff_initial_s
                delay = backoff_with_jitter(
                    failures, 1, max(1, int(self.backoff_max_s / scale)),
                    self.unit_random) * scale
                self.sleep(min(delay, self.backoff_max_s))
