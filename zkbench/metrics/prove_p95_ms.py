"""The 95th percentile of the latency of every proof of the window (host
clock, each proof from its call to the card's synchronize after it)."""

import statistics


def p95(values: list[float]) -> float:
    return statistics.quantiles(values, n=100, method="inclusive")[94]


def read(run):
    return 1e3 * p95(run.latencies_s) if len(run.latencies_s) >= 2 else None
