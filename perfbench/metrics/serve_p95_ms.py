"""The 95th percentile of the latency of every request of the window, ms
(host clock, each request from its call to its summaries on the host)."""

import statistics


def read(run):
    lat = run.window.get("latencies_s") or []
    if len(lat) < 2:
        return None
    return 1e3 * statistics.quantiles(lat, n=100, method="inclusive")[94]
