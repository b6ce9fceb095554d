"""90th percentile of every request's latency in the window, from its call
to its outputs after a synchronise (``statistics.quantiles``)."""

import statistics


def read(rec):
    lat = rec.get("latency_ms") or []
    return statistics.quantiles(lat, n=10)[8] if len(lat) >= 2 else None
