"""Median host time of a train step, from the call into the port's step to
its return, before its metrics are fetched."""

import statistics


def read(rec):
    return statistics.median(rec["dispatch_ms"]) if rec.get(
        "dispatch_ms") else None
