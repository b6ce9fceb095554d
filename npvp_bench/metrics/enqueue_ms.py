"""Median host time of a serving call, from the call to its return before
the synchronise: the serving API's dispatch of the forward."""

import statistics


def read(rec):
    return statistics.median(rec["enqueue_ms"]) if rec.get(
        "enqueue_ms") else None
