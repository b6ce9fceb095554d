"""Median of the loader's own ``last_wait_ms`` (the wait for the batch on
its prefetch queue) over the window's steps."""

import statistics


def read(rec):
    return statistics.median(rec["batch_wait_ms"]) if rec.get(
        "batch_wait_ms") else None
