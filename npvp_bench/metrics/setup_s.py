"""Seconds from the run's process start to the first timed request or
step: imports, kernel and library builds (or their caches), weights,
warm-up."""


def read(rec):
    return rec["setup_s"]
