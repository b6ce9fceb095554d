"""Training clips stepped in the window over its wall time, the window
ended by a synchronise."""


def read(rec):
    return rec["clips"] / rec["window_s"] if rec.get("clips") else None
