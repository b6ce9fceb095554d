"""Predicted frames completed in the window over the window's wall time."""


def read(rec):
    return rec["frames"] / rec["window_s"] if rec.get("frames") else None
