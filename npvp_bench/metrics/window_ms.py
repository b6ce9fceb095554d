"""Median device ms inside one of the port's ``npvp.serve.window`` spans
(one window of ``VideoPredictor.vfp_windowed``: encode, predictor,
decode), over the windows of the traced stretch with the port's spans
on."""

import statistics


def read(rec):
    got = (rec.get("spans") or {}).get("npvp.serve.window")
    return 1e3 * statistics.median(got) if got else None
