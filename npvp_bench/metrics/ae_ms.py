"""Device ms a request inside the AE's encode and decode ranges (the
benchmark's forward hooks on ``ae.encoder`` and ``ae.decoder``), over the
traced requests."""

from npvp_bench.trace import range_ms_per


def read(rec):
    return range_ms_per(rec, ("bench.ae.encode", "bench.ae.decode"),
                        "bench.request.call")
