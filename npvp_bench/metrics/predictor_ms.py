"""Device ms a request inside the predictor's range (the benchmark's
forward hook on ``NPPredictor``), over the traced requests."""

from npvp_bench.trace import range_ms_per


def read(rec):
    return range_ms_per(rec, ("bench.predictor",), "bench.request.call")
