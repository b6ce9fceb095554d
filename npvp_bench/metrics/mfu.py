"""The model step's share of the chip's peak, in %: the reference's FLOP
count of every request (the served forward) or train step (forward and
backward) in the window, over the window's wall time, against the peak of
the configuration's compute dtype."""

from npvp_bench.flops import mfu


def read(rec):
    return mfu(rec)
