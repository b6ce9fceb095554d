"""The attention kernel's share of its roofline, in %: the least time its
calls could take (the benchmark's byte and FLOP count of each traced
``npvp::temporal_attention`` call's shapes, at the H100 SXM peaks) over
the kernel's device time in the trace."""

from npvp_bench.trace import kernel_roofline


def read(rec):
    return kernel_roofline(rec, "npvp::temporal_attention",
                           "temporal_attention")
