"""Share of the traced stretch of the window in which no operation ran on
the device (the union of the kernels', copies' and sets' intervals), in
%."""

from npvp_bench.trace import idle_share


def read(rec):
    return idle_share(rec)
