"""CPU tests of the benchmark (and card tests, marked ``cuda``)."""
