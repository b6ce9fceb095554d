"""The experiment config matrix of the port: the 23 experiment YAMLs
(``config_<dataset>_<variant>.yaml``, equal to the JAX package's) and
their generator (``generate.py``)."""
