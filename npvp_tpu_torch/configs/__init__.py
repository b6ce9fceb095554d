"""The experiment config matrix of the port (``generate.py``)."""
