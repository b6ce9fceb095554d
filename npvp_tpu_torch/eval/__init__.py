"""Evaluation: quality metrics, the evaluation CLI and FVD."""
