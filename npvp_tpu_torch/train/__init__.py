"""Trainers of the port."""
