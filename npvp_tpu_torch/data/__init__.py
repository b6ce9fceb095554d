"""Data pipeline of the port: the procedural SMMNIST dataset, its
transforms, and a single-process batch loader."""
