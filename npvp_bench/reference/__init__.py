"""The plain float32 reference of the NPVP model and its train step."""
