"""Experiment recipes of the port (the JAX package's ``experiments/``)."""
