"""Serving runtime of the port: engine, slot pool, sampling, metrics."""
