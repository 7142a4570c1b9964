"""Synthetic data source of the port."""
