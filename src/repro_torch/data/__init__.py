"""Synthetic data of the port: the Gaussian-mixture classification task."""
