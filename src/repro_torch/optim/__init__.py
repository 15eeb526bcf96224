"""Optimizer-side helpers of the port: the learning-rate schedules."""
