"""Deterministic, checkpointable synthetic data pipeline."""
