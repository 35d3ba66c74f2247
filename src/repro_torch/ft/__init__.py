"""Fault tolerance: checkpoint / restore (with an async save)."""
