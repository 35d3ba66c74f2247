"""Launchers: the training CLI."""
