"""Synthetic LM data for the port's trainer."""
