"""Drivers that use the port end to end."""
