"""Command-line entry points of the port: ``inference`` and ``evaluate``."""
