"""Command-line entry points and probes of the port (run with
``python -m``)."""
