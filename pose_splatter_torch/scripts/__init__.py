"""Command-line probes of the port (run with ``python -m``)."""
