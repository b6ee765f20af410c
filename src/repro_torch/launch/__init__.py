"""Command-line entry points (port of ``src/repro/launch``)."""
