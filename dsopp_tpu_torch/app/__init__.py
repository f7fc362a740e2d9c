"""Command-line entry points of the port: ``main`` (track a camera's
frames) and ``track2trajectory``."""
