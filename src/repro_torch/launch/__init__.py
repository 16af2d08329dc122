"""Port of repro/launch/__init__.py: command-line launchers."""
