"""Command-line simulation apps."""
