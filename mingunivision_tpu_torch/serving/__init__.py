"""The HTTP serving layer."""
