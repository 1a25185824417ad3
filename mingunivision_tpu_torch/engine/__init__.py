"""Prefill, decode and image-generation loops, and the multi-round session."""
