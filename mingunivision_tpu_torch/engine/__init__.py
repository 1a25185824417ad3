"""Prefill, decode and image-generation loops, the multi-round session, and the continuous-batching
engines over a dense and a paged KV pool."""
