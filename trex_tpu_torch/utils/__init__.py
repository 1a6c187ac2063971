"""Utilities: memory-bounded chunking."""
