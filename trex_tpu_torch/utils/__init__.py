"""Utilities: memory-bounded chunking, timing and profiling, metrics,
checkpoints and the numerical-debug switch."""
