"""Synthetic tasks, byte tokenizer and the deterministic loader — a copy of
``repro/data`` (numpy only), so the same seed gives the same batches bit for
bit without importing the JAX package."""
