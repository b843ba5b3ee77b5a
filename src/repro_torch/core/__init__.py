"""Quantizers and the BitLinear layer."""
