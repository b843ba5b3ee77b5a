"""Attention layers, MLPs, transformer blocks and stacks."""
