"""See kernel.py for the design and ops.py for the public wrapper."""
