"""Distributed helpers of the port (``elastic``: the step watchdog the
serving supervisor uses)."""
