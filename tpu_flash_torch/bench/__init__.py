"""Timing harness and the headline benchmark of the port (H100)."""
