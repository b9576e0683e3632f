"""K7: the Mamba selective scan, chunked over time (prefill)."""
