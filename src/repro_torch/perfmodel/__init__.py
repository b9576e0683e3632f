"""Performance models on top of the simulator: ``effective_bw``, the
effective (not peak) DRAM bandwidth of LLM traffic streams."""
