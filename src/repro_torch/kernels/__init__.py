"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

  * ``bank_fsm`` — the bank-FSM clock edge (K1), its event bound (K2) and
    the fused hot loop (K3). Sources in ``repro_torch/csrc``; ``build``
    compiles and loads them.
  * ``decode_attention`` — one-token GQA decode attention (K5).
  * ``flash_attention`` — blocked causal GQA attention for prefill (K6).
  * ``addr_map`` — trace address decode with a per-bank histogram (K4).
  * ``selective_scan`` — the Mamba selective scan for prefill (K7).
"""
