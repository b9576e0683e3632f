"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

  * ``bank_fsm`` — the bank-FSM clock edge (K1), its event bound (K2) and
    the fused hot loop (K3). Sources in ``repro_torch/csrc``; ``build``
    compiles and loads them.
"""
