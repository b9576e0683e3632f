"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

  * ``bank_fsm`` — the bank-FSM clock edge (K1), its event bound (K2) and
    the fused hot loop (K3). Sources in ``repro_torch/csrc``; ``build``
    compiles and loads them.
  * ``decode_attention`` — one-token GQA decode attention (K5).
  * ``flash_attention`` — blocked causal GQA attention for prefill (K6).
  * ``addr_map`` — trace address decode with a per-bank histogram (K4).
  * ``selective_scan`` — the Mamba selective scan for prefill (K7).

Importing the package builds nothing: each wrapper compiles its kernel
(``build.load``) at its first launch on a CUDA tensor.
"""

from repro_torch.kernels.bank_fsm.ops import bank_fsm_step
from repro_torch.kernels.addr_map.ops import addr_map
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.selective_scan.ops import selective_scan

__all__ = ["bank_fsm_step", "addr_map", "attention", "decode_attention",
           "selective_scan"]
