"""MemorySim on PyTorch and CUDA: the port of the JAX package ``repro``.

The simulator's main path — parameters, queues, the bank-FSM and DRAM
timing model, the per-cycle engine (``simulate``), the event-horizon engine
(``simulate_fast``), the ideal reference and the Table-2 statistics — with
the three bank-FSM kernels hand-written in CUDA for Hopper
(``repro_torch/csrc``). Entry points run on the CUDA card unless the caller
passes ``device="cpu"``. This package imports neither JAX nor ``repro``.
"""
