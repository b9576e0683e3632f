"""Bank-FSM kernels: ``ops`` (K1/K2 entry points), ``fused`` (K3), ``ref``
(packed ABI and the plain versions of K1/K2)."""
