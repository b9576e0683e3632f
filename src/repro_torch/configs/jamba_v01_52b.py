"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave with MoE.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16 experts
top-2 on every other layer; attention at slot 4 of each 8-layer period; no
positional encoding (Mamba carries position). [arXiv:2403.19887; hf]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab=65536,
    period=("mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba"),
    ffn_period=("dense", "moe", "dense", "moe", "dense", "moe", "dense", "moe"),
    n_experts=16,
    top_k=2,
    d_ff_expert=14336,
    use_rope=False,
    ssm_expand=2,
    ssm_d_state=16,
    ssm_d_conv=4,
    subquadratic=True,
    max_seq=262_144,
).validate()
