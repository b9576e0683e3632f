"""phi3.5-moe-42b-a6.6b [moe] — 16 experts top-2 on every layer.

32L d_model=4096 32H (GQA kv=8) expert d_ff=6400 vocab=32064.
[hf:microsoft/Phi-3.5-MoE-instruct; hf]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=6400,
    vocab=32064,
    period=("attn",),
    ffn_period=("moe",),
    n_experts=16,
    top_k=2,
    d_ff_expert=6400,
    max_seq=131_072,
).validate()
