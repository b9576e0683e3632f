"""qwen3-14b [dense] — GQA with qk-norm.

40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936.
[hf:Qwen/Qwen3-8B family; hf]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_head=128,
    d_ff=17408,
    vocab=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    max_seq=131_072,
).validate()
