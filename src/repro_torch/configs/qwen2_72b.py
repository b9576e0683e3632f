"""qwen2-72b [dense] — GQA with QKV bias.

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.
[arXiv:2407.10671; hf]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-72b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=29568,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    train_microbatches=16,
    max_seq=131_072,
).validate()
