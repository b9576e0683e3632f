"""llava-next-34b [vlm] — dense GQA backbone with anyres vision tiling.

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000. The vision
frontend is a STUB: input_specs() provides precomputed patch embeddings;
anyres tiling is reflected in the token count of the shapes.
[hf:llava-hf/llava-v1.6 family; unverified]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_head=128,
    d_ff=20480,
    vocab=64000,
    frontend="vision_stub",
    rope_theta=5_000_000.0,
    train_microbatches=16,
    max_seq=32_768,
).validate()
