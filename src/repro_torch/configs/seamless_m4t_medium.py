"""seamless-m4t-medium [audio] — encoder-decoder multimodal backbone.

12L encoder + 12L decoder, d_model=1024 16H (kv=16) d_ff=4096 vocab=256206.
The audio frontend is a STUB: input_specs() provides precomputed frame
embeddings [B, S_src, d_model]. [arXiv:2308.11596; hf]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,          # decoder depth
    n_enc_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_head=64,
    d_ff=4096,
    vocab=256206,
    frontend="audio_stub",
    max_seq=4096,
).validate()
