"""minicpm-2b [dense] — llama-like, trained with the WSD schedule.

40L d_model=2304 36H (kv=36, i.e. MHA) d_ff=5760 vocab=122753; tied
embeddings. The WSD (warmup-stable-decay) schedule is wired in
repro.optim.schedules and selected by this config. [arXiv:2404.06395; hf]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_head=64,
    d_ff=5760,
    vocab=122753,
    tie_embeddings=True,
    max_seq=4096,
).validate()
