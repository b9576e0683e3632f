"""xlstm-1.3b [ssm] — sLSTM + mLSTM recurrent blocks (xLSTM[7:1]).

48L d_model=2048 4H (kv=4) d_ff=0 (no separate FFN; blocks carry their own
up/down projections) vocab=50304. [arXiv:2405.04517; unverified]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_head=512,
    d_ff=0,
    vocab=50304,
    period=("mlstm",) * 7 + ("slstm",),
    ffn_period=("none",) * 8,
    subquadratic=True,
    max_seq=1_048_576,
).validate()
