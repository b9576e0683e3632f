"""deepseek-v3-671b [moe] — MLA + 1 shared + 256 routed experts top-8.

61L d_model=7168 128H (MLA: q_lora=1536 kv_lora=512 nope=128 rope=64
v=128) vocab=129280. First 3 layers dense (d_ff=18432 per the tech
report); remaining 58 layers MoE with per-expert d_ff=2048 (the
assignment's d_ff), 1 shared expert. MTP (multi-token prediction) is a
training-objective add-on, out of scope for the backbone cells — noted in
DESIGN.md. [arXiv:2412.19437; hf]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_head=128,
    d_ff=18432,            # dense prefix layers
    vocab=129280,
    attn_type="mla",
    mla_q_lora=1536,
    mla_kv_lora=512,
    mla_rope_dim=64,
    mla_nope_dim=128,
    mla_v_dim=128,
    prefix=(("attn", "dense"),) * 3,
    period=("attn",),
    ffn_period=("moe",),
    n_experts=256,
    top_k=8,
    n_shared_experts=1,
    d_ff_expert=2048,
    train_microbatches=16,
    max_seq=131_072,
).validate()
