"""kimi-k2-1t-a32b — [moe] 61L d_model=7168 64H (GQA kv=8) d_ff=2048
vocab=163840, MoE 384 experts top-8 (+1 shared). Trillion-param MoE
(paper-table). [arXiv:2501.kimi2; unverified]"""
from repro_torch.configs.base import ArchConfig, MOE

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family=MOE,
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=0,
    d_ff_expert=2048,
    n_experts=384,
    top_k=8,
    n_shared_experts=1,
    vocab=163840,
    rope_theta=50000.0,
)
