"""qwen2-vl-72b — [vlm] 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064. M-RoPE (3-section t/h/w); dynamic-resolution vision frontend is
a STUB: input_specs() provides token ids (text cells) — the M-RoPE dataflow is
exercised with t=h=w positions. [arXiv:2409.12191; hf]"""
from repro_torch.configs.base import ArchConfig, VLM

CONFIG = ArchConfig(
    name="qwen2-vl-72b",
    family=VLM,
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab=152064,
    mrope=True,
    mrope_sections=(16, 24, 24),
    rope_theta=1000000.0,
)
