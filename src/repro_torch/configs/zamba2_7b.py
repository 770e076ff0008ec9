"""zamba2-7b: hybrid, Mamba2 blocks + one shared attention block.

81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000, ssm_state=64
[arXiv:2411.15242; unverified], the reference's config
(``src/repro/configs/zamba2_7b.py``) copied field for field.

One shared-weight attention + MLP block is applied every 6 Mamba2 layers
(layers 0, 6, ..., 78: 14 applications); d_ff is carried by that block's
MLP.  Decode attention uses the paper's HCK Algorithm-3 state.  Zyphra's
published config differs (head dim 224 over a concatenation with the
embeddings, other shared-block positions, a GELU MLP, a 4,096-token
context); the port mirrors the reference, which is its oracle.
"""
from repro_torch.configs.base import ArchConfig, register_arch


@register_arch
def zamba2_7b() -> ArchConfig:
    """The zamba2-7b architecture."""
    return ArchConfig(
        name="zamba2-7b", family="hybrid",
        n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
        d_ff=14336, vocab=32000, d_head=112,
        ssm=True, ssm_state=64, ssm_head_dim=64, ssm_expand=2,
        shared_attn_every=6,
        attn_backend="hck",
    )
