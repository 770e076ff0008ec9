"""Architecture and input-shape configs of the port's LM path (counterpart
of ``repro.configs.base``, copied, not imported).

Every architecture registers an :class:`ArchConfig` through
:func:`register_arch`; ``--arch <id>`` in the launcher resolves through
:func:`get_arch`.  ``ArchConfig.reduced()`` is the small same-family
config of the CPU tests.  The mesh and train configs of the reference
belong to the training and distributed items of ROADMAP (A16b, A14).
"""
from __future__ import annotations

import dataclasses
from typing import Callable


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One model architecture, field for field the reference's."""

    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                     # 0 => attention-free
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                  # 0 => d_model // n_heads

    # attention details
    qk_norm: bool = False
    rope_theta: float = 1.0e4
    mrope: bool = False
    sliding_window: int = 0          # 0 => none
    attn_backend: str = "auto"       # auto | full | hck

    # MoE
    moe: bool = False
    n_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    dense_residual: bool = False

    # SSM (Mamba2/SSD)
    ssm: bool = False
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_groups: int = 1

    # hybrid (zamba2): one shared attention block applied every N layers
    shared_attn_every: int = 0

    # modality frontend stub
    frontend: str = "none"           # none | patch (vlm) | frame (audio)

    # HCK attention hyper-parameters (used when the backend is hck)
    hck_leaf: int = 1024             # exact local block (n0)
    hck_rank: int = 64               # landmarks per node (r)
    hck_levels: int = 5              # tree depth over the sequence

    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        """Attention head width (``d_head``, else d_model / n_heads)."""
        if self.d_head:
            return self.d_head
        return self.d_model // max(self.n_heads, 1)

    @property
    def has_attention(self) -> bool:
        """True when the model has an attention block (own or shared)."""
        return self.n_heads > 0 or self.shared_attn_every > 0

    def reduced(self) -> "ArchConfig":
        """Same-family tiny config for CPU tests."""
        return dataclasses.replace(
            self,
            n_layers=max(2, min(3, self.n_layers)),
            d_model=64,
            n_heads=4 if self.n_heads else 0,
            n_kv_heads=2 if self.n_kv_heads else 0,
            d_head=16 if self.has_attention else 0,
            d_ff=128,
            vocab=256,
            n_experts=min(self.n_experts, 4),
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=16 if self.ssm else 0,
            ssm_chunk=16,
            sliding_window=min(self.sliding_window, 32),
            shared_attn_every=2 if self.shared_attn_every else 0,
            hck_leaf=32, hck_rank=8, hck_levels=2,
            dtype="float32",
        )

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), as the
        reference counts it."""
        d, ff, v = self.d_model, self.d_ff, self.vocab
        per_layer = 0
        if self.ssm:
            d_in = self.ssm_expand * d
            nh = d_in // self.ssm_head_dim
            per_layer += d * (2 * d_in + 2 * self.ssm_groups * self.ssm_state
                              + nh)
            per_layer += d_in * d + 2 * d
        if self.n_heads:
            hd = self.head_dim
            qkv = d * (self.n_heads + 2 * self.n_kv_heads) * hd
            per_layer += qkv + self.n_heads * hd * d
        if self.moe:
            per_layer += d * self.n_experts + self.n_experts * 3 * d * ff
            if self.dense_residual:
                per_layer += 3 * d * ff
        elif not self.ssm:
            per_layer += 3 * d * ff
        per_layer += 2 * d
        total = self.n_layers * per_layer + 2 * v * d
        if self.shared_attn_every:
            hd = self.head_dim or d // 32
            total += d * 4 * 32 * hd  # one shared attention block
        return total


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input shape: sequence length, global batch and step kind."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode

    def reduced(self) -> "ShapeConfig":
        """The shape cut to CPU-test size."""
        return dataclasses.replace(
            self, seq_len=min(self.seq_len, 64),
            global_batch=min(self.global_batch, 2))


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

_ARCHS: dict[str, Callable[[], ArchConfig]] = {}


def register_arch(fn: Callable[[], ArchConfig]) -> Callable[[], ArchConfig]:
    """Decorator: register the config that ``fn`` returns under its name."""
    cfg = fn()
    _ARCHS[cfg.name] = fn
    return fn


def get_arch(name: str) -> ArchConfig:
    """The registered architecture ``name``; KeyError if unknown."""
    import repro_torch.configs  # noqa: F401  (populates the registry)

    if name not in _ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_ARCHS)} (the "
                       "port registers the architectures of its ported "
                       "paths; the others come with ROADMAP A16b)")
    return _ARCHS[name]()


def get_shape(name: str) -> ShapeConfig:
    """The input shape ``name``; KeyError if unknown."""
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; have {sorted(SHAPES)}")
    return SHAPES[name]
