"""Model zoo facade of the port (counterpart of ``repro.models.model_zoo``):
model inputs and step functions per (architecture x input shape).

``input_specs(cfg, shape)`` makes concrete inputs; ``abstract=True`` makes
them on the meta device (shapes and dtypes, no memory), the port's
stand-in for the reference's ShapeDtypeStructs.  Train steps, the loss and
the modality front ends come with ROADMAP A16b.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import transformer as tf


def input_specs(cfg: ArchConfig, shape: ShapeConfig, *,
                abstract: bool = False,
                generator: torch.Generator | None = None,
                device=None) -> dict:
    """Model inputs for one cell.  prefill: {"tokens": (B, S) int64};
    decode: one token, the decode caches and the position S // 2.  Token
    ids are drawn from ``generator`` (default: seeded 0 on ``device``)."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        raise NotImplementedError("train inputs come with ROADMAP A16b")
    dev = torch.device("meta") if abstract else torch.device(device or "cpu")

    def tokens(shp):
        if abstract:
            return torch.empty(shp, dtype=torch.int64, device=dev)
        gen = generator or torch.Generator(device=dev).manual_seed(0)
        return torch.randint(0, cfg.vocab, shp, generator=gen,
                             dtype=torch.int64, device=gen.device)

    if shape.kind == "prefill":
        return {"tokens": tokens((b, s))}
    caches = tf.init_decode_caches(cfg, b, s, abstract=abstract, device=dev)
    return {"tokens": tokens((b, 1)), "caches": caches, "pos": s // 2}


def make_prefill_step(cfg: ArchConfig):
    """fn(params, batch) -> (logits, caches) of the prompt."""
    def prefill(params, batch):
        return tf.forward(params, cfg, batch, mode="prefill")

    return prefill


def make_decode_step(cfg: ArchConfig):
    """fn(params, batch) -> (logits, caches) of one token; batch holds
    "tokens", "caches" and "pos"."""
    def decode(params, batch):
        return tf.decode_step(params, cfg, batch["caches"],
                              {"tokens": batch["tokens"]}, batch["pos"])

    return decode
