"""Plain PyTorch version of the attention stage (counterpart of
``repro.kernels.flash_attention.ref``): dense (S, S) scores in float32.

``window > 0`` also masks keys more than ``window - 1`` positions behind
the query (the reference's ``dense_attention`` rule), which the CPU path
of :func:`repro_torch.models.attention_backends.chunked_attention` needs;
the CUDA kernel raises on it.
"""
from __future__ import annotations

import torch
from torch import Tensor


def attention_ref(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                  window: int = 0) -> Tensor:
    """(B, Hq, S, D) queries, (B, Hkv, S, D) keys and values -> (B, Hq, S,
    D) in q's dtype; GQA maps query head h to KV head h // (Hq / Hkv)."""
    attention_ref.calls += 1
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    kk = k.repeat_interleave(group, dim=1).float()
    vv = v.repeat_interleave(group, dim=1).float()
    s_mat = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) / (d ** 0.5)
    rows = torch.arange(s, device=q.device)[:, None]
    cols = torch.arange(s, device=q.device)[None, :]
    keep = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        keep &= rows >= cols
    if window:
        keep &= rows - cols < window
    s_mat.masked_fill_(~keep, float("-inf"))
    p = torch.softmax(s_mat, dim=-1)
    del s_mat
    return torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)


attention_ref.calls = 0
