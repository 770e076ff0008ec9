"""Plain PyTorch version of the SSD intra-chunk stage (counterpart of
``repro.kernels.ssd_chunk.ref``): the einsum form, in float32."""
from __future__ import annotations

import torch
from torch import Tensor


def ssd_intra_chunk_ref(c: Tensor, b: Tensor, xdt: Tensor, cs: Tensor
                        ) -> Tensor:
    """c, b (BH, nc, Q, N), xdt (BH, nc, Q, P), cs (BH, nc, Q) -> y (BH,
    nc, Q, P) float32: Y = ((C B^T) * L) (X dt), L[i, j] = exp(cs_i - cs_j)
    for i >= j, else 0."""
    ssd_intra_chunk_ref.calls += 1
    scores = torch.einsum("zcin,zcjn->zcij", c.float(), b.float())
    q = c.shape[2]
    decay = torch.exp(cs[..., :, None] - cs[..., None, :])
    mask = (torch.arange(q, device=c.device)[:, None]
            >= torch.arange(q, device=c.device)[None, :])
    l_mat = torch.where(mask, decay, 0.0)
    return torch.einsum("zcij,zcjp->zcip", scores * l_mat, xdt.float())


ssd_intra_chunk_ref.calls = 0
