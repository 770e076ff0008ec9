"""Mamba2 / SSD mixer (counterpart of ``repro.models.ssm``): the chunked
parallel form and the O(1)-state recurrent decode step.

Chunked SSD (Dao & Gu 2024, arXiv:2405.21060): the sequence splits into
chunks of Q tokens; within a chunk the SSM is a masked (Q, Q) quadratic
form, whose intra-chunk term goes through the ``ssd_intra_chunk`` stage
(B15 on the card, its plain version on the CPU); across chunks a
first-order scan carries the (H, N, P) state.  Equivalent to the
recurrence

    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T ,   y_t = C_t h_t + D x_t.
"""
from __future__ import annotations

import torch
from torch import Tensor

from repro_torch.kernels.registry import get_impl, resolve_backend
from repro_torch.precision import entry_point


def stage_ssd_intra_chunk(c: Tensor, b: Tensor, xdt: Tensor, cs: Tensor
                          ) -> Tensor:
    """One SSD intra-chunk block through the registry: c, b (BH, nc, Q, N),
    xdt (BH, nc, Q, P), cs (BH, nc, Q) -> (BH, nc, Q, P) float32."""
    c, b, xdt, cs = (t.contiguous() for t in (c, b, xdt, cs))
    backend = resolve_backend(None, "ssd_intra_chunk", c, b, xdt, cs)
    return get_impl("ssd_intra_chunk", backend)(c, b, xdt, cs)


def _fold_groups(m: Tensor, b: int, nc: int, chunk: int, h: int) -> Tensor:
    """(B, S, G, N) per-group B or C -> (B H, nc, Q, N), each group repeated
    over its H / G heads (head h reads group h // (H / G)), in the stage's
    per-head layout."""
    g, n = m.shape[2], m.shape[3]
    m = m.reshape(b, nc, chunk, g, 1, n).permute(0, 3, 4, 1, 2, 5)
    return m.expand(b, g, h // g, nc, chunk, n).reshape(b * h, nc, chunk, n)


@entry_point
def ssd_chunked(x: Tensor, dt: Tensor, a: Tensor, bmat: Tensor,
                cmat: Tensor, *, chunk: int = 256) -> Tensor:
    """Chunked SSD scan.  x (B, S, H, P), dt (B, S, H) positive, a (H,)
    negative, bmat and cmat (B, S, G, N) -> y (B, S, H, P).

    S must be a multiple of ``chunk`` (the reference's reshape fails
    otherwise; here it raises ``ValueError``).
    """
    b, s, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    if chunk <= 0 or s % chunk:
        raise ValueError(f"ssd_chunked needs S % chunk == 0; got S={s}, "
                         f"chunk={chunk}")
    nc = s // chunk
    rep = h // g

    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    da = dtc * a[None, None, None, :]                      # (B,nc,Q,H)
    cums = torch.cumsum(da, dim=2)                         # within-chunk

    # ---- intra-chunk (quadratic, causal): the stage -----------------------
    xdt = xc * dtc[..., None]                              # (B,nc,Q,H,P)
    y_flat = stage_ssd_intra_chunk(
        _fold_groups(cmat, b, nc, chunk, h), _fold_groups(bmat, b, nc, chunk, h),
        xdt.permute(0, 3, 1, 2, 4).reshape(b * h, nc, chunk, p),
        cums.permute(0, 3, 1, 2).reshape(b * h, nc, chunk))
    del xdt
    y = y_flat.reshape(b, h, nc, chunk, p).permute(0, 2, 3, 1, 4)
    del y_flat

    # ---- chunk states -------------------------------------------------------
    bc = bmat.reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3)
    decay_out = torch.exp(cums[:, :, -1:, :] - cums)       # (B,nc,Q,H)
    states = torch.einsum("bzjhn,bzjhp->bzhnp", bc,
                          (dtc * decay_out)[..., None] * xc)
    del bc

    # ---- inter-chunk scan -----------------------------------------------------
    chunk_decay = torch.exp(torch.sum(da, dim=2))          # (B,nc,H)
    prev = torch.empty_like(states)                        # state BEFORE chunk
    carry = torch.zeros((b, h, n, p), dtype=x.dtype, device=x.device)
    for z in range(nc):
        prev[:, z] = carry
        carry = carry * chunk_decay[:, z, :, None, None] + states[:, z]

    cc = cmat.reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3)
    y_inter = torch.einsum("bzihn,bzhnp->bzihp", cc, prev)
    y_inter = y_inter * torch.exp(cums)[..., None]
    return (y + y_inter).reshape(b, s, h, p)


def ssd_decode_step(state: Tensor, x: Tensor, dt: Tensor, a: Tensor,
                    bvec: Tensor, cvec: Tensor) -> tuple[Tensor, Tensor]:
    """One-token recurrent update.  state (B, H, N, P), x (B, H, P), dt (B,
    H), a (H,), bvec and cvec (B, G, N) -> (new state, y (B, H, P))."""
    h = state.shape[1]
    rep = h // bvec.shape[1]
    br = bvec.repeat_interleave(rep, dim=1)                # (B,H,N)
    cr = cvec.repeat_interleave(rep, dim=1)
    decay = torch.exp(dt * a[None, :])                     # (B,H)
    new = (state * decay[..., None, None]
           + (br * dt[..., None])[..., :, None] * x[..., None, :])
    y = torch.einsum("bhn,bhnp->bhp", cr, new)
    return new, y


def causal_conv1d(x: Tensor, w: Tensor, cache: Tensor | None = None
                  ) -> tuple[Tensor, Tensor]:
    """Depthwise causal convolution.  x (B, S, C), w (K, C) -> (y (B, S, C),
    new cache (B, K - 1, C)); a given ``cache`` (the last K - 1 inputs) is
    prepended (decode: S == 1)."""
    k = w.shape[0]
    if cache is None:
        cache = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([cache, x], dim=1)                      # (B, S+K-1, C)
    s = x.shape[1]
    y = xp[:, 0:s] * w[0][None, None, :]
    for i in range(1, k):
        y = y + xp[:, i:i + s] * w[i][None, None, :]
    return y, xp[:, -(k - 1):]


def ssd_reference(x: Tensor, dt: Tensor, a: Tensor, bmat: Tensor,
                  cmat: Tensor) -> Tensor:
    """Sequential oracle for tests: the recurrence itself, in float32."""
    b, s, h, p = x.shape
    n = bmat.shape[3]
    state = torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        state, y = ssd_decode_step(state, x[:, t].float(), dt[:, t], a,
                                   bmat[:, t], cmat[:, t])
        ys.append(y)
    return torch.stack(ys, dim=1).to(x.dtype)
