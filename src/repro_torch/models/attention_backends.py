"""Attention backends of the port's serving path (counterpart of
``repro.models.attention_backends``): exact attention (dense oracle,
chunked prefill through the ``attention`` stage, one-token decode) and the
paper's HCK decode (Algorithm 3 over a frozen prefix plus an exact
window).

``chunked_attention`` is the reference's pure-XLA online softmax; its
docstring names the flash-attention kernel as the per-shard runtime
equivalent, and that is the route here: on CUDA tensors it launches B14
(``repro_torch.kernels.flash_attention``), on CPU tensors the stage's
plain version.  The HCK training path (``hck_attention`` and its dense
reference) comes with ROADMAP A16b.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import Tensor

from repro_torch.kernels.registry import get_impl, resolve_backend

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Exact backends
# ---------------------------------------------------------------------------

def _gqa_scores(q: Tensor, k: Tensor) -> Tensor:
    """q (B, K, G, Sq, D), k (B, K, Sk, D) -> (B, K, G, Sq, Sk)."""
    return torch.einsum("bkgqd,bkld->bkgql", q, k)


def dense_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    window: int = 0, scale: float | None = None) -> Tensor:
    """Reference full attention.  q (B, H, S, D); k, v (B, Hkv, S, D)."""
    b, h, s, d = q.shape
    hkv = k.shape[1]
    g = h // hkv
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, hkv, g, s, d)
    scores = _gqa_scores(qg * scale, k).float()
    rows = torch.arange(s, device=q.device)[:, None]
    cols = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= rows >= cols
    if window:
        mask &= rows - cols < window
    scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgql,bkld->bkgqd", p.to(v.dtype), v)
    return out.reshape(b, h, s, d)


def chunked_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                      window: int = 0, block: int = 1024) -> Tensor:
    """Exact causal GQA attention through the ``attention`` stage.

    q (B, H, S, D); k, v (B, Hkv, S, D) -> (B, H, S, D) in q's dtype, the
    scores, softmax and sums in float32.  ``block`` is the reference's KV
    block of its XLA scan; the kernel tiles on its own, so it is accepted
    and unused.  ``window > 0`` runs on CPU tensors (the plain version
    masks it) and raises ``NotImplementedError`` on CUDA tensors.
    """
    del block
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    backend = resolve_backend(None, "attention", q, k, v)
    return get_impl("attention", backend)(q, k, v, causal=causal,
                                          window=window)


def decode_attention(q: Tensor, k_cache: Tensor, v_cache: Tensor, *,
                     window: int = 0, length: int | None = None) -> Tensor:
    """One-token decode: q (B, H, 1, D) against the cache (B, Hkv, S, D);
    ``length`` masks unwritten slots (columns >= length), the query sits at
    position length - 1."""
    b, h, _, d = q.shape
    hkv = k_cache.shape[1]
    g = h // hkv
    s = k_cache.shape[2]
    qg = (q * d ** -0.5).reshape(b, hkv, g, 1, d)
    sc = _gqa_scores(qg, k_cache).float()                  # (b,kv,g,1,s)
    cols = torch.arange(s, device=q.device)
    if length is not None:
        sc = torch.where(cols < length, sc, NEG_INF)
    if window:
        qpos = (length - 1) if length is not None else (s - 1)
        sc = torch.where(qpos - cols < window, sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bkgql,bkld->bkgqd", p.to(v_cache.dtype), v_cache)
    return out.reshape(b, h, 1, d)


# ---------------------------------------------------------------------------
# HCK decode: Algorithm 3 over a frozen prefix + exact window
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HCKAttnConfig:
    """Hyper-parameters of HCK attention (leaf n0, rank r, tree levels)."""

    leaf: int = 1024        # n0: exact local block
    rank: int = 64          # r: landmarks per tree level
    levels: int = 5         # tree depth (leaves = 2**levels)
    jitter: float = 1e-3
    tau_cap: float = 16.0   # cosine-logit scale cap (f32 safety)

    def for_seq(self, s: int) -> "HCKAttnConfig":
        """Clamp levels so the leaf never drops below rank."""
        levels = self.levels
        while levels > 0 and s // (1 << levels) < max(self.leaf // 4,
                                                      self.rank):
            levels -= 1
        return dataclasses.replace(self, levels=levels)


def _normalize(x: Tensor) -> Tensor:
    return x * torch.rsqrt(
        torch.sum(x.float() ** 2, dim=-1, keepdim=True) + 1e-6)


def _exp_kernel(a: Tensor, b: Tensor, tau: float) -> Tensor:
    """exp(tau <a, b>) for unit-norm rows: (..., m, d), (..., n, d) -> (...,
    m, n) float32."""
    return torch.exp(tau * torch.einsum("...md,...nd->...mn", a.float(),
                                        b.float()))


def default_landmarks(levels: int, rank: int, d: int, seed: int = 0x4C4D, *,
                      device=None) -> Tensor:
    """Deterministic landmark parameters (levels, rank, d) for call sites
    without learned ones, drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device``.  Not bit-equal to the reference's draw: tests
    inject landmarks."""
    gen = torch.Generator(device=device or "cpu").manual_seed(seed)
    return torch.randn((levels, rank, d), generator=gen, dtype=torch.float32,
                       device=gen.device)


def _level_factors(landmarks: Tensor, levels: int, tau: float,
                   jitter: float):
    """Per-level shared factors: (normalised landmarks (levels, r, d),
    sigma (levels, r, r), sigma^-1 (levels, r, r), [w_l for l = 1..levels-1]
    (r, r))."""
    r = landmarks.shape[1]
    lm = _normalize(landmarks[:levels].float())
    eye = torch.eye(r, dtype=torch.float32, device=landmarks.device)
    sigma = torch.exp(tau * torch.einsum("lrd,lsd->lrs", lm, lm)) + jitter * eye
    sigma_inv = torch.linalg.inv(sigma)
    w = [torch.exp(tau * lm[l] @ lm[l - 1].T) @ sigma_inv[l - 1]
         for l in range(1, levels)]
    return lm, sigma, sigma_inv, w


@dataclasses.dataclass
class HCKDecodeState:
    """Per-layer decode-attention state (built at prefill, O(n0 + r) per
    token).

    window_k/v  (B, Hkv, n0, D)    exact recent window
    lm_k        (B, Hkv, r, D)     top-level landmark parameters (static)
    sigma       (B, Hkv, r, r)     their (jittered) Gram (static)
    summary     (B, Hkv, r, D + 1) hierarchical value summary of the prefix
    win_len     ()                 valid entries in the window (int32)
    """

    window_k: Tensor
    window_v: Tensor
    lm_k: Tensor
    sigma: Tensor
    summary: Tensor
    win_len: Tensor

    FIELDS = ("window_k", "window_v", "lm_k", "sigma", "summary", "win_len")


def build_hck_decode_state(k_cache: Tensor, v_cache: Tensor, *,
                           cfg: HCKAttnConfig,
                           landmarks: Tensor | None = None
                           ) -> HCKDecodeState:
    """Collapse the prefix hierarchy into the decode summary (Algorithm-3
    preparation).  The decode query always lives in the rightmost leaf, so
    the d-chain telescopes into one (r, D + 1) matrix per head."""
    b, hkv, s, d = k_cache.shape
    cfg = cfg.for_seq(s)
    levels, r = cfg.levels, cfg.rank
    nl = 1 << levels
    n0 = s // nl
    tau = min(d ** 0.5, cfg.tau_cap)
    if landmarks is None:
        landmarks = default_landmarks(cfg.levels, r, d,
                                      device=k_cache.device)
    lm, sigma, sigma_inv, w = _level_factors(landmarks, levels, tau,
                                             cfg.jitter)
    kn = _normalize(k_cache)
    ones = torch.ones((b, hkv, s, 1), dtype=torch.float32,
                      device=k_cache.device)
    vv = torch.cat([v_cache.float(), ones], dim=-1)
    kl = kn.reshape(b, hkv, nl, n0, d)
    vl = vv.reshape(b, hkv, nl, n0, d + 1)

    u = _exp_kernel(kl, lm[levels - 1], tau) @ sigma_inv[levels - 1]

    def pair_sum(x):
        return x.reshape(*x.shape[:2], x.shape[2] // 2, 2,
                         *x.shape[3:]).sum(3)

    c = {levels: torch.einsum("bkpnr,bkpnv->bkprv", u, vl)}
    for lvl in range(levels - 1, 0, -1):
        c[lvl] = torch.einsum("ij,bkpiv->bkpjv", w[lvl - 1],
                              pair_sum(c[lvl + 1]))

    # d-chain for the rightmost leaf only (path index all ones)
    dlast = torch.zeros((b, hkv, r, d + 1), dtype=torch.float32,
                        device=k_cache.device)
    for lvl in range(1, levels + 1):
        left_idx = (1 << lvl) - 2
        contrib = torch.einsum("ij,bkjv->bkiv", sigma[lvl - 1],
                               c[lvl][:, :, left_idx])
        if lvl == 1:
            dlast = contrib
        else:
            dlast = contrib + torch.einsum("ij,bkjv->bkiv", w[lvl - 2], dlast)

    def bc(x):
        return x.expand((b, hkv) + tuple(x.shape)).contiguous()

    return HCKDecodeState(
        window_k=k_cache[:, :, -n0:].contiguous(),
        window_v=v_cache[:, :, -n0:].contiguous(),
        lm_k=bc(lm[levels - 1]).to(k_cache.dtype),
        sigma=bc(sigma[levels - 1]),
        summary=dlast,
        win_len=torch.tensor(n0, dtype=torch.int32, device=k_cache.device),
    )


def hck_decode_attention(q: Tensor, state: HCKDecodeState,
                         tau_cap: float = 16.0) -> Tensor:
    """One-token hierarchical decode: q (B, H, 1, D) -> (B, H, 1, D), the
    exact window softmax plus the Algorithm-3 cross term,
    O(n0 d + r d + r^2)."""
    b, h, _, d = q.shape
    hkv = state.window_k.shape[1]
    g = h // hkv
    tau = min(d ** 0.5, tau_cap)
    qn = _normalize(q).reshape(b, hkv, g, d)

    # cross: psi_q Sigma^-1 summary (lm_k already unit-norm parameters)
    kq = torch.exp(tau * torch.einsum("bkgd,bkrd->bkgr", qn.float(),
                                      state.lm_k.float()))
    phi = torch.einsum("bkgr,bkrv->bkgv", kq,
                       _spd_solve(state.sigma, state.summary))

    # exact window (masked to its valid length)
    wk = _normalize(state.window_k)
    sloc = tau * torch.einsum("bkgd,bkmd->bkgm", qn, wk.float())
    n0 = wk.shape[2]
    valid = (torch.arange(n0, device=q.device)[None, None, None, :]
             >= (n0 - state.win_len))
    ploc = torch.where(valid, torch.exp(sloc), 0.0)
    ones = torch.ones((b, hkv, n0, 1), dtype=torch.float32, device=q.device)
    vv = torch.cat([state.window_v.float(), ones], dim=-1)
    loc = torch.einsum("bkgm,bkmv->bkgv", ploc, vv)

    total = loc + phi
    out = total[..., :d] / torch.clamp(total[..., d:], min=1e-6)
    return out.reshape(b, h, 1, d).to(q.dtype)


def hck_decode_append(state: HCKDecodeState, k_new: Tensor, v_new: Tensor
                      ) -> HCKDecodeState:
    """Shift the new token into the exact window (the summary refreshes
    lazily through build_hck_decode_state)."""
    wk = torch.cat([state.window_k[:, :, 1:], k_new], dim=2)
    wv = torch.cat([state.window_v[:, :, 1:], v_new], dim=2)
    win_len = torch.clamp(state.win_len + 1, max=state.window_k.shape[2])
    return dataclasses.replace(state, window_k=wk, window_v=wv,
                               win_len=win_len)


def _spd_solve(mat: Tensor, rhs: Tensor) -> Tensor:
    """Batched SPD solve (leading dims broadcast).  ``solve_ex`` skips the
    singularity check, which would synchronise the host with the card at
    every decode step; the reference's ``jnp.linalg.solve`` checks nothing
    either."""
    return torch.linalg.solve_ex(mat, rhs)[0]
