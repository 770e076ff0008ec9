"""Decoder-only model of the port's serving path (counterpart of
``repro.models.transformer``): the parameter table, the blocks, and the
prefill and decode steps of the ``ssm`` and ``hybrid`` families.

Families ported here:
  ssm                 : [Mamba2/SSD]
  hybrid (zamba2)     : [Mamba2] trunk + ONE shared attention + MLP block
                        applied every ``cfg.shared_attn_every`` layers

The reference's layer ``scan`` and ``lax.cond`` become a Python loop over
layers; its ``_caches_per_layer`` / ``_caches_from_layerwise`` become plain
slot indexing (the shared block's cache slot of layer i is i // every).
Differences a caller can see:

* ``forward(mode="prefill")`` returns the shared block's K/V only for the
  layers that apply it, (ceil(L / every), B, Hkv, S, D): the reference
  returns all L slots, zeros where the block does not apply (at
  Zamba2-7B's 4 x 3,840 prefill 18 GB against 3.1 GB).
* ``decode_step`` updates the caches in place and returns them.

The dense, MoE, VLM and audio families, ``mode="train"`` (and its loss),
``moe_block`` and HCK attention at prefill come with ROADMAP A16b; they
raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import Tensor
from torch.nn import functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention_backends as ab
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (apply_rope, dense_init, rms_norm,
                                       rope_freqs, swiglu)

LONG_SEQ = 131072          # "auto" switches to the HCK backend at/after this
PORTED_FAMILIES = ("ssm", "hybrid")
_LATER = "ROADMAP A16b (the rest of the LM stack)"


def _require_family(cfg: ArchConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (the port serves "
            f"{PORTED_FAMILIES}); it comes with {_LATER}")


def use_hck(cfg: ArchConfig, seq_len: int) -> bool:
    """True when attention at ``seq_len`` uses the HCK backend."""
    if not cfg.has_attention:
        return False
    return cfg.attn_backend == "hck" or (
        cfg.attn_backend == "auto" and seq_len >= LONG_SEQ)


def hck_cfg(cfg: ArchConfig) -> ab.HCKAttnConfig:
    """The HCK attention hyper-parameters of ``cfg``."""
    return ab.HCKAttnConfig(leaf=cfg.hck_leaf, rank=cfg.hck_rank,
                            levels=cfg.hck_levels)


# ---------------------------------------------------------------------------
# Parameter table
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PDef:
    """One parameter: shape, fan-in of its initialiser, logical kind."""

    shape: tuple
    fan_in: int
    logical: str          # embed|col|row|norm|vec|conv|head|landmark


def _attn_defs(cfg: ArchConfig, prefix_shape: tuple = ()) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads
    defs = {
        "ln": PDef(prefix_shape + (d,), d, "norm"),
        "wq": PDef(prefix_shape + (d, h * hd), d, "col"),
        "wk": PDef(prefix_shape + (d, kv * hd), d, "col"),
        "wv": PDef(prefix_shape + (d, kv * hd), d, "col"),
        "wo": PDef(prefix_shape + (h * hd, d), h * hd, "row"),
    }
    if cfg.qk_norm:
        defs["q_norm"] = PDef(prefix_shape + (hd,), hd, "norm")
        defs["k_norm"] = PDef(prefix_shape + (hd,), hd, "norm")
    # learned per-level HCK landmark parameters (content-independent
    # inducing points keep hierarchical attention strictly causal)
    defs["hck_lm"] = PDef(
        prefix_shape + (cfg.hck_levels, cfg.hck_rank, hd), hd, "landmark")
    return defs


def _mlp_defs(cfg: ArchConfig, prefix_shape: tuple = ()) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "ln": PDef(prefix_shape + (d,), d, "norm"),
        "w_gate": PDef(prefix_shape + (d, ff), d, "col"),
        "w_up": PDef(prefix_shape + (d, ff), d, "col"),
        "w_down": PDef(prefix_shape + (ff, d), ff, "row"),
    }


def _mamba_defs(cfg: ArchConfig, prefix_shape: tuple = ()) -> dict:
    d = cfg.d_model
    din = cfg.ssm_expand * d
    nh = din // cfg.ssm_head_dim
    gn = cfg.ssm_groups * cfg.ssm_state
    conv_dim = din + 2 * gn
    return {
        "ln": PDef(prefix_shape + (d,), d, "norm"),
        "in_proj": PDef(prefix_shape + (d, 2 * din + 2 * gn + nh), d, "col"),
        "conv_w": PDef(prefix_shape + (4, conv_dim), 4, "conv"),
        "dt_bias": PDef(prefix_shape + (nh,), nh, "vec"),
        "a_log": PDef(prefix_shape + (nh,), nh, "vec"),
        "d_skip": PDef(prefix_shape + (nh,), nh, "vec"),
        "gnorm": PDef(prefix_shape + (din,), din, "norm"),
        "out_proj": PDef(prefix_shape + (din, d), din, "row"),
    }


def param_defs(cfg: ArchConfig) -> dict:
    """The parameter table: embed, blocks (stacked on a leading layer
    axis), final_norm, head and, for hybrid, the shared block."""
    _require_family(cfg)
    l = (cfg.n_layers,)
    d, v = cfg.d_model, cfg.vocab
    blocks = {"mamba_" + k: p for k, p in _mamba_defs(cfg, l).items()}
    defs: dict = {"embed": {"w": PDef((v, d), v, "embed")}, "blocks": blocks,
                  "final_norm": {"w": PDef((d,), d, "norm")},
                  "head": {"w": PDef((d, v), d, "head")}}
    if cfg.family == "hybrid":
        defs["shared"] = {
            **{"attn_" + k: p for k, p in _attn_defs(cfg).items()},
            **{"mlp_" + k: p for k, p in _mlp_defs(cfg).items()}}
    return defs


def _walk(tree: dict, path: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, PDef):
            yield path + (k,), v
        else:
            yield from _walk(v, path + (k,))


def init_params(cfg: ArchConfig, generator: torch.Generator) -> dict:
    """Random parameters of ``cfg`` drawn from ``generator``, made on its
    device, in ``cfg.dtype``: norms 1, the Mamba2 vectors
    0.1, landmarks N(0, 1), matrices N(0, 1 / fan_in).  The stacked block
    weights are drawn one layer at a time (float32 draws of a whole stack
    would double the peak memory at full width).  Not bit-equal to the
    reference's draw: tests carry its weights across with
    :func:`repro_torch.convert.lm_params_from_arrays`."""
    dtype = getattr(torch, cfg.dtype)
    device = generator.device
    out: dict = {}
    for path, pd in _walk(param_defs(cfg)):
        if pd.logical == "norm":
            arr = torch.ones(pd.shape, dtype=dtype, device=device)
        elif pd.logical == "vec":
            arr = torch.full(pd.shape, 0.1, dtype=dtype, device=device)
        else:
            arr = torch.empty(pd.shape, dtype=dtype, device=device)
            parts = arr if path[0] == "blocks" else arr[None]
            for part in parts:
                if pd.logical == "landmark":
                    part.copy_(torch.randn(part.shape, generator=generator,
                                           dtype=torch.float32,
                                           device=device))
                else:
                    part.copy_(dense_init(generator, tuple(part.shape), dtype,
                                          fan_in=pd.fan_in))
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = arr
    return out


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _split_heads(x: Tensor, n: int, hd: int) -> Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n, hd).transpose(1, 2)          # (B, H, S, D)


def _merge_heads(x: Tensor) -> Tensor:
    b, h, s, hd = x.shape
    return x.transpose(1, 2).reshape(b, s, h * hd)


def attn_block(x: Tensor, p: dict, cfg: ArchConfig, *, mode: str,
               cos: Tensor, sin: Tensor, backend: str,
               cache: tuple | None = None, pos: int | None = None,
               hck_state: ab.HCKDecodeState | None = None):
    """Attention block.  Returns (x_out, new_cache, new_hck_state); at
    prefill new_cache is (k, v), at exact decode the cache is updated in
    place at ``pos``."""
    h, kv = cfg.n_heads, cfg.n_kv_heads
    hd = cfg.head_dim
    xn = rms_norm(x, p["ln"])
    q = _split_heads(xn @ p["wq"], h, hd)
    k = _split_heads(xn @ p["wk"], kv, hd)
    v = _split_heads(xn @ p["wv"], kv, hd)
    if cfg.qk_norm and "q_norm" in p:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    q = apply_rope(q.transpose(1, 2), cos, sin).transpose(1, 2)
    k = apply_rope(k.transpose(1, 2), cos, sin).transpose(1, 2)

    new_cache, new_state = cache, hck_state
    if mode == "prefill":
        if backend == "hck":
            raise NotImplementedError(
                f"HCK attention at prefill comes with {_LATER}")
        out = ab.chunked_attention(q, k, v, causal=True,
                                   window=cfg.sliding_window)
        new_cache = (k, v)
    elif mode == "decode":
        if backend == "hck":
            out = ab.hck_decode_attention(q, hck_state)
            new_state = ab.hck_decode_append(hck_state, k, v)
        else:
            ck, cv = cache
            ck[:, :, pos:pos + 1] = k
            cv[:, :, pos:pos + 1] = v
            out = ab.decode_attention(q, ck, cv, window=cfg.sliding_window,
                                      length=pos + 1)
    else:
        raise NotImplementedError(f"attention mode {mode!r} comes with "
                                  f"{_LATER}")
    y = _merge_heads(out) @ p["wo"]
    return x + y, new_cache, new_state


def mlp_block(x: Tensor, p: dict) -> Tensor:
    """Pre-norm SwiGLU MLP with its residual."""
    xn = rms_norm(x, p["ln"])
    return x + swiglu(xn, p["w_gate"], p["w_up"], p["w_down"])


def moe_block(x: Tensor, p: dict, cfg: ArchConfig):
    """Mixture-of-experts block: not ported yet."""
    raise NotImplementedError(f"moe_block comes with {_LATER}")


def mamba_block(x: Tensor, p: dict, cfg: ArchConfig, *, mode: str,
                ssm_state: Tensor | None = None,
                conv_cache: Tensor | None = None):
    """Mamba2 block.  Returns (x_out, new_ssm_state, new_conv_cache); the
    state is None outside prefill and decode."""
    d = cfg.d_model
    din = cfg.ssm_expand * d
    nh = din // cfg.ssm_head_dim
    ph = cfg.ssm_head_dim
    gn = cfg.ssm_groups * cfg.ssm_state
    xn = rms_norm(x, p["ln"])
    zxbcdt = xn @ p["in_proj"]
    z, xbc, dt = torch.split(zxbcdt, [din, din + 2 * gn, nh], dim=-1)
    xbc, new_conv = ssm_lib.causal_conv1d(xbc, p["conv_w"], cache=conv_cache)
    xbc = F.silu(xbc)
    xs, bmat, cmat = torch.split(xbc, [din, gn, gn], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    a = -torch.exp(p["a_log"].float())
    b_, s_ = x.shape[0], x.shape[1]
    xh = xs.reshape(b_, s_, nh, ph)
    bm = bmat.reshape(b_, s_, cfg.ssm_groups, cfg.ssm_state)
    cm = cmat.reshape(b_, s_, cfg.ssm_groups, cfg.ssm_state)
    if mode == "decode":
        new_state, yh = ssm_lib.ssd_decode_step(
            ssm_state, xh[:, 0].float(), dt[:, 0], a, bm[:, 0].float(),
            cm[:, 0].float())
        yh = yh[:, None]
    else:
        chunk = min(cfg.ssm_chunk, s_)
        yh = ssm_lib.ssd_chunked(xh.float(), dt, a, bm.float(), cm.float(),
                                 chunk=chunk)
        new_state = (_ssd_final_state(xh, dt, a, bm, cm)
                     if mode == "prefill" else None)
    yh = yh + p["d_skip"].float()[None, None, :, None] * xh
    y = yh.reshape(b_, s_, din).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["gnorm"])
    return x + y @ p["out_proj"], new_state, new_conv


def _ssd_final_state(xh: Tensor, dt: Tensor, a: Tensor, bm: Tensor,
                     cm: Tensor) -> Tensor:
    """Final SSM state h_S (B, H, N, P) for the prefill -> decode handoff."""
    h = xh.shape[2]
    rep = h // bm.shape[2]
    da = dt * a[None, None, :]
    cum = torch.cumsum(da, dim=1)
    decay = torch.exp(cum[:, -1:, :] - cum)                # (B,S,H)
    br = bm.repeat_interleave(rep, dim=2).float()          # (B,S,H,N)
    return torch.einsum("bshn,bshp->bhnp", br,
                        (dt * decay)[..., None] * xh.float())


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def embed_tokens(params: dict, cfg: ArchConfig, batch: dict) -> Tensor:
    """Token embeddings (B, S, d) in ``cfg.dtype``."""
    _require_family(cfg)
    x = params["embed"]["w"][batch["tokens"]]
    return x.to(getattr(torch, cfg.dtype))


def lm_head(params: dict, cfg: ArchConfig, x: Tensor) -> Tensor:
    """Final norm and vocabulary projection."""
    return rms_norm(x, params["final_norm"]["w"]) @ params["head"]["w"]


def _freqs(cfg: ArchConfig, seq: int, offset: int = 0, *, device=None):
    hd = cfg.head_dim if cfg.has_attention else 2
    return rope_freqs(seq, hd, cfg.rope_theta, offset=offset, device=device)


def _prefixed(p: dict, prefix: str, index: int | None = None) -> dict:
    """The entries of ``p`` under ``prefix`` (stripped), at layer
    ``index`` of a stacked table."""
    n = len(prefix)
    return {k[n:]: (v if index is None else v[index])
            for k, v in p.items() if k.startswith(prefix)}


def _napp(cfg: ArchConfig) -> int:
    every = cfg.shared_attn_every
    return (cfg.n_layers + every - 1) // every


# ---------------------------------------------------------------------------
# Forward (prefill) and decode
# ---------------------------------------------------------------------------

def forward(params: dict, cfg: ArchConfig, batch: dict, *,
            mode: str = "prefill"):
    """Prefill: (logits (B, S, V), caches).  caches = (ssm (L, B, H, N, P),
    conv (L, B, 3, C)) and, for hybrid, (shared_k, shared_v) of the
    applying layers only, (ceil(L / every), B, Hkv, S, D)."""
    if mode != "prefill":
        raise NotImplementedError(f"forward(mode={mode!r}) comes with "
                                  f"{_LATER}; the port serves prefill")
    x = embed_tokens(params, cfg, batch)
    b, seq = x.shape[0], x.shape[1]
    dev = x.device
    cos, sin = _freqs(cfg, seq, device=dev)
    nl = cfg.n_layers
    din = cfg.ssm_expand * cfg.d_model
    nh = din // cfg.ssm_head_dim
    conv_w = params["blocks"]["mamba_conv_w"]
    ssm_states = torch.empty((nl, b, nh, cfg.ssm_state, cfg.ssm_head_dim),
                             dtype=torch.float32, device=dev)
    convs = torch.empty((nl, b, conv_w.shape[1] - 1, conv_w.shape[2]),
                        dtype=x.dtype, device=dev)
    hybrid = cfg.family == "hybrid" and cfg.shared_attn_every > 0
    if hybrid:
        every = cfg.shared_attn_every
        kv_shape = (_napp(cfg), b, cfg.n_kv_heads, seq, cfg.head_dim)
        shared_k = torch.empty(kv_shape, dtype=x.dtype, device=dev)
        shared_v = torch.empty(kv_shape, dtype=x.dtype, device=dev)
        attn_p = _prefixed(params["shared"], "attn_")
        mlp_p = _prefixed(params["shared"], "mlp_")
    for i in range(nl):
        x, ssm_states[i], convs[i] = mamba_block(
            x, _prefixed(params["blocks"], "mamba_", i), cfg, mode="prefill")
        if hybrid and i % every == 0:
            x, (k, v), _ = attn_block(x, attn_p, cfg, mode="prefill", cos=cos,
                                      sin=sin, backend="exact")
            x = mlp_block(x, mlp_p)
            shared_k[i // every] = k
            shared_v[i // every] = v
    logits = lm_head(params, cfg, x)
    caches = (ssm_states, convs) + ((shared_k, shared_v) if hybrid else ())
    return logits, caches


def init_decode_caches(cfg: ArchConfig, batch_size: int, max_seq: int, *,
                       abstract: bool = False, device=None) -> dict:
    """Decode caches: SSM states and conv caches per layer and, for hybrid,
    the shared block's exact K/V or, when ``use_hck(cfg, max_seq)``, HCK
    decode state per application slot.  ``abstract=True`` makes them on
    the meta device (shapes only)."""
    _require_family(cfg)
    dtype = getattr(torch, cfg.dtype)
    dev = torch.device("meta") if abstract else torch.device(device or "cpu")
    l = cfg.n_layers

    def mk(shape, dt):
        return torch.zeros(shape, dtype=dt, device=dev)

    def mk_eye(shape, dt):
        # Sigma grams must be invertible even in a fresh state
        return torch.eye(shape[-1], dtype=dt, device=dev).expand(
            shape).contiguous()

    din = cfg.ssm_expand * cfg.d_model
    nh = din // cfg.ssm_head_dim
    gn = cfg.ssm_groups * cfg.ssm_state
    caches: dict = {
        "ssm": mk((l, batch_size, nh, cfg.ssm_state, cfg.ssm_head_dim),
                  torch.float32),
        "conv": mk((l, batch_size, 3, din + 2 * gn), dtype)}
    if cfg.family == "hybrid" and cfg.shared_attn_every:
        napp = _napp(cfg)
        kv, hd = cfg.n_kv_heads, cfg.head_dim
        if use_hck(cfg, max_seq):
            hcfg = hck_cfg(cfg).for_seq(max_seq)
            n0 = max_seq // (1 << hcfg.levels)
            r = hcfg.rank
            caches["shared_hck"] = {
                "window_k": mk((napp, batch_size, kv, n0, hd), dtype),
                "window_v": mk((napp, batch_size, kv, n0, hd), dtype),
                "lm_k": mk((napp, batch_size, kv, r, hd), dtype),
                "sigma": mk_eye((napp, batch_size, kv, r, r), torch.float32),
                "summary": mk((napp, batch_size, kv, r, hd + 1),
                              torch.float32),
                "win_len": mk((napp,), torch.int32),
            }
        else:
            caches["shared_k"] = mk((napp, batch_size, kv, max_seq, hd), dtype)
            caches["shared_v"] = mk((napp, batch_size, kv, max_seq, hd), dtype)
    return caches


def decode_step(params: dict, cfg: ArchConfig, caches: dict, batch: dict,
                pos: int):
    """One-token serve step: batch["tokens"] (B, 1) at position ``pos``.
    Returns (logits (B, 1, V), caches), the caches updated in place."""
    x = embed_tokens(params, cfg, batch)
    cos, sin = _freqs(cfg, 1, offset=int(pos), device=x.device)
    hybrid = cfg.family == "hybrid" and cfg.shared_attn_every > 0
    if hybrid:
        every = cfg.shared_attn_every
        attn_p = _prefixed(params["shared"], "attn_")
        mlp_p = _prefixed(params["shared"], "mlp_")
    for i in range(cfg.n_layers):
        x, caches["ssm"][i], caches["conv"][i] = mamba_block(
            x, _prefixed(params["blocks"], "mamba_", i), cfg, mode="decode",
            ssm_state=caches["ssm"][i], conv_cache=caches["conv"][i])
        if not (hybrid and i % every == 0):
            continue
        slot = i // every
        if "shared_hck" in caches:
            sh = caches["shared_hck"]
            st = ab.HCKDecodeState(**{f: sh[f][slot]
                                      for f in ab.HCKDecodeState.FIELDS})
            x, _, st = attn_block(x, attn_p, cfg, mode="decode", cos=cos,
                                  sin=sin, backend="hck", hck_state=st)
            for f in ab.HCKDecodeState.FIELDS:
                sh[f][slot] = getattr(st, f)
        else:
            x, _, _ = attn_block(
                x, attn_p, cfg, mode="decode", cos=cos, sin=sin,
                backend="exact", pos=int(pos),
                cache=(caches["shared_k"][slot], caches["shared_v"][slot]))
        x = mlp_block(x, mlp_p)
    return lm_head(params, cfg, x), caches
