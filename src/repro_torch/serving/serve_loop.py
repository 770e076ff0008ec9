"""LM serving session of the port (counterpart of
``repro.serving.serve_loop.ServeSession``): prefill once, then decode one
token at a time against the caches.

The hybrid family's shared attention decodes through the paper's
Algorithm-3 HCK state (``attn_backend="hck"``) or the exact K/V cache
(``"full"``).  ``KRRServeLoop`` comes with ROADMAP A12.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import Tensor

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention_backends as ab
from repro_torch.models import transformer as tf
from repro_torch.models.model_zoo import make_decode_step, make_prefill_step
from repro_torch.precision import entry_point


@dataclasses.dataclass
class ServeSession:
    """Stateful LM serving session: prefill once, decode incrementally.
    The caches live on the parameters' device and are updated in place."""

    cfg: ArchConfig
    params: dict
    max_seq: int
    caches: dict | None = None
    pos: int = 0

    @entry_point
    def prefill(self, batch: dict) -> Tensor:
        """Run the prompt (B, S), build the decode caches, return the last
        token's logits (B, V)."""
        tokens = batch["tokens"]
        b, seq = tokens.shape[0], tokens.shape[1]
        if seq > self.max_seq:
            raise ValueError(f"prompt of {seq} tokens exceeds max_seq "
                             f"{self.max_seq}")
        logits, layer_caches = make_prefill_step(self.cfg)(self.params,
                                                           batch)
        last = logits[:, -1].contiguous()
        del logits
        self.caches = tf.init_decode_caches(self.cfg, b, self.max_seq,
                                            device=tokens.device)
        self._absorb_prefill(layer_caches, seq)
        self.pos = seq
        return last

    def _absorb_prefill(self, layer_caches: tuple, seq: int) -> None:
        cfg = self.cfg
        self.caches["ssm"] = layer_caches[0]
        self.caches["conv"] = layer_caches[1]
        if cfg.family != "hybrid" or len(layer_caches) <= 2:
            return
        sk, sv = layer_caches[2], layer_caches[3]   # the applying slots
        if "shared_k" in self.caches:
            self.caches["shared_k"][:, :, :, :seq] = sk
            self.caches["shared_v"][:, :, :, :seq] = sv
        elif "shared_hck" in self.caches:
            hcfg = tf.hck_cfg(cfg).for_seq(self.max_seq)
            lm = self.params["shared"]["attn_hck_lm"]
            states = [ab.build_hck_decode_state(sk[i], sv[i], cfg=hcfg,
                                                landmarks=lm)
                      for i in range(sk.shape[0])]
            self.caches["shared_hck"] = {
                f: torch.stack([getattr(st, f) for st in states])
                for f in ab.HCKDecodeState.FIELDS}

    @entry_point
    def decode(self, tokens: Tensor, *, steps: int, temperature: float = 0.0,
               generator: torch.Generator | None = None) -> Tensor:
        """Generate ``steps`` tokens after ``tokens`` (B, 1): greedy, or
        sampled at ``temperature`` > 0 from ``generator`` (default: seeded
        0 on the tokens' device).  Returns (B, 1 + steps)."""
        if self.caches is None:
            raise RuntimeError("decode before prefill")
        if temperature > 0 and generator is None:
            generator = torch.Generator(device=tokens.device).manual_seed(0)
        decode_fn = make_decode_step(self.cfg)
        out = [tokens]
        cur = tokens
        for _ in range(steps):
            if self.pos >= self.max_seq:
                raise ValueError(f"decode past max_seq {self.max_seq}")
            logits, self.caches = decode_fn(
                self.params, {"tokens": cur, "caches": self.caches,
                              "pos": self.pos})
            last = logits[:, -1]
            if temperature > 0:
                probs = torch.softmax(last.float() / temperature, dim=-1)
                nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
            else:
                nxt = torch.argmax(last, dim=-1)
            cur = nxt[:, None]
            out.append(cur)
            self.pos += 1
        return torch.cat(out, dim=1)
