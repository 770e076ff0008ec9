"""Serving loops of the port (counterpart of ``repro.serving.serve_loop``).

:class:`ServeSession` is the LM session: prefill once, then decode one
token at a time against the caches.  The hybrid family's shared attention
decodes through the paper's Algorithm-3 HCK state (``attn_backend="hck"``)
or the exact K/V cache (``"full"``).

:class:`KRRServeLoop` is the kernel-model counterpart: it drains a query
stream through a :class:`repro_torch.serving.predict_service.
ModelRegistry`, stamping every response with the version that served it,
and retries, then degrades to the last good version, when the live one
fails.
"""
from __future__ import annotations

import dataclasses
import time

import torch
from torch import Tensor

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention_backends as ab
from repro_torch.models import transformer as tf
from repro_torch.models.model_zoo import make_decode_step, make_prefill_step
from repro_torch.precision import entry_point
from repro_torch.runtime import health


def _wait(z: Tensor) -> None:
    """Wait for the card to finish ``z``: an asynchronous kernel fault
    surfaces here, and a latency read after it is the batch's."""
    if z.is_cuda:
        torch.cuda.synchronize(z.device)


@dataclasses.dataclass
class ServedBatch:
    """One response of :class:`KRRServeLoop`: outputs and provenance.

    ``degraded`` marks a batch served from the last good version after the
    live one failed (non-finite output, exception or missed deadline);
    ``retries`` counts the extra live attempts the batch took and
    ``failure`` is the last live failure's message.
    """

    z: Tensor                  # (q, k) predictions
    version: int               # registry version that served this batch
    latency_s: float
    degraded: bool = False
    retries: int = 0
    failure: str | None = None


@dataclasses.dataclass
class KRRServeLoop:
    """Drain query micro-batches through a versioned model registry.

    Each :meth:`serve` reads one live snapshot of the registry and serves
    the whole batch from it, so a swap between (or during) calls never
    gives a mixed-version response.  ``responses`` keeps the trail.

    Every live attempt must return finite predictions within
    ``deadline_s`` (None: no deadline), timed up to the card's
    synchronisation (``ServedBatch.latency_s``; the finiteness probe after
    it is not timed).  A failed attempt is retried at once, up to
    ``max_retries`` times, each retry reading the live snapshot again (a
    concurrent rollback heals the loop).  When every
    attempt fails, the batch is served from the last version that answered
    cleanly, stamped ``degraded=True`` and counted in :meth:`stats`; only
    without such a version does the failure propagate.  A malformed batch
    (``ValueError``) is the caller's error and propagates at once; any
    other exception of the engine counts as a failed attempt.
    """

    registry: object           # repro_torch.serving.predict_service.ModelRegistry
    responses: list = dataclasses.field(default_factory=list)
    deadline_s: float | None = None
    max_retries: int = 2
    _last_good: object = dataclasses.field(default=None, repr=False)
    _failures: int = dataclasses.field(default=0, repr=False)
    _retries: int = dataclasses.field(default=0, repr=False)
    _degraded: int = dataclasses.field(default=0, repr=False)
    _deadline_misses: int = dataclasses.field(default=0, repr=False)

    def _attempt(self, entry, queries: Tensor) -> tuple[Tensor, float]:
        """One serve attempt from ``entry``; raises NumericalFailure on a
        non-finite response, an engine error or a missed deadline."""
        t0 = time.perf_counter()
        try:
            z = entry.engine(queries)
            _wait(z)
        except health.NumericalFailure:
            raise
        except ValueError:
            raise    # a malformed batch: the caller's error
        except Exception as e:
            # an engine that throws enters the same retry and degraded
            # ladder as one that returns garbage
            raise health.NumericalFailure(
                "serve", statistic="engine_error", value=type(e).__name__,
                detail=f"version {entry.version}: {e}")
        dt = time.perf_counter() - t0
        # the last line of defence between a poisoned model and a client
        # (the canary gate is the first): not gated on SolveConfig.checks
        health.probe_predictions(z, force=True, stage="serve")
        if self.deadline_s is not None and dt > self.deadline_s:
            self._deadline_misses += 1
            raise health.NumericalFailure(
                "serve", statistic="deadline_s", value=dt,
                detail=f"budget {self.deadline_s:g}s, version "
                       f"{entry.version}")
        return z, dt

    def serve(self, queries: Tensor) -> ServedBatch:
        """Serve one micro-batch; record and return the stamped response."""
        failure: Exception | None = None
        retries = 0
        for attempt in range(self.max_retries + 1):
            entry = self.registry.live      # a fresh snapshot per attempt
            if entry is None:
                raise ValueError("registry has no live model")
            try:
                z, dt = self._attempt(entry, queries)
            except health.NumericalFailure as e:
                self._failures += 1
                failure = e
                retries = attempt
                continue
            out = ServedBatch(z, entry.version, dt, retries=attempt,
                              failure=str(failure) if failure else None)
            self._retries += attempt
            self._last_good = entry
            self.responses.append(out)
            return out

        # degraded mode: serve from the last version that answered cleanly
        fallback = self._last_good
        if fallback is None or fallback.version == entry.version:
            raise failure
        t0 = time.perf_counter()
        z = fallback.engine(queries)
        _wait(z)
        out = ServedBatch(z, fallback.version, time.perf_counter() - t0,
                          degraded=True, retries=retries,
                          failure=str(failure))
        self._retries += retries
        self._degraded += 1
        self.responses.append(out)
        return out

    def run(self, queries: Tensor, micro_batch: int) -> list:
        """Serve ``queries`` in ``micro_batch`` slices; return responses."""
        if micro_batch <= 0:
            raise ValueError(f"micro_batch must be >= 1, got {micro_batch}")
        return [self.serve(queries[i:i + micro_batch])
                for i in range(0, queries.shape[0], micro_batch)]

    @property
    def versions_served(self) -> list[int]:
        """Distinct versions served, in first-served order."""
        seen: list[int] = []
        for r in self.responses:
            if r.version not in seen:
                seen.append(r.version)
        return seen

    def stats(self) -> dict:
        """Loop counters: batches, failures, retries, degraded batches,
        deadline misses, versions served."""
        return {
            "batches": len(self.responses),
            "failures": self._failures,
            "retries": self._retries,
            "degraded_batches": self._degraded,
            "deadline_misses": self._deadline_misses,
            "versions_served": self.versions_served,
        }


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
