"""Serving launcher of the port (counterpart of ``repro.launch.serve``).

``--task lm``: prefill a batch of prompts, then decode greedily (or
sampled at ``--temperature``) with the architecture's caches (the HCK
Algorithm-3 state or the exact K/V):

  PYTHONPATH=src python -m repro_torch.launch.serve --task lm \\
      --arch zamba2-7b --reduced --device cpu --prompt-len 64 --gen 32

Runs on the card unless ``--device cpu``; without a card the default
raises.  Weights are random, drawn from ``--seed``.  ``--task krr`` (the
versioned hot-swap registry) comes with ROADMAP A12.
"""
from __future__ import annotations

import argparse
import time

import torch


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_lm(args) -> torch.Tensor:
    """Prefill and decode once; print the times; return the tokens."""
    from repro_torch import device as _device
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.model_zoo import input_specs
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.serve_loop import ServeSession

    dev = _device.resolve(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    max_seq = args.max_seq or (args.prompt_len + args.gen + 16)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(cfg, gen)
    shape = ShapeConfig("serve", args.prompt_len, args.batch, "prefill")
    batch = input_specs(cfg, shape, generator=gen, device=dev)

    session = ServeSession(cfg, params, max_seq=max_seq)
    _sync(dev)
    t0 = time.perf_counter()
    last_logits = session.prefill(batch)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    last = torch.argmax(last_logits, dim=-1)[:, None]

    t0 = time.perf_counter()
    out = session.decode(last, steps=args.gen, temperature=args.temperature,
                         generator=gen)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    per_tok = t_decode / max(args.gen, 1) * 1e3
    print(f"arch={cfg.name} device={dev} prefill {args.prompt_len} tok: "
          f"{t_prefill * 1e3:.1f} ms; decode {args.gen} tok: "
          f"{t_decode * 1e3:.1f} ms ({per_tok:.2f} ms/tok)")
    print("generated token ids (first row):", out[0, :16].tolist())
    return out


def main(argv=None):
    """Parse the arguments and run the task."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", choices=["lm", "krr"], default="lm")
    ap.add_argument("--arch")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--max-seq", type=int, default=None)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.task == "krr":
        raise NotImplementedError(
            "--task krr (the versioned hot-swap registry and KRRServeLoop) "
            "comes with ROADMAP A12")
    if not args.arch:
        raise SystemExit("--arch is required for --task lm")
    return run_lm(args)


if __name__ == "__main__":
    main()
