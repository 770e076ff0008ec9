"""Serving launcher of the port (counterpart of ``repro.launch.serve``).

``--task lm``: prefill a batch of prompts, then decode greedily (or
sampled at ``--temperature``) with the architecture's caches (the HCK
Algorithm-3 state or the exact K/V):

  PYTHONPATH=src python -m repro_torch.launch.serve --task lm \\
      --arch zamba2-7b --reduced --device cpu --prompt-len 64 --gen 32

``--task krr``: fit an HCK kernel ridge model and serve a stream of query
micro-batches through the versioned hot-swap registry
(:class:`repro_torch.serving.predict_service.ModelRegistry`) and
:class:`repro_torch.serving.serve_loop.KRRServeLoop`, reporting queries/s
and latency percentiles.  ``--update-batch N`` absorbs N new points online
mid-stream (``krr.fit_incremental``) and hot-swaps the new version under
the running stream; ``--rollback`` rolls back to version 1 for the tail of
the stream:

  PYTHONPATH=src python -m repro_torch.launch.serve --task krr \\
      --device cpu --n 2048 --rank 64 --queries 4096 --update-batch 256 \\
      --rollback

Runs on the card unless ``--device cpu``; without a card the default
raises.  Weights and data are random, drawn from ``--seed``.
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


def _krr_target(x: torch.Tensor) -> torch.Tensor:
    return torch.sin(x[:, 0]) + 0.25 * torch.cos(x[:, 1] * 2.0)


def _percentile(sorted_vals: list, q: float) -> float:
    return sorted_vals[min(len(sorted_vals) - 1, int(len(sorted_vals) * q))]


def run_krr(args) -> dict:
    """Fit, publish and serve the query stream (with the optional online
    update and rollback mid-stream); print the times.  Returns the loop's
    and the registry's ``stats`` with the throughput and latencies: p50,
    p99 and ``qps_serving`` by host clock around each whole
    ``loop.serve`` call, as a client waits for it."""
    from repro_torch import device as _device
    from repro_torch.core import krr
    from repro_torch.core.kernels_fn import BaseKernel
    from repro_torch.kernels.registry import SolveConfig
    from repro_torch.serving.predict_service import ModelRegistry
    from repro_torch.serving.serve_loop import KRRServeLoop

    dev = _device.resolve(args.device)
    cfg = SolveConfig()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    x = torch.randn((args.n, args.d), generator=gen, device=dev)
    y = _krr_target(x)
    ker = BaseKernel("gaussian", sigma=args.sigma)

    _sync(dev)
    t0 = time.perf_counter()
    model = krr.fit(x, y, kernel=ker, lam=1e-2, rank=args.rank,
                    solve_config=cfg, device=dev, generator=gen)
    _sync(dev)
    t_fit = time.perf_counter() - t0

    t0 = time.perf_counter()
    registry = ModelRegistry(model, tag="fit", warmup=True)
    t_warm = time.perf_counter() - t0
    loop = KRRServeLoop(registry)

    queries = torch.randn((args.queries, args.d), generator=gen, device=dev)
    batches = [queries[i:i + args.micro_batch]
               for i in range(0, args.queries, args.micro_batch)]
    swap_at = len(batches) // 2 if args.update_batch else None
    rollback_at = (3 * len(batches)) // 4 if args.rollback else None
    t_swap = t_rollback = None
    info = None
    order: list[int] = []
    waited: list[float] = []
    _sync(dev)
    t0 = time.perf_counter()
    for i, batch in enumerate(batches):
        if swap_at is not None and i == swap_at:
            # online update and hot swap mid-stream: the live version keeps
            # serving while the new one builds and warms; the swap itself
            # is one reference store
            xu = torch.randn((args.update_batch, args.d), generator=gen,
                             device=dev)
            t1 = time.perf_counter()
            _, info = registry.update_and_publish(
                xu, _krr_target(xu), tag="update", warmup=True)
            t_swap = time.perf_counter() - t1
        if rollback_at is not None and i == rollback_at:
            t1 = time.perf_counter()
            registry.rollback(1)
            t_rollback = time.perf_counter() - t1
        # a client waits for the whole call: the engine, the card's sync
        # and the loop's finiteness probe
        t1 = time.perf_counter()
        version = loop.serve(batch).version
        waited.append(time.perf_counter() - t1)
        if not order or order[-1] != version:
            order.append(version)
    total = time.perf_counter() - t0
    lat = sorted(waited)
    engine_lat = sorted(r.latency_s for r in loop.responses)
    rollback_bitwise = None
    if rollback_at is not None and loop.responses[0].version == 1:
        # the stored v1 serves the first batch again, as before the swap
        rollback_bitwise = torch.equal(registry.predict(batches[0])[0],
                                       loop.responses[0].z)
    out = {
        "device": str(dev), "fit_s": t_fit, "publish_warmup_s": t_warm,
        "queries": args.queries, "stream_s": total,
        "qps": args.queries / total,
        "qps_serving": args.queries / sum(lat),
        "p50_ms": _percentile(lat, 0.5) * 1e3,
        "p99_ms": _percentile(lat, 0.99) * 1e3,
        "engine_p50_ms": _percentile(engine_lat, 0.5) * 1e3,
        "swap_s": t_swap, "rollback_s": t_rollback,
        "rollback_bitwise": rollback_bitwise,
        "versions_in_order": order,
        "loop": loop.stats(), "registry_stats": registry.stats,
        "update": None if info is None else {
            "k": info.record.k, "residual": info.residual,
            "needs_rebuild": info.needs_rebuild},
    }
    print(f"krr n={args.n} rank={args.rank} d={args.d} device={dev}: fit "
          f"{t_fit:.2f} s, publish+warmup {t_warm:.2f} s (versions served "
          f"in order {order})")
    print(f"served {args.queries} queries in micro-batches of "
          f"{args.micro_batch}: {out['qps']:,.0f} queries/s over the stream "
          f"({out['qps_serving']:,.0f} queries/s of serving time), latency "
          f"p50 {out['p50_ms']:.3f} ms  p99 {out['p99_ms']:.3f} ms (engine "
          f"up to the sync, without the probe: p50 "
          f"{out['engine_p50_ms']:.3f} ms)")
    if t_swap is not None:
        print(f"online update of {args.update_batch} points mid-stream: "
              f"build+warm+swap {t_swap * 1e3:.1f} ms (insert "
              f"k={info.record.k}/leaf, resid {info.residual:.2e}, "
              f"rebuild={info.needs_rebuild})")
    if t_rollback is not None:
        print(f"rollback to v1 mid-stream: {t_rollback * 1e3:.3f} ms; v1 "
              f"serves its first batch bitwise as before the swap: "
              f"{rollback_bitwise}")
    print(f"loop stats {loop.stats()}; registry stats {registry.stats}")
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
    # krr task
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--rank", type=int, default=64)
    ap.add_argument("--d", type=int, default=8)
    ap.add_argument("--sigma", type=float, default=2.0,
                    help="bandwidth of the gaussian kernel")
    ap.add_argument("--queries", type=int, default=4096)
    ap.add_argument("--micro-batch", type=int, default=256)
    ap.add_argument("--update-batch", type=int, default=0,
                    help="absorb this many new points online mid-stream and "
                    "hot-swap the updated model (0 = off)")
    ap.add_argument("--rollback", action="store_true",
                    help="roll back to the initial version for the stream "
                    "tail")
    args = ap.parse_args(argv)
    if args.task == "krr":
        return run_krr(args)
    if not args.arch:
        raise SystemExit("--arch is required for --task lm")
    return run_lm(args)


if __name__ == "__main__":
    main()
