"""Measured launch parameters for the stage registry (counterpart of
``repro.kernels.autotune``).

The port's kernels choose their launch shapes by rules derived from the
H100's shared-memory budget (``oos_stage.ops.plan``, ``build_stage.ops.
cross_rows``); which of the shapes that fit runs fastest is empirical.
This module runs a timed sweep per (stage, shape bucket, device kind,
dtype) over candidate values of the one launch parameter a stage has
(:data:`TUNABLE`) and over the two backends, and persists the winners in
an on-disk JSON database (``~/.cache/repro_torch/tile_db.json``, or
``REPRO_TILE_DB``; apart from the reference's file).  The wrappers consult
it when the caller leaves the parameter to them (``SolveConfig.leaf_block
is None``, no ``row_tile``) and fall back to today's plan on a cold,
disabled or corrupt database, so a machine without measurements behaves
exactly as before.

Keying: shapes are bucketed to powers of two, as the reference buckets
them, so one measurement covers a neighbourhood of problem sizes; the
device key is ``torch.cuda.get_device_name(0)`` sanitised (or "cpu"), and
calibration aggregates by coarse platform ("gpu" / "cpu").  A sweep keys
a stage by the shape its wrapper looks up: the oos stages with r = 0 (their
plan does not depend on the rank), ``build_cross`` with k = r and
``build_cross_dist`` with k = r and d = 0, the shapes the reference's
wrappers hand ``tile_config``.

A second ``autotune_stage`` call with the same key is a cache hit: the
stored record is returned with ``"cached": True`` and no kernel runs.  Set
``REPRO_AUTOTUNE=0`` to disable database lookups (the plans only).

**A deliberate divergence from the reference.**  The sweep times the
"torch" (plain) and "cuda" (kernel) versions side by side and records the
winner, as the reference records xla against pallas.  But
``registry.resolve_backend("auto")`` keeps following the tensors' device:
on the card the plain version never serves a stage, unlike the reference's
measured xla/pallas crossover, because the port's rule is that a CUDA
tensor launches the kernel or raises.  A bucket whose winner is "torch" is
a finding to report (:func:`torch_winners`); it changes no route.  On CPU
tensors the "cuda" candidates are recorded with the error their wrapper's
rule gives them (the kernels run on CUDA tensors only).

Timing: the best of ``repeats`` calls after one warm-up call, the card
synchronised on both sides of each; on the card each call is timed by two
CUDA events around it (device time), on the CPU by the host clock.  The
oos stages take ``queries`` queries a call (:func:`autotune_all`; the
serving request size where the caller gives it), the others ``batch``
leaves.  Candidates that raise (a rank above
``MAX_CROSS_RANK``, 256, the panel forms' limit; a tile past a kernel's
shared-memory limit) are recorded with their error, as in the reference.
"""
from __future__ import annotations

import functools
import json
import os
import time

import torch

from repro_torch.utils import roofline

#: stage -> the launch parameter of the port's kernel that plays the role of
#: the reference's tile: the rows of a point block B7 stages per step
#: (``oos_stage.ops.plan``'s ``leaf_block``) and the float64 cross tiles'
#: row height (``build_stage.ops.cross_rows``' ``row_tile``).  The other
#: stages the reference tunes (``leaf_matvec``, ``kernel_matvec``) have
#: fixed plans in the port and, like the untunable ones, record timings only.
TUNABLE = {
    "oos_local": "leaf_block",
    "oos_walk": "leaf_block",
    "build_cross": "row_tile",
    "build_cross_dist": "row_tile",
}

OOS_STAGES = ("oos_local", "oos_walk")

#: stages the convenience sweep (:func:`autotune_all`) covers: the
#: reference's list
DEFAULT_STAGES = ("leaf_matvec", "leaf_solve", "leaf_project", "leaf_factor",
                  "build_gram", "build_cross", "build_gram_dist",
                  "build_cross_dist", "oos_local", "oos_walk",
                  "kernel_matvec", "pairwise_kernel")

_ITEMSIZE_DTYPE = {2: "bfloat16", 4: "float32", 8: "float64"}

#: set while a sweep runs, so that the wrappers' consults do not read the
#: half-written database (candidates are timed with explicit parameters)
_SWEEPING = False


def db_path() -> str:
    """Path of the tile database (``REPRO_TILE_DB`` or the user cache)."""
    return os.environ.get("REPRO_TILE_DB") or os.path.join(
        os.path.expanduser("~"), ".cache", "repro_torch", "tile_db.json")


def lookups_enabled() -> bool:
    """Whether the wrappers' database consults are on (``REPRO_AUTOTUNE``)."""
    return os.environ.get("REPRO_AUTOTUNE", "1") != "0" and not _SWEEPING


class TileDB:
    """On-disk JSON map of measured launch parameters and backends.

    A corrupt or unreadable file degrades to an empty database (the plans)
    with ``corrupt = True`` instead of raising; the next :meth:`save`
    rewrites the file.
    """

    def __init__(self, path: str | None = None):
        """Load the database at ``path`` (default :func:`db_path`)."""
        self.path = path or db_path()
        self.entries: dict[str, dict] = {}
        #: the wrappers' consults' answers by their arguments
        #: (``registry.autotuned_block``); :meth:`put` clears it
        self.answers: dict[tuple, int | None] = {}
        self.corrupt = False
        try:
            with open(self.path) as f:
                raw = json.load(f)
            entries = raw.get("entries", {})
            if isinstance(entries, dict):
                self.entries = {k: v for k, v in entries.items()
                                if isinstance(v, dict)}
            else:
                self.corrupt = True
        except FileNotFoundError:
            pass
        except (json.JSONDecodeError, OSError, AttributeError,
                UnicodeDecodeError):
            self.corrupt = True

    def get(self, key: str) -> dict | None:
        """Stored record of ``key`` or None."""
        return self.entries.get(key)

    def put(self, key: str, rec: dict) -> None:
        """Insert or replace ``key`` (in memory; :meth:`save` persists)."""
        self.entries[key] = rec
        self.answers.clear()

    def save(self) -> None:
        """Write the database back to disk atomically (a temporary file,
        then a rename); clears ``corrupt``."""
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        blob = {"version": 1, "torch": torch.__version__,
                "entries": self.entries}
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(blob, f, indent=1, sort_keys=True)
        os.replace(tmp, self.path)
        self.corrupt = False


_DB: TileDB | None = None
_DB_ENV: str | None = None     # the REPRO_TILE_DB that _DB was loaded for


def get_db() -> TileDB:
    """The process's database, loaded lazily from :func:`db_path` and
    again when ``REPRO_TILE_DB`` changes (the wrappers consult it on every
    launch, so the check is one environment read)."""
    global _DB, _DB_ENV
    env = os.environ.get("REPRO_TILE_DB")
    if _DB is None or env != _DB_ENV:
        _DB, _DB_ENV = TileDB(), env
    return _DB


def reset_db() -> None:
    """Drop the cached database and device kind (tests repoint
    ``REPRO_TILE_DB``)."""
    global _DB
    _DB = None
    device_kind.cache_clear()


@functools.lru_cache(maxsize=None)
def device_kind() -> str:
    """Fine-grained kind of device 0, sanitised for database keys: the
    card's name, or "cpu" without one."""
    try:
        kind = (torch.cuda.get_device_name(0) if torch.cuda.is_available()
                else "cpu")
    except Exception:   # noqa: BLE001 -- a broken install: no card
        kind = "cpu"
    return str(kind).strip().replace(" ", "_").replace("|", "_") or "cpu"


def _bucket(v: int) -> int:
    return 0 if v <= 0 else 1 << max(0, int(v) - 1).bit_length()


def bucket_key(stage: str, device: str, dtype: str, *, n0: int, r: int,
               k: int, d: int) -> str:
    """Database key: stage | device kind | dtype | power-of-two bucketed
    shape (the reference's format)."""
    return (f"{stage}|{device}|{dtype}|"
            f"n0={_bucket(n0)},r={_bucket(r)},k={_bucket(k)},d={_bucket(d)}")


def key_shape(stage: str, *, n0: int, r: int, k: int,
              d: int) -> dict:
    """The shape a sweep keys ``stage`` by: the one its wrapper looks up
    (the oos stages with r = 0, the cross stages with k = r, and
    ``build_cross_dist`` with d = 0)."""
    if stage in OOS_STAGES:
        r = 0
    elif stage == "build_cross":
        k = r
    elif stage == "build_cross_dist":
        k, d = r, 0
    return {"n0": n0, "r": r, "k": k, "d": d}


def _dtype(dtype) -> torch.dtype:
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def candidates(stage: str, *, n0: int, r: int, k: int, d: int,
               itemsize: int = 4) -> list[int]:
    """Candidate values of a tunable stage's launch parameter at one shape
    (empty where the stage's plan is fixed).

    The oos stages: the rows of a block staged per step, powers of two
    below the most rows one warp's slots hold (``stage_rows``) and that
    most itself (the cold plan), so the sweep can only improve on it.  The
    cross stages in float64: each of ``ops.row_tiles``, whose block fits the
    shared memory (past rank 128 the panel form's one height; none past
    ``ops.MAX_CROSS_RANK``; the float32 and bfloat16-data routes are on the
    tensor cores with fixed tiles, so they record timings only).
    """
    if stage in OOS_STAGES:
        from repro_torch.kernels.oos_stage.ops import stage_rows

        try:
            most = stage_rows(max(n0, 1), max(d, 1), itemsize, k=max(k, 1))
        except ValueError:
            return []
        return sorted({min(b, most) for b in (16, 32, 64, 128, 256)}
                      | {most})
    if stage in ("build_cross", "build_cross_dist") and itemsize == 8:
        from repro_torch.kernels.build_stage import ops

        smem = ops.cross_smem if stage == "build_cross" else \
            ops.cross_dist_smem
        if r > ops.MAX_CROSS_RANK:
            return []
        return sorted(ops.row_tiles(r, itemsize, smem))
    return []


def stage_inputs(stage: str, gen: torch.Generator, *, batch: int, n0: int,
                 r: int, k: int, d: int, dtype: torch.dtype,
                 device: torch.device) -> tuple[tuple, dict]:
    """Synthetic (args, kwargs) of one stage's registry signature: points
    scaled by 1/sqrt(d) (distances O(1), kernel values O(0.1)), an SPD
    leaf tile for ``leaf_factor``, squared distances of such points for
    the ``*_dist`` stages, lower-triangular Linv = I + tril(noise) / r
    (well conditioned) for the cross stages and ``leaf_solve``."""
    o = dict(dtype=dtype, device=device)
    dd = max(d, 1)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, **o)

    def pts(*shape):
        return rnd(*shape) / dd ** 0.5

    def linv(p, m):
        return torch.eye(m, **o) + torch.tril(rnd(p, m, m)) / max(m, 1)

    def sqdist(a, b):
        return (a[:, :, None, :] - b[:, None, :, :]).square().sum(-1)

    kw = {"name": "gaussian", "sigma": 1.0}
    if stage == "leaf_matvec":
        return (rnd(batch, n0, n0), rnd(batch, n0, r), rnd(batch, n0, k)), {}
    if stage == "leaf_solve":
        return (linv(batch, n0), rnd(batch, n0, r), rnd(batch, r, r),
                rnd(batch, n0, k)), {}
    if stage == "leaf_project":
        return (rnd(batch, n0, r), rnd(batch, n0, k)), {}
    if stage == "leaf_factor":
        a = rnd(batch, n0, n0)
        return (a @ a.mT / n0 + 2.0 * torch.eye(n0, **o),), {}
    if stage == "build_gram":
        return (pts(batch, n0, dd),), {**kw, "jitter": 1e-4,
                                       "want_chol": True}
    if stage == "build_gram_dist":
        p = pts(batch, n0, 8)
        return (sqdist(p, p),), {**kw, "jitter": 1e-4, "want_chol": True}
    if stage == "build_cross":
        return (pts(batch, n0, dd), pts(batch, r, dd), linv(batch, r)), kw
    if stage == "build_cross_dist":
        return (sqdist(pts(batch, n0, 8), pts(batch, r, 8)),
                linv(batch, r)), kw
    if stage in OOS_STAGES:
        idx = torch.arange(batch, device=device) % batch
        return (pts(batch, n0, dd), rnd(batch, n0, k), pts(batch, dd), idx,
                idx), kw
    if stage == "kernel_matvec":
        return (pts(n0, dd), pts(max(r, 8), dd), rnd(max(r, 8), k)), kw
    if stage == "pairwise_kernel":
        return (pts(n0, dd), pts(max(r, 8), dd)), kw
    raise ValueError(f"no synthetic inputs for stage {stage!r}")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_impl(fn, args, kwargs, repeats: int,
               device: torch.device) -> float:
    """Best time (s) of ``fn(*args, **kwargs)`` over ``repeats`` calls
    after one warm-up call, the card synchronised on both sides of each:
    on the card the elapsed time of two CUDA events around the call, on
    the CPU the host clock's."""
    fn(*args, **kwargs)
    _sync(device)
    best = float("inf")
    for _ in range(max(1, repeats)):
        _sync(device)
        if device.type == "cuda":
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            t0.record()
            fn(*args, **kwargs)
            t1.record()
            t1.synchronize()
            t = t0.elapsed_time(t1) / 1e3
        else:
            t0 = time.perf_counter()
            fn(*args, **kwargs)
            t = time.perf_counter() - t0
        best = min(best, t)
    return best


def sweep_inputs(stage: str, *, n0: int, r: int = 0, k: int = 1,
                 d: int = 0, batch: int = 8, dtype="float32", seed: int = 0,
                 device=None) -> tuple[tuple, dict]:
    """The synthetic (args, kwargs) that :func:`autotune_stage` times
    ``stage`` on for this shape: its bucketed key shape, from ``seed``
    (a caller holds a kernel's output on them against the plain
    version's)."""
    from repro_torch import device as _device

    dev = _device.resolve(device)
    shape = key_shape(stage, n0=n0, r=r, k=k, d=d)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return stage_inputs(stage, gen, batch=batch,
                        n0=max(_bucket(shape["n0"]), 8),
                        r=_bucket(shape["r"]), k=max(_bucket(shape["k"]), 1),
                        d=_bucket(shape["d"]), dtype=_dtype(dtype),
                        device=dev)


def autotune_stage(stage: str, *, n0: int, r: int = 0, k: int = 1,
                   d: int = 0, batch: int = 8, dtype="float32",
                   backends: tuple[str, ...] = ("torch", "cuda"),
                   repeats: int = 3, db: TileDB | None = None,
                   force: bool = False, seed: int = 0,
                   device=None) -> dict:
    """Measure (or fetch) the best backend and launch parameter of one
    stage bucket, on ``device`` (None: the card, as the port's entry points
    default; "cpu" times the plain versions alone).

    On a cache hit the stored record is returned with ``"cached": True``
    and nothing runs; ``force=True`` sweeps again.  The sweep times every
    (backend, candidate) pair on synthetic inputs at the bucketed shape
    (:func:`stage_inputs`), records the winner, every candidate's time or
    error, the best "cuda" candidate's parameter (``cuda_block``) and the
    achieved FLOP/s and bytes/s of the best run (:func:`roofline.
    stage_cost`, for calibration), and saves the database.
    """
    global _SWEEPING
    from repro_torch import device as _device
    from repro_torch.kernels.registry import get_impl

    dev = _device.resolve(device)
    dt = _dtype(dtype)
    dtype_name = str(dt).removeprefix("torch.")
    shape = key_shape(stage, n0=n0, r=r, k=k, d=d)
    kind = device_kind()
    key = bucket_key(stage, kind, dtype_name, **shape)
    db = db or get_db()
    hit = db.get(key)
    if hit is not None and not force:
        return {**hit, "cached": True}

    bn0, br = max(_bucket(shape["n0"]), 8), _bucket(shape["r"])
    bk, bd = max(_bucket(shape["k"]), 1), _bucket(shape["d"])
    args, kwargs = sweep_inputs(stage, **shape, batch=batch, dtype=dt,
                                seed=seed, device=dev)
    param = TUNABLE.get(stage)
    cands = (candidates(stage, n0=bn0, r=br, k=bk, d=bd,
                        itemsize=_itemsize(dt)) if param else []) or [None]
    results = []
    _SWEEPING = True
    try:
        for backend in backends:
            if backend == "cuda" and dev.type != "cuda":
                results.append({"backend": backend, "block": None,
                                "error": "the cuda backend runs on CUDA "
                                         "tensors only"})
                continue
            try:
                fn = get_impl(stage, backend)
            except KeyError:
                continue
            for block in (cands if backend == "cuda" else [None]):
                kw = dict(kwargs)
                if block is not None:
                    kw[param] = block
                try:
                    t = _time_impl(fn, args, kw, repeats, dev)
                except Exception as e:   # noqa: BLE001 -- record, go on
                    results.append({"backend": backend, "block": block,
                                    "error": f"{type(e).__name__}: {e}"})
                    continue
                results.append({"backend": backend, "block": block, "s": t})
    finally:
        _SWEEPING = False

    timed = [c for c in results if "s" in c]
    if not timed:
        raise RuntimeError(f"autotune: no candidate ran for {key}: "
                           f"{results}")
    best = min(timed, key=lambda c: c["s"])
    qbatch = 1 if stage in ("kernel_matvec", "pairwise_kernel") else batch
    flops, nbytes = roofline.stage_cost(stage, batch=qbatch, n0=bn0, r=br,
                                        k=bk, d=bd, itemsize=_itemsize(dt))
    cuda_timed = [c for c in timed
                  if c["backend"] == "cuda" and c["block"] is not None]
    rec = {
        "stage": stage, "device_kind": kind,
        "platform": roofline.default_device_kind(),
        "dtype": dtype_name,
        "bucket": {"n0": bn0, "r": br, "k": bk, "d": bd, "batch": batch},
        "backend": best["backend"], "block": best["block"],
        "cuda_block": (min(cuda_timed, key=lambda c: c["s"])["block"]
                       if cuda_timed else None),
        "best_s": best["s"], "torch": torch.__version__,
        "candidates": results,
        "rates": {"flops_per_s": flops / best["s"],
                  "bytes_per_s": nbytes / best["s"]},
    }
    db.put(key, rec)
    try:
        db.save()
    except OSError:
        pass    # a read-only cache directory: keep the entry in memory
    return {**rec, "cached": False}


def autotune_all(*, n0: int = 256, r: int = 16, k: int = 2, d: int = 4,
                 batch: int = 8, queries: int | None = None,
                 dtype="float32", stages: tuple[str, ...] = DEFAULT_STAGES,
                 repeats: int = 3, force: bool = False,
                 device=None) -> list[dict]:
    """Sweep the standard stage set at one shape (the reference's default
    shape unless given); the oos stages take ``queries`` queries a call
    (default ``batch``: a server's request size belongs there, since their
    record steers its launches).  Returns the records."""
    return [autotune_stage(stage, n0=n0, r=r, k=k, d=d,
                           batch=(queries or batch) if stage in OOS_STAGES
                           else batch,
                           dtype=dtype, repeats=repeats, force=force,
                           device=device)
            for stage in stages]


def _lookup(stage: str, dtype_name: str, *, n0: int, r: int, k: int,
            d: int) -> dict | None:
    if not lookups_enabled():
        return None
    db = get_db()
    if not db.entries:
        return None
    return db.get(bucket_key(stage, device_kind(), dtype_name,
                             n0=n0, r=r, k=k, d=d))


def lookup_block(stage: str, *, n0: int, r: int, k: int, d: int = 0,
                 itemsize: int = 4) -> int | None:
    """Measured launch parameter of this bucket, or None (a cold,
    disabled or corrupt database, or an untunable stage).  The parameter
    only steers the kernel, so this is the best "cuda" candidate's even
    where the plain version won the sweep."""
    if stage not in TUNABLE:
        return None
    rec = _lookup(stage, _ITEMSIZE_DTYPE.get(itemsize, "float32"), n0=n0,
                  r=r, k=k, d=d)
    if rec is None:
        return None
    block = rec.get("cuda_block") or rec.get("block")
    return None if block is None else int(block)


def lookup_backend(stage: str, *, dtype, n0: int, r: int, k: int = 1,
                   d: int = 0) -> str | None:
    """Measured backend winner of this bucket, or None.  A record, not a
    route: ``registry.resolve_backend`` does not read it (see the module
    note)."""
    rec = _lookup(stage, str(_dtype(dtype)).removeprefix("torch."), n0=n0,
                  r=r, k=k, d=d)
    return None if rec is None else rec.get("backend")


def torch_winners(records) -> list[dict]:
    """The records whose sweep the plain version won: findings to report
    (a kernel slower than plain torch at that bucket); no route changes."""
    return [rec for rec in records if rec.get("backend") == "torch"]


def calibrated_peaks(platform: str | None = None) -> dict | None:
    """Best measured rates on one coarse platform, for roofline
    calibration: ``{"flops_per_s": max, "bytes_per_s": max}`` over the
    database's records of that platform, or None without any."""
    if not lookups_enabled():
        return None
    platform = platform or roofline.default_device_kind()
    best_f, best_b = 0.0, 0.0
    for rec in get_db().entries.values():
        if rec.get("platform") != platform:
            continue
        rates = rec.get("rates") or {}
        best_f = max(best_f, float(rates.get("flops_per_s", 0.0)))
        best_b = max(best_b, float(rates.get("bytes_per_s", 0.0)))
    if best_f <= 0.0 and best_b <= 0.0:
        return None
    return {"flops_per_s": best_f, "bytes_per_s": best_b}
