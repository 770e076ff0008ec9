"""Chunked host-resident ingestion for the HCK build engine, and the
synthetic Table-1 data (counterpart of ``repro.data.pipeline``; its token
stream ``TokenPipeline`` comes with ROADMAP item A16b).

A :class:`ChunkSource` exposes row-range and row-gather access to an
(n, d) point set in host memory (or on disk).  :func:`stream_partition`
projects the rows through the device one chunk at a time and reproduces
:func:`repro_torch.core.partition.build_partition` exactly on the same
draws; :func:`repro_torch.core.hck.build_hck_streaming` then stages groups
of leaf blocks through the build stages, so no more than a bounded
working set of points is ever on the device.

Random draws come from an explicit ``torch.Generator`` on the device the
fit runs on, in the order the in-memory path draws them, so a streamed
fit and :func:`repro_torch.core.krr.fit` on the same generator pad,
partition and pick landmarks alike.  Every draw can be passed in instead
(the parity tests pass the reference's).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core.partition import (PartitionTree, project_rows,
                                        rp_directions)

Tensor = torch.Tensor


class ChunkSource:
    """Host-resident (n, d) point set with chunked/gather row access.

    The contract the streaming build path needs -- subclass (or duck-type)
    for memory-mapped files, object stores, or feature services:

      * ``n`` / ``dim``: row count and feature dim (ints).
      * ``dtype``: numpy dtype of the rows.
      * ``chunk(start, stop)``: contiguous row range as an (stop-start, d)
        numpy array.
      * ``take(rows)``: arbitrary row gather as a (len(rows), d) numpy
        array (used for the partition's chunks, landmark rows and leaf
        blocks).

    Nothing here touches the device: callers move rows with
    ``torch.from_numpy(...).to(device)`` when they enter a stage.
    """

    @property
    def n(self) -> int:
        """Number of rows."""
        raise NotImplementedError

    @property
    def dim(self) -> int:
        """Feature dimension d."""
        raise NotImplementedError

    @property
    def dtype(self):
        """Numpy dtype of the rows."""
        raise NotImplementedError

    def chunk(self, start: int, stop: int) -> np.ndarray:
        """Contiguous rows [start, stop) as a (stop-start, d) host array."""
        raise NotImplementedError

    def take(self, rows: np.ndarray) -> np.ndarray:
        """Arbitrary row gather as a (len(rows), d) host array."""
        raise NotImplementedError


class ArraySource(ChunkSource):
    """ChunkSource over an in-memory array (numpy or a tensor; held as a
    host numpy array).

    The reference source: wraps training data that does fit in host
    memory, so the streaming path can be held to exact equality with the
    in-memory path, and large-but-host-sized fits bound their device
    working set.
    """

    def __init__(self, data):
        if isinstance(data, torch.Tensor):
            data = data.detach().cpu().numpy()
        self._data = np.asarray(data)
        if self._data.ndim != 2:
            raise ValueError(f"expected (n, d) data, got {self._data.shape}")

    @property
    def n(self) -> int:
        """Number of rows."""
        return self._data.shape[0]

    @property
    def dim(self) -> int:
        """Feature dimension d."""
        return self._data.shape[1]

    @property
    def dtype(self):
        """Numpy dtype of the rows."""
        return self._data.dtype

    def chunk(self, start: int, stop: int) -> np.ndarray:
        """Contiguous rows [start, stop) as a view of the wrapped array."""
        return self._data[start:stop]

    def take(self, rows: np.ndarray) -> np.ndarray:
        """Arbitrary row gather from the wrapped array."""
        return self._data[rows]


class PaddedSource(ChunkSource):
    """A ChunkSource extended by a small block of host-side pad rows.

    Row indices ``< base.n`` resolve to the base source, indices beyond it
    to the in-memory ``extra`` block -- so the build engine sees one
    contiguous (n + p, d) point set while only the O(p) pad rows are ever
    duplicated in host memory.
    """

    def __init__(self, base: ChunkSource, extra: np.ndarray):
        self._base = base
        self._extra = np.asarray(extra, dtype=base.dtype)

    @property
    def n(self) -> int:
        """Base rows plus pad rows."""
        return self._base.n + self._extra.shape[0]

    @property
    def dim(self) -> int:
        """Feature dimension d (of the base source)."""
        return self._base.dim

    @property
    def dtype(self):
        """Numpy dtype of the rows (of the base source)."""
        return self._base.dtype

    def chunk(self, start: int, stop: int) -> np.ndarray:
        """Contiguous rows, stitched across the base/pad boundary."""
        nb = self._base.n
        parts = []
        if start < nb:
            parts.append(self._base.chunk(start, min(stop, nb)))
        if stop > nb:
            parts.append(self._extra[max(start - nb, 0):stop - nb])
        if not parts:      # empty range landing exactly on the boundary
            return np.empty((0, self.dim), dtype=self.dtype)
        return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)

    def take(self, rows: np.ndarray) -> np.ndarray:
        """Row gather routed to the base source or the pad block."""
        rows = np.asarray(rows)
        nb = self._base.n
        out = np.empty((rows.shape[0], self.dim), dtype=self.dtype)
        low = rows < nb
        if low.any():
            out[low] = self._base.take(rows[low])
        if (~low).any():
            out[~low] = self._extra[rows[~low] - nb]
        return out


def torch_dtype(source: ChunkSource) -> torch.dtype:
    """The torch dtype of ``source``'s rows."""
    return torch.from_numpy(np.empty((0,), dtype=source.dtype)).dtype


def draw_device(generator, device) -> torch.device:
    """Where the draws are made: the generator's device, else ``device``
    (None = the card)."""
    if generator is not None:
        return torch.device(generator.device)
    return _device.resolve(device)


def rows_to(source: ChunkSource, rows: np.ndarray,
            dev: torch.device) -> Tensor:
    """``source.take(rows)`` as a tensor on ``dev``."""
    return torch.from_numpy(np.ascontiguousarray(source.take(rows))).to(dev)


def pad_source(source: ChunkSource, y, leaf_size: int, levels: int, *,
               generator: torch.Generator | None = None, device=None,
               index=None, noise=None):
    """Streaming analogue of :func:`repro_torch.core.partition.pad_points`.

    Pads ``source`` (and targets ``y``) to ``leaf_size * 2**levels`` rows
    with the same duplicate-and-jitter rule: pad rows copy uniformly drawn
    real rows (``index``) plus ``noise`` (default 1e-4 * standard normal),
    and duplicate their targets.  The draws are those ``pad_points`` makes
    from the same ``generator`` -- ``index``, then ``noise``, on the
    generator's device (else on ``device``, None = the card) -- moved to
    the host; ``index`` / ``noise`` replace them.  ``y`` may be a tensor
    (padded on its device) or an array (padded on the host).

    Returns ``(padded_source, y_pad, mask)`` with ``mask`` a host bool
    array of the real rows; exact-size inputs round-trip unchanged (the
    same source object).  Raises ``ValueError`` for ``levels < 1`` or a
    capacity overflow, like ``pad_points``.
    """
    if levels is None or levels < 1:
        raise ValueError(f"pad_source needs levels >= 1, got {levels!r}")
    if leaf_size < 1:
        raise ValueError(f"leaf_size must be >= 1, got {leaf_size}")
    n, d = source.n, source.dim
    target = leaf_size * (1 << levels)
    if n > target:
        raise ValueError(f"n={n} exceeds capacity {target}")
    if n == target:
        return source, y, np.ones((n,), dtype=bool)
    extra = target - n
    if index is None:
        index = torch.randint(0, n, (extra,), generator=generator,
                              device=draw_device(generator, device))
    if noise is None:
        noise = 1e-4 * torch.randn((extra, d), dtype=torch_dtype(source),
                                   device=draw_device(generator, device),
                                   generator=generator)
    index = torch.as_tensor(index).to(torch.int64)
    noise = torch.as_tensor(noise)
    if index.shape != (extra,) or noise.shape != (extra, d):
        raise ValueError(f"padding needs index ({extra},) and noise "
                         f"({extra}, {d})")
    idx = index.cpu().numpy()
    rows = source.take(idx) + noise.cpu().numpy().astype(source.dtype)
    y_pad = None
    if isinstance(y, torch.Tensor):
        y_pad = torch.cat([y, y[index.to(y.device)]], dim=0)
    elif y is not None:
        y_np = np.asarray(y)
        y_pad = np.concatenate([y_np, y_np[idx]], axis=0)
    mask = np.concatenate([np.ones((n,), bool), np.zeros((extra,), bool)])
    return PaddedSource(source, rows), y_pad, mask


def _split_streamed(source: ChunkSource, perm: Tensor, direction: Tensor,
                    chunk_rows: int) -> tuple[Tensor, Tensor]:
    """One level of :func:`stream_partition`: the rows in ``perm``'s order
    (n,) projected chunk by chunk on their nodes' ``direction`` rows
    (B, d), every node split at its projected median.  Returns the
    level's permutation and thresholds (B,)."""
    n, bsz = perm.shape[0], direction.shape[0]
    m, dev = n // bsz, perm.device
    order_host = perm.cpu().numpy()
    proj = torch.empty((n,), dtype=direction.dtype, device=dev)
    for c0 in range(0, n, chunk_rows):
        c1 = min(c0 + chunk_rows, n)
        node = torch.arange(c0, c1, device=dev) // m
        proj[c0:c1] = project_rows(rows_to(source, order_host[c0:c1], dev),
                                   direction[node])
    proj = proj.view(bsz, m)
    order = torch.argsort(proj, dim=1, stable=True)
    sorted_proj = torch.gather(proj, 1, order)
    thr = 0.5 * (sorted_proj[:, m // 2 - 1] + sorted_proj[:, m // 2])
    return torch.gather(perm.view(bsz, m), 1, order).reshape(-1), thr


def stream_partition(
    source: ChunkSource, levels: int, *,
    generator: torch.Generator | None = None, device=None, directions=None,
    method: str = "rp", chunk_rows: int = 1 << 16, mesh=None,
    timings: dict | None = None,
):
    """Streaming level-synchronous partition over a host-resident source.

    Per level, the rows in their current order pass through the device in
    chunks of ``chunk_rows`` (gathered from the source by index), each
    row projected on its node's direction by
    :func:`~repro_torch.core.partition.project_rows`; a chunk may end
    inside one node and begin the next.  Only O(chunk * d) points and the
    O(n) scalar projections and permutation are on the device at once.
    The nodes of a level are then split at their projected medians by one
    stable sort, batched over the level, as
    :func:`~repro_torch.core.partition.build_partition` splits them.  A
    row's projection does not depend on the rows around it and a stable
    sort has one result, so the permutation, directions and thresholds
    equal ``build_partition``'s on the same data and draws, bit for bit.

    Directions come from :func:`~repro_torch.core.partition.rp_directions`
    level by level (``generator``, on its device, else on ``device``, None
    = the card), as ``build_partition`` draws them; ``directions`` (one
    (2**l, d) tensor per level) replaces them.  ``timings``, a dict,
    receives the wall seconds of each level (the device synchronised).

    Returns ``(perm, tree)``: the host int64 permutation (sorted position
    -> source row) and the device :class:`PartitionTree`.  Only ``method=
    "rp"`` streams (PCA directions need the blocks' second moments);
    ``mesh`` (a sharded projection) comes with ROADMAP item A14.
    """
    if mesh is not None:
        raise NotImplementedError(
            "a mesh-sharded streaming partition comes with ROADMAP item "
            "A14 (distributed)")
    if method != "rp":
        raise NotImplementedError(
            f"stream_partition supports method='rp' only, got {method!r}")
    n, d = source.n, source.dim
    if n % (1 << levels) != 0:
        raise ValueError(f"n={n} not divisible by 2**levels={1 << levels}")
    if directions is not None and len(directions) != levels:
        raise ValueError(f"{len(directions)} directions for {levels} levels")
    if chunk_rows < 1:
        raise ValueError(f"chunk_rows must be >= 1, got {chunk_rows}")
    dev = draw_device(generator, device)
    dtype = torch_dtype(source)
    perm = torch.arange(n, device=dev)
    dirs, thrs = [], []
    for lvl in range(levels):
        if directions is None:
            direction = rp_directions(1 << lvl, d, dtype=dtype, device=dev,
                                      generator=generator)
        else:
            direction = torch.as_tensor(directions[lvl]).to(dtype=dtype,
                                                            device=dev)
            if direction.shape != (1 << lvl, d):
                raise ValueError(f"level {lvl} direction shape "
                                 f"{tuple(direction.shape)} != "
                                 f"{(1 << lvl, d)}")
        perm, thr = _device.timed(
            timings, f"partition level {lvl}", dev,
            lambda: _split_streamed(source, perm, direction, chunk_rows))
        dirs.append(direction)
        thrs.append(thr)
    return perm.cpu().numpy(), PartitionTree(perm, tuple(dirs), tuple(thrs))


def _sorted_quantile(s: Tensor, q: float) -> Tensor:
    """Linear-interpolation quantile ``q`` of the sorted 1-D ``s`` (numpy's
    and jnp's default rule)."""
    pos = q * (s.shape[0] - 1)
    lo = int(pos)
    hi = min(lo + 1, s.shape[0] - 1)
    frac = pos - lo
    return s[lo] + frac * (s[hi] - s[lo])


def regression_dataset(cfg, *, generator: torch.Generator | None = None,
                       device=None, dtype: torch.dtype = torch.float32,
                       draws: dict | None = None, chunk_rows: int = 1 << 16):
    """Synthetic stand-in for a row of the paper's Table 1 (``cfg``, a
    :class:`repro_torch.configs.hck_krr.HCKConfig`): size, dimension and
    task type match; the target is a smooth mixture of 32 gaussian bumps
    of length scale 0.5 sqrt(d) over points uniform in [0, 1]^d, so kernel
    methods are the right model class.

    Regression returns the noisy train targets and the clean test ones;
    binary thresholds both at the median of the clean train values;
    multiclass bins the noisy train targets and the clean test values at
    the clean train values' ``n_classes`` quantiles (``searchsorted``,
    left), as the reference does.  Labels are int32.

    The draws -- ``x`` (n, d) and ``x_test`` uniform, ``centers`` (32, d)
    uniform, ``weights`` (32,) and ``noise`` (n,) standard normal -- are
    made in that order from ``generator`` (on its device, else on
    ``device``, None = the card); ``draws`` (a dict of those names)
    replaces them.  The (rows, 32, d) differences are formed ``chunk_rows``
    rows at a time.  Returns ``((x, y), (x_test, y_test))`` on the draws'
    device.
    """
    dev = draw_device(generator, device)
    n, d, n_centers = cfg.n_train, cfg.d, 32
    if draws is None:
        opts = dict(dtype=dtype, device=dev, generator=generator)
        draws = {"x": torch.rand((n, d), **opts),
                 "x_test": torch.rand((cfg.n_test, d), **opts),
                 "centers": torch.rand((n_centers, d), **opts),
                 "weights": torch.randn((n_centers,), **opts),
                 "noise": torch.randn((n,), **opts)}
    x, xt, centers, weights, eps = (
        torch.as_tensor(draws[k]).to(dtype=dtype, device=dev)
        for k in ("x", "x_test", "centers", "weights", "noise"))
    scale = 2 * (0.5 * d ** 0.5) ** 2

    def fstar(pts):
        out = torch.empty((pts.shape[0],), dtype=dtype, device=dev)
        for c0 in range(0, pts.shape[0], chunk_rows):
            p = pts[c0:c0 + chunk_rows]
            d2 = torch.sum((p[:, None, :] - centers[None]) ** 2, dim=-1)
            out[c0:c0 + chunk_rows] = torch.exp(-d2 / scale) @ weights
        return out

    f, ft = fstar(x), fstar(xt)
    y = f + 0.05 * torch.std(f, correction=0) * eps
    if cfg.task == "regression":
        return (x, y), (xt, ft)
    s = torch.sort(f).values
    if cfg.task == "binary":
        thr = _sorted_quantile(s, 0.5)
        return ((x, (f > thr).to(torch.int32)),
                (xt, (ft > thr).to(torch.int32)))
    qs = torch.stack([_sorted_quantile(s, i / cfg.n_classes)
                      for i in range(1, cfg.n_classes)])
    return ((x, torch.searchsorted(qs, y).to(torch.int32)),
            (xt, torch.searchsorted(qs, ft).to(torch.int32)))
