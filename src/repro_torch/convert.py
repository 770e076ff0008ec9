"""Carry a model fitted by the JAX reference across to the port.

The input is a flat ``dict[str, numpy.ndarray]`` keyed by the reference's
field paths; a tuple field is spread over ``<field>/<position>`` keys:

  factors  ``x_sorted``, ``perm``, ``directions/<l>``, ``thresholds/<l>``,
           ``landmarks/<l>``, ``sigma/<l>``, ``sigma_cho/<l>`` (l = 0..L-1),
           ``w/<i>`` (i = 0..L-2, the tree levels 1..L-1), ``u``, ``adiag``
  plan     ``plan.c/<i>`` (i = 0..L-1), ``plan.w_leaf``, ``plan.c_tilde``
  model    ``alpha`` and, for a classification fit, ``classes``
  inverse  optional, the cached Algorithm-2 inverse of a fit:
           ``inverse.adiag``, ``inverse.u``, ``inverse.sigma/<l>``,
           ``inverse.w/<i>``, ``inverse.logabsdet``, ``inverse.linv`` and
           ``leaf_lo``

The sweep engine's objects carry across the same way, each through its
own reader: a ``SweepPlan`` (``x_sorted``, ``perm``, ``directions/<l>``,
``thresholds/<l>``, ``landmarks/<l>``, ``lm_self/<l>``, ``lm_cross/<i>``,
``leaf_self``, ``leaf_cross``), a ``KRRPath`` (the factors, ``lams``,
``alphas``, optional ``scores`` and ``classes``), an
``HCKGaussianProcess`` (the factors, ``inverse.*``, ``alpha`` and
``plan.*``) and a ``KPCAModel`` (the factors, ``embedding``, ``evals``,
``v1``, ``a0``).  An exact-kernel ``ExactKRR`` carries across as ``x``,
``alpha`` and, for a classification fit, ``classes``, and an EigenPro
preconditioner as ``vecs``, ``weights``, ``tail`` and ``rho``.

Arrays keep their dtype; indices become int64.  The factors of a
budgeted build carry their per-level prefix masks as ``rank_mask/<l>``.

An LM's parameters carry across as the reference's own tree, nested dicts
of arrays (``embed``, ``blocks`` stacked on a leading layer axis,
``final_norm``, ``head`` and, for hybrid, ``shared``), through
:func:`lm_params_from_arrays`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.configs.base import ArchConfig
from repro_torch.core.gp import HCKGaussianProcess
from repro_torch.core.hck import HCKFactors, SweepPlan
from repro_torch.core.hmatrix import InverseFactors
from repro_torch.core.kernels_fn import BaseKernel
from repro_torch.core.kpca import KPCAModel
from repro_torch.core.krr import ExactKRR, HCKRegressor, KRRPath
from repro_torch.core.oos import OOSPlan
from repro_torch.core.partition import PartitionTree
from repro_torch.kernels.registry import SolveConfig
from repro_torch.solvers.eigenpro import EigenProPrecond


def _tensor(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    a = np.array(a, dtype=np.int64 if a.dtype.kind in "iu" else a.dtype,
                 order="C")                       # a writable copy
    return torch.from_numpy(a).to(dev)


def _stack(arrays: dict, field: str, count: int, dev) -> tuple:
    try:
        return tuple(_tensor(arrays[f"{field}/{i}"], dev) for i in range(count))
    except KeyError as e:
        raise KeyError(f"model arrays lack {e.args[0]!r}") from None


def _levels(arrays: dict) -> int:
    levels = 0
    while f"directions/{levels}" in arrays:
        levels += 1
    return levels


def _tree(arrays: dict, levels: int, dev) -> PartitionTree:
    return PartitionTree(_tensor(arrays["perm"], dev),
                         _stack(arrays, "directions", levels, dev),
                         _stack(arrays, "thresholds", levels, dev))


def factors_from_arrays(arrays: dict, device=None) -> HCKFactors:
    """The port's :class:`HCKFactors` from the reference's arrays (with
    ``rank_mask/<l>`` for a budgeted build)."""
    dev = _device.resolve(device)
    levels = _levels(arrays)
    rank_mask = (_stack(arrays, "rank_mask", levels, dev)
                 if "rank_mask/0" in arrays else None)
    return HCKFactors(
        x_sorted=_tensor(arrays["x_sorted"], dev),
        tree=_tree(arrays, levels, dev),
        landmarks=_stack(arrays, "landmarks", levels, dev),
        sigma=_stack(arrays, "sigma", levels, dev),
        sigma_cho=_stack(arrays, "sigma_cho", levels, dev),
        w=_stack(arrays, "w", max(levels - 1, 0), dev),
        u=_tensor(arrays["u"], dev), adiag=_tensor(arrays["adiag"], dev),
        rank_mask=rank_mask)


def plan_from_arrays(arrays: dict, device=None) -> OOSPlan:
    """The port's :class:`OOSPlan` from the reference's ``plan.*`` arrays."""
    dev = _device.resolve(device)
    levels = _levels(arrays)
    c_tilde = arrays.get("plan.c_tilde")
    return OOSPlan(_stack(arrays, "plan.c", levels, dev),
                   _tensor(arrays["plan.w_leaf"], dev),
                   None if c_tilde is None else _tensor(c_tilde, dev))


def inverse_from_arrays(arrays: dict, device=None) -> InverseFactors | None:
    """The port's :class:`InverseFactors` from the reference's
    ``inverse.*`` arrays, or None when the arrays carry no inverse."""
    if "inverse.adiag" not in arrays:
        return None
    dev = _device.resolve(device)
    levels = _levels(arrays)
    linv = arrays.get("inverse.linv")
    return InverseFactors(
        _tensor(arrays["inverse.adiag"], dev), _tensor(arrays["inverse.u"], dev),
        _stack(arrays, "inverse.sigma", levels, dev),
        _stack(arrays, "inverse.w", max(levels - 1, 0), dev),
        _tensor(arrays["inverse.logabsdet"], dev),
        None if linv is None else _tensor(linv, dev))


def regressor_from_arrays(arrays: dict, *, kernel: str, sigma: float,
                          jitter: float, squeeze: bool = False,
                          solve_config: SolveConfig | None = None,
                          lam: float | None = None,
                          device=None) -> HCKRegressor:
    """The port's :class:`HCKRegressor` on ``device`` (default the card).

    ``kernel``, ``sigma`` and ``jitter`` are the reference's
    ``BaseKernel`` fields; ``squeeze`` its flag for 1-D regression
    targets; ``lam`` the fit's ridge.
    """
    dev = _device.resolve(device)
    classes = arrays.get("classes")
    leaf_lo = arrays.get("leaf_lo")
    factors = factors_from_arrays(arrays, dev)
    inverse = inverse_from_arrays(arrays, dev)
    return HCKRegressor(
        BaseKernel(kernel, sigma=sigma, jitter=jitter), factors,
        plan_from_arrays(arrays, dev), _tensor(arrays["alpha"], dev),
        None if classes is None else _tensor(classes, dev),
        squeeze=squeeze, solve_config=solve_config, lam=lam,
        base_leaf_size=None if inverse is None else factors.leaf_size,
        inverse=inverse,
        leaf_lo=None if leaf_lo is None else _tensor(leaf_lo, dev))


def sweep_plan_from_arrays(arrays: dict, *, metric: str,
                           device=None) -> SweepPlan:
    """The port's :class:`SweepPlan` from the reference plan's arrays;
    ``metric`` is the plan's ("l2" or "l1")."""
    dev = _device.resolve(device)
    levels = _levels(arrays)
    return SweepPlan(
        _tensor(arrays["x_sorted"], dev), _tree(arrays, levels, dev),
        _stack(arrays, "landmarks", levels, dev),
        _stack(arrays, "lm_self", levels, dev),
        _stack(arrays, "lm_cross", levels - 1, dev),
        _tensor(arrays["leaf_self"], dev), _tensor(arrays["leaf_cross"], dev),
        metric=metric)


def path_from_arrays(arrays: dict, *, kernel: str, sigma: float,
                     jitter: float, squeeze: bool = False,
                     solve_config: SolveConfig | None = None,
                     device=None) -> KRRPath:
    """The port's :class:`KRRPath` from the reference path's arrays."""
    dev = _device.resolve(device)
    opt = {key: None if key not in arrays else _tensor(arrays[key], dev)
           for key in ("scores", "classes")}
    return KRRPath(BaseKernel(kernel, sigma=sigma, jitter=jitter),
                   factors_from_arrays(arrays, dev),
                   _tensor(arrays["lams"], dev), _tensor(arrays["alphas"], dev),
                   opt["scores"], opt["classes"], squeeze=squeeze,
                   solve_config=solve_config)


def gp_from_arrays(arrays: dict, *, kernel: str, sigma: float, jitter: float,
                   noise: float, solve_config: SolveConfig | None = None,
                   device=None) -> HCKGaussianProcess:
    """The port's :class:`HCKGaussianProcess` from the reference GP's
    arrays (its structured inverse under ``inverse.*``)."""
    dev = _device.resolve(device)
    inverse = inverse_from_arrays(arrays, dev)
    if inverse is None:
        raise KeyError("model arrays lack 'inverse.adiag'")
    return HCKGaussianProcess(
        BaseKernel(kernel, sigma=sigma, jitter=jitter),
        factors_from_arrays(arrays, dev), inverse,
        _tensor(arrays["alpha"], dev), plan_from_arrays(arrays, dev), noise,
        solve_config)


def kpca_from_arrays(arrays: dict, *, kernel: str, sigma: float,
                     jitter: float, solve_config: SolveConfig | None = None,
                     device=None) -> KPCAModel:
    """The port's :class:`KPCAModel` from the reference model's arrays."""
    dev = _device.resolve(device)
    return KPCAModel(
        BaseKernel(kernel, sigma=sigma, jitter=jitter),
        factors_from_arrays(arrays, dev), *(
            _tensor(arrays[key], dev)
            for key in ("embedding", "evals", "v1", "a0")),
        solve_config=solve_config)


def exact_krr_from_arrays(arrays: dict, *, kernel: str, sigma: float,
                          jitter: float, lam: float, squeeze: bool = False,
                          solve_config: SolveConfig | None = None,
                          row_chunk: int = 1024, device=None) -> ExactKRR:
    """The port's :class:`ExactKRR` from the reference model's ``x``,
    ``alpha`` and optional ``classes``; it carries no solver trace
    (``result`` is None)."""
    dev = _device.resolve(device)
    classes = arrays.get("classes")
    return ExactKRR(BaseKernel(kernel, sigma=sigma, jitter=jitter),
                    _tensor(arrays["x"], dev), _tensor(arrays["alpha"], dev),
                    lam, None,
                    None if classes is None else _tensor(classes, dev),
                    squeeze=squeeze, solve_config=solve_config,
                    row_chunk=row_chunk)


def eigenpro_from_arrays(arrays: dict, device=None) -> EigenProPrecond:
    """The port's :class:`EigenProPrecond` from the reference's ``vecs``
    (its ``u``), ``weights``, ``tail`` and ``rho``."""
    dev = _device.resolve(device)
    return EigenProPrecond(*(_tensor(arrays[key], dev)
                             for key in ("vecs", "weights", "tail", "rho")))


def lm_params_from_arrays(arrays: dict, *, cfg: ArchConfig,
                          device=None) -> dict:
    """The port's LM parameters from the reference's parameter tree, each
    array checked against :func:`repro_torch.models.transformer.param_defs`
    and cast to ``cfg.dtype`` (bfloat16 arrays, which numpy keeps as
    ``ml_dtypes``, pass through float32)."""
    from repro_torch.models.transformer import param_defs

    dev = _device.resolve(device)
    dtype = getattr(torch, cfg.dtype)

    def conv(defs, tree, path):
        missing = set(defs) - set(tree)
        extra = set(tree) - set(defs)
        if missing or extra:
            raise KeyError(f"parameter tree at {path or '<root>'}: missing "
                           f"{sorted(missing)}, unexpected {sorted(extra)}")
        out = {}
        for key, pd in defs.items():
            name = f"{path}/{key}" if path else key
            if isinstance(pd, dict):
                out[key] = conv(pd, tree[key], name)
                continue
            a = np.asarray(tree[key])
            if tuple(a.shape) != tuple(pd.shape):
                raise ValueError(f"parameter {name}: shape {a.shape}, "
                                 f"expected {pd.shape}")
            if a.dtype.kind != "f" or a.dtype.itemsize < 4:
                a = a.astype(np.float32)
            out[key] = torch.from_numpy(np.array(a, order="C")).to(
                device=dev, dtype=dtype)
        return out

    return conv(param_defs(cfg), arrays, "")
