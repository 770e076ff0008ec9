"""Per-stage roofline of the port (counterpart of the per-stage half of
``repro.utils.roofline``).

:func:`stage_cost` gives closed-form flop and byte counts of one launch of
each registry stage, with the reference's stage names and formulas; the
autotuner (:mod:`repro_torch.kernels.autotune`) turns measured stage times
into achieved FLOP/s and bytes/s with it, and :func:`stage_roofline` sets
a measured time against the device model of :func:`hw_model`.

:data:`HW_MODELS` holds one row a coarse device kind: "gpu" is the NVIDIA
H100 SXM of the data sheet (3.35 TB/s HBM3, 495 TFLOP/s dense TF32, the
fastest rate any float32-data stage of the port uses, NVLink 450 GB/s each
way), "cpu" a deliberately rough server-class host so that achieved
fractions stay finite in the CPU tests (not a precision model).  With
``calibrate`` and a tile database holding measurements on this device
kind, :func:`hw_model` replaces the peaks by the best rates measured.

The reference's parsing of compiled HLO (``collective_bytes``,
``RooflineTerms``) has no counterpart here: the port compiles no HLO
(ROADMAP A16b, ``launch/dryrun.py``).
"""
from __future__ import annotations

#: nominal peak-rate models per coarse device kind (see the module note)
HW_MODELS = {
    "gpu": {"peak_flops": 495e12, "hbm_bw": 3.35e12, "link_bw": 450e9},
    "cpu": {"peak_flops": 2e11, "hbm_bw": 3e10, "link_bw": 1e10},
}


def model_flops(param_count: int, tokens: int, kind: str) -> float:
    """MODEL_FLOPS = 6 N D for training, 2 N D for an inference forward."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * param_count * tokens


def default_device_kind() -> str:
    """Coarse device kind the port runs on by default: "gpu" where torch
    sees a CUDA card, else "cpu"."""
    import torch

    try:
        return "gpu" if torch.cuda.is_available() else "cpu"
    except Exception:   # noqa: BLE001 -- a broken install: no card
        return "cpu"


def hw_model(device_kind: str | None = None, *,
             calibrate: bool = True) -> dict:
    """Peak-rate model for one coarse device kind.

    Starts from the nominal :data:`HW_MODELS` row and, when ``calibrate``
    and the autotune tile database holds measurements on this device kind,
    replaces the peaks by the best measured rates (floored at a thousandth
    of the nominal ones), so rooflines compare stages to what this machine
    sustains.  ``"calibration"`` says which source won.
    """
    kind = device_kind or default_device_kind()
    model = dict(HW_MODELS.get(kind, HW_MODELS["cpu"]))
    model["device_kind"] = kind
    model["calibration"] = "nominal"
    if calibrate:
        try:
            from repro_torch.kernels import autotune

            peaks = autotune.calibrated_peaks(kind)
        except Exception:   # noqa: BLE001 -- no database: nominal
            peaks = None
        if peaks:
            if peaks.get("flops_per_s"):
                model["peak_flops"] = max(model["peak_flops"] / 1e3,
                                          peaks["flops_per_s"])
            if peaks.get("bytes_per_s"):
                model["hbm_bw"] = max(model["hbm_bw"] / 1e3,
                                      peaks["bytes_per_s"])
            model["calibration"] = "measured (tile_db)"
    return model


def stage_cost(stage: str, *, batch: int = 1, n0: int, r: int = 0,
               k: int = 1, d: int = 0,
               itemsize: int = 4) -> tuple[float, float]:
    """Closed-form (flops, bytes) of one launch of ``stage``.

    ``n0`` is the leaf, node or contraction size, ``r`` the rank (or the
    second extent), ``k`` the right-hand sides, ``d`` the ambient
    dimension, ``batch`` the leaves, nodes, queries or rows the launch
    covers.  A kernel-evaluation epilogue counts 5 flops an element.  These
    are algorithmic minima (recomputation inside a tiled kernel is not
    charged), so achieved fractions from them are conservative.
    """
    epi = 5.0
    if stage == "leaf_matvec":
        f = 2.0 * n0 * n0 * k + 2.0 * n0 * r * k
        b = n0 * n0 + n0 * r + n0 * k * 2 + r * k
    elif stage == "leaf_solve":
        f = 4.0 * n0 * n0 * k + 4.0 * n0 * r * k + 2.0 * r * r * k
        b = n0 * n0 + n0 * r + r * r + n0 * k * 2 + r * k
    elif stage == "leaf_project":
        f = 2.0 * n0 * r * k
        b = n0 * r + n0 * k + r * k
    elif stage == "leaf_factor":
        f = (2.0 / 3.0) * n0 ** 3
        b = 3.0 * n0 * n0
    elif stage == "build_gram":
        f = 2.0 * n0 * n0 * d + epi * n0 * n0 + n0 ** 3 / 3.0
        b = n0 * d + 2.0 * n0 * n0
    elif stage == "build_gram_dist":
        f = epi * n0 * n0 + n0 ** 3 / 3.0
        b = 3.0 * n0 * n0
    elif stage == "build_cross":
        f = 2.0 * n0 * r * d + epi * n0 * r + 4.0 * n0 * r * r
        b = n0 * d + r * d + r * r + n0 * r
    elif stage == "build_cross_dist":
        f = epi * n0 * r + 4.0 * n0 * r * r
        b = 2.0 * n0 * r + r * r
    elif stage in ("oos_local", "oos_walk"):
        f = 2.0 * n0 * d + epi * n0 + 2.0 * n0 * k
        b = n0 * (d + k) + d + k
    elif stage == "kernel_matvec":
        f = 2.0 * n0 * r * d + epi * n0 * r + 2.0 * n0 * r * k
        b = n0 * d + r * d + r * k + n0 * k
    elif stage == "pairwise_kernel":
        f = 2.0 * n0 * r * d + epi * n0 * r
        b = n0 * d + r * d + n0 * r
    else:
        raise ValueError(f"no cost model for stage {stage!r}")
    return batch * f, batch * b * float(itemsize)


def stage_roofline(stage: str, measured_s: float, *, batch: int = 1,
                   n0: int, r: int = 0, k: int = 1, d: int = 0,
                   itemsize: int = 4, hw: dict | None = None) -> dict:
    """Roofline record of one measured stage time: flops and bytes
    (:func:`stage_cost`), the ideal time under ``hw`` (the larger of the
    compute and memory terms), which term binds, the achieved fraction of
    that ideal and the achieved GFLOP/s and GB/s."""
    hw = hw or hw_model()
    flops, nbytes = stage_cost(stage, batch=batch, n0=n0, r=r, k=k, d=d,
                               itemsize=itemsize)
    compute_s = flops / hw["peak_flops"]
    memory_s = nbytes / hw["hbm_bw"]
    ideal_s = max(compute_s, memory_s)
    measured_s = max(float(measured_s), 1e-12)
    return {
        "stage": stage,
        "flops": flops,
        "bytes": nbytes,
        "intensity": flops / max(nbytes, 1.0),
        "compute_s": compute_s,
        "memory_s": memory_s,
        "ideal_s": ideal_s,
        "measured_s": measured_s,
        "bound": "compute" if compute_s >= memory_s else "memory",
        "achieved_frac": ideal_s / measured_s,
        "achieved_gflops": flops / measured_s / 1e9,
        "achieved_gbps": nbytes / measured_s / 1e9,
    }
