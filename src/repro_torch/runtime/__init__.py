"""Runtime robustness layer of the port (counterpart of ``repro.runtime``):
health probes at stage boundaries (:mod:`repro_torch.runtime.health`) and
the detect-recover ladders around the numerical entry points
(:mod:`repro_torch.runtime.recover`)."""
from repro_torch.runtime.health import NumericalFailure, checks_enabled  # noqa: F401
