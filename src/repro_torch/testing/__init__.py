"""Test-support tooling shipped with the port (counterpart of
``repro.testing``): :mod:`repro_torch.testing.faultinject` makes every
fault class the health layer claims to detect and recover, against real
factors, solvers and serving objects."""
