"""Resilience subsystem of the port: fault injection (``faults``, numpy
host paths) and admission control, circuit breaking and retry
(``policies``, torch). ``faults`` is imported by its callers
(``from repro_torch.resilience import faults``), as in the reference."""
from repro_torch.resilience.policies import (ResilienceConfig, admission_mask,
                                             breaker_step, dispatch_mask,
                                             est_response, nearest_alive,
                                             probe_cap)

__all__ = [
    "ResilienceConfig", "admission_mask", "breaker_step", "dispatch_mask",
    "est_response", "nearest_alive", "probe_cap",
]
