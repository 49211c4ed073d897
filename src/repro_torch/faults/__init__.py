"""Chaos plane of the port: deterministic fault injection + graceful
degradation, the counterpart of ``repro.faults``.

  * :mod:`repro_torch.faults.plan`    — seeded, declarative
    :class:`FaultPlan` (crash / straggle / drop / corrupt / preempt events)
    lowered to per-round membership masks and corruption signals (the
    port's own copy of the reference's numpy module);
  * :mod:`repro_torch.faults.signals` — :class:`FaultSignals`, what the
    round consumes, and the deterministic bit-flip injector for the
    quantized wire (the reference's flip pattern, bit for bit);
  * :mod:`repro_torch.faults.runner`  — drives a `SwarmSession` through a
    plan (active-mask updates, EF quarantine on rejoin, preempt + restore);
  * :mod:`repro_torch.faults.retry`   — bounded retry/backoff/timeout for
    host-side I/O.
"""
from repro_torch.faults.plan import FaultEvent, FaultPlan, LoweredPlan
from repro_torch.faults.retry import RetryError, with_retry
from repro_torch.faults.runner import run_plan
from repro_torch.faults.signals import (FaultSignals, flip_payload_bits,
                                        idle_signals)

__all__ = [
    "FaultEvent", "FaultPlan", "LoweredPlan", "FaultSignals",
    "flip_payload_bits", "idle_signals", "RetryError", "with_retry",
    "run_plan",
]
