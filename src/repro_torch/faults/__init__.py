"""Fault handling of the port: bounded retry (`repro_torch.faults.retry`).
The fault plane itself (plans, runner, corrupt-wire injection) is not
ported yet (ROADMAP.md)."""
