"""Fault injection for the port's runtime (the seeded plane only)."""
from repro_torch.ft.inject import FaultPlane, FaultSpec, InjectedFault

__all__ = ["FaultPlane", "FaultSpec", "InjectedFault"]
