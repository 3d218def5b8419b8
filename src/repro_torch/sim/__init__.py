"""Analytic cost model of the port, copied unchanged from ``repro.sim``
(the simulator and its workloads are not ported yet: ROADMAP item 15)."""
from repro_torch.sim.costmodel import CostModel, H200_32B, H200_14B, H200_7B  # noqa: F401
