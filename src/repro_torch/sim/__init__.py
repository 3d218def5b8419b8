"""Analytic cost model, discrete-event simulator and workloads of the port,
copied unchanged from ``repro.sim``."""
from repro_torch.sim.costmodel import CostModel, H200_32B, H200_14B, H200_7B  # noqa: F401
from repro_torch.sim.simulator import ClusterSim, SimConfig  # noqa: F401
from repro_torch.sim.workload import (WorkloadConfig,  # noqa: F401
                                      lmsys_like_requests,
                                      closed_loop_clients, length_stats)
