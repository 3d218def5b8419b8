"""LAPS scheduling core, copied unchanged from ``repro.core``.

boundary — §2.1 compute/memory boundary latency model + runtime fitting
queueing — §2.2 M/G/1 P-K interference analysis (HoL penalty)
buckets  — §3.1 token / decode bucket ladders
awd      — Algorithm 1 Adaptive-Wait-Depth batching
queues   — §3.2 dual-queue LP/SP classification
scheduler— §3.2 temporal/spatial policies + serving modes + ablations
controller — Algorithm 2 instance-pressure controller
slo      — TTFT/violation metrics
routing  — §3 cluster routers over engine snapshots (spatial mode)
faults   — §11 deterministic chaos injection (FaultPlan/FaultInjector)
"""
from repro_torch.core.boundary import LatencyModel, fit, roofline_boundary, H200_QWEN32B  # noqa: F401
from repro_torch.core.buckets import Bucket, BucketGrid  # noqa: F401
from repro_torch.core.awd import AWDConfig, AWDScheduler  # noqa: F401
from repro_torch.core.queues import DualQueue  # noqa: F401
from repro_torch.core.controller import (ControllerConfig,  # noqa: F401
                                         InstanceStats, Migration,
                                         PressureController)
from repro_torch.core.request import Batch, Request  # noqa: F401
from repro_torch.core.scheduler import (ServingMode, Variant, make_policy,  # noqa: F401
                                        TemporalDisaggPolicy, FCFSPolicy, PoolPolicy,
                                        ChunkWork)
from repro_torch.core.routing import (EngineView,  # noqa: F401
                                      LeastLoadedRouter, LengthAwareRouter,
                                      RoundRobinRouter, RouteRequest, Router,
                                      make_router)
from repro_torch.core.slo import SLOTracker, SLOReport, percentile  # noqa: F401
from repro_torch.core.faults import (FaultEvent, FaultInjector,  # noqa: F401
                                     FaultPlan)
from repro_torch.core import queueing  # noqa: F401
