"""LAPS scheduling core, copied unchanged from ``repro.core``.

boundary — §2.1 compute/memory boundary latency model + runtime fitting
buckets  — §3.1 token / decode bucket ladders
awd      — Algorithm 1 Adaptive-Wait-Depth batching
queues   — §3.2 dual-queue LP/SP classification
scheduler— §3.2 temporal/spatial policies + serving modes + ablations
slo      — TTFT/violation metrics
"""
from repro_torch.core.boundary import LatencyModel, fit, roofline_boundary, H200_QWEN32B  # noqa: F401
from repro_torch.core.buckets import Bucket, BucketGrid  # noqa: F401
from repro_torch.core.awd import AWDConfig, AWDScheduler  # noqa: F401
from repro_torch.core.queues import DualQueue  # noqa: F401
from repro_torch.core.request import Batch, Request  # noqa: F401
from repro_torch.core.scheduler import (ServingMode, Variant, make_policy,  # noqa: F401
                                        TemporalDisaggPolicy, FCFSPolicy, PoolPolicy,
                                        ChunkWork)
from repro_torch.core.slo import SLOTracker, SLOReport, percentile  # noqa: F401
