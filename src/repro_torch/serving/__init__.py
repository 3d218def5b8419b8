"""Serving stack of the port: paged KV arena, executors, engine, loop."""
from repro_torch.serving.kvcache import KVArena, PagedKVArena  # noqa: F401
from repro_torch.serving.packing import (SegmentSpec,  # noqa: F401
                                         MixedStream, assemble_mixed_stream,
                                         fit_decodes, DecodeRows,
                                         pad_decode_rows)
from repro_torch.serving.executor import (BucketExecutor,  # noqa: F401
                                          DecodeBucketExecutor,
                                          PackedBucketExecutor)
from repro_torch.serving.sampling import SamplingParams, GREEDY  # noqa: F401
from repro_torch.serving.draft import (DraftProposer,  # noqa: F401
                                       NGramDraft, ScriptedDraft,
                                       SmallModelDraft)
from repro_torch.serving.engine import (Engine, EngineConfig,  # noqa: F401
                                        MixedStepResult)
from repro_torch.serving.loop import PendingRequest, ServeLoop  # noqa: F401
