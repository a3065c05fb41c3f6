"""``repro_torch.serve`` — the continuous-batching conv serving subsystem.

The counterpart of the JAX package's ``repro.serve``: heterogeneous
request shapes map onto a small set of warm ``ConvSpec`` buckets
(``bucketing``), admission + continuous batching fold concurrent requests
into one launch of the fused kernel (``batcher``, ``engine``), every
latency lands in streaming histograms with per-class SLO attainment
(``metrics``), and an open-loop synthetic traffic generator drives it
(``traffic``).  The LM path's continuous-batching decode loop is
``slots.SlotLoop``, which ``repro_torch.launch.serve`` drives.

    table = BucketTable.for_workload([(28, 28), (56, 56)], kernel_size=3,
                                     in_channels=256, out_channels=256,
                                     quant=INT8_FREQ)
    eng = Engine(w, table, backend="cuda", algo="sfc6_6", device="cuda")
    futs = [eng.submit(x) for x in images]     # (h, w, C) each
    while eng.step():                          # or start() / drain()
        pass
    ys = [r.y for r in results(futs)]
"""
from repro_torch.serve.batcher import (EDF, FCFS, AdmissionPolicy, Batch,
                                       BatchQueue, SchedulerPolicy,
                                       fold_rows_per_step)
from repro_torch.serve.bucketing import Bucket, BucketTable
from repro_torch.serve.engine import Engine, results
from repro_torch.serve.metrics import LatencyHistogram, MetricsRegistry
from repro_torch.serve.slots import SlotLoop, SlotLoopStats
from repro_torch.serve.traffic import (PromptStream, ShapeMix, TrafficEvent,
                                       bursty_arrivals, default_shape_mix,
                                       poisson_arrivals, synthesize)
from repro_torch.serve.types import (BATCH, INTERACTIVE, SLO_CLASSES,
                                     QuarantinedError, Request,
                                     RejectedError, Result, ShedError,
                                     SLOClass)

__all__ = [
    "Engine", "results",
    "AdmissionPolicy", "Batch", "BatchQueue", "SchedulerPolicy",
    "FCFS", "EDF", "fold_rows_per_step",
    "Bucket", "BucketTable",
    "LatencyHistogram", "MetricsRegistry",
    "SlotLoop", "SlotLoopStats",
    "PromptStream", "ShapeMix", "TrafficEvent", "poisson_arrivals",
    "bursty_arrivals", "default_shape_mix", "synthesize",
    "Request", "Result", "RejectedError", "ShedError", "QuarantinedError",
    "SLOClass", "SLO_CLASSES", "INTERACTIVE", "BATCH",
]
