"""Serving: batched KV-cache decode, retrieval-augmented serving (RAG),
the online ANNS update/serve loop (insert/delete/search over one
JasperIndex with generation-stamped results), and the standing-query
scheduler front-end (shape-bucketed coalescing + deadline-aware dispatch
over open-loop traffic, with seeded Poisson/bursty load generation) —
the PyTorch port of `repro.serving`."""

from repro_torch.serving.anns_service import (
    AnnsService,
    SearchTicket,
    ServiceStats,
    StepResult,
)
from repro_torch.serving.loadgen import Arrival, bursty_trace, poisson_trace
from repro_torch.serving.rag import RagPipeline
from repro_torch.serving.scheduler import (
    QueryHandle,
    SchedulerConfig,
    SchedulerStats,
    StandingQueryScheduler,
    summarize_handles,
)
from repro_torch.serving.serve_loop import generate, make_serve_step

__all__ = ["generate", "make_serve_step", "RagPipeline",
           "AnnsService", "SearchTicket", "ServiceStats", "StepResult",
           "Arrival", "poisson_trace", "bursty_trace",
           "QueryHandle", "SchedulerConfig", "SchedulerStats",
           "StandingQueryScheduler", "summarize_handles"]
