"""Serving: batched KV-cache decode and retrieval-augmented serving (RAG)
over the port's `JasperIndex` (PyTorch port of the matching half of
`repro.serving`)."""

from repro_torch.serving.rag import RagPipeline
from repro_torch.serving.serve_loop import generate, make_serve_step

__all__ = ["generate", "make_serve_step", "RagPipeline"]
