"""Serving: the retrieval session, the generation engine and the
bank-mode RAG pipeline."""
from .engine import Request, RetrievalSession, ServeEngine, kv_cache_bytes
from .rag import RAGAnswer, RAGPipeline

__all__ = ["Request", "RetrievalSession", "ServeEngine", "kv_cache_bytes",
           "RAGAnswer", "RAGPipeline"]
