"""Serving: the retrieval session and the bank-mode RAG pipeline."""
from .engine import RetrievalSession
from .rag import RAGAnswer, RAGPipeline

__all__ = ["RetrievalSession", "RAGAnswer", "RAGPipeline"]
