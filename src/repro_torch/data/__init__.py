"""Data substrate: synthetic corpora, entity recognition, tokenizer and
the packed LM batches of training."""
from .datasets import SyntheticCorpus, hospital_corpus, unhcr_corpus
from .ner import build_gazetteer, recognize_entities
from .pipeline import PackedBatches, PipelineState, TextDataset
from .tokenizer import HashTokenizer

__all__ = ["SyntheticCorpus", "hospital_corpus", "unhcr_corpus",
           "build_gazetteer", "recognize_entities", "HashTokenizer",
           "PackedBatches", "PipelineState", "TextDataset"]
