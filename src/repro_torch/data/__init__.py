"""Data substrate: synthetic corpora, entity recognition, tokenizer."""
from .datasets import SyntheticCorpus, hospital_corpus, unhcr_corpus
from .ner import build_gazetteer, recognize_entities
from .tokenizer import HashTokenizer

__all__ = ["SyntheticCorpus", "hospital_corpus", "unhcr_corpus",
           "build_gazetteer", "recognize_entities", "HashTokenizer"]
