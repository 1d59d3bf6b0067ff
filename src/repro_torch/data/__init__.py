"""Data substrate: synthetic corpora and entity recognition."""
from .datasets import SyntheticCorpus, hospital_corpus, unhcr_corpus
from .ner import build_gazetteer, recognize_entities

__all__ = ["SyntheticCorpus", "hospital_corpus", "unhcr_corpus",
           "build_gazetteer", "recognize_entities"]
