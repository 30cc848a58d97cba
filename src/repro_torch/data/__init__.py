"""Data substrate: synthetic corpora and batch iterators."""

from .pipeline import DataConfig, SyntheticCorpus, batches_for_model, token_batches

__all__ = ["DataConfig", "SyntheticCorpus", "batches_for_model",
           "token_batches"]
