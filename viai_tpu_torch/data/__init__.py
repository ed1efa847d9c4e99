"""Data of the port: the synthetic corpus and its loader."""

from .loader import SYNTHETIC_MODES, InOrderLoader, create_dataloader
from .synthetic import (AV_CUE_GAP, SyntheticAVDataset,
                        SyntheticBatchIterator, SyntheticConfig)

__all__ = ["create_dataloader", "InOrderLoader", "SYNTHETIC_MODES",
           "SyntheticConfig", "SyntheticAVDataset", "SyntheticBatchIterator",
           "AV_CUE_GAP"]
