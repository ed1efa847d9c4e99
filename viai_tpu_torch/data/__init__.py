"""Data of the port: the synthetic corpus, the folder datasets (wav,
npy and AVI frames, musices manifests), the loader and the prefetch to
the device."""

from .audio import AudioFolderDataset, find_wavs, load_wav
from .av import AVFolderDataset, MusicesManifest, load_frames_for
from .loader import (FOLDER_MODES, SYNTHETIC_MODES, InOrderLoader,
                     NativeAudioIterator, create_dataloader)
from .prefetch import device_prefetch
from .synthetic import (AV_CUE_GAP, SyntheticAVDataset,
                        SyntheticBatchIterator, SyntheticConfig)

__all__ = ["create_dataloader", "InOrderLoader", "SYNTHETIC_MODES",
           "FOLDER_MODES", "NativeAudioIterator", "SyntheticConfig",
           "SyntheticAVDataset", "SyntheticBatchIterator", "AV_CUE_GAP",
           "AudioFolderDataset", "AVFolderDataset", "MusicesManifest",
           "find_wavs", "load_wav", "load_frames_for", "device_prefetch"]
