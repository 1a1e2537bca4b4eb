"""Host-side data of the port (counterpart of ``dvc_tpu/data``): feature
reading and rescale (through the native library, ``native_io``), the
caption datasets and their static collation, HuBERT sound features
(``audio``), the vocabulary ``Translator``, and the prefetching
loaders."""

from .dataset import (BatchLoader, DenseCaptionDataset, collate,
                      resize_feature)
from .fusion_dataset import FusionBatchLoader, FusionDataset, fusion_collate
from .prefetch import DevicePrefetchLoader, PrefetchLoader
from .vocabulary import Translator

__all__ = ['BatchLoader', 'DenseCaptionDataset', 'DevicePrefetchLoader', 'FusionBatchLoader',
           'FusionDataset', 'PrefetchLoader', 'Translator', 'collate',
           'fusion_collate', 'resize_feature']
