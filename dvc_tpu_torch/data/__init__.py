"""Host-side data of the port (counterpart of ``dvc_tpu/data``, numpy
only): feature reading and rescale, the caption datasets and their static
collation, and the vocabulary ``Translator``."""

from .dataset import DenseCaptionDataset, collate, resize_feature
from .fusion_dataset import FusionBatchLoader, FusionDataset, fusion_collate
from .vocabulary import Translator

__all__ = ['DenseCaptionDataset', 'FusionBatchLoader', 'FusionDataset',
           'Translator', 'collate', 'fusion_collate', 'resize_feature']
