"""Host-side data helpers of the serving path (counterpart of
``dvc_tpu/data``): the feature rescale and the vocabulary ``Translator``.
Neither imports the ``dvc_tpu`` package."""

from .dataset import resize_feature
from .vocabulary import Translator

__all__ = ['Translator', 'resize_feature']
