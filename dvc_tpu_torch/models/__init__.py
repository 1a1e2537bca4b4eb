from .caption_heads import LightCaptionHead
from .convert import from_jax_params, pdvc_from_jax_params
from .fusion import FusionPDVC, make_fusion_model
from .pdvc import PDVC, PDVCConfig, make_pdvc_model
from .postprocess import postprocess, to_dvc_records

__all__ = ['FusionPDVC', 'LightCaptionHead', 'PDVC', 'PDVCConfig',
           'from_jax_params', 'make_fusion_model', 'make_pdvc_model',
           'pdvc_from_jax_params', 'postprocess', 'to_dvc_records']
