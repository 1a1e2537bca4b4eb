from .convert import from_jax_params
from .fusion import FusionPDVC, make_fusion_model
from .pdvc import PDVC, PDVCConfig
from .postprocess import postprocess, to_dvc_records

__all__ = ['FusionPDVC', 'PDVC', 'PDVCConfig', 'from_jax_params',
           'make_fusion_model', 'postprocess', 'to_dvc_records']
