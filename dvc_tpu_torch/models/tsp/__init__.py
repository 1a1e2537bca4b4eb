"""TSP video backbones, their training loss and feature extraction of the
port (counterpart of ``dvc_tpu/models/tsp``)."""

from .backbones import (MViTBlockSpec, MViTConfig, MViTV2, VideoResNet,
                        mvit_block_specs, mvit_v2_s, r2plus1d_18,
                        r2plus1d_34, r3d_18)
from .convert import (TSPWeights, load_tsp_weights, tsp_from_jax_params,
                      tsp_momentum_from_jax, tsp_weights)
from .extractor import FeatureExtractor
from .model import (BACKBONES, TSPModel, make_backbone, make_tsp_model,
                    tsp_cross_entropy)

__all__ = ['BACKBONES', 'FeatureExtractor', 'MViTBlockSpec', 'MViTConfig',
           'MViTV2', 'TSPModel', 'TSPWeights', 'VideoResNet',
           'load_tsp_weights', 'make_backbone', 'make_tsp_model',
           'mvit_block_specs', 'mvit_v2_s', 'r2plus1d_18', 'r2plus1d_34',
           'r3d_18', 'tsp_cross_entropy', 'tsp_from_jax_params',
           'tsp_momentum_from_jax', 'tsp_weights']
