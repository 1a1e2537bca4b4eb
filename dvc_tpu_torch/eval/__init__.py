"""The evaluation stack of the port (counterpart of ``dvc_tpu/eval``): the
pure-Python caption scorers, the dense-captioning (2018/2021), SODA and
paragraph metrics, and the evaluation loop over the port's ``Trainer``."""

from .scorers import (Bleu, Cider, Meteor, Rouge, ptb_tokenize,
                      porter_stem, tokenize_dict)
from .dvc_eval import DVCEvaluator, eval_dvc, iou_1d
from .soda import SODAC, chased_dp_assignment, eval_soda
from .para_eval import ParaEvaluator, eval_para
from .eval_utils import (eval_metrics, evaluate, reranking, save_dvc_json)

__all__ = [
    "Bleu", "Cider", "Meteor", "Rouge", "ptb_tokenize", "porter_stem",
    "tokenize_dict", "DVCEvaluator", "eval_dvc", "iou_1d", "SODAC",
    "chased_dp_assignment", "eval_soda", "ParaEvaluator", "eval_para",
    "eval_metrics", "evaluate", "reranking", "save_dvc_json",
]
