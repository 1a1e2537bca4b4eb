"""Config system of the port: the same flags, defaults and ``cfgs/*.yml``
surface as the JAX package's ``dvc_tpu/utils/config.py``.

The reference builds an argparse namespace of ~90 flags and overlays YAML
files with recursive single inheritance via ``base_cfg_path`` (reference
``opts.py:7-221``).  This is the port's own copy (standard library and
``yaml`` only), so that a recipe resolves to the same option dict in both
packages; ``tests/test_torch_config.py`` compares the two key by key.
The one difference: ``--device`` names the port's device (``cuda`` by
default, or ``cpu``).
"""

from __future__ import annotations

import argparse
import copy
import math
import os
import time
from typing import Any

import yaml


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    add = p.add_argument

    # configure of this run (reference opts.py:11-19)
    add('--cfg_path', type=str, default=None, help='config file')
    add('--id', type=str, default='')
    add('--gpu_id', type=str, nargs='+', default=[])  # accepted, unused
    add('--disable_tqdm', action='store_true')
    add('--seed', type=int, default=777)
    add('--random_seed', action='store_true')
    add('--disable_cudnn', type=int, default=0)      # accepted, unused
    add('--debug', action='store_true')
    add('--device', default='cuda', choices=['cpu', 'cuda'])

    # input data path (opts.py:22-40)
    add('--train_caption_file', type=str,
        default='data/anet/captiondata/train_modified.json')
    add('--invalid_video_json', type=str, nargs='+', default=[])
    add('--val_caption_file', type=str,
        default='data/anet/captiondata/val_1.json')
    add('--visual_feature_folder', type=str, default='data/anet/resnet_bn')
    add('--gt_file_for_auc', type=str, nargs='+',
        default='data/anet/captiondata/val_all.json')
    add('--gt_file_for_eval', type=str, nargs='+',
        default=['data/anet/captiondata/val_1.json',
                 'data/anet/captiondata/val_2.json'])
    add('--gt_file_for_para_eval', type=str, nargs='+',
        default=['data/anet/captiondata/para/anet_entities_val_1_para.json',
                 'data/anet/captiondata/para/anet_entities_val_2_para.json'])
    add('--dict_file', type=str,
        default='data/anet/vocabulary_activitynet.json')
    add('--criteria_for_best_ckpt', type=str, default='dvc',
        choices=['dvc', 'pc'])
    add('--visual_feature_type', type=str, default='c3d')
    add('--feature_dim', type=int, default=500)
    add('--start_from', type=str, default='')
    add('--start_from_mode', type=str, choices=['best', 'last'], default='last')
    add('--pretrain', type=str, choices=['full', 'encoder', 'decoder'],
        default=None)
    add('--pretrain_path', type=str, default='')

    # dataloader (opts.py:43-52)
    add('--nthreads', type=int, default=4)
    add('--data_norm', type=int, default=0)
    add('--data_rescale', type=int, default=1)
    add('--feature_sample_rate', type=int, default=1)
    add('--train_proposal_sample_num', type=int, default=24)
    add('--gt_proposal_sample_num', type=int, default=10)

    # caption decoder (opts.py:56-68)
    add('--vocab_size', type=int, default=5747)
    add('--wordRNN_input_feats_type', type=str, default='C',
        choices=['C', 'E', 'C+E'])
    add('--caption_decoder_type', type=str, default='light',
        choices=['none', 'light', 'standard'])
    add('--rnn_size', type=int, default=512)
    add('--num_layers', type=int, default=1)
    add('--input_encoding_size', type=int, default=512)
    add('--att_hid_size', type=int, default=512)
    add('--drop_prob', type=float, default=0.5)
    add('--max_caption_len', type=int, default=30)

    # transformer (opts.py:71-97)
    add('--hidden_dim', type=int, default=512)
    add('--num_queries', type=int, default=100)
    add('--hidden_dropout_prob', type=float, default=0.5)
    add('--layer_norm_eps', type=float, default=1e-12)
    add('--caption_cost_type', type=str, default='loss')
    add('--set_cost_caption', type=float, default=0)
    add('--set_cost_class', type=float, default=1)
    add('--set_cost_bbox', type=float, default=5)
    add('--set_cost_giou', type=float, default=2)
    add('--cost_alpha', type=float, default=0.25)
    add('--cost_gamma', type=float, default=2)
    add('--bbox_loss_coef', default=5, type=float)
    add('--giou_loss_coef', default=2, type=float)
    add('--count_loss_coef', default=0, type=float)
    add('--caption_loss_coef', default=0, type=float)
    add('--eos_coef', default=0.1, type=float)
    add('--num_classes', type=int, default=1)
    add('--dec_layers', type=int, default=6)
    add('--enc_layers', type=int, default=6)
    add('--transformer_ff_dim', type=int, default=2048)
    add('--transformer_dropout_prob', type=float, default=0.1)
    add('--frame_embedding_num', type=int, default=100)
    add('--sample_method', type=str, default='nearest',
        choices=['nearest', 'linear'])
    add('--fix_xcw', type=int, default=0)

    # optimizer (opts.py:100-111)
    add('--training_scheme', type=str, default='all',
        choices=['cap_head_only', 'no_cap_head', 'all'])
    add('--epoch', type=int, default=30)
    add('--batch_size', type=int, default=1)
    add('--batch_size_for_eval', type=int, default=1)
    add('--grad_clip', type=float, default=100.)
    add('--optimizer_type', type=str, default='adam')
    add('--weight_decay', type=float, default=0)
    add('--lr', type=float, default=1e-4)
    add('--learning_rate_decay_start', type=float, default=8)
    add('--learning_rate_decay_every', type=float, default=3)
    add('--learning_rate_decay_rate', type=float, default=0.5)

    # saving / logging (opts.py:114-117)
    add('--min_epoch_when_save', type=int, default=-1)
    add('--save_checkpoint_every', type=int, default=1)
    add('--save_all_checkpoint', action='store_true')
    add('--save_dir', type=str, default='save')

    # deformable DETR (opts.py:120-153)
    add('--lr_backbone_names', default=["None"], type=str, nargs='+')
    add('--lr_backbone', default=2e-5, type=float)
    add('--lr_proj', default=0, type=int)
    add('--lr_linear_proj_names',
        default=['reference_points', 'sampling_offsets'], type=str, nargs='+')
    add('--lr_linear_proj_mult', default=0.1, type=float)
    add('--with_box_refine', default=False, action='store_true')
    add('--transformer_input_type', default='queries',
        choices=['gt_proposals', 'learnt_proposals', 'queries'])
    add('--backbone', default=None, type=str)
    add('--dilation', action='store_true')
    add('--position_embedding', default='sine', type=str,
        choices=('sine', 'learned'))
    add('--position_embedding_scale', default=2 * math.pi, type=float)
    add('--num_feature_levels', default=4, type=int)
    add('--nheads', default=8, type=int)
    add('--dec_n_points', default=4, type=int)
    add('--enc_n_points', default=4, type=int)
    add('--share_caption_head', type=int, default=1)
    add('--cap_nheads', default=8, type=int)
    add('--cap_dec_n_points', default=4, type=int)
    add('--cap_num_feature_levels', default=4, type=int)
    add('--disable_mid_caption_heads', action='store_true')

    # loss (opts.py:156-170)
    add('--no_aux_loss', dest='aux_loss', action='store_false')
    add('--cls_loss_coef', default=2, type=float)
    add('--focal_alpha', default=0.25, type=float)
    add('--focal_gamma', default=2., type=float)
    add('--max_eseq_length', default=10, type=int)
    add('--lloss_gau_mask', default=1, type=int)
    add('--lloss_beta', default=1, type=float)

    # scheduled sampling (opts.py:173-181)
    add('--scheduled_sampling_start', type=int, default=-1)
    add('--basic_ss_prob', type=float, default=0)
    add('--scheduled_sampling_increase_every', type=int, default=2)
    add('--scheduled_sampling_increase_prob', type=float, default=0.05)
    add('--scheduled_sampling_max_prob', type=float, default=0.25)

    # reranking (opts.py:184)
    add('--ec_alpha', type=float, default=0.3)

    # TSP / end-to-end flags (reference new_opts.py:209-301 superset)
    add('--root_dir', type=str, default=None)
    add('--workers', type=int, default=1)
    add('--clip_workers', type=int, default=1)
    add('--backbone_tsp', type=str, default='mvit_v2_s')
    add('--clip_len', type=int, default=16)
    add('--frame_rate', type=float, default=15)
    add('--stride', type=int, default=16)
    add('--backbone_lr', type=float, default=1e-5)
    add('--fc_lr', type=float, default=5e-5)
    add('--sound_lr', type=float, default=5e-5)
    add('--lr_warmup_epochs', type=int, default=2)
    add('--lr_milestones', type=int, nargs='+', default=[4, 6])
    add('--lr_gamma', type=float, default=0.1)
    add('--momentum', type=float, default=0.9)
    add('--tsp_weight_decay', type=float, default=0.005,
        help='TSP SGD weight decay (reference TSP --weight-decay)')
    add('--tsp_train_bn', type=int, default=0,
        help='update BatchNorm running stats during TSP training '
             '(SyncBN-equivalent under the data mesh)')
    add('--label_columns', type=str, nargs='+',
        default=['action-label', 'temporal-region-label'])
    add('--loss_alphas', type=float, nargs='+', default=[1.0, 1.0])
    add('--global_video_features', type=str, default=None)
    add('--train_csv_filename', type=str, default=None)
    add('--valid_csv_filename', type=str, default=None)
    add('--metadata_csv_valid', type=str, default=None)
    add('--train_subdir', type=str, default='train')
    add('--valid_subdir', type=str, default='valid')
    add('--label_mapping_jsons', type=str, nargs='+', default=[])
    add('--in_batch_size', type=int, default=64)
    add('--shard_id', type=int, default=0)
    add('--num_shards', type=int, default=1)
    add('--sound_feature_folder', type=str, default=None)
    add('--sound_feature_dim', type=int, default=0,
        help='dim of the cached sound features / missing-audio zero '
             'fallback; 0 = HuBERT default (768)')
    add('--ckpt_every_batches', type=int, default=100)

    # flags of the JAX package's TPU paths: accepted with the same defaults
    # so that one command line and one info.json serve both packages; the
    # port reads none of them
    add('--eval_tool_version', type=str, default='2018',
        choices=['2018', '2021'])
    add('--tpu_mesh_data', type=int, default=1)
    add('--tpu_compute_dtype', type=str, default='float32',
        choices=['float32', 'bfloat16'])
    add('--fusion_dtype', type=str, default='float32',
        choices=['float32', 'bfloat16'])
    add('--tpu_prng', type=str, default='rbg', choices=['threefry', 'rbg'])
    add('--msda_impl', type=str, default='auto',
        choices=['auto', 'ref', 'dense', 'pallas', 'pallas_interpret'])
    add('--msda_trunk_impl', type=str, default='',
        choices=['', 'auto', 'ref', 'dense', 'pallas', 'pallas_interpret'])
    add('--caption_scan_remat', type=int, default=0)
    add('--dsa_lstm_fuse', type=int, default=0)
    add('--dsa_scan_fuse', type=int, default=1)
    add('--dsa_greedy_fuse', type=int, default=1)
    add('--caption_sample_max', type=int, default=1)
    add('--caption_sample_temperature', type=float, default=1.0)
    add('--caption_len_bucketing', type=int, default=1,
        help='slice caption tensors to the batch max length rounded up to '
             '8 (exact-equivalent; fewer teacher-forcing scan steps)')
    add('--steps_per_dispatch', type=int, default=1)
    add('--tpu_seq_shard', type=int, default=0)
    add('--device_prefetch', type=int, default=1)
    add('--streaming_features', type=int, default=0)
    add('--video_folder', type=str, default=None)
    add('--tsp_checkpoint', type=str, default=None)
    add('--extraction_dtype', type=str, default='bfloat16',
        choices=['float32', 'bfloat16'])
    add('--streaming_cache', type=int, default=4096)
    return p


class Config:
    """Attribute-access view over the option dict (argparse-namespace-like)."""

    def __init__(self, d: dict[str, Any]):
        self.__dict__.update(d)

    def to_dict(self) -> dict[str, Any]:
        return copy.deepcopy(self.__dict__)

    def __repr__(self):
        return f"Config({self.__dict__!r})"


def import_cfg(cfg_path: str, args: dict[str, Any], root: str = '.') -> None:
    """Recursive YAML overlay (reference ``opts.py:214-221``).

    ``base_cfg_path`` chains are resolved relative to ``root`` (the repo the
    recipe lives in) so the reference's relative paths work verbatim.
    """
    path = cfg_path if os.path.isabs(cfg_path) else os.path.join(root, cfg_path)
    with open(path, 'r') as handle:
        yml = yaml.load(handle, Loader=yaml.FullLoader) or {}
    if 'base_cfg_path' in yml:
        import_cfg(yml['base_cfg_path'], args, root)
    args.update(yml)


def parse_opts(argv=None, root: str = '.') -> Config:
    """CLI entry — mirrors reference ``opts.py:parse_opts`` semantics."""
    parser = _build_parser()
    args = parser.parse_args(argv)
    d = vars(args)
    if d.get('cfg_path'):
        import_cfg(d['cfg_path'], d, root)

    if d.get('random_seed'):
        import random
        seed = int(random.random() * 1000)
        new_id = d['id'] + f'_seed{seed}'
        save_folder = os.path.join(d['save_dir'], new_id)
        while os.path.exists(save_folder):
            seed = int(random.random() * 1000)
            new_id = d['id'] + f'_seed{seed}'
            save_folder = os.path.join(d['save_dir'], new_id)
        d['id'] = new_id
        d['seed'] = seed

    if d.get('debug'):
        d['id'] = 'debug_' + time.strftime('%Y-%m-%d_%H-%M-%S', time.localtime())
        d['save_checkpoint_every'] = 1
        d['shuffle'] = 0

    if d.get('caption_decoder_type') == 'none':
        assert d['caption_loss_coef'] == 0
        assert d['set_cost_caption'] == 0
    return Config(d)


def load_config(cfg_path: str | None = None, root: str = '.',
                **overrides) -> Config:
    """Programmatic construction: defaults + optional YAML + overrides."""
    parser = _build_parser()
    d = vars(parser.parse_args([]))
    if cfg_path:
        import_cfg(cfg_path, d, root)
    d.update(overrides)
    return Config(d)
