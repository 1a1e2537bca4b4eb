from .trainer import (ENCODER_KEYS, Trainer, bucket_caption_length,
                      filtered_restore, is_encoder_param, load_checkpoint,
                      make_optimizer, multistep_lr, save_checkpoint,
                      ss_prob_for_epoch)
from .tsp_trainer import (TSPTrainer, lr_group, lr_param_groups,
                          warmup_multistep_lr)

__all__ = ['ENCODER_KEYS', 'TSPTrainer', 'Trainer', 'bucket_caption_length',
           'filtered_restore', 'is_encoder_param', 'load_checkpoint',
           'lr_group', 'lr_param_groups', 'make_optimizer', 'multistep_lr',
           'save_checkpoint', 'ss_prob_for_epoch',
           'warmup_multistep_lr']
