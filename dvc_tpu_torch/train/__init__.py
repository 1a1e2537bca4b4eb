from .trainer import (ENCODER_KEYS, Trainer, bucket_caption_length,
                      filtered_restore, is_encoder_param, load_checkpoint,
                      make_optimizer, multistep_lr, save_checkpoint,
                      ss_prob_for_epoch)

__all__ = ['ENCODER_KEYS', 'Trainer', 'bucket_caption_length',
           'filtered_restore', 'is_encoder_param', 'load_checkpoint',
           'make_optimizer', 'multistep_lr', 'save_checkpoint',
           'ss_prob_for_epoch']
