from .trainer import (Trainer, bucket_caption_length, load_checkpoint,
                      make_optimizer, multistep_lr, save_checkpoint,
                      ss_prob_for_epoch)

__all__ = ['Trainer', 'bucket_caption_length', 'load_checkpoint',
           'make_optimizer', 'multistep_lr', 'save_checkpoint',
           'ss_prob_for_epoch']
