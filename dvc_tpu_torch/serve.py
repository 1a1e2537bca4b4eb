"""Batch inference / serving API of the port (counterpart of
``dvc_tpu/serve.py``).

Load a run (FusionPDVC, or plain PDVC with any caption head) once, then
caption feature tensors:

    from dvc_tpu_torch.serve import DenseCaptioner
    dc = DenseCaptioner('save/yc2_run', device='cuda')
    events = dc.caption_features(feats, duration=120.0, sound=audio_feats)
    # [{'timestamp': [t0, t1], 'sentence': ..., 'proposal_score': ...}, ...]

A run folder is what any trainer of either package writes: the port's
(``dvc_tpu_torch.new_train`` or ``run_train``: ``info.json`` and
``model-{best,last}.pth``, a torch ``state_dict``) or the JAX package's
(``info.json`` and ``model-{best,last}.ckpt``, whose flax params are
converted with :func:`dvc_tpu_torch.models.convert.from_jax_params` or
``pdvc_from_jax_params``).  The reference's own PDVC and NewModel
``.pth`` files load too (``{'model': state_dict, ...}``, keys under
``module.``): :func:`reference_state_dict` drops what they hold beyond the
model, as the JAX package's converters do, and any other key raises.  The
weights say which model it is: a FusionPDVC's keys carry the
``pdvcModel.`` prefix (:func:`make_model`).  ``DenseCaptioner`` also takes
``(opt, state_dict)`` directly; :func:`load_run` reads a run folder for it
and for ``dvc_tpu_torch.run_eval``.
Features are rescaled to the model's frame budget as in the training
pipeline; the model runs under ``torch.inference_mode()`` on ``device``,
the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import json
import os
import pickle
import re

import numpy as np
import torch

from .data import Translator, resize_feature
from .models import (from_jax_params, make_fusion_model, make_pdvc_model,
                     pdvc_from_jax_params, postprocess, to_dvc_records)
from .utils.config import Config, load_config

_SAFE_BUILTINS = {'complex', 'set', 'frozenset', 'slice', 'range',
                  'bytearray', 'bytes', 'tuple', 'list', 'dict', 'int',
                  'float', 'bool', 'str'}


class _Stub:
    """Stands in for a class the checkpoint names but serving never reads
    (optax optimizer states, JAX arrays): accepts and drops its state."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        pass


class _TraceTree:
    """Stands in for optax's ``TraceState`` namedtuple: unpickles as its
    ``trace`` tree (the SGD momentum of a TSP checkpoint)."""

    def __new__(cls, trace):
        return trace


class _CheckpointUnpickler(pickle.Unpickler):
    """Reads a ``save_checkpoint`` pickle without importing JAX or optax:
    numpy, a few builtins and ``collections`` load; optax's
    ``TraceState`` becomes its trace tree (:class:`_TraceTree`); every
    other class becomes a :class:`_Stub`."""

    def find_class(self, module, name):
        root = module.split('.')[0]
        if (root == 'numpy' or (root == 'collections' and name == 'OrderedDict')
                or (module == 'builtins' and name in _SAFE_BUILTINS)):
            return super().find_class(module, name)
        if root == 'optax' and name == 'TraceState':
            return _TraceTree
        return type(name, (_Stub,), {'__module__': module})


def load_checkpoint(path: str) -> dict:
    """The payload of a JAX ``model-*.ckpt`` pickle; only numpy-backed
    entries (``params``, ``epoch``) are meaningful."""
    with open(path, 'rb') as f:
        return _CheckpointUnpickler(f).load()


def load_info_json(save_dir: str):
    path = os.path.join(save_dir, 'info.json')
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def read_pth(path: str) -> dict:
    """The state_dict of a ``.pth`` as the JAX package reads a reference
    checkpoint (``load_torch_state_dict``): unpickled in full
    (``weights_only=False``: the reference's files hold more than
    tensors), then its ``'model'`` entry, then that one's
    ``'state_dict'``, else the bare dict."""
    sd = torch.load(path, map_location='cpu', weights_only=False)
    for k in ('model', 'state_dict'):
        if isinstance(sd, dict) and k in sd:
            sd = sd[k]
    return sd


def load_weights(path: str) -> dict:
    """The model ``state_dict`` (CPU tensors) of a checkpoint file: a
    ``.pth``, the port's or the reference's own (PDVC or NewModel, as
    :func:`read_pth` reads it; :func:`make_model` drops what the reference
    saves but never uses), or the JAX package's ``.ckpt`` (flax params
    converted with :func:`from_jax_params` for a FusionPDVC, whose tree has
    the fusion blocks, else :func:`pdvc_from_jax_params`)."""
    if path.endswith('.pth'):
        return read_pth(path)
    params = load_checkpoint(path)['params']
    convert = (from_jax_params if 'visual_sa' in params.get('params', params)
               else pdvc_from_jax_params)
    return {k: torch.as_tensor(np.asarray(v))
            for k, v in convert(params).items()}


def is_fusion_state(state_dict) -> bool:
    """Whether a state_dict is a FusionPDVC's (its PDVC under
    ``pdvcModel.``, after a ``module.`` prefix, as the JAX
    ``load_checkpoint`` tells them apart), not a plain PDVC's."""
    return any(k.startswith(('pdvcModel.', 'module.pdvcModel.'))
               for k in state_dict)


# what the reference saves but never uses, as the JAX converters discard
# it (dvc_tpu/models/pdvc_converter.py:50-56): the decoder's aliases of the
# box heads under box refinement, the detr-style two-stage encoder output,
# a vestigial caption reference head
_UNUSED_PREFIXES = ('transformer.decoder.bbox_head.', 'transformer.enc_output',
                    'transformer.reference_points_cap')
# the caption sampler's attention weights and output projection, created
# by the reference but dead on its return-value path (:259-262)
_DEAD_SAMPLER = re.compile(r'(caption_head\.\d+\.core\.deformable_att)\.'
                           r'(attention_weights|output_proj)\.(weight|bias)$')


def reference_state_dict(state_dict, transformer_input_type) -> dict:
    """``state_dict`` without what the reference's own checkpoints hold
    beyond the model, as ``convert_pdvc`` / ``convert_fusion`` read them:
    the ``module.`` prefix; the unused keys above; the dormant branch of
    ``transformer_input_type`` (the reference builds both
    ``reference_points`` and ``pos_trans*``, :131-140); the dead sampler
    keys of a head that has a sampler; a NewModel's HuBERT
    ``sound_model.*`` (:357-368).  The identity on the port's own weights
    and on converted JAX ones."""
    sd = {k[len('module.'):] if k.startswith('module.') else k: v
          for k, v in state_dict.items()}
    fusion = is_fusion_state(sd)
    dormant = ('transformer.reference_points.'
               if transformer_input_type == 'gt_proposals'
               else 'transformer.pos_trans')

    prefix = 'pdvcModel.' if fusion else ''

    def unused(key):
        if fusion and key.startswith('sound_model.'):
            return True
        if not key.startswith(prefix):
            return False
        k = key[len(prefix):]
        dead = _DEAD_SAMPLER.match(k)
        return k.startswith(_UNUSED_PREFIXES + (dormant,)) or (
            dead is not None
            and f'{prefix}{dead[1]}.sampling_offsets.weight' in sd)
    return {k: v for k, v in sd.items() if not unused(k)}


def make_model(opt, state_dict, device='cuda'):
    """The model of ``state_dict`` (FusionPDVC or plain PDVC, by its keys)
    built from ``opt`` on ``device``, in eval mode, with the weights of
    :func:`reference_state_dict` loaded ``strict=True``; a key that the
    model does not have raises, naming every such key."""
    state_dict = reference_state_dict(state_dict, opt.transformer_input_type)
    make = make_fusion_model if is_fusion_state(state_dict) else \
        make_pdvc_model
    model = make(opt, device)
    unknown = sorted(set(state_dict) - set(model.state_dict()))
    if unknown:
        raise ValueError(f'checkpoint tensors that the {type(model).__name__} '
                         f'of these options does not have (a layout other '
                         f'than the reference\'s): {unknown}')
    model.load_state_dict(
        {k: torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v)
         else v for k, v in state_dict.items()}, strict=True)
    return model


def load_pdvc_weights(path: str) -> dict:
    """The PDVC ``state_dict`` (reference layout, CPU tensors) that
    ``--pretrain`` warm-starts from: a plain-PDVC run's JAX ``.ckpt``
    (flax params converted with :func:`pdvc_from_jax_params`), or a ``.pth``
    holding a PDVC state_dict (as :func:`read_pth` reads it; 'module.'
    prefixes dropped, as the JAX package's ``convert_pdvc`` drops them), or
    the PDVC of a FusionPDVC ``.pth`` (``pdvcModel.*``: the port's own
    checkpoints)."""
    if path.endswith('.pth'):
        sd = {k[len('module.'):] if k.startswith('module.') else k: v
              for k, v in read_pth(path).items()}
        if any(k.startswith('pdvcModel.') for k in sd):
            sd = {k[len('pdvcModel.'):]: v for k, v in sd.items()
                  if k.startswith('pdvcModel.')}
        return sd
    params = load_checkpoint(path)['params']
    return {k: torch.as_tensor(np.asarray(v))
            for k, v in pdvc_from_jax_params(params).items()}


def run_options(folder: str, which: str = 'best') -> Config:
    """The options of a run folder's ``info.json[which]`` over the
    defaults (the recipe file they name is not read again)."""
    info = load_info_json(folder)
    if info is None:
        raise FileNotFoundError(f'no info.json in {folder}')
    return Config({**load_config().to_dict(), **info[which]['opt']})


def load_run(folder: str, which: str = 'best', checkpoint=None, opt=None):
    """(opt, state_dict) of a run folder that either trainer wrote: the
    options of :func:`run_options` unless ``opt`` is given, and the
    weights of ``checkpoint``, else of ``model-{which}.pth``, else of
    ``model-{which}.ckpt``."""
    if opt is None:
        opt = run_options(folder, which)
    if checkpoint is None:
        checkpoint = os.path.join(folder, f'model-{which}.pth')
        if not os.path.exists(checkpoint):
            checkpoint = checkpoint[:-len('.pth')] + '.ckpt'
    return opt, load_weights(checkpoint)


class DenseCaptioner:
    def __init__(self, run_folder: str | None = None, which: str = 'best',
                 dict_file: str | None = None, opt=None, state_dict=None,
                 device='cuda'):
        if state_dict is None:
            opt, state_dict = load_run(run_folder, which, opt=opt)
        elif opt is None:
            raise ValueError('a state_dict needs the opt it was built with')
        if opt.transformer_input_type == 'gt_proposals':
            raise ValueError('a two-stage (gt_proposals) run takes its '
                             'queries from gt boxes, which requests do not '
                             'carry: evaluate it with run_eval')
        self.opt = opt
        self.device = torch.device(device)
        self.model = make_model(opt, state_dict, self.device)
        self.fusion = is_fusion_state(state_dict)
        # the draws of a sampling decode (--caption_sample_max 0)
        self.gen = torch.Generator(device=self.device).manual_seed(opt.seed)
        self.translator = Translator(dict_file or opt.dict_file,
                                     opt.vocab_size)

    def _make_batch(self, feats_list, durations, sound_list=None):
        opt = self.opt
        T, C, B = opt.frame_embedding_num, opt.feature_dim, len(feats_list)
        video = np.zeros((B, T, C), np.float32)
        vmask = np.zeros((B, T), bool)
        vlen = np.zeros((B, 3), np.float32)
        sound = np.zeros((B, T, C), np.float32)
        for b, f in enumerate(feats_list):
            if opt.data_rescale and f.shape[0] != T:
                f = resize_feature(f, T, opt.sample_method)
            L = min(len(f), T)
            video[b, :L] = f[:L]
            vmask[b, :L] = True
            vlen[b] = [L, durations[b], 1]
        # audio clip features aligned with the visual stream; zeros when a
        # video has none
        for b, s in enumerate(sound_list or []):
            if s is None:
                continue
            s = np.asarray(s, np.float32)
            if opt.data_rescale and s.shape[0] != T:
                s = resize_feature(s, T, opt.sample_method)
            L = min(len(s), T)
            sound[b, :L] = s[:L]
        batch = {'video_tensor': video, 'video_mask': vmask,
                 'video_length': vlen}
        if self.fusion:
            batch['sound_tensor'] = sound
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in batch.items()}

    def caption_features(self, feats, duration: float, top_k: int | None = None,
                         sound=None):
        """feats (T, feature_dim) clip features of one video; ``sound``
        optional (T, feature_dim) audio features (a FusionPDVC run's)."""
        return self.caption_batch([np.asarray(feats)], [duration],
                                  top_k=top_k, sound_list=[sound])[0]

    def caption_batch(self, feats_list, durations, top_k: int | None = None,
                      sound_list=None):
        batch = self._make_batch(feats_list, durations, sound_list)
        with torch.inference_mode():
            out = self.model(batch, self.gen)
            post = postprocess(out, torch.tensor(durations, dtype=torch.float32,
                                                 device=self.device))
        records = to_dvc_records(
            post, [str(i) for i in range(len(feats_list))], durations,
            self.translator)
        results = []
        for i in range(len(feats_list)):
            events = records[str(i)]
            k = top_k or int(events[0]['pred_event_count']) if events else 0
            events = sorted(events, key=lambda e: e['proposal_score'],
                            reverse=True)[:k]
            results.append(sorted(events, key=lambda e: e['timestamp']))
        return results
