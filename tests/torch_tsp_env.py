"""Shared fixtures of the port's TSP tests (tests/test_torch_tsp_*.py,
test_torch_streaming.py, test_torch_eval_loop.py): JAX TSP trees with
every leaf drawn from seeded numpy noise (the flax init leaves the
rel-pos tables, the class token and the biases at zero, which would hide
a wrong rel-pos or CLS path), JAX ``.ckpt`` files of them, cv2-written
synthetic videos and a tiny streaming recipe."""
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np


def noisy_tree(shapes, seed=0):
    """A flax tree of ``shapes`` (e.g. ``jax.eval_shape(model.init,
    ...)``) filled with seeded noise: kernels N(0, 1/fan_in), LayerNorm and
    BatchNorm scales 1 + N(0, 0.1^2), BatchNorm variances U(0.5, 1.5),
    everything else (biases, means, rel-pos tables, the class token)
    N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name == 'var':
            x = 0.5 + rng.random(s.shape)
        elif name == 'kernel':
            fan_in = 27 if s.shape[:3] == (3, 3, 3) and len(s.shape) == 4 \
                else int(np.prod(s.shape[:-1]))
            x = rng.standard_normal(s.shape) / np.sqrt(fan_in)
        elif name == 'scale':
            x = 1.0 + 0.1 * rng.standard_normal(s.shape)
        else:
            x = 0.1 * rng.standard_normal(s.shape)
        return x.astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def jax_variables(model, x, seed=0):
    """Noisy variables of a flax ``model`` at input ``x``'s shape."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros(x.shape, jnp.float32))
    return noisy_tree(shapes, seed)


def write_jax_ckpt(path, backbone, clip_len, seed=0):
    """A JAX TSP ``.ckpt`` (pickle ``{'variables': numpy tree}``, as
    train_tsp.py writes it) of a one-head ``TSPModel``; returns its
    variables."""
    from dvc_tpu.models.tsp import TSPModel
    hw = 224 if backbone == 'mvit_v2_s' else 112
    model = TSPModel(backbone=backbone, num_classes=(1,), num_heads=1)
    variables = jax_variables(model, np.zeros((1, clip_len, hw, hw, 3)),
                              seed)
    with open(path, 'wb') as f:
        pickle.dump({'variables': variables}, f)
    return variables


def write_video(path, n_frames=30, w=64, h=48, fps=30.0, seed=0):
    """An mp4v video of drifting seeded colours."""
    import cv2
    rng = np.random.default_rng(seed)
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*'mp4v'), fps,
                         (w, h))
    base = rng.integers(0, 200, size=3)
    ramp = np.arange(w, dtype=np.int64)[None, :, None]
    for i in range(n_frames):
        frame = ((base + i * 3 + ramp) % 255).astype(np.uint8)
        vw.write(np.broadcast_to(frame, (h, w, 3)).copy())
    vw.release()


WORDS = ('stir', 'the', 'pot', 'chop', 'leek', 'boil', 'water', 'add',
         'salt', 'fry', 'onion', 'pan')


def write_stream_env(root, n_videos=3, n_frames=30):
    """``root/videos`` with ``n_videos`` synthetic videos (2 clips each at
    clip_len 4, stride 8), an annotation file over them and one video
    without a file (zero features), a letters-only vocabulary and the
    paragraph gt file.  Returns the recipe's data options."""
    vid_dir = root / 'videos'
    vid_dir.mkdir()
    rng = np.random.default_rng(7)
    anno = {}
    for v in range(n_videos):
        key = f'v_stream{v:05d}'[:13]
        write_video(vid_dir / f'{key}.mp4', n_frames=n_frames, seed=v)
        anno[key] = {'duration': n_frames / 30.0,
                     'timestamps': [[0.1, 0.5], [0.4, 0.9]],
                     'sentences': [' '.join(rng.choice(WORDS, 4))
                                   for _ in range(2)]}
    anno['v_missing0000'] = {'duration': 1.0, 'timestamps': [[0.2, 0.8]],
                             'sentences': ['boil the water']}
    anno_path = root / 'anno.json'
    anno_path.write_text(json.dumps(anno))
    words = sorted(set(WORDS))
    vocab = root / 'vocab.json'
    vocab.write_text(json.dumps({
        'word_to_ix': {w: i for i, w in enumerate(words, 1)},
        'ix_to_word': {str(i): w for i, w in enumerate(words, 1)}}))
    para = root / 'para.json'
    para.write_text(json.dumps({k: ' '.join(v['sentences'])
                                for k, v in anno.items()}))
    return dict(train_caption_file=str(anno_path),
                val_caption_file=str(anno_path),
                gt_file_for_eval=[str(anno_path)],
                gt_file_for_para_eval=[str(para)], dict_file=str(vocab),
                vocab_size=len(words), invalid_video_json=[],
                visual_feature_type='tsp', visual_feature_folder='',
                sound_feature_folder=None, streaming_features=1,
                video_folder=str(vid_dir), backbone_tsp='r3d_18', clip_len=4,
                frame_rate=15, stride=8, in_batch_size=2,
                extraction_dtype='float32', feature_dim=512)


# a tiny plain PDVC (light caption head) over the streaming features
STREAM_PDVC = dict(base_cfg_path='cfgs/anet_c3d_pdvcl.yml', hidden_dim=32,
                   nheads=4, enc_layers=1, dec_layers=1,
                   transformer_ff_dim=32, num_queries=6,
                   input_encoding_size=16, rnn_size=32, max_eseq_length=4,
                   frame_embedding_num=16, gt_proposal_sample_num=2,
                   max_caption_len=6, batch_size=2, batch_size_for_eval=2,
                   epoch=1, transformer_dropout_prob=0.0, drop_prob=0.0,
                   seed=5)
