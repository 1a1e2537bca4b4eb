"""The port's own copies of the config and vocabulary code agree with the
JAX package's, and the port imports nothing of JAX or of ``dvc_tpu``.

The config copy must resolve every recipe in ``cfgs/`` to the same option
dict, key by key; the one key that differs on purpose is ``device``, the
port's device (``cuda`` by default) where the JAX package names a TPU.
"""
import ast
import glob
import json
import os
import subprocess
import sys

import pytest

from dvc_tpu.data.vocabulary import Translator as JaxTranslator
from dvc_tpu.utils.config import load_config as jax_load_config
from dvc_tpu.utils.config import parse_opts as jax_parse_opts
from dvc_tpu_torch.data import Translator
from dvc_tpu_torch.utils.config import load_config, parse_opts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, 'dvc_tpu_torch')
RECIPES = sorted(os.path.relpath(p, REPO)
                 for p in glob.glob(os.path.join(REPO, 'cfgs', '*.yml')))


def _same_options(got, want):
    got, want = got.to_dict(), want.to_dict()
    assert (got.pop('device'), want.pop('device')) == ('cuda', 'tpu')
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == want[k], k


@pytest.mark.parametrize('recipe', RECIPES)
def test_config_copy_resolves_every_recipe_alike(recipe):
    _same_options(load_config(recipe, root=REPO),
                  jax_load_config(recipe, root=REPO))


def test_config_copy_parses_command_lines_alike():
    argv = ['--cfg_path', 'cfgs/yc2_newModel_sound.yml', '--debug',
            '--lr', '0.001', '--ckpt_every_batches', '7']
    got, want = parse_opts(argv, root=REPO), jax_parse_opts(argv, root=REPO)
    # the recipe overlays the command line, as in the reference's opts.py
    assert got.lr == 5e-5 and got.ckpt_every_batches == 7
    got.id = want.id = 'debug'          # both stamp the current time
    _same_options(got, want)


def test_vocabulary_copy_translates_alike(tmp_path):
    words = ['add', 'salt', 'stir', 'the', 'pan', 'UNK']
    path = tmp_path / 'vocab.json'
    path.write_text(json.dumps({
        'word_to_ix': {w: i for i, w in enumerate(words, 1)},
        'ix_to_word': {str(i): w for i, w in enumerate(words, 1)}}))
    got, want = Translator(str(path), 6), JaxTranslator(str(path), 6)
    for sent in ('Add the salt, then stir.', 'stir-fry the PAN; add "oil"',
                 ''):
        for n in (3, 8, 30):
            assert got.translate(sent, n).tolist() == \
                want.translate(sent, n).tolist()
    for ids in ([1, 4, 2, 0, 3], [0], [5, 6, 2]):
        assert got.rtranslate(ids) == want.rtranslate(ids)
    with pytest.raises(ValueError):
        Translator(str(path), 7)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize('path', sorted(
    os.path.relpath(p, REPO) for p in
    glob.glob(os.path.join(PORT, '**', '*.py'), recursive=True)))
def test_port_module_imports_neither_jax_nor_the_jax_package(path):
    for name in _imports(os.path.join(REPO, path)):
        assert name.split('.')[0] not in ('jax', 'jaxlib', 'flax', 'optax',
                                          'dvc_tpu'), (path, name)
    # nor does it execute a file of the JAX package by its path
    src = open(os.path.join(REPO, path)).read()
    assert 'spec_from_file_location' not in src and 'load_shared' not in src


_LOADED = """
import json, os, sys
import dvc_tpu_torch.new_train, dvc_tpu_torch.serve, dvc_tpu_torch.train
import dvc_tpu_torch.models, dvc_tpu_torch.ops, dvc_tpu_torch.data
import dvc_tpu_torch.run_train, dvc_tpu_torch.run_eval
import dvc_tpu_torch.models.tsp, dvc_tpu_torch.data.streaming
import dvc_tpu_torch.data.video_clips, dvc_tpu_torch.extract_features
import dvc_tpu_torch.eval_ete, dvc_tpu_torch.utils.logging
import dvc_tpu_torch.data.native_io, dvc_tpu_torch.data.audio
import dvc_tpu_torch.models.hubert, dvc_tpu_torch.parallel
import dvc_tpu_torch.train_tsp, dvc_tpu_torch.test_and_visualize
import dvc_tpu_torch.utils.precision, dvc_tpu_torch.tools.build_vocab
import dvc_tpu_torch.tools.check_data, dvc_tpu_torch.tools.make_tsp_groundtruth
import dvc_tpu_torch.tools.calibrate_meteor
import dvc_tpu_torch.tools.measure_greedy_divergence
import dvc_tpu_torch.tools.profile_step, dvc_tpu_torch.utils.roofline
import dvc_tpu_torch.utils.profiling
pkg = os.path.join(sys.argv[1], 'dvc_tpu') + os.sep
print(json.dumps(sorted(
    n for n, m in list(sys.modules.items())
    if n.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'dvc_tpu')
    or (getattr(m, '__file__', None) or '').startswith(pkg))))
"""


def test_port_loads_no_module_of_jax_or_the_jax_package():
    proc = subprocess.run([sys.executable, '-c', _LOADED, REPO],
                          capture_output=True, text=True, timeout=300,
                          cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
