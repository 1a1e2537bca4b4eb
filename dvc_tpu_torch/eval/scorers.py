"""Caption scorers — pure-Python BLEU / CIDEr / ROUGE-L / METEOR (the
port's copy of ``dvc_tpu/eval/scorers.py``).

The one difference from that module: the jar-mode tokenizer
(``_ptb_jar_tokenize``) raises when the jar prints another number of
lines than it was given captions, so ``tokenize_dict`` falls back to the
Python tokenizer instead of zipping the lines onto the wrong ids.

The reference evaluates through pycocoevalcap, whose METEOR and tokenizer
shell out to java jars (``densevid_eval3/pycocoevalcap/meteor/meteor.py:12-24``,
``tokenizer/ptbtokenizer.py:17-18``) that are external artifacts not shipped
with the repo.  This module re-implements the published algorithms natively:

* BLEU: Papineni et al. 2002, coco-caption conventions ("closest" reference
  length, tiny-epsilon smoothing on the per-instance scores).
* CIDEr: Vedantam et al. 2015 (n-gram TF-IDF, df from the gts of the call).
* ROUGE-L: Lin 2004, beta = 1.2 (coco-caption convention).
* METEOR: Denkowski & Lavie 2014 formulation with exact + Porter-stem +
  synonym + paraphrase matchers and the Meteor-1.5 'en' parameters
  (alpha=.85, beta=.2, gamma=.6, delta=.75, stem/paraphrase weight .6,
  synonym weight .8, content/function-word distinction).  The paraphrase
  stage activates when ``DVC_METEOR_PARAPHRASE`` points at a Meteor
  paraphrase table (the ``paraphrase-en.gz`` artifact); the synonym stage
  when ``DVC_METEOR_WORDNET`` points at a WordNet ``dict`` directory.
  Alignment resolution implements the published meteor-1.5 beam search
  (maximize covered words, then minimize chunks, then minimize match
  distance; beam 40 — brute-force-verified exact on short sentences in
  tests/test_tokenizer_meteor.py).  If a ``meteor-1.5.jar`` is available
  set ``DVC_METEOR_JAR`` and it is used instead (score-parity mode), and
  ``tools/calibrate_meteor.py`` reports the jar-vs-python divergence on a
  corpus.

All scorers share the pycocoevalcap interface:
``compute_score(gts, res) -> (corpus_score, per_instance_scores)`` where
gts/res map id -> [sentence, ...].
"""

from __future__ import annotations

import math
import os
import re
import sys
from collections import Counter, defaultdict

# ---------------------------------------------------------------------------
# PTB-style tokenizer (replaces the Stanford CoreNLP jar)
# ---------------------------------------------------------------------------

_PUNCT = {"''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
          ".", "?", "!", ",", ":", "-", "--", "...", ";",
          # raw forms of what the CoreNLP tokenizer escapes to the
          # -LRB-/`` family before the reference's post-filter drops them
          "(", ")", "[", "]", "{", "}", '"'}

# PTB clitic splitting: don't -> do n't, it's -> it 's, we'll -> we 'll;
# the lookbehind includes digits so possessive/decade forms split too
# (CoreNLP: "80's" -> "80 's")
_CLITIC_SPLIT = re.compile(
    r"(?<=[a-z0-9])(n't|'s|'re|'ve|'ll|'d|'m)(?![a-z0-9])")

_TOKEN_RE = re.compile(
    r"n't|'(?:s|re|ve|ll|d|m)(?![a-z0-9])"  # split-off clitics
    r"|\d+(?:[.,]\d+)+"                     # 3.5 / 1,000 stay one token
    r"|[a-z0-9]+(?:['-][a-z0-9]+)*"         # words/ranges: stir-fry, 5-6
    r"|[^\sa-z0-9]")


def ptb_tokenize(caption: str) -> str:
    """Lowercase, split clitics and punctuation the PTB way, drop the PTB
    punctuation tokens (mirrors the Stanford PTBTokenizer + the
    post-filtering in ``ptbtokenizer.py``): hyphenated words and decimal /
    thousands-separated numbers stay single tokens; ``don't`` -> ``do n't``."""
    s = _CLITIC_SPLIT.sub(r' \1', caption.lower())
    return ' '.join(t for t in _TOKEN_RE.findall(s) if t not in _PUNCT)


# the reference's post-filter applied to the jar's token stream
# (ptbtokenizer.py:21-22,64-65)
_JAR_PUNCTUATIONS = {"''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-",
                     "-RCB-", ".", "?", "!", ",", ":", "-", "--", "...",
                     ";"}


def _ptb_filter_jar_lines(lines):
    """Drop PUNCTUATIONS from each jar output line (the reference's
    post-filter, ``ptbtokenizer.py:64-65``)."""
    return [' '.join(w for w in line.rstrip().split(' ')
                     if w not in _JAR_PUNCTUATIONS) for line in lines]


def _ptb_jar_tokenize(captions, jar):
    """Tokenize a flat list of raw caption strings through the Stanford
    CoreNLP jar — the exact protocol of the reference's wrapper
    (``pycocoevalcap/tokenizer/ptbtokenizer.py:28-67``: temp file,
    ``edu.stanford.nlp.process.PTBTokenizer -preserveLines -lowerCase``,
    then the PUNCTUATIONS post-filter)."""
    import subprocess
    import tempfile
    sentences = '\n'.join(c.replace('\n', ' ') for c in captions)
    with tempfile.NamedTemporaryFile('w', suffix='.txt',
                                     delete=False) as f:
        f.write(sentences)
        tmp = f.name
    try:
        out = subprocess.run(
            ['java', '-cp', jar, 'edu.stanford.nlp.process.PTBTokenizer',
             '-preserveLines', '-lowerCase', tmp],
            capture_output=True, text=True, check=True).stdout
    finally:
        os.remove(tmp)
    lines = out.split('\n')
    if lines and lines[-1] == '':      # the newline that ends the last line
        lines.pop()
    if len(lines) != len(captions):
        raise RuntimeError(f'the PTB tokenizer printed {len(lines)} lines '
                           f'for {len(captions)} captions')
    return _ptb_filter_jar_lines(lines)


def tokenize_dict(caps: dict) -> dict:
    """{id: [{'caption': str}, ...]} -> {id: [tokenized str, ...]}
    (the pycocoevalcap tokenizer interface used by the eval stack).

    Score-parity mode: when ``DVC_PTB_JAR`` points at
    ``stanford-corenlp-3.4.1.jar`` the captions go through the official
    tokenizer instead of the python approximation (mirrors
    ``DVC_METEOR_JAR``); a jar failure falls back with a stderr note."""
    jar = os.environ.get('DVC_PTB_JAR')
    if jar and os.path.exists(jar):
        keys = [k for k, v in caps.items() for _ in v]
        flat = [c['caption'] for v in caps.values() for c in v]
        try:
            toks = _ptb_jar_tokenize(flat, jar)
            # seed every key: ids with zero captions must map to [] like
            # the python path (SODA indexes preds[vid] unconditionally)
            out = {k: [] for k in caps}
            for k, t in zip(keys, toks):
                out[k].append(t)
            return out
        except Exception as e:
            print(f'DVC_PTB_JAR tokenization failed ({e!r}); falling back '
                  'to the python tokenizer', file=sys.stderr)
    return {k: [ptb_tokenize(c['caption']) for c in v]
            for k, v in caps.items()}


# ---------------------------------------------------------------------------
# BLEU
# ---------------------------------------------------------------------------

def _ngram_counts(tokens, n):
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def bleu_compute_score(gts, res, n_max=4):
    """Corpus BLEU-1..4 + per-instance scores (coco-caption conventions)."""
    small = 1e-9
    tiny = 1e-15
    total_clip = [0] * n_max
    total_count = [0] * n_max
    ref_len_total = 0
    test_len_total = 0
    per_instance = [[] for _ in range(n_max)]

    for key in gts:
        hyp = res[key][0].split()
        refs = [r.split() for r in gts[key]]
        hlen = len(hyp)
        # closest reference length
        rlen = min((abs(len(r) - hlen), len(r)) for r in refs)[1] if refs else 0
        ref_len_total += rlen
        test_len_total += hlen
        inst_clip, inst_count = [], []
        for n in range(1, n_max + 1):
            h_counts = _ngram_counts(hyp, n)
            max_ref = Counter()
            for r in refs:
                for ng, c in _ngram_counts(r, n).items():
                    max_ref[ng] = max(max_ref[ng], c)
            clip = sum(min(c, max_ref[ng]) for ng, c in h_counts.items())
            count = max(len(hyp) - n + 1, 0)
            total_clip[n - 1] += clip
            total_count[n - 1] += count
            inst_clip.append(clip)
            inst_count.append(count)
        # per-instance score with tiny smoothing, own brevity penalty
        bp_i = 1.0 if hlen >= rlen else (
            math.exp(1 - rlen / (hlen + tiny)) if hlen > 0 else 0.0)
        p_cum = 1.0
        for n in range(n_max):
            p_n = (inst_clip[n] + tiny) / (inst_count[n] + small)
            p_cum *= p_n
            per_instance[n].append((p_cum ** (1.0 / (n + 1))) * bp_i)

    bp = 1.0 if test_len_total >= ref_len_total else (
        math.exp(1 - ref_len_total / (test_len_total + tiny))
        if test_len_total > 0 else 0.0)
    scores = []
    p_cum = 1.0
    for n in range(n_max):
        p_n = (total_clip[n] + tiny) / (total_count[n] + small)
        p_cum *= p_n
        scores.append((p_cum ** (1.0 / (n + 1))) * bp)
    return scores, per_instance


# ---------------------------------------------------------------------------
# CIDEr
# ---------------------------------------------------------------------------

def cider_compute_score(gts, res, n_max=4, sigma=6.0):
    """CIDEr-D style scoring as in coco-caption (df over this call's gts)."""
    keys = list(gts.keys())
    doc_freq = [defaultdict(int) for _ in range(n_max)]
    for key in keys:
        for n in range(n_max):
            seen = set()
            for ref in gts[key]:
                seen |= set(_ngram_counts(ref.split(), n + 1).keys())
            for ng in seen:
                doc_freq[n][ng] += 1
    log_ref = math.log(max(len(keys), 1))

    def tfidf_vec(tokens):
        vecs, norms = [], []
        length = len(tokens)
        for n in range(n_max):
            counts = _ngram_counts(tokens, n + 1)
            vec = {}
            norm = 0.0
            for ng, c in counts.items():
                df = math.log(max(doc_freq[n][ng], 1.0))
                w = c * (log_ref - df)
                vec[ng] = w
                norm += w * w
            vecs.append(vec)
            norms.append(math.sqrt(norm))
        return vecs, norms, length

    def sim(v_h, n_h, l_h, v_r, n_r, l_r):
        delta = l_h - l_r
        s = []
        for n in range(n_max):
            num = 0.0
            for ng, w in v_h[n].items():
                num += min(w, v_r[n].get(ng, 0.0)) * v_r[n].get(ng, 0.0)
            denom = n_h[n] * n_r[n]
            val = num / denom if denom > 0 else 0.0
            val *= math.exp(-(delta ** 2) / (2 * sigma ** 2))
            s.append(val)
        return s

    per_instance = []
    for key in keys:
        v_h, n_h, l_h = tfidf_vec(res[key][0].split())
        score_n = [0.0] * n_max
        for ref in gts[key]:
            v_r, n_r, l_r = tfidf_vec(ref.split())
            s = sim(v_h, n_h, l_h, v_r, n_r, l_r)
            for n in range(n_max):
                score_n[n] += s[n]
        n_refs = max(len(gts[key]), 1)
        score = 10.0 * sum(score_n) / n_max / n_refs
        per_instance.append(score)
    mean = sum(per_instance) / len(per_instance) if per_instance else 0.0
    return mean, per_instance


# ---------------------------------------------------------------------------
# ROUGE-L
# ---------------------------------------------------------------------------

def _lcs_len(a, b):
    la, lb = len(a), len(b)
    if la == 0 or lb == 0:
        return 0
    prev = [0] * (lb + 1)
    for i in range(1, la + 1):
        cur = [0] * (lb + 1)
        ai = a[i - 1]
        for j in range(1, lb + 1):
            if ai == b[j - 1]:
                cur[j] = prev[j - 1] + 1
            else:
                cur[j] = max(prev[j], cur[j - 1])
        prev = cur
    return prev[lb]


def rouge_l_compute_score(gts, res, beta=1.2):
    per_instance = []
    for key in gts:
        hyp = res[key][0].split()
        best = 0.0
        for ref in gts[key]:
            r_toks = ref.split()
            lcs = _lcs_len(hyp, r_toks)
            p = lcs / len(hyp) if hyp else 0.0
            r = lcs / len(r_toks) if r_toks else 0.0
            if p > 0 and r > 0:
                f = ((1 + beta ** 2) * p * r) / (r + beta ** 2 * p)
            else:
                f = 0.0
            best = max(best, f)
        per_instance.append(best)
    mean = sum(per_instance) / len(per_instance) if per_instance else 0.0
    return mean, per_instance


# ---------------------------------------------------------------------------
# Porter stemmer (standard algorithm, for the METEOR stem matcher)
# ---------------------------------------------------------------------------

_VOWELS = 'aeiou'


def _is_cons(word, i):
    ch = word[i]
    if ch in _VOWELS:
        return False
    if ch == 'y':
        return i == 0 or not _is_cons(word, i - 1)
    return True


def _measure(stem):
    m = 0
    prev_c = None
    for i in range(len(stem)):
        c = _is_cons(stem, i)
        if prev_c is True and c is False:
            pass
        if prev_c is False and c is True:
            m += 1
        prev_c = c
    return m


def _has_vowel(stem):
    return any(not _is_cons(stem, i) for i in range(len(stem)))


def _ends_double_cons(word):
    return (len(word) >= 2 and word[-1] == word[-2]
            and _is_cons(word, len(word) - 1))


def _cvc(word):
    if len(word) < 3:
        return False
    if (_is_cons(word, len(word) - 3) and not _is_cons(word, len(word) - 2)
            and _is_cons(word, len(word) - 1)):
        return word[-1] not in 'wxy'
    return False


def porter_stem(word: str) -> str:
    if len(word) <= 2:
        return word
    w = word
    # step 1a
    if w.endswith('sses'):
        w = w[:-2]
    elif w.endswith('ies'):
        w = w[:-2]
    elif w.endswith('ss'):
        pass
    elif w.endswith('s'):
        w = w[:-1]
    # step 1b
    flag = False
    if w.endswith('eed'):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    elif w.endswith('ed'):
        if _has_vowel(w[:-2]):
            w = w[:-2]
            flag = True
    elif w.endswith('ing'):
        if _has_vowel(w[:-3]):
            w = w[:-3]
            flag = True
    if flag:
        if w.endswith(('at', 'bl', 'iz')):
            w += 'e'
        elif _ends_double_cons(w) and not w.endswith(('l', 's', 'z')):
            w = w[:-1]
        elif _measure(w) == 1 and _cvc(w):
            w += 'e'
    # step 1c
    if w.endswith('y') and _has_vowel(w[:-1]):
        w = w[:-1] + 'i'
    # step 2
    for suf, rep in (('ational', 'ate'), ('tional', 'tion'), ('enci', 'ence'),
                     ('anci', 'ance'), ('izer', 'ize'), ('abli', 'able'),
                     ('alli', 'al'), ('entli', 'ent'), ('eli', 'e'),
                     ('ousli', 'ous'), ('ization', 'ize'), ('ation', 'ate'),
                     ('ator', 'ate'), ('alism', 'al'), ('iveness', 'ive'),
                     ('fulness', 'ful'), ('ousness', 'ous'), ('aliti', 'al'),
                     ('iviti', 'ive'), ('biliti', 'ble')):
        if w.endswith(suf):
            if _measure(w[:-len(suf)]) > 0:
                w = w[:-len(suf)] + rep
            break
    # step 3
    for suf, rep in (('icate', 'ic'), ('ative', ''), ('alize', 'al'),
                     ('iciti', 'ic'), ('ical', 'ic'), ('ful', ''),
                     ('ness', '')):
        if w.endswith(suf):
            if _measure(w[:-len(suf)]) > 0:
                w = w[:-len(suf)] + rep
            break
    # step 4
    for suf in ('al', 'ance', 'ence', 'er', 'ic', 'able', 'ible', 'ant',
                'ement', 'ment', 'ent', 'ou', 'ism', 'ate', 'iti', 'ous',
                'ive', 'ize'):
        if w.endswith(suf):
            if _measure(w[:-len(suf)]) > 1:
                w = w[:-len(suf)]
            break
    else:
        if w.endswith('ion') and len(w) > 3 and w[-4] in 'st':
            if _measure(w[:-3]) > 1:
                w = w[:-3]
    # step 5a
    if w.endswith('e'):
        stem = w[:-1]
        m = _measure(stem)
        if m > 1 or (m == 1 and not _cvc(stem)):
            w = stem
    # step 5b
    if _measure(w) > 1 and _ends_double_cons(w) and w.endswith('l'):
        w = w[:-1]
    return w


# ---------------------------------------------------------------------------
# METEOR
# ---------------------------------------------------------------------------

_FUNCTION_WORDS = set('''a an the of to in on at by for with from as is are
was were be been being am do does did have has had will would can could may
might shall should must it its this that these those he she they them his her
their there here and or but if then than so not no nor own same such only
very s t just don now d ll m o re ve y about into over after before between
under again further once all any both each few more most other some'''.split())

_M_ALPHA, _M_BETA, _M_GAMMA, _M_DELTA = 0.85, 0.2, 0.6, 0.75
_STEM_WEIGHT = 0.6
_SYNONYM_WEIGHT = 0.8           # meteor-1.5 'en' matcher weight
_PARAPHRASE_WEIGHT = 0.6        # meteor-1.5 'en' matcher weight

_function_words_cache: dict = {}


def load_function_words(path: str):
    """Load a meteor-1.5 function-word list (the jar's ``function/en.words``
    resource: ``unzip -p meteor-1.5.jar function/en.words``) — one word per
    line, ``#`` comments ignored.  Cached per path."""
    if path in _function_words_cache:
        return _function_words_cache[path]
    words = set()
    with open(path, encoding='utf-8') as f:
        for line in f:
            w = line.strip()
            if w and not w.startswith('#'):
                words.add(w.lower())
    _function_words_cache[path] = words
    return words


def _active_function_words():
    """The jar's own list via ``DVC_METEOR_FUNCTION_WORDS`` when present
    (drop-in, zero code changes), else the built-in approximation."""
    path = os.environ.get('DVC_METEOR_FUNCTION_WORDS')
    if path and os.path.exists(path):
        return load_function_words(path)
    return _FUNCTION_WORDS


_paraphrase_cache: dict = {}


def _is_number(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


def load_paraphrase_table(path: str):
    """Load a Meteor paraphrase table (the ``paraphrase-en.gz`` artifact
    shipped with meteor-1.5 — ``densevid_eval3/pycocoevalcap/meteor/
    meteor.py:12-24`` runs the jar that reads it) into a symmetric
    phrase -> {phrases} map.  Cached per path.

    Format tolerance so the real artifact drops in with zero code changes:
    plain or gzipped text; fields separated by ``|||`` or tabs; each entry
    is a *weighted phrase pair* — a numeric translation-probability field
    may lead or trail the two phrases (meteor-1.5 builds its tables with
    the translation-pivot approach of Bannard & Callison-Burch 2005, one
    weighted pair per line).  The entry weight is not used: the jar scores
    every paraphrase match with the fixed 'en' matcher weight 0.6, which
    is what ``_PARAPHRASE_WEIGHT`` reproduces."""
    if path in _paraphrase_cache:
        return _paraphrase_cache[path]
    import gzip
    table: dict = defaultdict(set)
    opener = gzip.open if path.endswith('.gz') else open
    with opener(path, 'rt', encoding='utf-8', errors='replace') as f:
        for line in f:
            parts = ([p.strip() for p in line.split('|||')]
                     if '|||' in line else
                     [p.strip() for p in line.rstrip('\n').split('\t')])
            parts = [p for p in parts if p]
            # drop numeric weight fields (leading or trailing)
            while len(parts) > 2 and _is_number(parts[0]):
                parts = parts[1:]
            while len(parts) > 2 and _is_number(parts[-1]):
                parts = parts[:-1]
            if len(parts) != 2:
                continue
            a, b = parts
            if a != b:
                table[a].add(b)
                table[b].add(a)
    table = dict(table)
    _paraphrase_cache[path] = table
    return table


def _active_paraphrase_table():
    path = os.environ.get('DVC_METEOR_PARAPHRASE')
    if path and os.path.exists(path):
        return load_paraphrase_table(path)
    return None


_synset_cache: dict = {}


def load_wordnet_synsets(dict_dir: str):
    """Load a WordNet ``dict`` directory's index files into a
    lemma -> frozenset('pos:offset') map for the METEOR synonym matcher
    (meteor-1.5's 'en' synonymy module is WordNet-derived;
    the jar's matcher order is exact, stem, synonym, paraphrase).

    Index line format (``wnintro(5)``): ``lemma pos synset_cnt p_cnt
    [ptr_symbol...] sense_cnt tagsense_cnt synset_offset...``.
    Multi-word lemmas (``a_posteriori``) are skipped — the matcher aligns
    single tokens; phrases belong to the paraphrase stage.  Cached per
    path."""
    if dict_dir in _synset_cache:
        return _synset_cache[dict_dir]
    table: dict = {}
    for fname in ('index.noun', 'index.verb', 'index.adj', 'index.adv'):
        path = os.path.join(dict_dir, fname)
        if not os.path.exists(path):
            continue
        with open(path, encoding='utf-8', errors='replace') as f:
            for line in f:
                if line.startswith(' '):
                    continue              # license header lines
                parts = line.split()
                if len(parts) < 7:
                    continue
                lemma, pos = parts[0], parts[1]
                if '_' in lemma:
                    continue
                try:
                    synset_cnt = int(parts[2])
                    p_cnt = int(parts[3])
                except ValueError:
                    continue
                offsets = parts[4 + p_cnt + 2:]
                if len(offsets) != synset_cnt:
                    continue
                ids = frozenset(f'{pos}:{o}' for o in offsets)
                prev = table.get(lemma)
                table[lemma] = ids if prev is None else prev | ids
    _synset_cache[dict_dir] = table
    return table


def _active_synonym_table():
    """WordNet synsets via ``DVC_METEOR_WORDNET`` (a WordNet ``dict``
    directory) when present — drop-in, zero code changes."""
    path = os.environ.get('DVC_METEOR_WORDNET')
    if path and os.path.isdir(path):
        return load_wordnet_synsets(path)
    return None


_ALIGNER_BEAM = 40              # meteor-1.5 Aligner beam width
_MAX_PHRASE_LEN = 6


def _collect_matches(hyp, ref, paraphrases=None, synonyms=None):
    """All candidate matches between hyp and ref, meteor-1.5 matcher
    order (exact, stem, synonym, paraphrase).  A match is
    ``(h_start, h_len, r_start, r_len, weight)``; when several stages
    match the same span pair the earliest (highest-priority) stage wins.
    Exact/stem/synonym match single words; paraphrase matches phrases."""
    cands: dict = {}

    def add(h, hl, r, rl, weight):
        cands.setdefault((h, hl, r, rl), weight)

    for i, hw in enumerate(hyp):
        for j, rw in enumerate(ref):
            if hw == rw:
                add(i, 1, j, 1, 1.0)
    hyp_stem = [porter_stem(w) for w in hyp]
    ref_stem = [porter_stem(w) for w in ref]
    for i, hs in enumerate(hyp_stem):
        for j, rs in enumerate(ref_stem):
            if hs == rs:
                add(i, 1, j, 1, _STEM_WEIGHT)
    if synonyms:
        for i, hw in enumerate(hyp):
            h_syn = synonyms.get(hw)
            if not h_syn:
                continue
            for j, rw in enumerate(ref):
                r_syn = synonyms.get(rw)
                if r_syn and not h_syn.isdisjoint(r_syn):
                    add(i, 1, j, 1, _SYNONYM_WEIGHT)
    if paraphrases:
        ref_spans: dict = {}
        for lj in range(1, _MAX_PHRASE_LEN + 1):
            for j in range(len(ref) - lj + 1):
                ref_spans.setdefault(' '.join(ref[j:j + lj]),
                                     []).append((j, lj))
        for li in range(1, _MAX_PHRASE_LEN + 1):
            for i in range(len(hyp) - li + 1):
                entry = paraphrases.get(' '.join(hyp[i:i + li]))
                if not entry:
                    continue
                for phrase in entry:
                    for j, lj in ref_spans.get(phrase, ()):
                        add(i, li, j, lj, _PARAPHRASE_WEIGHT)
    return [k + (w,) for k, w in cands.items()]


def _alignment_stats(matches):
    """(covered_words, chunks, distance, weight_sum) of a one-to-one match
    set — the meteor-1.5 resolution objective, lexicographic: maximize
    words covered across both sentences, minimize chunks (contiguous,
    identically-ordered match runs), minimize summed |h_start - r_start|;
    weight_sum (maximized) breaks remaining ties deterministically in
    favor of higher-priority matcher stages."""
    ms = sorted(matches)
    cov = sum(m[1] + m[3] for m in ms)
    chunks = 0
    dist = 0
    wsum = 0.0
    ph = pr = -1
    for h, hl, r, rl, w in ms:
        if not (h == ph and r == pr):
            chunks += 1
        ph, pr = h + hl, r + rl
        dist += abs(h - r)
        wsum += w * (hl + rl)
    return cov, chunks, dist, wsum


def _resolve_alignment(cands, n_hyp):
    """Meteor-1.5 alignment resolution (Denkowski & Lavie 2014 §2;
    the jar's Aligner): beam search over hypothesis positions choosing
    the one-to-one, non-overlapping subset of candidate matches that
    (1) maximizes covered words over both sentences, (2) minimizes
    chunks, (3) minimizes total match start distance, (4, deterministic
    tiebreak) maximizes total matcher weight.  Beam width 40 (the
    jar's) — exhaustive for short sentences (see the brute-force oracle
    in tests/test_tokenizer_meteor.py)."""
    from collections import defaultdict
    by_start = defaultdict(list)
    for m in cands:
        by_start[m[0]].append(m)
    # state: (cov, chunks, dist, wsum, r_mask, prev_h_end, prev_r_end,
    #         matches)
    init = (0, 0, 0, 0.0, 0, -1, -1, ())
    states = {0: [init]}
    key = (lambda st: (-st[0], st[1], st[2], -st[3]))
    for pos in range(n_hyp):
        cur = states.pop(pos, [])
        if not cur:
            continue
        cur.sort(key=key)
        del cur[_ALIGNER_BEAM:]
        nxt = states.setdefault(pos + 1, [])
        for st in cur:
            cov, ch, dist, wsum, rmask, phe, pre, ms = st
            nxt.append(st)                    # hyp word at pos unmatched
            for m in by_start.get(pos, ()):
                h, hl, r, rl, w = m
                mmask = ((1 << rl) - 1) << r
                if rmask & mmask:
                    continue
                nst = (cov + hl + rl,
                       ch + (0 if (h == phe and r == pre) else 1),
                       dist + abs(h - r), wsum + w * (hl + rl),
                       rmask | mmask, h + hl, r + rl, ms + (m,))
                states.setdefault(pos + hl, []).append(nst)
    final = states.get(n_hyp, [])
    if not final:
        return (), 0
    best = min(final, key=key)
    return best[7], best[1]


def _score_alignment(hyp_toks, ref_toks, matches, chunks):
    """Meteor-1.5 score of a resolved alignment: delta-weighted P/R over
    content/function words, alpha-F-mean, gamma*frag^beta fragmentation
    penalty with frag = chunks / mean covered words per side."""
    if not matches:
        return 0.0
    fwords = _active_function_words()

    h_w: dict = {}
    r_w: dict = {}
    for h, hl, r, rl, w in matches:
        for k in range(hl):
            h_w[h + k] = w
        for k in range(rl):
            r_w[r + k] = w

    def weighted_count(toks, idx_weights):
        content = fn = 0.0
        for i, w in idx_weights.items():
            if toks[i] in fwords:
                fn += w
            else:
                content += w
        return content, fn

    def totals(toks):
        c = sum(1 for t in toks if t not in fwords)
        return c, len(toks) - c

    h_c, h_f = weighted_count(hyp_toks, h_w)
    r_c, r_f = weighted_count(ref_toks, r_w)
    th_c, th_f = totals(hyp_toks)
    tr_c, tr_f = totals(ref_toks)
    d = _M_DELTA
    p_den = d * th_c + (1 - d) * th_f
    r_den = d * tr_c + (1 - d) * tr_f
    P = (d * h_c + (1 - d) * h_f) / p_den if p_den > 0 else 0.0
    R = (d * r_c + (1 - d) * r_f) / r_den if r_den > 0 else 0.0
    if P <= 0 or R <= 0:
        return 0.0
    f_mean = P * R / (_M_ALPHA * P + (1 - _M_ALPHA) * R)

    # meteor-1.5 fragmentation denominator: average covered words per side
    avg_matches = (len(h_w) + len(r_w)) / 2.0
    frag = chunks / avg_matches
    penalty = _M_GAMMA * (frag ** _M_BETA)
    return f_mean * (1.0 - penalty)


def _meteor_sentence(hyp_toks, ref_toks, paraphrases=None, synonyms=None):
    if not hyp_toks or not ref_toks:
        return 0.0
    cands = _collect_matches(hyp_toks, ref_toks, paraphrases, synonyms)
    if not cands:
        return 0.0
    matches, chunks = _resolve_alignment(cands, len(hyp_toks))
    return _score_alignment(hyp_toks, ref_toks, matches, chunks)


def meteor_compute_score(gts, res):
    jar = os.environ.get('DVC_METEOR_JAR')
    if jar and os.path.exists(jar):
        return _meteor_jar_compute_score(gts, res, jar)
    paraphrases = _active_paraphrase_table()
    synonyms = _active_synonym_table()
    per_instance = []
    for key in gts:
        hyp = res[key][0].split()
        best = max((_meteor_sentence(hyp, ref.split(), paraphrases, synonyms)
                    for ref in gts[key]), default=0.0)
        per_instance.append(best)
    mean = sum(per_instance) / len(per_instance) if per_instance else 0.0
    return mean, per_instance


def _meteor_jar_compute_score(gts, res, jar):
    """Score-parity mode through the official meteor-1.5 jar
    (same protocol as ``pycocoevalcap/meteor/meteor.py``)."""
    import subprocess
    keys = list(gts.keys())
    proc = subprocess.Popen(
        ['java', '-jar', '-Xmx2G', jar, '-', '-', '-stdio', '-l', 'en',
         '-norm'],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    for key in keys:
        refs = '|||'.join(gts[key])
        proc.stdin.write(' ||| '.join(('SCORE', refs, res[key][0])) + '\n')
    proc.stdin.flush()
    stats = [proc.stdout.readline().strip() for _ in keys]
    for s in stats:
        proc.stdin.write('EVAL ||| ' + s + '\n')
    proc.stdin.flush()
    per_instance = [float(proc.stdout.readline().strip()) for _ in keys]
    final = sum(per_instance) / len(per_instance) if per_instance else 0.0
    proc.stdin.close()
    proc.wait()
    return final, per_instance


# ---------------------------------------------------------------------------
# pycocoevalcap-style scorer objects
# ---------------------------------------------------------------------------

class Bleu:
    def __init__(self, n=4):
        self.n = n

    def method(self):
        return 'Bleu'

    def compute_score(self, gts, res):
        gts_s = {k: list(v) for k, v in gts.items()}
        res_s = {k: list(v) for k, v in res.items()}
        return bleu_compute_score(gts_s, res_s, self.n)


class Meteor:
    def method(self):
        return 'METEOR'

    def compute_score(self, gts, res):
        return meteor_compute_score(gts, res)


class Rouge:
    def method(self):
        return 'ROUGE_L'

    def compute_score(self, gts, res):
        return rouge_l_compute_score(gts, res)


class Cider:
    def method(self):
        return 'CIDEr'

    def compute_score(self, gts, res):
        return cider_compute_score(gts, res)


class Spice:
    """SPICE through the official ``spice-1.0.jar``.

    Protocol parity with the reference wrapper
    (``densevid_eval3/pycocoevalcap/spice/spice.py:32-103``): input is a
    JSON list of ``{image_id, test, refs}`` records, the jar is invoked as
    ``java -jar -Xmx8G spice.jar <in> -cache <dir> -out <out> -subset
    -silent``, and the result is ``(mean of scores['All']['f'],
    per-image category score dicts)`` with non-numeric entries mapped to
    NaN.  SPICE itself is a Java scene-graph matcher over Stanford CoreNLP
    parses — there is no meaningful native reimplementation, and the jar +
    CoreNLP models are external artifacts (the reference downloads them at
    first use, ``spice/get_stanford_models.py``), so this scorer is gated:
    set ``DVC_SPICE_JAR`` to a local jar.  ``DVC_SPICE_JAVA`` overrides the
    java binary (used by the protocol test, which substitutes a stub);
    ``DVC_SPICE_TMP`` pins the work/cache directory.
    """

    def method(self):
        return 'SPICE'

    @staticmethod
    def _float(x):
        try:
            return float(x)
        except (TypeError, ValueError):
            return float('nan')

    def compute_score(self, gts, res):
        import json
        import subprocess
        import tempfile

        jar = os.environ.get('DVC_SPICE_JAR')
        if not jar or not os.path.exists(jar):
            raise RuntimeError(
                'SPICE needs the official spice-1.0.jar (plus java and the '
                'Stanford CoreNLP models): set DVC_SPICE_JAR to a local '
                'copy (no network access in this environment)')
        keys = sorted(gts.keys())
        payload = [{'image_id': k, 'test': res[k][0], 'refs': list(gts[k])}
                   for k in keys]
        workdir = (os.environ.get('DVC_SPICE_TMP')
                   or tempfile.mkdtemp(prefix='dvc_spice_'))
        cache = os.path.join(workdir, 'cache')
        os.makedirs(cache, exist_ok=True)
        in_path = os.path.join(workdir, 'input.json')
        out_path = os.path.join(workdir, 'output.json')
        with open(in_path, 'w') as f:
            json.dump(payload, f, indent=2)
        java = os.environ.get('DVC_SPICE_JAVA', 'java')
        subprocess.check_call(
            [java, '-jar', '-Xmx8G', jar, in_path,
             '-cache', cache, '-out', out_path, '-subset', '-silent'])
        with open(out_path) as f:
            results = json.load(f)
        by_id = {item['image_id']: item['scores'] for item in results}
        per_instance = [self._float(by_id[k]['All']['f']) for k in keys]
        scores = [{cat: {m: self._float(v) for m, v in tup.items()}
                   for cat, tup in by_id[k].items()} for k in keys]
        mean = (float(sum(per_instance) / len(per_instance))
                if per_instance else 0.0)
        return mean, scores
