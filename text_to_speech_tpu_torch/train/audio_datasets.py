"""Corpus loaders: a registry of named layouts, each read into a list of
row dicts.

Counterpart of ``text_to_speech_tpu/train/audio_datasets.py``, without
pandas (the machines that run the port need not have it): where the JAX
package returns a DataFrame, the port returns the list of its records, the
same rows with the same columns in the same order.  Every row has ``id``,
``filename``, ``text`` and ``speaker``; `resample_dataset` adds
``wavs_<rate>``, which `ops.audio_io.load_audio` reads first.

The layouts: ``siwis``, ``common_voice`` (its tsv read with `csv`; the
optional columns ``age``, ``gender`` and ``accent`` kept where the file has
them, as strings), ``libri_speech``, ``voxforge`` and ``ljspeech``.
"""

import csv
import glob
import logging
import os
import re

logger = logging.getLogger(__name__)

_DATASETS = {}


def register_dataset(name):
    def deco(fn):
        _DATASETS[name.lower()] = fn
        return fn
    return deco


def load_dataset(name, directory, ** kwargs):
    key = name.lower()
    if key not in _DATASETS:
        raise ValueError('Unknown dataset {!r} (known: {})'.format(name, sorted(_DATASETS)))
    return _DATASETS[key](directory, ** kwargs)


def list_datasets():
    return sorted(_DATASETS)


@register_dataset('siwis')
def load_siwis(directory, *, langs = ('fr',), parts = None, ** kwargs):
    """SIWIS: ``text/<part>/*.txt`` beside ``wavs/<part>/*.wav`` (one
    professional speaker)."""
    rows = []
    text_root = os.path.join(directory, 'text')
    wav_root = os.path.join(directory, 'wavs')
    part_dirs = sorted(os.listdir(text_root)) if os.path.isdir(text_root) else []
    if parts: part_dirs = [p for p in part_dirs if p in set(map(str, parts))]
    for part in part_dirs:
        for txt in sorted(glob.glob(os.path.join(text_root, part, '*.txt'))):
            stem = os.path.splitext(os.path.basename(txt))[0]
            wav = os.path.join(wav_root, part, stem + '.wav')
            if not os.path.exists(wav): continue
            with open(txt, encoding = 'utf-8') as f:
                text = f.read().strip()
            rows.append({'id': stem, 'filename': wav, 'text': text, 'speaker': 'siwis',
                         'part': part})
    return rows


@register_dataset('common_voice')
def load_common_voice(directory, *, subset = 'validated', ** kwargs):
    """Mozilla Common Voice: ``<subset>.tsv`` (client_id, path, sentence,
    ...) beside ``clips/``."""
    with open(os.path.join(directory, subset + '.tsv'), newline = '', encoding = 'utf-8') as f:
        table = list(csv.DictReader(f, delimiter = '\t'))
    extras = [c for c in ('age', 'gender', 'accent') if table and c in table[0]]
    return [{'id': re.sub(r'\.\w+$', '', r['path']),
             'filename': os.path.join(directory, 'clips', r['path']),
             'text': r['sentence'], 'speaker': r['client_id'],
             ** {c: r[c] for c in extras}} for r in table]


@register_dataset('libri_speech')
def load_libri_speech(directory, ** kwargs):
    """LibriSpeech: ``<speaker>/<chapter>/<speaker>-<chapter>.trans.txt``
    beside the ``.flac`` files."""
    rows = []
    for trans in sorted(glob.glob(os.path.join(directory, '*', '*', '*.trans.txt'))):
        chapter_dir = os.path.dirname(trans)
        speaker = os.path.basename(os.path.dirname(chapter_dir))
        with open(trans, encoding = 'utf-8') as f:
            for line in f:
                if not line.strip(): continue
                utt_id, text = line.strip().split(' ', 1)
                audio = os.path.join(chapter_dir, utt_id + '.flac')
                if os.path.exists(audio):
                    rows.append({'id': utt_id, 'filename': audio, 'text': text.lower(),
                                 'speaker': speaker})
    return rows


@register_dataset('voxforge')
def load_voxforge(directory, ** kwargs):
    """VoxForge sessions: ``<session>/etc/PROMPTS`` and
    ``<session>/wav/*.wav``; the speaker is the session name up to its
    first ``-``."""
    rows = []
    for prompts in sorted(glob.glob(os.path.join(directory, '*', 'etc', 'PROMPTS'))):
        session_dir = os.path.dirname(os.path.dirname(prompts))
        session = os.path.basename(session_dir)
        speaker = session.split('-')[0]
        with open(prompts, encoding = 'utf-8', errors = 'replace') as f:
            for line in f:
                parts = line.strip().split(' ', 1)
                if len(parts) != 2: continue
                utt_path, text = parts
                utt = os.path.basename(utt_path)
                wav = os.path.join(session_dir, 'wav', utt + '.wav')
                if os.path.exists(wav):
                    rows.append({'id': '{}-{}'.format(session, utt), 'filename': wav,
                                 'text': text.lower(), 'speaker': speaker})
    return rows


@register_dataset('ljspeech')
def load_ljspeech(directory, ** kwargs):
    """LJSpeech: ``metadata.csv`` (id|text|normalized text) and ``wavs/``."""
    rows = []
    with open(os.path.join(directory, 'metadata.csv'), encoding = 'utf-8') as f:
        for line in f:
            parts = line.rstrip('\n').split('|')
            if len(parts) < 2: continue
            utt_id, text = parts[0], parts[-1]
            rows.append({'id': utt_id, 'filename': os.path.join(directory, 'wavs', utt_id + '.wav'),
                         'text': text, 'speaker': 'ljspeech'})
    return rows


def resample_dataset(rows, rate, *, directory = None, max_workers = 4):
    """Every row's file resampled to `rate` once, as a 16-bit WAV in a
    ``wavs_<rate>/`` directory beside the originals' (or in `directory`),
    kept for later calls → new rows with a ``wavs_<rate>`` column."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from ..ops.audio_io import load_audio, write_audio

    column = 'wavs_{}'.format(rate)

    def process(filename):
        out_dir = directory or os.path.join(os.path.dirname(os.path.dirname(filename)), column)
        out = os.path.splitext(os.path.join(out_dir, os.path.basename(filename)))[0] + '.wav'
        if not os.path.exists(out):
            audio = load_audio(filename, rate)
            write_audio(out, (np.asarray(audio) * 32767).astype('int16'), rate)
        return out

    with ThreadPoolExecutor(max_workers = max_workers) as pool:
        outs = list(pool.map(process, [r['filename'] for r in rows]))
    return [dict(r, ** {column: out}) for r, out in zip(rows, outs)]
