"""The port's data pipeline, corpora, checkpoints and history against the
JAX package's, on tiny synthetic data: every comparison exact.

  - `as_rows` of lists, column dicts, a DataFrame and csv / tsv files;
    `train_test_split` by rows and by speaker;
  - `Dataset` batches over two epochs (shuffle seed, length buckets, a
    filter, drop_remainder, the prefetch thread, parallel map) and its
    native preload; an error of the collate function reaches the consumer;
  - `FileCacheDataset`: the second epoch and a new dataset over the same
    directory read the files back, tuples of arrays identical, without
    mapping again (the JAX package's cannot read a tuple back: pinned);
  - the five corpus layouts, `get_dataset` of one and of several corpora,
    the registry, `summarize_dataset`, `benchmark_dataset` and
    `resample_dataset`: the port's rows equal the records of the JAX
    package's DataFrames;
  - `CheckpointManager` best, rotation and ``load(best = True)``, through
    the async saver too, and `History.get_best`, on one sequence of
    metrics: the same manifest and the same best.
"""

import os

import numpy as np
import pandas as pd
import pytest
from scipy.io import wavfile

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse, module)

from text_to_speech_tpu.train import audio_datasets as jcorpora
from text_to_speech_tpu.train import datasets as jdatasets
from text_to_speech_tpu.train import loader as jloader
from text_to_speech_tpu.train.checkpoint import CheckpointManager as JaxManager
from text_to_speech_tpu.train.history import History as JaxHistory

from text_to_speech_tpu_torch.train import audio_datasets as corpora
from text_to_speech_tpu_torch.train import datasets, loader
from text_to_speech_tpu_torch.train.checkpoint import AsyncCheckpointSaver, CheckpointManager
from text_to_speech_tpu_torch.train.history import History
from text_to_speech_tpu_torch.utils.file_utils import load_json

ROWS = [{'filename': 'f{}.wav'.format(i), 'text': 'text number {}'.format('x' * (i % 5)),
         'speaker': 'spk{}'.format(i % 3)} for i in range(11)]


def test_rows_and_splits_match_jax(tmp_path):
    columns = {k: [r[k] for r in ROWS] for k in ROWS[0]}
    frame = pd.DataFrame(ROWS)
    for sep, ext in ((',', 'csv'), ('\t', 'tsv')):
        path = str(tmp_path / ('rows.' + ext))
        frame.to_csv(path, sep = sep, index = False)
        assert datasets.as_rows(path) == jdatasets.as_rows(path) == ROWS
    for source in (ROWS, tuple(ROWS), columns, frame):
        assert datasets.as_rows(source) == jdatasets.as_rows(source) == ROWS
    for kw in (dict(valid_size = 0.3), dict(valid_size = 2, random_state = 3),
               dict(valid_size = 0.1, shuffle = False),
               dict(split_column = 'speaker', valid_size = 0.5),
               dict(split_column = 'speaker', valid_size = 1, random_state = 5),
               dict(split_column = 'speaker', valid_size = 0.2, shuffle = False)):
        out = datasets.train_test_split(ROWS, ** kw)
        assert out == jdatasets.train_test_split(ROWS, ** kw), kw
    train, valid = datasets.train_test_split(frame, split_column = 'speaker', valid_size = 0.5)
    assert not {r['speaker'] for r in train} & {r['speaker'] for r in valid}


def _map(row):
    return (np.arange(len(row['text'])), row['speaker'])


def _collate(items):
    return [(int(len(t)), s) for t, s in items]


@pytest.mark.parametrize('kw', [
    dict(shuffle = True, batch_size = 3, prefetch = 2, seed = 4),
    dict(shuffle = True, batch_size = 2, prefetch = 0, seed = 1,
         length_bucket_fn = lambda item: len(item[0]), drop_remainder = True),
    dict(shuffle = False, batch_size = 4, num_parallel_calls = 3, prefetch = 1,
         filter_fn = lambda tokens, speaker: speaker != 'spk1')],
    ids = ['shuffle-prefetch', 'buckets-drop', 'parallel-filter'])
def test_dataset_batches_match_jax(kw):
    ds = datasets.Dataset(ROWS, map_fn = _map, collate_fn = _collate, ** kw)
    ref = jdatasets.Dataset(ROWS, map_fn = _map, collate_fn = _collate, ** kw)
    assert len(ds) == len(ref)
    for _ in range(2):
        assert list(ds) == list(ref)
    prepared = datasets.prepare_dataset(ROWS, prepare_fn = _map, collate_fn = _collate,
                                        batch_size = 3, seed = 2)
    assert list(prepared) == list(jdatasets.prepare_dataset(
        ROWS, prepare_fn = _map, collate_fn = _collate, batch_size = 3, seed = 2))


def test_prefetch_raises_the_collate_error():
    def broken(items):
        raise KeyError('no collate')
    ds = datasets.Dataset(ROWS, collate_fn = broken, batch_size = 2, prefetch = 2)
    with pytest.raises(KeyError, match = 'no collate'):
        list(ds)
    # a consumer that stops early leaves no producer behind
    ds = datasets.Dataset(ROWS, batch_size = 1, prefetch = 1)
    next(iter(ds))


def test_native_preload_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    rows = []
    for i, rate in enumerate((16000, 22050, 16000)):
        path = str(tmp_path / 'a{}.wav'.format(i))
        wavfile.write(path, rate, (rng.standard_normal(rate // 4) * 8000).astype(np.int16))
        rows.append({'filename': path, 'text': 'x'})
    rows.append({'audio': np.ones(4, np.float32), 'rate': 22050, 'filename': 'kept.wav'})
    kw = dict(native_audio_rate = 22050, prefetch = 0, batch_size = 4)
    ds = datasets.Dataset(rows, ** kw)
    (batch,), (ref,) = list(ds), list(jdatasets.Dataset(rows, ** kw))
    assert ds.native_rows == 3
    for out, expected in zip(batch, ref):
        assert out.keys() == expected.keys() and out['rate'] == expected['rate'] == 22050
        np.testing.assert_array_equal(out['audio'], expected['audio'])


def test_file_cache_reads_back_what_it_mapped(tmp_path):
    calls = []

    def prepare(row):
        calls.append(row['filename'])
        n = len(row['text'])
        return (np.arange(n), np.full((n, 3), 0.5, np.float32), n), (np.ones(n), row['speaker'])

    kw = dict(map_fn = prepare, cache = False, prefetch = 0, batch_size = 4)
    ds = datasets.FileCacheDataset(ROWS, str(tmp_path / 'cache'), ** kw)
    first = [item for batch in ds for item in batch]
    assert len(calls) == len(ROWS) and len(os.listdir(tmp_path / 'cache')) == len(ROWS)
    again = datasets.FileCacheDataset(ROWS, str(tmp_path / 'cache'), ** kw)
    for second in ([item for batch in ds for item in batch],
                   [item for batch in again for item in batch]):
        assert len(calls) == len(ROWS) and len(second) == len(first)
        for a, b in zip(first, second):
            (ta, ma, na), (ga, sa) = a
            (tb, mb, nb), (gb, sb) = b
            assert isinstance(b, tuple) and na == nb and sa == sb
            for x, y in ((ta, tb), (ma, mb), (ga, gb)):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
    # the JAX package writes the same rows but cannot read a tuple back
    ref = jdatasets.FileCacheDataset(ROWS, str(tmp_path / 'jax_cache'), ** kw)
    ref._materialize()
    with pytest.raises(ValueError, match = 'size 1'):
        ref._materialize()


def _write(path, text = ''):
    os.makedirs(os.path.dirname(path), exist_ok = True)
    with open(path, 'w', encoding = 'utf-8') as f:
        f.write(text)


@pytest.fixture(scope = 'module')
def corpus_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('corpora'))
    j = os.path.join
    for part in ('part1', 'part2'):
        for stem in ('a', 'b'):
            _write(j(root, 'siwis', 'text', part, stem + '.txt'), 'Bonjour {} {}\n'.format(part, stem))
            _write(j(root, 'siwis', 'wavs', part, stem + '.wav'))
    _write(j(root, 'siwis', 'text', 'part2', 'orphan.txt'), 'no wav')
    _write(j(root, 'common_voice', 'validated.tsv'),
           'client_id\tpath\tsentence\tage\tgender\n'
           'c1\tx1.mp3\tFirst sentence.\ttwenties\tmale\n'
           'c2\tx2.mp3\tSecond one.\tthirties\tfemale\n')
    for spk, chapter in (('19', '198'), ('26', '495')):
        d = j(root, 'libri_speech', spk, chapter)
        _write(j(d, '{}-{}.trans.txt'.format(spk, chapter)),
               '{0}-{1}-0000 HELLO THERE\n\n{0}-{1}-0001 GOOD MORNING\n'.format(spk, chapter))
        _write(j(d, '{}-{}-0000.flac'.format(spk, chapter)))
        _write(j(d, '{}-{}-0001.flac'.format(spk, chapter)))
    for session in ('anna-20100101-abc', 'bob-20110202-xyz'):
        d = j(root, 'voxforge', session)
        _write(j(d, 'etc', 'PROMPTS'), 'mfc/a0001 HELLO WORLD\nmfc/a0002 A SECOND PROMPT\nbad\n')
        _write(j(d, 'wav', 'a0001.wav'))
        _write(j(d, 'wav', 'a0002.wav'))
    _write(j(root, 'ljspeech', 'metadata.csv'),
           'LJ001-0001|Printing, in the only sense|Printing, in the only sense\n'
           'LJ001-0002|In being comparatively modern.|In being comparatively modern.\n')
    return root


@pytest.mark.parametrize('name', ['siwis', 'common_voice', 'libri_speech', 'voxforge',
                                  'ljspeech'])
def test_corpus_layouts_match_jax(corpus_root, name):
    directory = os.path.join(corpus_root, name)
    rows = corpora.load_dataset(name, directory)
    assert rows and rows == jcorpora.load_dataset(name, directory).to_dict('records')
    assert rows == loader.get_dataset(name, directory = directory)


def test_loader_matches_jax(corpus_root, tmp_path):
    # the JAX package's own corpora: other test files of a worker register
    # custom loaders in its process-wide registry (`add_dataset`)
    builtin = sorted(name for name, fn in jcorpora._DATASETS.items()
                     if fn.__module__ == jcorpora.__name__)
    assert corpora.list_datasets() == builtin
    old = loader.get_dataset_dir(), jloader.get_dataset_dir()
    try:
        loader.set_dataset_dir(corpus_root)
        jloader.set_dataset_dir(corpus_root)
        for spec in (['voxforge', 'ljspeech'], {'siwis': {'parts': ['part2']},
                                                'libri_speech': None}):
            # pandas fills a column that one corpus lacks with NaN; the
            # port's rows keep their own columns
            out = loader.get_dataset(spec)
            assert out == [{k: v for k, v in r.items() if not (isinstance(v, float) and v != v)}
                           for r in jloader.get_dataset(spec).to_dict('records')]
            assert {r['dataset'] for r in out} == set(spec)
        libri = os.path.join(corpus_root, 'libri_speech')
        assert loader.get_dataset('LibriSpeech', directory = libri) \
            == jloader.get_dataset('LibriSpeech', directory = libri).to_dict('records')
        assert loader.get_dataset_dir('voxforge') == os.path.join(corpus_root, 'voxforge')
        assert loader.is_custom_dataset(['CommonVoice', 'nope']) == [True, False]
    finally:
        loader.set_dataset_dir(old[0])
        jloader.set_dataset_dir(old[1])
    summary = loader.summarize_dataset(ROWS + [{'n': 3}], limit = 5)
    ref = jloader.summarize_dataset(ROWS + [{'n': 3}], limit = 5)
    assert summary['speaker'] == ref['speaker'] and summary['filename'] == ref['filename']
    numbers = [{'n': v} for v in (3, 1, 4, 1, 5, 9, 2, 6)]
    out, expected = loader.summarize_dataset(numbers)['n'], jloader.summarize_dataset(numbers)['n']
    assert out.keys() == expected.keys()
    for key, value in expected.items():
        assert out[key] == pytest.approx(value, rel = 1e-12, abs = 0), key
    loader.add_dataset(lambda directory, ** kw: [{'id': directory}], name = 'Tiny Set',
                       task = loader.Task.SI, directory = '{}/tiny')
    try:
        assert loader.get_dataset('tinyset') == [{'id': '{}/tiny'.format(loader.get_dataset_dir())}]
        assert 'Tiny Set' in loader._TASKS[loader.Task.SI.value]
        loader.show_datasets()
    finally:
        corpora._DATASETS.pop('tiny set')
        loader._DATASET_INFOS.pop('tinyset')
        loader._TASKS.pop(loader.Task.SI.value)
    with pytest.raises(ValueError, match = 'Unknown dataset'):
        loader.get_dataset('tinyset')
    stats = loader.benchmark_dataset(ROWS, steps = 2, build = True, prepare_fn = _map,
                                     collate_fn = lambda items: np.stack([len(t) for t, _ in items]),
                                     batch_size = 3)
    assert stats['steps'] == 2 and stats['batch_stats'].startswith('shape : (3,)')


def test_resample_dataset_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    rows = []
    for i in range(2):
        path = str(tmp_path / 'corpus' / 'wav' / 'u{}.wav'.format(i))
        os.makedirs(os.path.dirname(path), exist_ok = True)
        wavfile.write(path, 16000, (rng.standard_normal(4000) * 6000).astype(np.int16))
        rows.append({'filename': path, 'speaker': 's'})
    out = corpora.resample_dataset(rows, 22050, directory = str(tmp_path / 'port'))
    ref = jcorpora.resample_dataset(pd.DataFrame(rows), 22050,
                                    directory = str(tmp_path / 'jax')).to_dict('records')
    assert [r['wavs_22050'] for r in out] == [r['wavs_22050'].replace('/jax/', '/port/')
                                              for r in ref]
    for r, e in zip(out, ref):
        a, b = wavfile.read(r['wavs_22050']), wavfile.read(e['wavs_22050'])
        assert a[0] == b[0] == 22050
        np.testing.assert_array_equal(a[1], b[1])


METRICS = [5., 3., 4., None, 2.5, 6., 7.]


def test_best_checkpoint_rotation_and_history_match_jax(tmp_path):
    tree = lambda e: {'params': {'w': np.full((2,), float(e), np.float32)}}
    manager = CheckpointManager(str(tmp_path / 'port'), max_to_keep = 2)
    saver = AsyncCheckpointSaver(CheckpointManager(str(tmp_path / 'async'), max_to_keep = 2))
    ref = JaxManager(str(tmp_path / 'jax'), max_to_keep = 2)
    history, jhistory = History(), JaxHistory()
    for h in (history, jhistory):
        h.set_config({'epochs': len(METRICS)})
    for epoch, metric in enumerate(METRICS, start = 1):
        for m in (manager, ref):
            m.save(tree(epoch), epoch, metric = metric)
        saver.save(tree(epoch), epoch, metric = metric)
        for h in (history, jhistory):
            h.on_epoch_begin(epoch - 1)
            h.on_batch_end({'loss': 1.})
            h.on_epoch_end({'val_loss': metric, 'acc': -epoch}, epoch = epoch - 1)
        assert manager.best_epoch == ref.best_epoch
        # a rotated checkpoint is never the best
        assert manager.best_epoch in [c['epoch'] for c in manager.checkpoints]
    saver.close()
    manifest = load_json(str(tmp_path / 'jax' / 'checkpoint.json'))
    for directory in ('port', 'async'):
        assert load_json(str(tmp_path / directory / 'checkpoint.json')) == manifest
    assert manager.checkpoints == ref.checkpoints and manager.best_epoch == 5
    assert sorted(os.listdir(tmp_path / 'port')) == sorted(os.listdir(tmp_path / 'jax'))
    np.testing.assert_array_equal(manager.load(best = True)['params']['w'], [5., 5.])
    np.testing.assert_array_equal(manager.load()['params']['w'], [7., 7.])
    for metric, mode in (('val_loss', None), ('acc', None), ('acc', 'min'), ('nope', None)):
        assert history.get_best(metric, mode) == jhistory.get_best(metric, mode)
    # history epochs count from 0, checkpoints from 1
    assert history.get_best('val_loss')[1] + 1 == manager.best_epoch
    assert (len(history), history.steps, repr(history)) == (len(jhistory), jhistory.steps,
                                                            repr(jhistory))
    # is_best forces; without any metric the best falls back to the latest
    manager.save(tree(8), 8, is_best = True)
    ref.save(tree(8), 8, is_best = True)
    assert manager.best_epoch == ref.best_epoch == 8
    plain = CheckpointManager(str(tmp_path / 'plain'))
    plain.save(tree(1), 1)
    plain.save(tree(2), 2)
    assert plain.best_epoch is None
    np.testing.assert_array_equal(plain.load(best = True)['params']['w'], [2., 2.])
