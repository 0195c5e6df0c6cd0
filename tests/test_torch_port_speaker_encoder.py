"""The speaker encoder and the embedding utilities: the port against the JAX
package on the same seeded inputs.

One tiny encoder (the ``tests/test_encoder.py`` sizes: two strided convs of
8 filters, width 3, a 16-wide embedding) with seeded weights and batch-norm
statistics away from the identity, handed to both packages:

  - `AudioEncoder` at even and odd lengths (XLA's SAME padding at stride
    2), with and without `lengths`: 1e-5 absolute (float32 on both sides);
  - `SpeakerEncoder.embed` of a saved JAX encoder loaded by name, on one
    clip and on a ragged batch with a 22,050 Hz WAV (resampled to 16 kHz):
    1e-5 absolute (the mels agree to float32 rounding; the embeddings are
    l2-normalized);
  - the encoder saved by the port, loaded by the JAX package; `identify`;
  - `utils.embeddings` files written by one package and read by the other
    (npy, npz, pkl), the selection modes and centroids, and every metric of
    `utils.distances`: equal up to float32 rounding (1e-6).
"""

import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse, module)
from text_to_speech_tpu.models import saving
from text_to_speech_tpu.models.encoder import SpeakerEncoder as JaxSpeakerEncoder
from text_to_speech_tpu.models.encoder_arch import AudioEncoder as JaxAudioEncoder
from text_to_speech_tpu.models.interfaces import reset_instances
from text_to_speech_tpu.nn import activations as jax_activations, layers as jax_layers
from text_to_speech_tpu.utils import distances as jax_distances, embeddings as jax_embeddings
from text_to_speech_tpu_torch.init import init_audio_encoder
from text_to_speech_tpu_torch.models import get_pretrained
from text_to_speech_tpu_torch.models.encoder import SpeakerEncoder
from text_to_speech_tpu_torch.models.encoder_arch import AudioEncoder
from text_to_speech_tpu_torch.nn import layers
from text_to_speech_tpu_torch.ops.audio_io import write_wav
from text_to_speech_tpu_torch.utils import distances, embeddings
from text_to_speech_tpu_torch.weights import audio_encoder_from_jax, audio_encoder_to_jax

TINY = dict(embedding_dim = 16, filters = (8, 8), strides = (2, 2), kernel_size = 3)
ATOL = 1e-5


def _jax(tree):
    return {k: _jax(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in tree.items()}


def clip(seconds, f0, rate = 16000, seed = 0):
    t = np.arange(int(seconds * rate)) / rate
    noise = np.random.default_rng(seed).standard_normal(len(t))
    return (0.5 * np.sin(2 * np.pi * f0 * t) + 0.05 * noise).astype(np.float32)


@pytest.fixture(scope = 'module')
def weights():
    return init_audio_encoder(AudioEncoder(** TINY).hp, seed = 0, statistics = True)


@pytest.fixture(scope = 'module')
def saved(weights, tmp_path_factory):
    """A models root holding the JAX encoder 'enc_tiny' (the seeded weights),
    with the JAX model, and reference audio: three clips as rows and a WAV
    at 22,050 Hz."""
    root = str(tmp_path_factory.mktemp('models'))
    wav = os.path.join(root, 'reference_22050.wav')
    write_wav(wav, clip(0.7, 150., rate = 22050, seed = 3), 22050)
    rows = [{'audio': clip(s, f, seed = i), 'rate': 16000}
            for i, (s, f) in enumerate(((0.5, 110.), (0.8, 220.), (1.1, 330.)))]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(saving, '_PRETRAINED_ROOT', root)
        reset_instances()
        jax_encoder = JaxSpeakerEncoder(name = 'enc_tiny', ** TINY)
        jax_encoder.set_weights(* (_jax(t) for t in weights))
        jax_encoder.save()
        yield root, jax_encoder, rows + [wav]
        reset_instances()


@pytest.mark.parametrize('width,T', [(5, 20), (5, 21), (3, 7), (4, 10)])
def test_strided_same_padding_matches_xla(width, T):
    rng = np.random.default_rng(width + T)
    x = rng.standard_normal((2, T, 3)).astype(np.float32)
    conv = {'kernel': rng.standard_normal((width, 3, 4)).astype(np.float32),
            'bias': rng.standard_normal(4).astype(np.float32)}
    ref = jax_layers.conv1d(_jax(conv), jnp.asarray(x), stride = 2, padding = 'SAME')
    port = {'weight': torch.from_numpy(conv['kernel'].transpose(2, 1, 0).copy()),
            'bias': torch.from_numpy(conv['bias'])}
    out = layers.conv1d(port, torch.from_numpy(x), stride = 2, padding = 'SAME')
    assert out.shape == ref.shape == (2, -(-T // 2), 4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol = ATOL, rtol = 0)


def test_l2_norm_matches_jax():
    x = np.random.default_rng(1).standard_normal((3, 16)).astype(np.float32)
    x[1] = 0.                                              # the epsilon floor
    np.testing.assert_allclose(layers.l2_norm(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_activations.l2_norm(jnp.asarray(x))),
                               atol = 1e-6, rtol = 0)


@pytest.mark.parametrize('T', [20, 21])
@pytest.mark.parametrize('ragged', [False, True])
def test_audio_encoder_matches_jax(weights, T, ragged):
    jparams, jstate = weights
    params, state = audio_encoder_from_jax(jparams, jstate)
    mel = np.random.default_rng(T).standard_normal((3, T, 80)).astype(np.float32)
    lengths = np.array([T, T - 5, T - 8], np.int32) if ragged else None
    ref, _ = JaxAudioEncoder(** TINY)(_jax(jparams), _jax(jstate), jnp.asarray(mel),
                                      lengths = None if lengths is None else jnp.asarray(lengths))
    out = AudioEncoder(** TINY)(params, state, torch.from_numpy(mel),
                                lengths = None if lengths is None else torch.from_numpy(lengths))
    assert out.shape == (3, 16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol = ATOL, rtol = 0)
    np.testing.assert_allclose(np.linalg.norm(out.numpy(), axis = 1), 1., atol = 1e-6)


def test_weights_round_trip(weights):
    """The GE2E scalars ride along; the trees come back bit for bit."""
    jparams, jstate = weights
    params, state = audio_encoder_from_jax(jparams, jstate)
    assert params['ge2e']['w'].shape == () and float(params['ge2e']['b']) == -5.
    back_params, back_state = audio_encoder_to_jax(params, state)
    for ref, out in ((jparams, back_params), (jstate, back_state)):
        flat_ref, flat_out = _flat(ref), _flat(out)
        assert sorted(flat_ref) == sorted(flat_out)
        for key, value in flat_ref.items():
            np.testing.assert_array_equal(flat_out[key], value, err_msg = key)


def _flat(tree, prefix = ''):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + '/'))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_embed_by_name_matches_jax(saved):
    """One clip, and a ragged batch with the resampled WAV: the batch pads
    to its longest mel, then to a multiple of 64, on both sides."""
    root, jax_encoder, references = saved
    encoder = get_pretrained('enc_tiny', root = root, device = 'cpu')
    assert isinstance(encoder, SpeakerEncoder) and encoder.rate == 16000
    assert encoder.embedding_dim == 16 and encoder.mel_fn.n_mel_channels == 80
    one = encoder.embed(references[0])
    assert one.shape == (16,)
    np.testing.assert_allclose(one, jax_encoder.embed(references[0]), atol = ATOL, rtol = 0)
    batch = encoder.embed(references)
    assert batch.shape == (4, 16)
    np.testing.assert_allclose(batch, jax_encoder.embed(references), atol = ATOL, rtol = 0)
    # a clip's embedding depends on the batch's padding, as in the JAX package
    assert float(np.abs(batch[0] - one).max()) > 0.
    labels = ['low', 'mid', 'high', 'wav']
    assert encoder.identify(references[1], batch, labels = labels) \
        == jax_encoder.identify(references[1], batch, labels = labels) == 'mid'
    # GE2E training is ported (``test_torch_port_encoder_train.py``): rows
    # without enough speakers are refused, and a group collates as the JAX
    # package's does
    with pytest.raises(ValueError, match = 'speakers'):
        encoder.fit([])
    mel = np.zeros((30, 80), np.float32)
    (mels, lengths), targets = encoder.collate_ge2e([[mel, mel[:10]]])
    (ref_mels, ref_lengths), _ = jax_encoder.collate_ge2e([[mel, mel[:10]]])
    assert targets is None and mels.shape == ref_mels.shape
    np.testing.assert_array_equal(lengths, ref_lengths)
    with pytest.raises(NotImplementedError):
        encoder.embed(references[0], trim_silence = True)


def test_port_save_loads_in_jax(saved, monkeypatch):
    root, jax_encoder, references = saved
    encoder = SpeakerEncoder.from_pretrained('enc_tiny', root = root, device = 'cpu')
    encoder.name, encoder.folder = 'enc_port', os.path.join(root, 'enc_port')
    encoder.save()
    monkeypatch.setattr(saving, '_PRETRAINED_ROOT', root)
    reloaded = JaxSpeakerEncoder(name = 'enc_port')
    np.testing.assert_allclose(reloaded.embed(references[:2]), encoder.embed(references[:2]),
                               atol = ATOL, rtol = 0)


@pytest.mark.parametrize('ext', ['.npy', '.npz', '.pkl'])
def test_embedding_files_cross_packages(tmp_path, ext):
    table = np.random.default_rng(2).standard_normal((4, 6)).astype(np.float32)
    meta = {} if ext == '.npy' else {'speaker': ['a', 'b', 'a', 'c']}
    for writer, reader in ((embeddings, jax_embeddings), (jax_embeddings, embeddings)):
        name = str(tmp_path / '{}{}'.format(writer.__name__.split('.')[0], ext))
        written = writer.save_embeddings(name, table, ** meta)
        got = reader.load_embeddings(written)
        np.testing.assert_array_equal(got['embedding'], table)
        if meta:
            assert list(got['speaker']) == meta['speaker']


def test_embedding_selection_matches_jax():
    rng = np.random.default_rng(3)
    table = {'embedding': rng.standard_normal((6, 4)).astype(np.float32),
             'speaker': np.array(['a', 'b', 'a', 'c', 'b', 'a'])}
    for kw in (dict(mode = 'mean'), dict(mode = 'mean', label = 'a'), dict(mode = 2),
               dict(mode = 'random', seed = 5), dict(mode = 'mean', label = 'b',
                                                     label_column = 'speaker')):
        np.testing.assert_allclose(embeddings.select_embedding(table, ** kw),
                                   jax_embeddings.select_embedding(table, ** kw), atol = 1e-6)
    with pytest.raises(ValueError):
        embeddings.select_embedding(table, label = 'zz')
    # 'label' is a mode here: the mean of the label's rows (the JAX package
    # lists it but refuses it)
    np.testing.assert_allclose(embeddings.select_embedding(table, mode = 'label', label = 'a'),
                               jax_embeddings.select_embedding(table, mode = 'mean', label = 'a'),
                               atol = 1e-6)
    with pytest.raises(ValueError, match = 'selection mode'):
        jax_embeddings.select_embedding(table, mode = 'label', label = 'a')
    with pytest.raises(ValueError, match = 'label'):
        embeddings.select_embedding(table, mode = 'label')
    labels, centroids = embeddings.compute_centroids(table['embedding'], table['speaker'])
    ref_labels, ref_centroids = jax_embeddings.compute_centroids(table['embedding'],
                                                                 table['speaker'])
    assert labels == ref_labels == ['a', 'b', 'c']
    np.testing.assert_allclose(centroids, ref_centroids, atol = 1e-6)
    query = table['embedding'][3]
    for method in ('euclidean', 'cosine'):
        assert embeddings.get_closest_centroid(query, centroids, method) \
            == jax_embeddings.get_closest_centroid(query, centroids, method)
    aggregated = embeddings.aggregate_embeddings(table, column = 'speaker')
    np.testing.assert_allclose(
        aggregated['speaker_embedding'],
        jax_embeddings.aggregate_embeddings(table, column = 'speaker')['speaker_embedding'],
        atol = 1e-6)
    got = embeddings.get_embeddings_with_ids(table['embedding'], table['speaker'], ['b', 'c'])
    ref = jax_embeddings.get_embeddings_with_ids(table['embedding'], table['speaker'],
                                                 ['b', 'c'])
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    for text in ('[1, 2.5, -3]', '[[1 2], [3 4]]'):
        np.testing.assert_array_equal(embeddings.embeddings_to_np(text),
                                      jax_embeddings.embeddings_to_np(text))


@pytest.mark.parametrize('method', ['euclidean', 'manhattan', 'dot', 'cosine',
                                    'cosine_distance', 'dice'])
def test_distances_match_jax(method):
    rng = np.random.default_rng(4)
    x, y = rng.random((3, 5)).astype(np.float32), rng.random((4, 5)).astype(np.float32)
    np.testing.assert_allclose(distances.distance(x, y, method, as_matrix = True),
                               jax_distances.distance(x, y, method, as_matrix = True),
                               atol = 1e-6, rtol = 1e-6)
    np.testing.assert_allclose(distances.distance(x, y[:3], method),
                               jax_distances.distance(x, y[:3], method), atol = 1e-6, rtol = 1e-6)
    ids = np.array([0, 1, 1, 2])
    for weighted in (False, True):
        got = distances.knn(x, y, ids, k = 3, method = method, weighted = weighted,
                            return_scores = True)
        ref = jax_distances.knn(x, y, ids, k = 3, method = method, weighted = weighted,
                                return_scores = True)
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_allclose(got[1], ref[1], rtol = 1e-6)
    with pytest.raises(ValueError):
        distances.distance(x, y, 'nope')
