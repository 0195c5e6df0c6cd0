"""The port's transformer families and task heads against the JAX
package's, on the CPU, from HuggingFace models with random weights (built
from configs, no network; the configs of the JAX package's tests).

  - every converter (GPT-2, BERT, XLM-R, Mistral, Llama, Mixtral, T5, BART,
    mBART, Whisper; the MLM, classifier, NSP, QA and DPR heads): the port's
    numpy tree equal to the JAX converter's, array for array;
  - `from_hf_pretrained`: the port's params equal to
    `weights.transformer_from_jax` of the JAX function's, and the model's
    output against the HF model's at the JAX tests' tolerances (where the
    JAX preset matches the HF architecture: not XLM-R's position offset,
    not mBART's pre-norm);
  - the heads' outputs against HF's, the mean-pooled sentence embedding
    against the JAX function's, and `get_family`.
"""

import numpy as np
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse, module)

import jax
import jax.numpy as jnp

transformers = pytest.importorskip('transformers')

from text_to_speech_tpu.models.transformers import families as jax_families
from text_to_speech_tpu.models.transformers import heads as jax_heads
from text_to_speech_tpu_torch import init
from text_to_speech_tpu_torch.models.transformers import families, heads, transformer_arch
from text_to_speech_tpu_torch.weights import transformer_from_jax

TOKENS = np.array([[5, 9, 13, 2, 7, 11]])


def _tree_equal(port, ref):
    assert jax.tree_util.tree_structure(port) == jax.tree_util.tree_structure(ref)
    for a, b in zip(jax.tree_util.tree_leaves(port), jax.tree_util.tree_leaves(ref)):
        assert isinstance(a, np.ndarray) and np.array_equal(a, np.asarray(b))


def _sd(hf):
    return {k: v.detach().numpy() for k, v in hf.state_dict().items()}


def _decoder_logits(hf, model, params):
    with torch.no_grad():
        ref = hf(torch.tensor(TOKENS)).logits.numpy()
        out, _ = model.decode(params, torch.tensor(TOKENS))
    return out.numpy(), ref, 3e-4


def _encoder_hidden(hf, model, params):
    with torch.no_grad():
        ref = hf(torch.tensor(TOKENS)).last_hidden_state.numpy()
        out, _ = model.encode(params, torch.tensor(TOKENS))
    return out.numpy(), ref, 2e-4


def _encdec_hidden(hf, model, params, ** inputs):
    """The encoder's hidden states and the decoder's, the latter projected
    back from the tied logits (as the JAX package's tests compare them)."""
    dec = torch.tensor([[1, 7, 3]])
    with torch.no_grad():
        ref = hf(decoder_input_ids = dec, ** inputs)
        src = inputs.get('input_ids', inputs.get('input_features'))
        if 'input_features' in inputs:
            src = src.transpose(1, 2)
        enc, mask = model.encode(params, src)
        logits, _ = model.decode(params, dec, encoder_output = enc, encoder_mask = mask)
    hidden = logits.numpy() @ np.linalg.pinv(params['decoder']['embedding']['weight'].numpy().T)
    np.testing.assert_allclose(enc.numpy(), ref.encoder_last_hidden_state.numpy(), atol = 5e-4)
    return hidden, ref.last_hidden_state.numpy(), 5e-3


def _t5():
    cfg = transformers.T5Config(vocab_size = 64, d_model = 32, d_kv = 8, d_ff = 64, num_layers = 2,
                                num_heads = 4, relative_attention_num_buckets = 8)
    return transformers.T5Model(cfg), lambda hf, m, p: _encdec_hidden(
        hf, m, p, input_ids = torch.tensor([[5, 9, 13, 2]]))


def _bart(cls, config):
    cfg = config(vocab_size = 64, d_model = 32, encoder_layers = 2, decoder_layers = 2,
                 encoder_attention_heads = 4, decoder_attention_heads = 4, encoder_ffn_dim = 64,
                 decoder_ffn_dim = 64, max_position_embeddings = 64)
    return cls(cfg), lambda hf, m, p: _encdec_hidden(
        hf, m, p, input_ids = torch.tensor([[5, 9, 13, 2]]))


def _whisper():
    cfg = transformers.WhisperConfig(
        vocab_size = 64, d_model = 32, encoder_layers = 2, decoder_layers = 2,
        encoder_attention_heads = 4, decoder_attention_heads = 4, encoder_ffn_dim = 64,
        decoder_ffn_dim = 64, num_mel_bins = 20, max_source_positions = 50,
        max_target_positions = 40, pad_token_id = 0, bos_token_id = 1, eos_token_id = 2,
        decoder_start_token_id = 1, suppress_tokens = None, begin_suppress_tokens = None)
    mel = torch.tensor(np.random.RandomState(0).randn(1, 20, 100).astype(np.float32))
    return transformers.WhisperModel(cfg), lambda hf, m, p: _encdec_hidden(
        hf, m, p, input_features = mel)


def _bert_config(cls):
    return cls(vocab_size = 64, hidden_size = 32, num_hidden_layers = 2, num_attention_heads = 2,
               intermediate_size = 64, max_position_embeddings = 32)


def _rope_config(cls, ** kw):
    return cls(vocab_size = 64, hidden_size = 32, intermediate_size = 64, num_hidden_layers = 2,
               num_attention_heads = 4, max_position_embeddings = 64, ** kw)


FAMILIES = {
    'gpt2': lambda: (transformers.GPT2LMHeadModel(transformers.GPT2Config(
        vocab_size = 64, n_positions = 32, n_embd = 32, n_layer = 2, n_head = 2)),
        _decoder_logits),
    'bert': lambda: (transformers.BertModel(_bert_config(transformers.BertConfig)),
                     _encoder_hidden),
    'xlm-roberta': lambda: (transformers.XLMRobertaModel(
        _bert_config(transformers.XLMRobertaConfig)), None),
    'mistral': lambda: (transformers.MistralForCausalLM(_rope_config(
        transformers.MistralConfig, num_key_value_heads = 2)), _decoder_logits),
    'llama': lambda: (transformers.LlamaForCausalLM(_rope_config(
        transformers.LlamaConfig, num_key_value_heads = 4, rope_theta = 500000.)),
        _decoder_logits),
    'mixtral': lambda: (transformers.MixtralForCausalLM(_rope_config(
        transformers.MixtralConfig, num_key_value_heads = 2, num_local_experts = 4,
        num_experts_per_tok = 2)), _decoder_logits),
    't5': _t5,
    'bart': lambda: _bart(transformers.BartModel, transformers.BartConfig),
    'mbart': lambda: (_bart(transformers.MBartModel, transformers.MBartConfig)[0], None),
    'whisper': _whisper,
}


@pytest.mark.parametrize('family', sorted(FAMILIES))
def test_family_converter_and_import_match_jax(family):
    torch.manual_seed(0)
    hf, compare = FAMILIES[family]()
    hf.eval()
    sd = _sd(hf)
    _, jax_convert = jax_families._FAMILIES[family]
    _, convert = families._FAMILIES[family]
    kw = {}
    if family in ('mistral', 'llama', 'mixtral'):
        kw = dict(n_heads = 4, n_kv_heads = hf.config.num_key_value_heads)
    _tree_equal(convert(sd, ** kw), jax_convert(sd, ** kw))

    model, params = families.from_hf_pretrained(hf, family = family, device = 'cpu')
    jax_model, jax_params = jax_families.from_hf_pretrained(hf, family = family)
    assert model.hp.get_config() == jax_model.hp.get_config()
    ref = transformer_from_jax(jax.tree_util.tree_map(np.asarray, jax_params))
    for a, b in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(ref)):
        assert torch.equal(a, b)
    assert jax.tree_util.tree_structure(params) == jax.tree_util.tree_structure(ref)
    if compare is not None:
        out, expected, atol = compare(hf, model, params)
        np.testing.assert_allclose(out, expected, atol = atol)


def test_get_family_and_the_device_rule():
    for name in ('gpt2-medium', 'bert-base-uncased', 'facebook/mbart-large-50',
                 'openai/whisper-tiny', 'mistralai/Mixtral-8x7B-v0.1', 'xlm-roberta-base'):
        assert families.get_family(name) == jax_families.get_family(name)
    with pytest.raises(ValueError):
        families.get_family('resnet')
    model = transformer_arch.Transformer(vocab_size = 8, dim = 8, n_layers = 1, n_heads = 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match = 'device'):
            model.init(0)


# -- heads ---------------------------------------------------------------------------

HEAD_TOKENS = np.array([[5, 9, 13, 2], [7, 3, 1, 8]])


def _bert_model(hf):
    return transformer_arch.Transformer(** families.bert_config(hf.config))


def _port_tree(tree):
    return transformer_from_jax(tree)


def _heads_case(name):
    B = transformers
    if name == 'mlm':
        hf = B.BertForMaskedLM(_bert_config(B.BertConfig))
        return hf, 'convert_bert_mlm_state_dict', lambda h, hidden, mask, p: \
            heads.mlm_logits(p, h, hidden), lambda out: out.logits
    if name in ('classifier', 'nsp'):
        hf = B.BertForSequenceClassification(_bert_config(B.BertConfig)) \
            if name == 'classifier' else B.BertForNextSentencePrediction(
                _bert_config(B.BertConfig))
        return hf, 'convert_bert_classifier_state_dict', \
            lambda h, hidden, mask, p: heads.classify(h, hidden), lambda out: out.logits
    if name == 'qa':
        hf = B.BertForQuestionAnswering(_bert_config(B.BertConfig))
        return hf, 'convert_bert_qa_state_dict', \
            lambda h, hidden, mask, p: torch.stack(heads.qa_spans(h, hidden, mask)), \
            lambda out: torch.stack([torch.softmax(out.start_logits, dim = 1),
                                     torch.softmax(out.end_logits, dim = 1)])
    cfg = _bert_config(B.DPRConfig)
    cfg.projection_dim = 0
    return B.DPRQuestionEncoder(cfg), 'convert_dpr_state_dict', \
        lambda h, hidden, mask, p: heads.embed_sentences(h, hidden, mask, normalize = False), \
        lambda out: out.pooler_output


@pytest.mark.parametrize('name', ['mlm', 'classifier', 'nsp', 'qa', 'dpr'])
def test_head_converter_and_output_match(name):
    torch.manual_seed(1)
    hf, converter, apply, expected = _heads_case(name)
    hf.eval()
    sd = _sd(hf)
    params, head = getattr(heads, converter)(sd)
    ref_params, ref_head = getattr(jax_heads, converter)(sd)
    _tree_equal(params, ref_params)
    _tree_equal(head, ref_head)
    params, head = _port_tree(params), _port_tree(head)
    cfg = hf.config
    model = transformer_arch.Transformer(** families.bert_config(
        vocab_size = cfg.vocab_size, dim = cfg.hidden_size, n_layers = cfg.num_hidden_layers,
        n_heads = cfg.num_attention_heads, ffn_dim = cfg.intermediate_size,
        max_position = cfg.max_position_embeddings))
    with torch.no_grad():
        hidden, mask = model.encode(params, torch.tensor(HEAD_TOKENS))
        out = apply(head, hidden, mask, params)
        ref = expected(hf(torch.tensor(HEAD_TOKENS)))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol = 3e-4)


def test_heads_init_and_pooling_match_jax():
    rng = np.random.default_rng(2)
    hidden = rng.normal(size = (2, 4, 8)).astype(np.float32)
    mask = np.array([[1, 1, 0, 0], [1, 1, 1, 1]], np.float32)
    jax_head = jax_heads.init_embedding_head(jax.random.PRNGKey(0), 8, 5)
    head = _port_tree(jax.tree_util.tree_map(np.asarray, jax_head))
    for mode in ('mean', 'first'):
        ref = jax_heads.embed_sentences(jax_head, jnp.asarray(hidden), jnp.asarray(mask),
                                        mode = mode)
        out = heads.embed_sentences(head, torch.from_numpy(hidden), torch.from_numpy(mask),
                                    mode = mode)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol = 1e-6)
    dim, vocab = 16, 32
    params = {'embedding': {'weight': torch.randn(vocab, dim)}}
    x = torch.randn(3, 5, dim)
    assert heads.mlm_logits(params, heads.init_mlm_head(0, dim, vocab, device = 'cpu'),
                            x).shape == (3, 5, vocab)
    assert heads.classify(heads.init_classifier_head(1, dim, 7, device = 'cpu'), x).shape == (3, 7)
    s, e = heads.qa_spans(heads.init_qa_head(2, dim, device = 'cpu'), x)
    assert s.shape == (3, 5) and e.shape == (3, 5)
    assert heads.init_embedding_head(3, dim, dim, device = 'cpu') == {}
    assert heads.init_pooler(4, dim, device = 'cpu')['dense']['weight'].shape == (dim, dim)


# -- the seeded HF-layout state dicts of `init` ---------------------------------------

SEEDED = {
    'gpt2': lambda: init.gpt2_state_dict(3, vocab_size = 64, n_positions = 32, n_embd = 32,
                                         n_layer = 2),
    'mistral': lambda: init.mistral_state_dict(3, vocab_size = 64, hidden_size = 32,
                                               intermediate_size = 64, num_hidden_layers = 2,
                                               num_attention_heads = 4, num_key_value_heads = 2),
    'mixtral': lambda: init.mistral_state_dict(3, vocab_size = 64, hidden_size = 32,
                                               intermediate_size = 64, num_hidden_layers = 2,
                                               num_attention_heads = 4, num_key_value_heads = 2,
                                               num_local_experts = 4),
    't5': lambda: init.t5_state_dict(3, vocab_size = 64, d_model = 32, d_kv = 8, d_ff = 64,
                                     num_layers = 2, num_heads = 4,
                                     relative_attention_num_buckets = 8),
    'bart': lambda: init.bart_state_dict(3, vocab_size = 64, d_model = 32, encoder_layers = 2,
                                         decoder_layers = 2, ffn_dim = 64,
                                         max_position_embeddings = 64),
    'whisper': lambda: init.whisper_state_dict(3, vocab_size = 64, d_model = 32,
                                               encoder_layers = 2, decoder_layers = 2,
                                               ffn_dim = 64, num_mel_bins = 20,
                                               max_source_positions = 50,
                                               max_target_positions = 40),
}


@pytest.mark.parametrize('family', sorted(SEEDED) + ['bert_mlm'])
def test_seeded_state_dicts_have_the_hf_layout(family):
    """Each seeded dict loads into its HF model strictly (every key, every
    shape), and the port imported from it through the converter gives the
    HF model's output."""
    if family == 'bert_mlm':
        hf, _, apply, expected = _heads_case('mlm')
        sd = init.bert_mlm_state_dict(3, vocab_size = 64, hidden_size = 32, num_hidden_layers = 2,
                                      intermediate_size = 64, max_position_embeddings = 32)
    else:
        hf, compare = FAMILIES[family]()
        sd = SEEDED[family]()
    hf.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict = True)
    hf.eval()
    if family == 'bert_mlm':
        params, head = (transformer_from_jax(t) for t in heads.convert_bert_mlm_state_dict(sd))
        with torch.no_grad():
            hidden, mask = _bert_model(hf).encode(params, torch.tensor(HEAD_TOKENS))
            np.testing.assert_allclose(apply(head, hidden, mask, params).numpy(),
                                       expected(hf(torch.tensor(HEAD_TOKENS))).numpy(),
                                       atol = 3e-4)
        return
    model, params = families.from_hf_pretrained(hf, family = family, device = 'cpu')
    out, ref, atol = compare(hf, model, params)
    np.testing.assert_allclose(out, ref, atol = atol)
