"""Transformer model families: named configs and HuggingFace weight import.

Counterpart of ``text_to_speech_tpu/models/transformers/families.py``: each
family (GPT-2, BERT, XLM-R, Mistral, Llama, Mixtral, BART, mBART, Whisper,
T5) is an hparams preset for the generic `Transformer` stack (an
`EncoderDecoder` of two for BART, T5 and Whisper) and a state-dict
converter.  The converters are the JAX package's: numpy in, a numpy tree in
the JAX package's layout out (copied arrays), so both packages load the same
tree; `weights.transformer_from_jax` turns it into the port's layouts, as
`from_hf_pretrained` does.  Mistral's and Llama's q/k columns are permuted
per head so that the port's interleaved `rope` equals HF's rotate_half.
"""

import inspect

import numpy as np
import torch

from ...devices import default_device
from ...nn import layers as nn
from ...weights import transformer_from_jax, tree_to
from .transformer_arch import Transformer


class EncoderDecoder:
    """Two-stack wrapper (BART/T5/Whisper): params = {'encoder', 'decoder'};
    API-compatible with `generation_utils.generate`."""

    def __init__(self, encoder, decoder):
        self.encoder = encoder
        self.decoder = decoder
        self.hp = decoder.hp

    def init(self, seed = 0, *, device = None):
        """Random params of both stacks from `seed` (an int or a
        `torch.Generator`) on `device` (cuda unless given)."""
        device = default_device(device)
        gen = nn.generator(seed, device)
        return {'encoder': self.encoder.init(gen, decoder = False, device = device),
                'decoder': self.decoder.init(gen, decoder = True, device = device)}

    def encode(self, params, tokens, ** kwargs):
        if self.encoder.hp.audio_stem:
            return self.encoder.encode_audio(params['encoder'], tokens)
        return self.encoder.encode(params['encoder'], tokens, ** kwargs)

    def decode(self, params, tokens, *, caches = None, encoder_output = None,
               encoder_mask = None, ** kwargs):
        return self.decoder.decode(
            params['decoder'], tokens, caches = caches,
            encoder_output = encoder_output, encoder_mask = encoder_mask,
            ** kwargs)

    def init_caches(self, batch, max_length, ** kwargs):
        return self.decoder.init_caches(batch, max_length, ** kwargs)

    def __call__(self, params, enc_tokens, dec_tokens, ** kwargs):
        encoder_output, encoder_mask = self.encode(params, enc_tokens, ** kwargs)
        logits, _ = self.decode(params, dec_tokens,
                                encoder_output = encoder_output,
                                encoder_mask = encoder_mask)
        return logits


def _t(w):
    return np.asarray(w).T.copy()


def _norm_params(prefix, sd, norm = 'layer'):
    if norm == 'rms':
        return {'gamma': np.asarray(sd[prefix + '.weight'])}
    return {'gamma': np.asarray(sd[prefix + '.weight']),
            'beta': np.asarray(sd[prefix + '.bias'])}


# -- GPT-2 ---------------------------------------------------------------------

def gpt2_config(hf_config = None, ** kwargs):
    cfg = dict(
        vocab_size = 50257, dim = 768, n_layers = 12, n_heads = 12,
        ffn_dim = 3072, ffn_activation = 'gelu_new', norm = 'layer',
        norm_first = True, positional = 'learned', max_position = 1024,
        use_final_norm = True, tie_embeddings = True, use_bias = True,
    )
    if hf_config is not None:
        cfg.update(
            vocab_size = hf_config.vocab_size, dim = hf_config.n_embd,
            n_layers = hf_config.n_layer, n_heads = hf_config.n_head,
            ffn_dim = 4 * hf_config.n_embd, max_position = hf_config.n_positions,
        )
    cfg.update(kwargs)
    return cfg


def convert_gpt2_state_dict(sd):
    """HF GPT-2 (`transformer.*`) → Transformer param tree.  HF `Conv1D`
    weights are already (in, out)."""
    sd = {k.replace('transformer.', ''): v for k, v in sd.items()}
    params = {
        'embedding': {'embeddings': np.asarray(sd['wte.weight'])},
        'position_embedding': {'embeddings': np.asarray(sd['wpe.weight'])},
        'final_norm': _norm_params('ln_f', sd),
    }
    i = 0
    while 'h.{}.ln_1.weight'.format(i) in sd:
        p = 'h.{}.'.format(i)
        qkv_w = np.asarray(sd[p + 'attn.c_attn.weight'])     # (D, 3D)
        qkv_b = np.asarray(sd[p + 'attn.c_attn.bias'])
        D = qkv_w.shape[0]
        params['layer_{}'.format(i)] = {
            'attention_norm': _norm_params(p + 'ln_1', sd),
            'attention': {
                'query': {'kernel': qkv_w[:, :D], 'bias': qkv_b[:D]},
                'key': {'kernel': qkv_w[:, D: 2 * D], 'bias': qkv_b[D: 2 * D]},
                'value': {'kernel': qkv_w[:, 2 * D:], 'bias': qkv_b[2 * D:]},
                'output': {'kernel': np.asarray(sd[p + 'attn.c_proj.weight']),
                           'bias': np.asarray(sd[p + 'attn.c_proj.bias'])},
            },
            'ffn_norm': _norm_params(p + 'ln_2', sd),
            'ffn': {
                'up': {'kernel': np.asarray(sd[p + 'mlp.c_fc.weight']),
                       'bias': np.asarray(sd[p + 'mlp.c_fc.bias'])},
                'down': {'kernel': np.asarray(sd[p + 'mlp.c_proj.weight']),
                         'bias': np.asarray(sd[p + 'mlp.c_proj.bias'])},
            },
        }
        i += 1
    return params


# -- BERT / XLM-RoBERTa --------------------------------------------------------

def bert_config(hf_config = None, ** kwargs):
    cfg = dict(
        vocab_size = 30522, dim = 768, n_layers = 12, n_heads = 12,
        ffn_dim = 3072, ffn_activation = 'gelu_exact', norm = 'layer',
        norm_first = False, positional = 'learned', max_position = 512,
        use_final_norm = False, use_token_type = True, use_bias = True,
        epsilon = 1e-12,
    )
    if hf_config is not None:
        cfg.update(
            vocab_size = hf_config.vocab_size, dim = hf_config.hidden_size,
            n_layers = hf_config.num_hidden_layers,
            n_heads = hf_config.num_attention_heads,
            ffn_dim = hf_config.intermediate_size,
            max_position = hf_config.max_position_embeddings,
            epsilon = getattr(hf_config, 'layer_norm_eps', 1e-12),
        )
    cfg.update(kwargs)
    return cfg


xlm_roberta_config = bert_config   # same topology, different vocab/tokenizer


def convert_bert_state_dict(sd):
    sd = {k.replace('bert.', '').replace('roberta.', ''): v for k, v in sd.items()}
    params = {
        'embedding': {'embeddings': np.asarray(sd['embeddings.word_embeddings.weight'])},
        'position_embedding': {'embeddings': np.asarray(sd['embeddings.position_embeddings.weight'])},
        'token_type_embedding': {'embeddings': np.asarray(sd['embeddings.token_type_embeddings.weight'])},
        'embedding_norm': _norm_params('embeddings.LayerNorm', sd),
    }
    i = 0
    while 'encoder.layer.{}.attention.self.query.weight'.format(i) in sd:
        p = 'encoder.layer.{}.'.format(i)
        params['layer_{}'.format(i)] = {
            'attention': {
                'query': {'kernel': _t(sd[p + 'attention.self.query.weight']),
                          'bias': np.asarray(sd[p + 'attention.self.query.bias'])},
                'key': {'kernel': _t(sd[p + 'attention.self.key.weight']),
                        'bias': np.asarray(sd[p + 'attention.self.key.bias'])},
                'value': {'kernel': _t(sd[p + 'attention.self.value.weight']),
                          'bias': np.asarray(sd[p + 'attention.self.value.bias'])},
                'output': {'kernel': _t(sd[p + 'attention.output.dense.weight']),
                           'bias': np.asarray(sd[p + 'attention.output.dense.bias'])},
            },
            'attention_norm': _norm_params(p + 'attention.output.LayerNorm', sd),
            'ffn': {
                'up': {'kernel': _t(sd[p + 'intermediate.dense.weight']),
                       'bias': np.asarray(sd[p + 'intermediate.dense.bias'])},
                'down': {'kernel': _t(sd[p + 'output.dense.weight']),
                         'bias': np.asarray(sd[p + 'output.dense.bias'])},
            },
            'ffn_norm': _norm_params(p + 'output.LayerNorm', sd),
        }
        i += 1
    return params


# -- Mistral / Llama-style -----------------------------------------------------

def _interleave_rope_columns(kernel, n_heads):
    """HF llama/mistral RoPE rotates pairs (x[i], x[i+d/2]) per head
    ("rotate_half"); this framework's `rope` rotates interleaved pairs
    (x[2i], x[2i+1]).  Permuting the q/k projection output columns —
    new[2i] = old[i], new[2i+1] = old[i + d/2] — maps one convention onto
    the other exactly (the q·k dot product is invariant to applying the
    same permutation to both)."""
    d_in, d_out = kernel.shape
    head_dim = d_out // n_heads
    w = kernel.reshape(d_in, n_heads, 2, head_dim // 2)
    w = np.ascontiguousarray(np.swapaxes(w, 2, 3))
    return w.reshape(d_in, d_out)


def mistral_config(hf_config = None, ** kwargs):
    cfg = dict(
        vocab_size = 32000, dim = 4096, n_layers = 32, n_heads = 32,
        n_kv_heads = 8, ffn_dim = 14336, ffn_activation = 'silu',
        gated_ffn = True, norm = 'rms', norm_first = True,
        positional = 'rope', use_final_norm = True, use_bias = False,
        tie_embeddings = False, epsilon = 1e-5,
    )
    if hf_config is not None:
        cfg.update(
            vocab_size = hf_config.vocab_size, dim = hf_config.hidden_size,
            n_layers = hf_config.num_hidden_layers,
            n_heads = hf_config.num_attention_heads,
            n_kv_heads = hf_config.num_key_value_heads,
            ffn_dim = hf_config.intermediate_size,
            epsilon = hf_config.rms_norm_eps,
            rope_theta = getattr(hf_config, 'rope_theta', 10000.0),
        )
    cfg.update(kwargs)
    return cfg


def _rope_attn_params(sd, p, *, n_heads, n_kv_heads):
    q = _interleave_rope_columns(_t(sd[p + 'self_attn.q_proj.weight']), n_heads)
    k = _interleave_rope_columns(_t(sd[p + 'self_attn.k_proj.weight']), n_kv_heads)
    return {
        'query': {'kernel': q},
        'key': {'kernel': k},
        'value': {'kernel': _t(sd[p + 'self_attn.v_proj.weight'])},
        'output': {'kernel': _t(sd[p + 'self_attn.o_proj.weight'])},
    }


def convert_mistral_state_dict(sd, n_heads = None, n_kv_heads = None):
    sd = {k.replace('model.', ''): v for k, v in sd.items()}
    params = {
        'embedding': {'embeddings': np.asarray(sd['embed_tokens.weight'])},
        'final_norm': _norm_params('norm', sd, norm = 'rms'),
    }
    if 'lm_head.weight' in sd:
        params['lm_head'] = {'kernel': _t(sd['lm_head.weight'])}
    i = 0
    while 'layers.{}.input_layernorm.weight'.format(i) in sd:
        p = 'layers.{}.'.format(i)
        if n_heads is None:
            raise ValueError('convert_mistral_state_dict needs n_heads (the '
                             'RoPE column interleave is per-head)')
        params['layer_{}'.format(i)] = {
            'attention_norm': _norm_params(p + 'input_layernorm', sd, norm = 'rms'),
            'attention': _rope_attn_params(
                sd, p, n_heads = n_heads,
                n_kv_heads = n_kv_heads or n_heads),
            'ffn_norm': _norm_params(p + 'post_attention_layernorm', sd, norm = 'rms'),
            'ffn': {
                'gate': {'kernel': _t(sd[p + 'mlp.gate_proj.weight'])},
                'up': {'kernel': _t(sd[p + 'mlp.up_proj.weight'])},
                'down': {'kernel': _t(sd[p + 'mlp.down_proj.weight'])},
            },
        }
        i += 1
    return params


def mixtral_config(hf_config = None, ** kwargs):
    """Mistral attention + Mixtral sparse-MoE FFN (8 experts, top-2)."""
    cfg = mistral_config(hf_config, ** kwargs)
    cfg.setdefault('n_experts', 8)
    cfg.setdefault('n_experts_per_token', 2)
    if hf_config is not None:
        cfg.update(
            n_experts = hf_config.num_local_experts,
            n_experts_per_token = hf_config.num_experts_per_tok,
        )
    cfg.update(kwargs)
    return cfg


def convert_mixtral_state_dict(sd, n_heads = None, n_kv_heads = None):
    sd = {k.replace('model.', ''): v for k, v in sd.items()}
    params = {
        'embedding': {'embeddings': np.asarray(sd['embed_tokens.weight'])},
        'final_norm': _norm_params('norm', sd, norm = 'rms'),
    }
    if 'lm_head.weight' in sd:
        params['lm_head'] = {'kernel': _t(sd['lm_head.weight'])}
    i = 0
    while 'layers.{}.input_layernorm.weight'.format(i) in sd:
        p = 'layers.{}.'.format(i)
        moe = p + 'block_sparse_moe.'
        n_experts = 0
        while moe + 'experts.{}.w1.weight'.format(n_experts) in sd:
            n_experts += 1
        # HF expert m: w1 = gate (F, D), w3 = up (F, D), w2 = down (D, F)
        stack = lambda w: {'kernel': np.stack([
            _t(sd[moe + 'experts.{}.{}.weight'.format(m, w)])
            for m in range(n_experts)])}
        if n_heads is None:
            raise ValueError('convert_mixtral_state_dict needs n_heads (the '
                             'RoPE column interleave is per-head)')
        params['layer_{}'.format(i)] = {
            'attention_norm': _norm_params(p + 'input_layernorm', sd, norm = 'rms'),
            'attention': _rope_attn_params(
                sd, p, n_heads = n_heads,
                n_kv_heads = n_kv_heads or n_heads),
            'ffn_norm': _norm_params(p + 'post_attention_layernorm', sd, norm = 'rms'),
            'ffn': {
                'router': {'kernel': _t(sd[moe + 'gate.weight'])},
                'experts': {
                    'gate': stack('w1'), 'up': stack('w3'), 'down': stack('w2'),
                },
            },
        }
        i += 1
    return params


def _interleave_rope_rows(weight, n_heads):
    """`_interleave_rope_columns` on a torch (out, in) projection: the same
    permutation of its output rows, on its device."""
    d_out, d_in = weight.shape
    head_dim = d_out // n_heads
    return weight.reshape(n_heads, 2, head_dim // 2, d_in).transpose(1, 2).reshape(d_out, d_in)


def mixtral_from_state_dict(sd, n_heads, n_kv_heads = None):
    """A Mixtral state dict of torch tensors in HF's layout → the port's
    params, on the tensors' device and in their dtype (HF's (out, in)
    projections are `nn.layers`' dense layout; no copy through the host):
    ``transformer_from_jax(convert_mixtral_state_dict(sd))`` for tensors."""
    sd = {k.replace('model.', ''): v for k, v in sd.items()}
    n_kv_heads = n_kv_heads or n_heads
    params = {'embedding': {'weight': sd['embed_tokens.weight']},
              'final_norm': {'gamma': sd['norm.weight']}}
    if 'lm_head.weight' in sd:
        params['lm_head'] = {'weight': sd['lm_head.weight']}
    i = 0
    while 'layers.{}.input_layernorm.weight'.format(i) in sd:
        p = 'layers.{}.'.format(i)
        moe = p + 'block_sparse_moe.'
        n_experts = 0
        while moe + 'experts.{}.w1.weight'.format(n_experts) in sd:
            n_experts += 1
        stack = lambda w: {'weight': torch.stack([
            sd[moe + 'experts.{}.{}.weight'.format(m, w)] for m in range(n_experts)])}
        params['layer_{}'.format(i)] = {
            'attention_norm': {'gamma': sd[p + 'input_layernorm.weight']},
            'attention': {
                'query': {'weight': _interleave_rope_rows(
                    sd[p + 'self_attn.q_proj.weight'], n_heads)},
                'key': {'weight': _interleave_rope_rows(
                    sd[p + 'self_attn.k_proj.weight'], n_kv_heads)},
                'value': {'weight': sd[p + 'self_attn.v_proj.weight']},
                'output': {'weight': sd[p + 'self_attn.o_proj.weight']},
            },
            'ffn_norm': {'gamma': sd[p + 'post_attention_layernorm.weight']},
            'ffn': {'router': {'weight': sd[moe + 'gate.weight']},
                    'experts': {'gate': stack('w1'), 'up': stack('w3'), 'down': stack('w2')}},
        }
        i += 1
    return params


# -- BART / Whisper (encoder-decoder presets) ----------------------------------

def bart_config(hf_config = None, ** kwargs):
    cfg = dict(
        vocab_size = 50265, dim = 768, n_layers = 6, n_heads = 12,
        ffn_dim = 3072, ffn_activation = 'gelu_exact', norm = 'layer',
        norm_first = False, positional = 'learned', max_position = 1026,
        use_final_norm = False, use_cross_attention = True,
        scale_embedding = False, position_offset = 2,
    )
    if hf_config is not None:
        cfg.update(vocab_size = hf_config.vocab_size, dim = hf_config.d_model,
                   n_layers = hf_config.encoder_layers,
                   n_heads = hf_config.encoder_attention_heads,
                   ffn_dim = hf_config.encoder_ffn_dim)
    cfg.update(kwargs)
    return cfg


def whisper_config(hf_config = None, ** kwargs):
    cfg = dict(
        vocab_size = 51865, dim = 512, n_layers = 6, n_heads = 8,
        ffn_dim = 2048, ffn_activation = 'gelu', norm = 'layer',
        norm_first = True, positional = 'sinusoidal', max_position = 1500,
        use_final_norm = True, use_cross_attention = True,
    )
    if hf_config is not None:
        cfg.update(vocab_size = hf_config.vocab_size, dim = hf_config.d_model,
                   n_layers = hf_config.encoder_layers,
                   n_heads = hf_config.encoder_attention_heads,
                   ffn_dim = hf_config.encoder_ffn_dim)
    cfg.update(kwargs)
    return cfg


def t5_config(hf_config = None, ** kwargs):
    cfg = dict(
        vocab_size = 32128, dim = 512, n_layers = 6, n_heads = 8,
        ffn_dim = 2048, ffn_activation = 'relu', norm = 'rms',
        norm_first = True, positional = 'none', use_final_norm = True,
        use_cross_attention = True, use_bias = False, epsilon = 1e-6,
        use_relative_bias = True, attention_scale = 1.0,
    )
    if hf_config is not None:
        cfg.update(vocab_size = hf_config.vocab_size, dim = hf_config.d_model,
                   n_layers = hf_config.num_layers, n_heads = hf_config.num_heads,
                   ffn_dim = hf_config.d_ff,
                   rel_buckets = hf_config.relative_attention_num_buckets,
                   gated_ffn = getattr(hf_config, 'is_gated_act', False),
                   ffn_activation = 'gelu_new' if getattr(
                       hf_config, 'is_gated_act', False) else 'relu')
    cfg.update(kwargs)
    return cfg


def build_t5(hf_config = None, ** kwargs):
    cfg = t5_config(hf_config, ** kwargs)
    return EncoderDecoder(Transformer(** cfg), Transformer(** cfg))


def build_bart(hf_config = None, ** kwargs):
    cfg = bart_config(hf_config, ** kwargs)
    return EncoderDecoder(Transformer(** cfg), Transformer(** cfg))


def build_whisper(hf_config = None, ** kwargs):
    enc_cfg = whisper_config(hf_config, ** kwargs)
    dec_cfg = dict(enc_cfg)
    enc_cfg.update(audio_stem = True, positional = 'none')
    dec_cfg.update(positional = 'learned', max_position = 448)
    if hf_config is not None:
        enc_cfg['n_mels'] = hf_config.num_mel_bins
        dec_cfg.update(n_layers = hf_config.decoder_layers,
                       max_position = hf_config.max_target_positions)
    return EncoderDecoder(Transformer(** enc_cfg), Transformer(** dec_cfg))


def _attn_params(sd, prefix, q = 'q_proj', k = 'k_proj', v = 'v_proj',
                 o = 'out_proj'):
    def one(name):
        out = {'kernel': _t(sd['{}.{}.weight'.format(prefix, name)])}
        bias_key = '{}.{}.bias'.format(prefix, name)
        if bias_key in sd: out['bias'] = np.asarray(sd[bias_key])
        return out
    return {'query': one(q), 'key': one(k), 'value': one(v), 'output': one(o)}


def convert_t5_state_dict(sd):
    """HF T5 → {'encoder', 'decoder'} trees (rms norms, shared rel-bias on
    layer 0 of each stack, no biases)."""
    def stack(side, cross):
        p = {'embedding': {'embeddings': np.asarray(sd['shared.weight'])},
             'final_norm': _norm_params(side + '.final_layer_norm', sd, 'rms')}
        bias_key = (side + '.block.0.layer.0.SelfAttention'
                    '.relative_attention_bias.weight')
        if bias_key in sd:
            p['relative_bias'] = {'embeddings': np.asarray(sd[bias_key])}
        i = 0
        while '{}.block.{}.layer.0.SelfAttention.q.weight'.format(side, i) in sd:
            base = '{}.block.{}.layer'.format(side, i)
            layer = {
                'attention': _attn_params(sd, base + '.0.SelfAttention',
                                          'q', 'k', 'v', 'o'),
                'attention_norm': _norm_params(base + '.0.layer_norm', sd, 'rms'),
            }
            ffn_idx = 2 if cross else 1
            if cross:
                layer['cross_attention'] = _attn_params(
                    sd, base + '.1.EncDecAttention', 'q', 'k', 'v', 'o')
                layer['cross_norm'] = _norm_params(base + '.1.layer_norm', sd, 'rms')
            dense = base + '.{}.DenseReluDense'.format(ffn_idx)
            if dense + '.wi.weight' in sd:
                layer['ffn'] = {'up': {'kernel': _t(sd[dense + '.wi.weight'])},
                                'down': {'kernel': _t(sd[dense + '.wo.weight'])}}
            else:  # gated (t5 v1.1)
                layer['ffn'] = {'gate': {'kernel': _t(sd[dense + '.wi_0.weight'])},
                                'up': {'kernel': _t(sd[dense + '.wi_1.weight'])},
                                'down': {'kernel': _t(sd[dense + '.wo.weight'])}}
            layer['ffn_norm'] = _norm_params(
                base + '.{}.layer_norm'.format(ffn_idx), sd, 'rms')
            p['layer_{}'.format(i)] = layer
            i += 1
        return p

    return {'encoder': stack('encoder', False), 'decoder': stack('decoder', True)}


def _bart_like_stack(sd, side, cross, norm = 'layer'):
    p = {}
    emb = sd.get(side + '.embed_tokens.weight', sd.get('shared.weight'))
    if emb is not None:
        p['embedding'] = {'embeddings': np.asarray(emb)}
    if side + '.embed_positions.weight' in sd:
        p['position_embedding'] = {'embeddings': np.asarray(
            sd[side + '.embed_positions.weight'])}
    if side + '.layernorm_embedding.weight' in sd:
        p['embedding_norm'] = _norm_params(side + '.layernorm_embedding', sd)
    if side + '.layer_norm.weight' in sd:
        p['final_norm'] = _norm_params(side + '.layer_norm', sd)
    i = 0
    while '{}.layers.{}.self_attn.q_proj.weight'.format(side, i) in sd:
        base = '{}.layers.{}'.format(side, i)
        layer = {
            'attention': _attn_params(sd, base + '.self_attn'),
            'attention_norm': _norm_params(base + '.self_attn_layer_norm', sd),
            'ffn': {'up': {'kernel': _t(sd[base + '.fc1.weight']),
                           'bias': np.asarray(sd[base + '.fc1.bias'])},
                    'down': {'kernel': _t(sd[base + '.fc2.weight']),
                             'bias': np.asarray(sd[base + '.fc2.bias'])}},
            'ffn_norm': _norm_params(base + '.final_layer_norm', sd),
        }
        if cross and base + '.encoder_attn.q_proj.weight' in sd:
            layer['cross_attention'] = _attn_params(sd, base + '.encoder_attn')
            layer['cross_norm'] = _norm_params(base + '.encoder_attn_layer_norm', sd)
        p['layer_{}'.format(i)] = layer
        i += 1
    return p


def convert_bart_state_dict(sd):
    sd = {k.replace('model.', ''): v for k, v in sd.items()}
    return {'encoder': _bart_like_stack(sd, 'encoder', False),
            'decoder': _bart_like_stack(sd, 'decoder', True)}


def convert_whisper_state_dict(sd):
    sd = {k.replace('model.', ''): v for k, v in sd.items()}
    params = convert_bart_state_dict(sd)
    enc = params['encoder']
    enc.pop('embedding', None)
    enc['stem'] = {
        'conv1': {'kernel': np.asarray(sd['encoder.conv1.weight']).transpose(2, 1, 0),
                  'bias': np.asarray(sd['encoder.conv1.bias'])},
        'conv2': {'kernel': np.asarray(sd['encoder.conv2.weight']).transpose(2, 1, 0),
                  'bias': np.asarray(sd['encoder.conv2.bias'])},
    }
    return params


_FAMILIES = {
    'gpt2': (gpt2_config, convert_gpt2_state_dict),
    'bert': (bert_config, convert_bert_state_dict),
    'xlm-roberta': (xlm_roberta_config, convert_bert_state_dict),
    'mixtral': (mixtral_config, convert_mixtral_state_dict),
    'mistral': (mistral_config, convert_mistral_state_dict),
    # llama shares the mistral layout exactly (GQA + rotate_half RoPE +
    # SwiGLU + RMSNorm); config differences ride the hf_config fields
    'llama': (mistral_config, convert_mistral_state_dict),
    'bart': (build_bart, convert_bart_state_dict),
    'mbart': (build_bart, convert_bart_state_dict),
    'whisper': (build_whisper, convert_whisper_state_dict),
    't5': (build_t5, convert_t5_state_dict),
}

_ENCODER_DECODER = {'bart', 'mbart', 'whisper', 't5'}


def get_family(name):
    key = name.lower()
    for family in _FAMILIES:
        if family in key:
            return family
    raise ValueError('Unknown transformer family for {!r} (known: {})'.format(
        name, sorted(_FAMILIES)))


def from_hf_pretrained(name_or_model, family = None, *, device = None, ** kwargs):
    """(model, params) from a HF model instance or name, the params in the
    port's layouts on `device` (cuda unless given).  A name loads through
    ``transformers.AutoModel`` (imported here, only for a name)."""
    device = default_device(device)
    if isinstance(name_or_model, str):
        import transformers
        hf = transformers.AutoModel.from_pretrained(name_or_model)
        family = family or get_family(name_or_model)
    else:
        hf = name_or_model
        family = family or get_family(type(hf).__name__.lower())

    config_fn, convert_fn = _FAMILIES[family]
    if family in _ENCODER_DECODER:
        model = config_fn(hf.config, ** kwargs)
    else:
        model = Transformer(** config_fn(hf.config, ** kwargs))
    sd = {k: v.detach().cpu().numpy() for k, v in hf.state_dict().items()}
    if 'n_heads' in inspect.signature(convert_fn).parameters:
        params = convert_fn(sd, n_heads = hf.config.num_attention_heads,
                            n_kv_heads = getattr(hf.config, 'num_key_value_heads', None))
    else:
        params = convert_fn(sd)
    return model, tree_to(transformer_from_jax(params), device)
