"""BERT-style task heads over the generic `Transformer` encoder.

Counterpart of ``text_to_speech_tpu/models/transformers/heads.py``: each
head is an ``init_*`` / apply pair over the port's layouts that composes
with `Transformer.encode` (pooler, masked LM, classifier / next sentence,
extractive QA, sentence embeddings), and the HF converters of the JAX
module (numpy in, numpy trees in the JAX package's layout out; the port's
layout through `weights.transformer_from_jax`).
"""

import numpy as np
import torch

from ...devices import default_device
from ...nn import layers as nn
from ...nn.activations import get_activation, l2_norm
from .families import convert_bert_state_dict, _t, _norm_params


def _init(seed, device):
    device = default_device(device)
    return nn.generator(seed, device), device


# -- pooler ---------------------------------------------------------------------

def init_pooler(seed, dim, *, device = None):
    """BERT's pooler: dense + tanh on the first ([CLS]) token."""
    gen, device = _init(seed, device)
    return {'dense': nn.init_dense(gen, dim, dim, device = device)}


def pooler(params, hidden):
    """hidden (B, T, D) → pooled (B, D) = tanh(dense(hidden[:, 0]))."""
    return torch.tanh(nn.dense(params['dense'], hidden[:, 0]))


# -- masked language modeling ----------------------------------------------------

def init_mlm_head(seed, dim, vocab_size, *, device = None):
    """Transform dense + activation + layer norm, then tied-embedding
    logits + a free bias."""
    gen, device = _init(seed, device)
    return {'transform': nn.init_dense(gen, dim, dim, device = device),
            'transform_norm': nn.init_layer_norm(dim, device),
            'bias': torch.zeros((vocab_size,), device = device)}


def mlm_logits(params, head, hidden, *, activation = 'gelu_exact', epsilon = 1e-12):
    """hidden (B, T, D) → vocab logits (B, T, V), the decoder tied to the
    input embedding matrix."""
    act = get_activation(activation)
    x = act(nn.dense(head['transform'], hidden))
    x = nn.layer_norm(head['transform_norm'], x, epsilon = epsilon)
    return x @ params['embedding']['weight'].T + head['bias']


# -- sequence classification / NSP ------------------------------------------------

def init_classifier_head(seed, dim, num_classes, use_pooler = True, *, device = None):
    """(pooled or first-token) hidden → dense(num_classes)."""
    gen, device = _init(seed, device)
    head = {'classifier': nn.init_dense(gen, dim, num_classes, device = device)}
    if use_pooler:
        head['pooler'] = init_pooler(gen, dim, device = device)
    return head


def classify(head, hidden, *, activation = None, rng = None, drop_rate = 0.):
    """hidden (B, T, D) → class logits (B, num_classes), through the tanh
    pooler when the head has one, else the raw first token.  Dropout at
    `drop_rate` draws from `rng` (a `torch.Generator` on hidden's device)."""
    x = pooler(head['pooler'], hidden) if 'pooler' in head else hidden[:, 0]
    if drop_rate and rng is not None:
        x = nn.dropout(x, drop_rate, generator = rng)
    logits = nn.dense(head['classifier'], x)
    if activation is not None:
        logits = get_activation(activation)(logits)
    return logits


# -- extractive question answering -------------------------------------------------

def init_qa_head(seed, dim, *, device = None):
    """Per-token dense(2): start and end logits."""
    gen, device = _init(seed, device)
    return {'qa': nn.init_dense(gen, dim, 2, device = device)}


def qa_spans(head, hidden, mask = None):
    """hidden (B, T, D) → (start_probs, end_probs), each (B, T): softmax over
    the sequence axis of the two per-token logits, padded positions masked
    out."""
    logits = nn.dense(head['qa'], hidden)                    # (B, T, 2)
    if mask is not None:
        mask = torch.reshape(mask, (logits.shape[0], -1))     # (B, T)
        logits = torch.where(mask[..., None] > 0, logits, -1e9)
    probs = torch.softmax(logits, dim = 1)
    return probs[..., 0], probs[..., 1]


# -- sentence / dense-passage embeddings --------------------------------------------

def init_embedding_head(seed, dim, output_dim = None, *, device = None):
    """An optional projection to `output_dim` over a pooled sentence vector."""
    if output_dim is None or output_dim == dim:
        return {}
    gen, device = _init(seed, device)
    return {'project': nn.init_dense(gen, dim, output_dim, device = device)}


def embed_sentences(head, hidden, mask = None, *, mode = 'first', normalize = True):
    """hidden (B, T, D) → sentence embeddings (B, output_dim).

    mode: 'first' (CLS token, the DPR convention) or 'mean' (masked mean
    pooling).  L2-normalized by default."""
    if mode == 'first':
        x = hidden[:, 0]
    elif mode == 'mean':
        if mask is None:
            x = hidden.mean(dim = 1)
        else:
            m = torch.reshape(mask, (hidden.shape[0], -1, 1)).to(hidden.dtype)
            x = (hidden * m).sum(dim = 1) / torch.clamp(m.sum(dim = 1), min = 1.)
    else:
        raise ValueError('unknown pooling mode: {}'.format(mode))
    if 'project' in head:
        x = nn.dense(head['project'], x)
    return l2_norm(x) if normalize else x


# -- HF checkpoint import -----------------------------------------------------------

def convert_bert_mlm_state_dict(sd):
    """torch ``BertForMaskedLM`` state dict → (encoder params, mlm head)."""
    params = convert_bert_state_dict(sd)
    head = {
        'transform': {
            'kernel': _t(sd['cls.predictions.transform.dense.weight']),
            'bias': np.asarray(sd['cls.predictions.transform.dense.bias']),
        },
        'transform_norm': _norm_params('cls.predictions.transform.LayerNorm', sd),
        'bias': np.asarray(sd['cls.predictions.bias']),
    }
    return params, head


def convert_bert_pooler_state_dict(sd, prefix = 'bert.pooler.'):
    return {'dense': {'kernel': _t(sd[prefix + 'dense.weight']),
                      'bias': np.asarray(sd[prefix + 'dense.bias'])}}


def convert_bert_classifier_state_dict(sd):
    """torch ``BertForSequenceClassification`` / ``BertForNextSentence
    Prediction`` state dict → (encoder params, classifier head)."""
    params = convert_bert_state_dict(sd)
    head = {'pooler': convert_bert_pooler_state_dict(sd)}
    if 'classifier.weight' in sd:                 # SequenceClassification
        head['classifier'] = {'kernel': _t(sd['classifier.weight']),
                              'bias': np.asarray(sd['classifier.bias'])}
    else:                                          # NSP: cls.seq_relationship
        head['classifier'] = {
            'kernel': _t(sd['cls.seq_relationship.weight']),
            'bias': np.asarray(sd['cls.seq_relationship.bias'])}
    return params, head


def convert_bert_qa_state_dict(sd):
    """torch ``BertForQuestionAnswering`` state dict → (encoder, qa head)."""
    params = convert_bert_state_dict(sd)
    head = {'qa': {'kernel': _t(sd['qa_outputs.weight']),
                   'bias': np.asarray(sd['qa_outputs.bias'])}}
    return params, head


def convert_dpr_state_dict(sd):
    """torch ``DPRQuestionEncoder``/``DPRContextEncoder`` state dict →
    (encoder params, embedding head).  DPR checkpoints prefix the BERT tree
    with ``*_encoder.bert_model.`` and may add ``encode_proj``."""
    clean = {}
    for k, v in sd.items():
        for p in ('question_encoder.bert_model.', 'ctx_encoder.bert_model.',
                  'bert_model.'):
            if k.startswith(p):
                k = k[len(p):]
                break
        clean[k.replace('question_encoder.', '').replace('ctx_encoder.', '')] = v
    params = convert_bert_state_dict(clean)
    head = {}
    if 'encode_proj.weight' in clean:
        head['project'] = {'kernel': _t(clean['encode_proj.weight']),
                           'bias': np.asarray(clean['encode_proj.bias'])}
    return params, head
