"""The generic transformer stack.

Counterpart of ``text_to_speech_tpu/models/transformers/transformer_arch.py``:
`HParamsTransformer`, `t5_relative_buckets`, `moe_load_balancing_loss`,
`sinusoidal_embedding` and `Transformer` (encoder-only, decoder-only or one
stack of an encoder-decoder, by its hparams and the methods called), as
plain functions over parameter trees in `nn.layers`' layouts: learned,
sinusoidal, rotary or no positions; layer or RMS norm; pre- or post-norm;
plain, gated or mixture-of-experts FFN; T5's relative bias; cross
attention; token types; an embedding norm; a position offset (BART); the
Whisper audio stem; a tied or separate LM head.  The JAX package computes
all of it in XLA, outside any Pallas kernel, and so does the port: plain
tensor code, no CUDA kernel of the port.

A decode with per-layer KV caches takes a cache index that is an int or a
``(B,)`` tensor (`attention.py`): the causal mask ``key <= index + t``,
the positions and T5's bias then follow each row's own index, as the JAX
stepper's `vmap` over rows gives them.  Position lookups clamp to the
table, as XLA's gather does.

A mixture-of-experts FFN (`n_experts` > 0) keeps each projection's experts
stacked in one ``weight (E, out, in)``, evaluated densely over experts, as
the JAX stack is.  Expert parallelism: a `Transformer` given a
`parallel.Mesh` with an ``ep`` axis and params from
``shard_params(params, mesh, moe_param_specs(params))`` holds E / ep of
each layer's experts on each rank; it evaluates them against its columns
of the dense router weights and all-reduces the combine over ``ep`` (the
router, its logits and the load-balancing loss stay replicated).
"""

import numpy as np
import torch
import torch.nn.functional as F

from ...devices import default_device
from ...hparams import HParams
from ...nn import layers as nn
from ...nn.activations import get_activation
from ...parallel.collectives import Axis, tp_enter, tp_exit, tp_split
from .attention import (
    init_mha, mha, init_kv_cache, build_padding_mask, build_look_ahead_mask,
    combine_masks, cache_positions,
)

HParamsTransformer = HParams(
    vocab_size = 32000,
    dim = 512,
    n_layers = 6,
    n_heads = 8,
    n_kv_heads = None,
    ffn_dim = 2048,
    ffn_activation = 'gelu',
    gated_ffn = False,                 # SwiGLU-style (mistral/llama)
    norm = 'layer',                    # 'layer' | 'rms'
    norm_first = True,                 # pre-norm (GPT-2 style) vs post-norm (BERT)
    epsilon = 1e-5,
    max_position = 2048,
    positional = 'learned',            # 'learned' | 'sinusoidal' | 'rope' | 'none'
    rope_theta = 10000.0,
    pad_token = 0,
    use_bias = True,
    scale_embedding = False,
    use_final_norm = True,
    tie_embeddings = True,
    use_cross_attention = False,
    use_token_type = False,
    n_experts = 0,                     # >0: Mixtral-style sparse MoE FFN
    n_experts_per_token = 2,
    attention_scale = None,            # None = 1/sqrt(head_dim); T5 uses 1.0
    use_relative_bias = False,         # T5-style bucketed relative positions
    rel_buckets = 32,
    rel_max_distance = 128,
    position_offset = 0,               # BART stores positions shifted by 2
    audio_stem = False,                # Whisper conv1/conv2 mel front-end
    n_mels = 80,
)


def t5_relative_buckets(relative_position, *, bidirectional, num_buckets = 32,
                        max_distance = 128):
    """T5's log-bucketed relative positions, in float32 as the JAX function
    computes them."""
    ret = torch.zeros_like(relative_position)
    n = -relative_position
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).to(relative_position.dtype) * num_buckets
        n = torch.abs(n)
    else:
        n = torch.clamp(n, min = 0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_large = max_exact + (
        torch.log(torch.clamp(n, min = 1).to(torch.float32) / max_exact)
        / np.float32(np.log(max_distance / max_exact))
        * (num_buckets - max_exact)
    ).to(relative_position.dtype)
    val_large = torch.clamp(val_large, max = num_buckets - 1)
    return ret + torch.where(is_small, n, val_large)


def moe_load_balancing_loss(router_logits, n_experts, k):
    """Switch/Mixtral auxiliary load-balancing loss over a list of per-layer
    router logits (collected via ``decode(..., aux=[])``): E * sum_e
    (fraction of tokens routed to e) * (mean router prob of e), averaged
    over layers.  1.0 == perfectly balanced."""
    total = 0.
    for logits in router_logits:
        probs = torch.softmax(logits.to(torch.float32), dim = -1)
        _, top_i = torch.topk(probs, k, dim = -1)
        frac = F.one_hot(top_i, n_experts).to(torch.float32).mean(dim = (0, 1, 2))
        total = total + n_experts * torch.sum(frac * probs.mean(dim = (0, 1)))
    return total / max(len(router_logits), 1)


def sinusoidal_embedding(max_position, dim, device = None):
    """(max_position, dim) float32: sin on the even columns, cos on the odd
    ones, angle ``pos / 10000 ** (2 i / dim)``."""
    pos = torch.arange(max_position, device = device, dtype = torch.float32)[:, None]
    i = torch.arange(dim // 2, device = device, dtype = torch.float32)[None, :]
    angle = pos / torch.pow(torch.tensor(10000., device = device), 2. * i / dim)
    emb = torch.zeros((max_position, dim), device = device)
    emb[:, 0::2] = torch.sin(angle)
    emb[:, 1::2] = torch.cos(angle)
    return emb


def _window(table, offset, T):
    """Rows ``offset + t`` of `table` for t < T, clamped into the table:
    (T, D) for an int offset, (B, T, D) for a (B,) tensor."""
    rows = table.shape[0]
    if torch.is_tensor(offset):
        pos = torch.clamp(cache_positions(offset, T, offset.shape[0], table.device),
                          0, rows - 1)
    else:
        pos = torch.clamp(torch.arange(T, device = table.device) + offset, 0, rows - 1)
    return table[pos]


class Transformer:
    """Encoder-only / decoder-only / encoder-decoder depending on hparams and
    which apply methods are used."""

    def __init__(self, *, mesh = None, ** kwargs):
        self.hp = HParamsTransformer.extract(kwargs)
        self._tables = {}
        self.mesh = mesh

    def get_config(self):
        return self.hp.get_config()

    # -- init ------------------------------------------------------------------

    def _init_norm(self, dim, device):
        return nn.init_rms_norm(dim, device) if self.hp.norm == 'rms' \
            else nn.init_layer_norm(dim, device)

    def _norm(self, params, x):
        if self.hp.norm == 'rms':
            return nn.rms_norm(params, x, self.hp.epsilon)
        return nn.layer_norm(params, x, self.hp.epsilon)

    def _init_block(self, gen, device, cross = False):
        hp = self.hp
        block = {
            'attention': init_mha(gen, hp.dim, hp.n_heads, n_kv_heads = hp.n_kv_heads,
                                  use_bias = hp.use_bias, device = device),
            'attention_norm': self._init_norm(hp.dim, device),
            'ffn_norm': self._init_norm(hp.dim, device),
        }
        dense = lambda d_in, d_out, bias: nn.init_dense(gen, d_in, d_out, bias, device)
        if hp.n_experts:
            stack = lambda d_in, d_out: {'weight': torch.stack([
                dense(d_in, d_out, False)['weight'] for _ in range(hp.n_experts)])}
            block['ffn'] = {
                'router': dense(hp.dim, hp.n_experts, False),
                'experts': {'gate': stack(hp.dim, hp.ffn_dim), 'up': stack(hp.dim, hp.ffn_dim),
                            'down': stack(hp.ffn_dim, hp.dim)},
            }
        elif hp.gated_ffn:
            block['ffn'] = {'gate': dense(hp.dim, hp.ffn_dim, False),
                            'up': dense(hp.dim, hp.ffn_dim, False),
                            'down': dense(hp.ffn_dim, hp.dim, False)}
        else:
            block['ffn'] = {'up': dense(hp.dim, hp.ffn_dim, hp.use_bias),
                            'down': dense(hp.ffn_dim, hp.dim, hp.use_bias)}
        if cross:
            block['cross_attention'] = init_mha(gen, hp.dim, hp.n_heads,
                                                use_bias = hp.use_bias, device = device)
            block['cross_norm'] = self._init_norm(hp.dim, device)
        return block

    def init(self, seed = 0, *, decoder = None, device = None):
        """Random params for one stack, drawn from `seed` (an int or a
        `torch.Generator`) on `device` (cuda unless given).  `decoder=True`
        adds cross-attention blocks (when `use_cross_attention`)."""
        hp = self.hp
        device = default_device(device)
        gen = nn.generator(seed, device)
        params = {'embedding': nn.init_embedding(gen, hp.vocab_size, hp.dim, device = device)}
        if hp.positional == 'learned':
            params['position_embedding'] = nn.init_embedding(
                gen, hp.max_position, hp.dim, device = device)
        if hp.use_token_type:
            params['token_type_embedding'] = nn.init_embedding(gen, 2, hp.dim, device = device)
        cross = hp.use_cross_attention if decoder is None else decoder
        if hp.audio_stem:
            params['stem'] = {'conv1': nn.init_conv1d(gen, 3, hp.n_mels, hp.dim, device = device),
                              'conv2': nn.init_conv1d(gen, 3, hp.dim, hp.dim, device = device)}
        if hp.use_relative_bias:
            params['relative_bias'] = nn.init_embedding(gen, hp.rel_buckets, hp.n_heads,
                                                        device = device)
        for i in range(hp.n_layers):
            params['layer_{}'.format(i)] = self._init_block(gen, device, cross = cross)
        if hp.use_final_norm:
            params['final_norm'] = self._init_norm(hp.dim, device)
        if not hp.tie_embeddings:
            params['lm_head'] = nn.init_dense(gen, hp.dim, hp.vocab_size, False, device)
        return params

    # -- blocks ----------------------------------------------------------------

    def _ffn(self, params, x, aux = None):
        act = get_activation(self.hp.ffn_activation)
        if self.hp.n_experts:
            return self._moe_ffn(params, x, aux = aux)
        if self.hp.gated_ffn:
            return nn.dense(params['down'],
                            act(nn.dense(params['gate'], x)) * nn.dense(params['up'], x))
        return nn.dense(params['down'], act(nn.dense(params['up'], x)))

    def _moe_ffn(self, params, x, aux = None):
        """Mixtral-style sparse MoE: softmax router, top-k experts per token,
        weights renormalized over the selected k, evaluated densely over
        the experts (every expert on every token, the unselected weighted
        0).  ``aux``: a list that collects each layer's router logits for
        `moe_load_balancing_loss`."""
        hp = self.hp
        act = get_activation(hp.ffn_activation)
        logits = nn.dense(params['router'], x)                      # (B, T, E)
        if aux is not None:
            aux.append(logits)
        probs = torch.softmax(logits.to(torch.float32), dim = -1)
        top_w, top_i = torch.topk(probs, hp.n_experts_per_token, dim = -1)
        top_w = top_w / top_w.sum(dim = -1, keepdim = True)
        w_full = torch.zeros_like(probs).scatter(-1, top_i, top_w).to(x.dtype)
        we = params['experts']
        n_local = we['gate']['weight'].shape[0]
        ep = None
        if n_local != hp.n_experts:
            mesh = self.mesh
            if mesh is None or 'ep' not in mesh.shape:
                raise ValueError('{} of {} experts a layer, and no mesh with an ep axis'
                                 .format(n_local, hp.n_experts))
            # the rows are replicated over ep: they enter the local experts
            # (their gradient summed over the ranks), the weights of the
            # local experts are this rank's slice, and the combine's partial
            # sums leave by `tp_exit`, whose backward passes the gradient on
            # as it is (an all-reduce there would give ep times it)
            ep = Axis.of(mesh, 'ep')
            x = tp_enter(x, ep)
            w_full = tp_split(w_full, -1, ep)
        g = torch.einsum('btd,efd->ebtf', x, we['gate']['weight'])
        u = torch.einsum('btd,efd->ebtf', x, we['up']['weight'])
        y = torch.einsum('ebtf,edf->ebtd', act(g) * u, we['down']['weight'])
        return tp_exit(torch.einsum('ebtd,bte->btd', y, w_full), ep)

    def _relative_bias(self, params, q_len, k_len, *, bidirectional, offset = 0):
        """The additive attention bias of T5: (1, H, Tq, Tk), or (B, H, Tq,
        Tk) for a (B,) tensor `offset`."""
        hp = self.hp
        device = params['relative_bias']['weight'].device
        k_pos = torch.arange(k_len, device = device)
        if torch.is_tensor(offset):
            q_pos = cache_positions(offset, q_len, offset.shape[0], device)[..., None]
        else:
            q_pos = (offset + torch.arange(q_len, device = device))[:, None]
        buckets = t5_relative_buckets(k_pos - q_pos, bidirectional = bidirectional,
                                      num_buckets = hp.rel_buckets,
                                      max_distance = hp.rel_max_distance)
        bias = nn.embedding(params['relative_bias'], buckets)        # (..., Tq, Tk, H)
        return bias.movedim(-1, -3) if bias.dim() == 4 else bias.permute(2, 0, 1)[None]

    def block(self, params, x, *, mask = None, cache = None, encoder_output = None,
              encoder_mask = None, positions = None, rel_bias = None, aux = None):
        hp = self.hp
        use_rope = hp.positional == 'rope'

        def attn(x_in):
            return mha(params['attention'], x_in, n_heads = hp.n_heads, mask = mask,
                       cache = cache, positions = positions, use_rope = use_rope,
                       rope_base = hp.rope_theta, rel_bias = rel_bias,
                       scale = hp.attention_scale)

        if hp.norm_first:
            h, new_cache = attn(self._norm(params['attention_norm'], x))
            x = x + h
        else:
            h, new_cache = attn(x)
            x = self._norm(params['attention_norm'], x + h)

        if encoder_output is not None and 'cross_attention' in params:
            def cross(x_in):
                return mha(params['cross_attention'], x_in, encoder_output,
                           n_heads = hp.n_heads, mask = encoder_mask,
                           scale = hp.attention_scale)[0]
            if hp.norm_first:
                x = x + cross(self._norm(params['cross_norm'], x))
            else:
                x = self._norm(params['cross_norm'], x + cross(x))

        if hp.norm_first:
            x = x + self._ffn(params['ffn'], self._norm(params['ffn_norm'], x), aux = aux)
        else:
            x = self._norm(params['ffn_norm'], x + self._ffn(params['ffn'], x, aux = aux))
        return x, new_cache

    # -- embeddings ------------------------------------------------------------

    def _sinusoids(self, device):
        if device not in self._tables:
            self._tables[device] = sinusoidal_embedding(self.hp.max_position, self.hp.dim,
                                                        device = device)
        return self._tables[device]

    def embed(self, params, tokens, *, offset = 0, token_type = None):
        """Token embeddings plus positions from `offset` (an int or a (B,)
        tensor), token types and the embedding norm."""
        hp = self.hp
        x = nn.embedding(params['embedding'], tokens)
        if hp.scale_embedding:
            x = x * (hp.dim ** 0.5)
        T = tokens.shape[1]
        if hp.positional == 'learned':
            x = x + _window(params['position_embedding']['weight'],
                            hp.position_offset + offset, T)
        elif hp.positional == 'sinusoidal':
            table = self._sinusoids(x.device)
            if torch.is_tensor(offset):
                start = torch.clamp(offset, 0, hp.max_position - T)
            else:
                start = min(max(offset, 0), hp.max_position - T)
            x = x + _window(table, start, T)
        if 'token_type_embedding' in params:
            if token_type is None:
                token_type = torch.zeros_like(tokens)
            x = x + nn.embedding(params['token_type_embedding'], token_type)
        if 'embedding_norm' in params:
            x = self._norm(params['embedding_norm'], x)
        return x

    def logits(self, params, x):
        if 'lm_head' in params:
            return nn.dense(params['lm_head'], x)
        return x @ params['embedding']['weight'].T

    # -- full passes -----------------------------------------------------------

    def encode(self, params, tokens, *, lengths = None, token_type = None):
        """Non-causal encoder pass → (hidden (B, T, D), padding mask)."""
        mask = build_padding_mask(lengths = lengths, tokens = tokens,
                                  pad_token = self.hp.pad_token, max_length = tokens.shape[1])
        x = self.embed(params, tokens, token_type = token_type)
        rel_bias = None
        if self.hp.use_relative_bias:
            T = tokens.shape[1]
            rel_bias = self._relative_bias(params, T, T, bidirectional = True)
        for i in range(self.hp.n_layers):
            x, _ = self.block(params['layer_{}'.format(i)], x, mask = mask, rel_bias = rel_bias)
        if self.hp.use_final_norm:
            x = self._norm(params['final_norm'], x)
        return x, mask

    def encode_audio(self, params, mel):
        """Whisper-style audio encoder: conv stem (stride-2 downsample) +
        positions + non-causal layers.  mel (B, T, n_mels) → (hidden (B,
        ceil(T / 2), D), mask=None).  The second conv pads (1, 1) explicitly,
        as the JAX stem does (PyTorch's ``padding=1``), not XLA's SAME."""
        hp = self.hp
        x = nn.gelu(nn.conv1d(params['stem']['conv1'], mel, padding = 'SAME'))
        x = nn.gelu(nn.conv1d(params['stem']['conv2'], x, stride = 2, padding = [(1, 1)]))
        T = x.shape[1]
        if 'position_embedding' in params:
            x = x + params['position_embedding']['weight'][None, :T]
        else:
            x = x + self._sinusoids(x.device)[None, :T]
        for i in range(hp.n_layers):
            x, _ = self.block(params['layer_{}'.format(i)], x)
        if hp.use_final_norm:
            x = self._norm(params['final_norm'], x)
        return x, None

    def decode(self, params, tokens, *, caches = None, offset = None, encoder_output = None,
               encoder_mask = None, positions = None, valid_length = None, aux = None):
        """Causal decoder pass.  With `caches` (per-layer KV caches, index an
        int or a (B,) tensor) the pass processes `tokens` (usually one step)
        against the whole cache, which it writes in place.  Returns (logits,
        new_caches)."""
        hp = self.hp
        B, T = tokens.shape
        device = tokens.device
        if caches is not None:
            total = caches[0]['k'].shape[2]
            idx = caches[0]['index']
            key_pos = torch.arange(total, device = device)
            mask = key_pos[None, None, None, :] <= \
                cache_positions(idx, T, B, device)[:, None, :, None]
            if offset is None:
                offset = idx            # positions continue past the cache
        else:
            mask = combine_masks(build_look_ahead_mask(T, device = device),
                                 build_padding_mask(tokens = tokens, pad_token = hp.pad_token))

        x = self.embed(params, tokens, offset = offset if offset is not None else 0)
        rel_bias = None
        if hp.use_relative_bias:
            k_len = caches[0]['k'].shape[2] if caches is not None else T
            rel_bias = self._relative_bias(params, T, k_len, bidirectional = False,
                                           offset = caches[0]['index'] if caches is not None
                                           else 0)
        new_caches = []
        for i in range(hp.n_layers):
            cache_i = caches[i] if caches is not None else None
            x, new_cache = self.block(params['layer_{}'.format(i)], x, mask = mask,
                                      cache = cache_i, encoder_output = encoder_output,
                                      encoder_mask = encoder_mask, positions = positions,
                                      rel_bias = rel_bias, aux = aux)
            new_caches.append(new_cache)
        if hp.use_final_norm:
            x = self._norm(params['final_norm'], x)
        return self.logits(params, x), (new_caches if caches is not None else None)

    def init_caches(self, batch, max_length, dtype = torch.float32, device = None):
        """One empty KV cache a layer (`attention.init_kv_cache`) on `device`
        (cuda unless given)."""
        hp = self.hp
        head_dim = hp.dim // hp.n_heads
        n_kv = hp.n_kv_heads or hp.n_heads
        return [init_kv_cache(batch, max_length, n_kv, head_dim, dtype, device)
                for _ in range(hp.n_layers)]
