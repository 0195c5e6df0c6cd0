"""VITS inference over dictionaries of tensors.

Counterpart of the inference part of ``text_to_speech_tpu/models/vits_arch.py``:
text → durations → expanded prior → reverse flow → HiFi-GAN decode, in one
parallel pass.

  - `encode_text`: the token embedding scaled by sqrt(hidden), then post-LN
    blocks of windowed relative self-attention (`_text_attention`: the
    heads share the `rel_k` / `rel_v` tables, positions beyond the window
    get zero embeddings, the softmax runs in float32) and a conv FFN, the
    padded rows re-zeroed after each; ``text_rel_window=None`` takes the
    plain `transformers.attention.mha` with sinusoidal positions.  It is
    plain tensor code in the JAX formula, not a library attention call.
  - the durations: the conv predictor (`predict_log_durations`) or the
    stochastic one (`sdp_sample`: its spline flows run in reverse from noise
    scaled by `noise_scale_w`, without the first ConvFlow, as the published
    sampling path does), then ``ceil(exp(logw) * d_control)`` floored at
    `min_duration`.
  - `length_regulator` (the port's FastSpeech-2 one) expands the prior's
    (mean, log-std) to `max_frames`; the latent is ``m + eps * exp(logs) *
    noise_scale``, mapped back through the residual couplings (`flow`,
    reverse) and decoded by the HiFi-GAN generator (`decode_frames`).

Training (JAX ``:114-180``, ``:449-513``, ``:686-808``):

  - `train_forward`: the text encoder, the `posterior` over the linear
    spectrogram (a sampled latent), the `flow` to the prior's space, the
    monotonic alignment (`neg_cross_entropy`, then `maximum_path`, without
    gradient), the durations' loss terms (`sdp_nll`, or the conv
    predictor's log-durations for `duration_loss`), and the HiFi-GAN
    generator on a random window of `segment_frames` latent frames;
    `kl_loss` and `duration_loss` reduce in float32.
  - `maximum_path` is the JAX package's two scans as loops over the frames
    of batched tensor ops, the DP rows kept on the device: ``Q[t, l] =
    nc[t, l] + max(Q[t-1, l], Q[t-1, l-1])``, then the backtrack from
    ``(T_b - 1, L_b - 1)``, stepping down where ``down >= stay``; it equals
    the JAX path to the bit on the same `neg_cent`.
  - `sdp_nll` is a float32 island whatever the compute dtype, on detached
    text states; gradients flow through `nn.flows`' spline.
  - With ``train=True`` the JAX package's dropouts run (the text encoder,
    the conv duration predictor, the SDP's convs) at its rates, drawn from
    a `torch.Generator`; inference is unchanged.

Noise comes from a `torch.Generator` (``jax.random`` in the JAX package),
so only runs with ``noise_scale = noise_scale_w = 0`` or given noise are
comparable between the packages: `train_forward` and `sdp_nll` take the
posterior's `eps`, the SDP's `e_q` and the windows' `starts` as given
draws.  Under `dtype` every float32 leaf is cast; the spline flows compute
in float32 inside.  The JAX package runs all of it in XLA, outside any
Pallas kernel; the port runs it as plain tensor code and launches no kernel
of its own.

Inside `parallel.collectives.tensor_shard` over ``tp`` the three regions
of `parallel.vits_param_specs` split: the text encoder's blocks as
Megatron splits them (``n_heads / tp`` heads, the relative tables shared
and whole), the posterior's and the flows' WaveNet stacks on their hidden
channels (`_wn`), and the generator's ``conv_pre`` and first upsample
(`HiFiGAN.apply`); every tp rank draws the same noise, every dp rank its
rows of the whole batch's draw (`batch_draw`).
"""

import collections
import math

import torch
import torch.nn.functional as F

from ..hparams import HParams
from ..nn import layers as nn
from ..nn.flows import rational_quadratic_spline
from ..parallel.collectives import (
    batch_draw, batch_sum, tensor_axis, tp_all_gather, tp_enter, tp_split)
from ..weights import cast_tree
from .fastspeech2_arch import length_regulator
from .hifigan_arch import HParamsHiFiGAN, HiFiGAN
from .transformers.attention import mha
from .transformers.transformer_arch import sinusoidal_embedding

VITSInferenceOutput = collections.namedtuple(
    'VITSInferenceOutput',
    ['audio', 'lengths', 'stop_tokens', 'attention_weights', 'decoder_output', 'durations'],
)

HParamsVITS = HParams(
    vocab_size = 148,
    pad_token = 0,
    spec_channels = 513,            # linear-STFT bins (n_fft // 2 + 1)

    inter_channels = 192,           # the latent z
    hidden_channels = 192,
    filter_channels = 768,          # the text encoder's FFN
    n_heads = 2,
    n_text_layers = 6,
    text_kernel_size = 3,
    text_rel_window = 4,            # windowed relative attention (None: plain MHA)
    drop_rate = 0.1,
    epsilon = 1e-9,
    max_position = 2048,

    posterior_layers = 16,
    posterior_kernel_size = 5,

    flow_layers = 4,
    flow_wn_layers = 4,
    flow_kernel_size = 5,

    # the duration predictor: a conv stack, or the stochastic flows (`use_sdp`)
    duration_filters = 256,
    duration_kernel_size = 3,
    duration_drop_rate = 0.5,
    use_sdp = False,
    sdp_filter_channels = 192,
    sdp_kernel_size = 3,
    sdp_n_flows = 4,
    sdp_dds_layers = 3,
    sdp_n_bins = 10,
    sdp_tail_bound = 5.0,
    sdp_drop_rate = 0.5,

    # speakers: a learned table and/or an external embedding projected
    n_speakers = None,
    speaker_embedding_dim = None,
    gin_channels = 256,

    # the HiFi-GAN decoder (the published LJSpeech configuration)
    upsample_rates = (8, 8, 2, 2),
    upsample_kernel_sizes = (16, 16, 4, 4),
    upsample_initial_channel = 512,
    resblock_kernel_sizes = (3, 7, 11),
    resblock_dilation_sizes = ((1, 3, 5), (1, 3, 5), (1, 3, 5)),
    resblock_version = 1,
    leaky_slope = 0.1,
    mpd_periods = (2, 3, 5, 7, 11),
    msd_scales = 3,

    segment_frames = 32,            # training's decode window
    max_frames = 1024,              # the inference expansion buffer
)


_NEG = -1e9
_LOG_2PI = 1.8378770664093453


def neg_cross_entropy(z_p, m_p, logs_p, token_mask):
    """The prior's log-likelihood of each frame latent under each token's
    Gaussian, float32: z_p (B, T, C), m_p / logs_p (B, L, C) → (B, T, L),
    `_NEG` at padded tokens."""
    z_p, m_p, logs_p = z_p.float(), m_p.float(), logs_p.float()
    r = torch.exp(-2. * logs_p)                                  # 1 / sigma^2
    nc1 = torch.sum(-0.5 * _LOG_2PI - logs_p, dim = -1)          # (B, L)
    nc2 = -0.5 * (z_p ** 2) @ r.transpose(1, 2)
    nc3 = z_p @ (m_p * r).transpose(1, 2)
    nc4 = -0.5 * torch.sum(m_p ** 2 * r, dim = -1)               # (B, L)
    out = nc1[:, None, :] + nc2 + nc3 + nc4[:, None, :]
    return torch.where(token_mask[:, None, :], out, torch.full_like(out, _NEG))


@torch.no_grad()
def maximum_path(neg_cent, frame_mask, token_mask):
    """Monotonic alignment search: the best strictly monotonic, surjective
    token → frame path of `neg_cent` (B, T, L) within each row's frames
    (`frame_mask` (B, T)) and tokens (`token_mask` (B, L)) → one-hot (B, T,
    L) float32, without gradient.  Loops over the frames of batched ops on
    the device (the DP forward, then the backtrack), with the JAX package's
    arithmetic and tie rule (a step down where ``down >= stay``)."""
    nc = torch.where(token_mask[:, None, :], neg_cent.float(), torch.full_like(neg_cent, _NEG,
                                                                               dtype = torch.float32))
    B, T, L = nc.shape
    device = nc.device
    frame_len = frame_mask.sum(dim = 1)
    token_len = token_mask.sum(dim = 1)
    cols = torch.arange(L, device = device)
    neg_col = torch.full((B, 1), _NEG, dtype = torch.float32, device = device)

    q = nc[:, 0] + torch.where(cols == 0, 0., _NEG)[None, :]
    rows = []                                         # Q[0 .. T-2]
    for t in range(1, T):
        rows.append(q)
        q = nc[:, t] + torch.maximum(q, torch.cat([neg_col, q[:, :-1]], dim = 1))

    path = torch.zeros((B, T, L), dtype = torch.float32, device = device)
    l = torch.clamp(token_len - 1, min = 0)
    for t in range(T - 1, 0, -1):
        q_prev = rows[t - 1]
        active = t < frame_len
        path[:, t] = ((cols[None, :] == l[:, None]) & active[:, None]).float()
        stay = torch.gather(q_prev, 1, l[:, None])[:, 0]
        down = torch.gather(q_prev, 1, torch.clamp(l - 1, min = 0)[:, None])[:, 0]
        l = torch.where(active & (l > 0) & (down >= stay), l - 1, l)
    path[:, 0] = ((cols[None, :] == l[:, None]) & (frame_len > 0)[:, None]).float()
    return path


def _gather_window(x, starts, length):
    """Rows of `x` (B, T, ...) from `starts` (B,) for `length` steps, each
    start clamped into [0, T - length] as ``lax.dynamic_slice`` clamps it."""
    starts = torch.clamp(starts, 0, x.shape[1] - length)
    idx = starts[:, None] + torch.arange(length, device = x.device)[None, :]
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand((-1, -1) + x.shape[2:])
    return torch.gather(x, 1, idx)


class VITS:
    """Static hyper-parameters, the inference functions and the training
    forward."""

    def __init__(self, ** kwargs):
        self.hp = HParamsVITS.extract(kwargs)
        hp = self.hp
        self.generator = HiFiGAN(** {
            ** {k: hp[k] for k in HParamsHiFiGAN.get_config() if k in hp.get_config()},
            'n_mel_channels': hp.inter_channels,
        })
        self.upsample_rate = self.generator.total_upsampling
        self.half_channels = hp.inter_channels // 2
        self._positions = {}

    def get_config(self):
        return self.hp.get_config()

    @property
    def uses_global_cond(self):
        return bool(self.hp.n_speakers or self.hp.speaker_embedding_dim)

    # -- shared blocks -----------------------------------------------------------

    def _wn(self, wn, x, mask, g, n_layers):
        """The gated residual WaveNet stack (non-causal, dilation 1): in-conv
        → tanh · sigmoid with the global cond added → res / skip.  Under
        ``tp`` the stream and the skip sum hold this rank's hidden channels
        (`in_conv` and `res_skip_conv` split on their in channels): each
        in-conv's partial sums are all-reduced before its bias, each
        res / skip conv's reduce-scattered onto the rank's channels, and the
        skip sum gathered at the end."""
        tp = tensor_axis('tp')
        C = x.shape[-1]
        cond = nn.dense(wn['cond'], g) if g is not None and 'cond' in wn else None
        x = tp_split(x, -1, tp)
        skip = torch.zeros_like(x)
        for i in range(n_layers):
            h = nn.row_parallel(nn.conv1d, wn['in_conv_{}'.format(i)], x, tp)
            if cond is not None:
                h = h + cond[:, None, i * 2 * C: (i + 1) * 2 * C].to(h.dtype)
            a, b = h.chunk(2, dim = -1)
            last = i == n_layers - 1
            res, s = nn.res_skip_split(wn['res_skip_conv_{}'.format(i)],
                                       torch.tanh(a) * torch.sigmoid(b), C, tp, last = last)
            if not last:
                x = (x + res) * mask
            skip = skip + s
        return tp_all_gather(skip * mask, -1, tp)

    def global_cond(self, params, *, speaker_ids = None, speaker_embedding = None):
        """→ g (B, gin_channels) or None."""
        g = None
        if speaker_ids is not None and 'speaker_embedding' in params:
            g = nn.embedding(params['speaker_embedding'], speaker_ids)
        if speaker_embedding is not None and 'speaker_projection' in params:
            proj = nn.dense(params['speaker_projection'], speaker_embedding)
            g = proj if g is None else g + proj
        return g

    # -- the stochastic duration predictor ---------------------------------------------

    @staticmethod
    def _dropout(x, rate, train, generator):
        """Dropout at `rate` in training mode, its mask from `generator` (the
        default one when None); the identity otherwise."""
        if not train or rate <= 0.:
            return x
        return nn.dropout(x, rate, generator = generator)

    def _dds(self, dds, x, mask, *, g = None, train = False, generator = None):
        """Dilated depth-separable convs: depthwise (dilation kernel ** i) →
        LN → GELU → pointwise → LN → GELU → dropout (training) → residual,
        masked."""
        hp = self.hp
        if g is not None:
            x = x + g
        for i in range(hp.sdp_dds_layers):
            p = dds['layer_{}'.format(i)]
            h = nn.conv1d(p['depthwise'], x * mask, dilation = hp.sdp_kernel_size ** i,
                          groups = x.shape[-1])
            h = nn.gelu(nn.layer_norm(p['norm1'], h, hp.epsilon))
            h = nn.conv1d(p['pointwise'], h)
            h = nn.gelu(nn.layer_norm(p['norm2'], h, hp.epsilon))
            h = self._dropout(h, hp.sdp_drop_rate, train, generator)
            x = (x + h) * mask
        return x

    def _flow_stack(self, stack, z, mask, cond, *, reverse = False, skip_conv_flow_0 = False,
                    train = False, generator = None):
        """[ElementwiseAffine] + n × [spline ConvFlow, Flip] on (B, L, 2) →
        (z, log-determinant (B,)).  `skip_conv_flow_0`: the published
        sampling path, which drops the first ConvFlow (keeping its Flip)."""
        hp = self.hp
        logdet = torch.zeros(z.shape[:1], dtype = torch.float32, device = z.device)
        m2 = mask[..., 0].float()

        def affine(z):
            m, logs = stack['affine']['m'], stack['affine']['logs']
            ld = torch.sum(logs * torch.ones_like(z) * mask, dim = (1, 2))
            if reverse:
                return (z - m) * torch.exp(-logs) * mask, -ld
            return (m + torch.exp(logs) * z) * mask, ld

        def conv_flow(p, z):
            z0, z1 = z[..., :1], z[..., 1:]
            h = self._dds(p['dds'], nn.conv1d(p['pre'], z0), mask, g = cond, train = train,
                          generator = generator)
            out = (nn.conv1d(p['proj'], h) * mask).float()          # (B, L, 3K - 1)
            K = hp.sdp_n_bins
            scale = math.sqrt(float(hp.sdp_filter_channels))
            y1, ld = rational_quadratic_spline(
                z1[..., 0].float(), out[..., :K] / scale, out[..., K: 2 * K] / scale,
                out[..., 2 * K:], inverse = reverse, tail_bound = hp.sdp_tail_bound)
            z = torch.cat([z0, y1[..., None].to(z0.dtype)], dim = -1) * mask
            return z, torch.sum(ld * m2, dim = 1)

        steps = ['affine'] + [name for i in range(hp.sdp_n_flows)
                              for name in ('conv_flow_{}'.format(i), 'flip')]
        if reverse:
            steps = steps[::-1]
        if skip_conv_flow_0:
            steps = [s for s in steps if s != 'conv_flow_0']
        for name in steps:
            if name == 'affine':
                z, ld = affine(z)
            elif name == 'flip':
                z, ld = torch.flip(z, [-1]), 0.
            else:
                z, ld = conv_flow(stack[name], z)
            logdet = logdet + ld
        return z, logdet

    def sdp_sample(self, params, h, token_mask, *, g = None, noise_scale_w = 0.8,
                   generator = None, noise = None):
        """Log-durations (B, L) float32 sampled through the SDP flows in
        reverse from ``noise * noise_scale_w`` (`noise` (B, L, 2): a
        standard normal draw from `generator` unless given)."""
        p = params['duration_predictor']
        mask = token_mask[..., None].to(h.dtype)
        x = nn.conv1d(p['pre'], h)
        if g is not None and 'cond' in p:
            x = x + nn.dense(p['cond'], g)[:, None, :]
        x = self._dds(p['dds'], x, mask)
        x = nn.conv1d(p['proj'], x) * mask
        if noise is None:
            noise = batch_draw(torch.randn, mask.shape[:2] + (2,), generator = generator,
                               device = h.device)
        z = noise.to(h.dtype) * torch.as_tensor(noise_scale_w, dtype = h.dtype,
                                                device = h.device) * mask
        z, _ = self._flow_stack(p['flows'], z, mask, x, reverse = True, skip_conv_flow_0 = True)
        return z[..., 0].float() * token_mask.float()

    def sdp_nll(self, params, h, w, token_mask, *, g = None, train = True, generator = None,
                e_q = None):
        """The stochastic duration predictor's negative log-likelihood of the
        durations `w` (B, L), summed over rows and divided by the valid
        tokens.  Variational dequantization: the posterior flows map noise
        `e_q` (B, L, 2; a standard normal draw from `generator` unless given)
        to u in (0, 1) and an auxiliary channel, the main flows model
        ``(log(w - u), aux)``.  A float32 island: the params, `h` and `g`
        (both detached) in float32, whatever the compute dtype."""
        p = cast_tree(params['duration_predictor'], torch.float32)
        h = h.detach().float()
        mask = token_mask[..., None].float()
        w = w.float()[..., None] * mask                              # (B, L, 1)

        x = nn.conv1d(p['pre'], h)
        if g is not None and 'cond' in p:
            x = x + nn.dense(p['cond'], g.detach().float())[:, None, :]
        x = self._dds(p['dds'], x, mask, train = train, generator = generator)
        x = nn.conv1d(p['proj'], x) * mask

        # the posterior q(u, aux | w, h)
        h_w = nn.conv1d(p['post_pre'], w)
        h_w = self._dds(p['post_dds'], h_w, mask, train = train, generator = generator)
        h_w = nn.conv1d(p['post_proj'], h_w) * mask
        if e_q is None:
            e_q = batch_draw(torch.randn, w.shape[:2] + (2,), generator = generator,
                             device = w.device)
        e_q = e_q.float() * mask
        z_q, logdet_q = self._flow_stack(p['post_flows'], e_q, mask, x + h_w, train = train,
                                         generator = generator)
        z_u, z_aux = z_q[..., :1], z_q[..., 1:]
        u = torch.sigmoid(z_u) * mask
        z0 = (w - u) * mask
        logdet_q = logdet_q + torch.sum((F.logsigmoid(z_u) + F.logsigmoid(-z_u)) * mask,
                                        dim = (1, 2))
        logq = torch.sum(-0.5 * (_LOG_2PI + e_q ** 2) * mask, dim = (1, 2)) - logdet_q

        # the main flows on the log of the dequantized duration
        z0 = torch.log(torch.maximum(z0, torch.full_like(z0, 1e-5))) * mask
        logdet = torch.sum(-z0 * mask, dim = (1, 2))
        z, ld = self._flow_stack(p['flows'], torch.cat([z0, z_aux], dim = -1), mask, x,
                                 train = train, generator = generator)
        logdet = logdet + ld
        nll = torch.sum(0.5 * (_LOG_2PI + z ** 2) * mask, dim = (1, 2)) - logdet
        return batch_sum(torch.sum(nll + logq)) / torch.clamp(
            batch_sum(token_mask.float().sum()), min = 1.)

    # -- the prior (text) side -----------------------------------------------------

    def _position_table(self, device):
        if device not in self._positions:
            self._positions[device] = sinusoidal_embedding(
                self.hp.max_position, self.hp.hidden_channels, device = device)
        return self._positions[device]

    def _text_attention(self, blk, x, attn_mask):
        """Self-attention with windowed relative position terms: positions
        beyond ±window contribute zero relative embeddings."""
        hp = self.hp
        tp = tensor_axis('tp')
        if 'rel_k' not in blk:
            return mha(blk['attention'], x, n_heads = hp.n_heads, mask = attn_mask, tp = tp)[0]
        B, L, _ = x.shape
        H = hp.n_heads // (tp.size if tp is not None else 1)
        p = blk['attention']
        # under tp: this rank's heads; the tables, shared by every head,
        # enter whole (their gradient summed over the ranks)
        x = tp_enter(x, tp)
        rel_k, rel_v = tp_enter(blk['rel_k'], tp), tp_enter(blk['rel_v'], tp)
        D = p['query']['weight'].shape[0] // H
        to_heads = lambda name: nn.dense(p[name], x).reshape(B, L, H, D).transpose(1, 2)
        q, k, v = to_heads('query'), to_heads('key'), to_heads('value')
        scale = D ** -0.5
        logits = (q @ k.transpose(-1, -2)) * scale

        w = hp.text_rel_window
        pad = L - 1 - w

        def table_for(emb):                      # (2L - 1, D), zero beyond the window
            emb = emb.to(x.dtype)
            if pad >= 0:
                return F.pad(emb, (0, 0, pad, pad))
            return emb[-pad: -pad + 2 * L - 1]
        ar = torch.arange(L, device = x.device)
        idx = torch.clamp(ar[None, :] - ar[:, None] + L - 1, 0, 2 * L - 2)       # (L, L)

        rel_local = (q @ table_for(rel_k).T) * scale                     # (B, H, L, 2L-1)
        logits = logits + torch.gather(rel_local, -1, idx.expand(B, H, L, L))
        logits = logits.masked_fill(~attn_mask, -1e9)
        attn = torch.softmax(logits.float(), dim = -1).to(x.dtype)
        out = attn @ v + torch.einsum('bhlm,lmd->bhld', attn, table_for(rel_v)[idx])
        out = out.transpose(1, 2).reshape(B, L, H * D)
        return nn.row_parallel(nn.dense, p['output'], out, tp)

    def encode_text(self, params, tokens, *, train = False, generator = None):
        """tokens (B, L) → (h (B, L, H), m_p, logs_p (B, L, C), token mask
        (B, L)); with `train`, dropout after the embedding, the attention and
        the first FFN conv."""
        hp = self.hp
        L = tokens.shape[1]
        valid = tokens != hp.pad_token
        attn_mask = valid[:, None, None, :]
        fmask = valid[..., None].float()
        x = nn.embedding(params['embedding'], tokens) * math.sqrt(float(hp.hidden_channels))
        if hp.text_rel_window is None:
            # the plain-MHA variant needs absolute positions; the windowed
            # relative encoder has none
            x = x + self._position_table(x.device)[None, :L].to(x.dtype)
        x = self._dropout(x, hp.drop_rate, train, generator)
        x = x * fmask.to(x.dtype)
        tp = tensor_axis('tp')
        for i in range(hp.n_text_layers):
            blk = params['text_encoder']['layer_{}'.format(i)]
            h = self._dropout(self._text_attention(blk, x, attn_mask), hp.drop_rate, train,
                              generator)
            x = nn.layer_norm(blk['attention_norm'], x + h, hp.epsilon) * fmask.to(x.dtype)
            # under tp: conv1 makes this rank's FFN channels, conv2 sums them
            h = torch.relu(nn.conv1d(blk['conv1'], tp_enter(x, tp)))
            if train:
                h = nn.dropout(h, hp.drop_rate, generator = generator, tp = tp)
            # masked between the convs: conv1's bias and relu make pad rows non-zero
            h = nn.row_parallel(nn.conv1d, blk['conv2'], h * fmask.to(h.dtype), tp)
            x = nn.layer_norm(blk['ffn_norm'], x + h, hp.epsilon) * fmask.to(x.dtype)
        stats = nn.conv1d(params['text_proj'], x) * fmask.to(x.dtype)
        m_p, logs_p = stats.chunk(2, dim = -1)
        return x, m_p, logs_p, valid

    def predict_log_durations(self, params, h, token_mask, *, g = None, train = False,
                              generator = None):
        """The conv duration predictor over the detached text states → (B,
        L); with `train`, dropout after each conv block."""
        hp = self.hp
        x = h.detach()
        if g is not None and 'duration_cond' in params:
            x = x + nn.dense(params['duration_cond'], g.detach())[:, None, :]
        p = params['duration_predictor']
        fmask = token_mask[..., None].to(x.dtype)
        x = x * fmask
        x = nn.layer_norm(p['norm1'], torch.relu(nn.conv1d(p['conv1'], x)), hp.epsilon)
        x = self._dropout(x, hp.duration_drop_rate, train, generator) * fmask
        x = nn.layer_norm(p['norm2'], torch.relu(nn.conv1d(p['conv2'], x)), hp.epsilon)
        x = self._dropout(x, hp.duration_drop_rate, train, generator)
        return nn.dense(p['proj'], x)[..., 0] * token_mask

    # -- the posterior --------------------------------------------------------------

    def posterior(self, params, spec, frame_mask, *, g = None, eps = None, generator = None):
        """Linear spectrogram (B, T, spec_channels) → (z, m_q, logs_q), the
        latent sampled as ``m_q + eps * exp(logs_q)``: `eps` a standard
        normal draw from `generator` unless given (0. for the mean)."""
        p = params['posterior']
        mask = frame_mask[..., None].to(spec.dtype)
        x = nn.conv1d(p['pre'], spec) * mask
        x = self._wn(p['wn'], x, mask, g, self.hp.posterior_layers)
        m_q, logs_q = (nn.conv1d(p['proj'], x) * mask).chunk(2, dim = -1)
        if eps is None:
            eps = batch_draw(torch.randn, m_q.shape, generator = generator, device = m_q.device)
        if torch.is_tensor(eps):
            eps = eps.to(m_q.dtype)
        return (m_q + eps * torch.exp(logs_q)) * mask, m_q, logs_q

    # -- the flow ---------------------------------------------------------------------

    def flow(self, params, x, frame_mask, *, g = None, reverse = False):
        """The residual coupling stack (mean-only, volume-preserving);
        `reverse` is the inference direction (prior → latent)."""
        hp = self.hp
        mask = frame_mask[..., None].to(x.dtype)
        order = range(hp.flow_layers)
        for k in (reversed(order) if reverse else order):
            flow_p = params['flow_{}'.format(k)]
            if reverse:
                x = torch.flip(x, [-1])              # undo the flip after the coupling
            x0, x1 = x.chunk(2, dim = -1)
            h = nn.conv1d(flow_p['pre'], x0) * mask
            h = self._wn(flow_p['wn'], h, mask, g, hp.flow_wn_layers)
            m = nn.conv1d(flow_p['post'], h) * mask
            x1 = (x1 - m) if reverse else (x1 + m)
            x = torch.cat([x0, x1 * mask], dim = -1)
            if not reverse:
                x = torch.flip(x, [-1])
        return x

    # -- training -------------------------------------------------------------------------

    def train_forward(self, params, tokens, spec, spec_lengths, audio, generator = None, *,
                      speaker_ids = None, speaker_embedding = None, train = True, eps = None,
                      e_q = None, starts = None):
        """One training pass → what the GAN step's losses read: tokens (B,
        L), the linear spectrogram (B, T, spec_channels), its lengths (B,)
        and the waveform (B, T * rate) aligned to it.  The draws (dropout,
        the posterior's `eps`, the SDP's `e_q`, the windows' `starts` (B,)
        in frames) come from `generator` unless given."""
        hp = self.hp
        g = self.global_cond(params, speaker_ids = speaker_ids,
                             speaker_embedding = speaker_embedding)
        h, m_p_tok, logs_p_tok, tok_mask = self.encode_text(params, tokens, train = train,
                                                            generator = generator)
        T = spec.shape[1]
        frame_mask = torch.arange(T, device = spec.device)[None, :] < spec_lengths[:, None]
        z, m_q, logs_q = self.posterior(params, spec, frame_mask, g = g, eps = eps,
                                        generator = generator)
        z_p = self.flow(params, z, frame_mask, g = g)

        # the monotonic alignment, without gradient
        path = maximum_path(neg_cross_entropy(z_p.detach(), m_p_tok.detach(),
                                              logs_p_tok.detach(), tok_mask),
                            frame_mask, tok_mask)                     # (B, T, L)
        # float32 products, as the JAX package's einsum promotes a bfloat16 prior
        m_p = path @ m_p_tok.float()
        logs_p = path @ logs_p_tok.float()
        w = path.sum(dim = 1)                                       # (B, L) durations

        if hp.use_sdp:
            duration_nll = self.sdp_nll(params, h, w, tok_mask, g = g, train = train,
                                        generator = generator, e_q = e_q)
            logw_hat = None
        else:
            duration_nll = None
            logw_hat = self.predict_log_durations(params, h, tok_mask.to(h.dtype), g = g,
                                                  train = train, generator = generator)

        # the generator on a random window of the latent
        seg, hop = hp.segment_frames, self.upsample_rate
        if starts is None:
            max_start = torch.clamp(spec_lengths - seg, min = 0)
            u = batch_draw(torch.rand, (z.shape[0],), generator = generator, device = z.device)
            starts = torch.floor(u * (max_start + 1).float()).long()
        starts = torch.as_tensor(starts, device = z.device).long()
        z_seg = _gather_window(z, starts, seg)
        audio_seg = _gather_window(audio, starts * hop, seg * hop)
        cond = nn.dense(params['generator_cond'], g) \
            if g is not None and 'generator_cond' in params else None
        audio_hat = self.generator.apply(params['generator'], z_seg, cond = cond,
                                         tp = tensor_axis('tp'))
        return {'z_p': z_p, 'm_p': m_p, 'logs_p': logs_p, 'logs_q': logs_q,
                'frame_mask': frame_mask, 'token_mask': tok_mask, 'durations': w,
                'log_durations_hat': logw_hat, 'duration_nll': duration_nll,
                'audio_hat': audio_hat, 'audio_seg': audio_seg, 'starts': starts, 'path': path}

    @staticmethod
    def kl_loss(z_p, logs_q, m_p, logs_p, frame_mask):
        """KL(posterior ‖ the flow-mapped prior) in its sampled form, a
        masked mean in float32."""
        z_p, logs_p = z_p.float(), logs_p.float()
        kl = logs_p - logs_q.float() - 0.5
        kl = kl + 0.5 * (z_p - m_p.float()) ** 2 * torch.exp(-2. * logs_p)
        mask = frame_mask[..., None].float()
        return batch_sum(torch.sum(kl * mask)) / (batch_sum(torch.sum(mask)) * z_p.shape[-1])

    @staticmethod
    def duration_loss(log_durations_hat, durations, token_mask):
        """The squared error of the log-durations over the tokens, float32."""
        mask = token_mask.float()
        target = torch.log(durations.float() + 1e-6) * mask
        err = (log_durations_hat.float() - target) ** 2 * mask
        return batch_sum(torch.sum(err)) / torch.clamp(batch_sum(torch.sum(mask)), min = 1.)

    # -- inference ---------------------------------------------------------------------

    def infer_latent(self, params, tokens, *, speaker_embedding = None, speaker_ids = None,
                     max_frames = None, noise_scale = 0.667, noise_scale_w = 0.8,
                     d_control = 1., min_duration = 0, dtype = None, generator = None,
                     noise = None):
        """Text → durations → expanded prior → latent `z` (B, max_frames, C)
        through the reverse flow.  Returns ``(z, cond, lengths, durations,
        align)``; the noise of the SDP, then of the prior, is drawn from
        `generator` unless `noise` gives both standard normal draws:
        ``{'sdp': (B, L, 2), 'prior': (B, max_frames, C)}`` (an exported
        forward takes them as inputs; the JAX package's draws from its key
        are these)."""
        hp = self.hp
        if max_frames is None:
            max_frames = hp.max_frames
        if dtype is not None:
            params = cast_tree(params, dtype)
            if speaker_embedding is not None:
                speaker_embedding = speaker_embedding.to(dtype)
        g = self.global_cond(params, speaker_ids = speaker_ids,
                             speaker_embedding = speaker_embedding)
        h, m_p, logs_p, tok_valid = self.encode_text(params, tokens)
        tok_mask = tok_valid.to(h.dtype)
        if hp.use_sdp:
            logw = self.sdp_sample(params, h, tok_valid, g = g, noise_scale_w = noise_scale_w,
                                   generator = generator,
                                   noise = None if noise is None else noise['sdp'])
        else:
            logw = self.predict_log_durations(params, h, tok_mask, g = g)
        w = torch.exp(logw.float()) * tok_mask.float() * d_control
        durations = torch.clamp(torch.ceil(w), min = float(min_duration)).to(torch.int32)
        durations = durations * tok_valid

        stats, frame_mask, lengths, idx = length_regulator(
            torch.cat([m_p, logs_p], dim = -1), durations, max_frames)
        m_p_f, logs_p_f = stats.chunk(2, dim = -1)
        eps = noise['prior'] if noise is not None else batch_draw(
            torch.randn, m_p_f.shape, generator = generator, device = m_p_f.device)
        eps = eps.to(m_p_f.dtype)
        z_p = m_p_f + eps * torch.exp(logs_p_f) * torch.as_tensor(
            noise_scale, dtype = m_p_f.dtype, device = m_p_f.device)
        z_p = z_p * frame_mask[..., None].to(z_p.dtype)
        z = self.flow(params, z_p, frame_mask, g = g, reverse = True)
        z = z * frame_mask[..., None].to(z.dtype)
        cond = nn.dense(params['generator_cond'], g) \
            if g is not None and 'generator_cond' in params else None
        align = F.one_hot(idx.long(), tokens.shape[1]).float() * frame_mask[..., None]
        return z, cond, lengths, durations, align

    def decode_frames(self, params, z, cond = None, *, dtype = None):
        """Latent frames (B, T, C) → waveform (B, T * rate), float32; under
        `dtype` the generator, `z` and `cond` are cast."""
        gen = params['generator']
        if dtype is not None:
            gen = cast_tree(gen, dtype)
            z = z.to(dtype)
            if cond is not None:
                cond = cond.to(dtype)
        return self.generator.apply(gen, z, cond = cond, tp = tensor_axis('tp'))

    def infer(self, params, state, tokens, *, speaker_embedding = None, speaker_ids = None,
              max_frames = None, noise_scale = 0.667, noise_scale_w = 0.8, d_control = 1.,
              min_duration = 0, dtype = None, generator = None, noise = None, ** _):
        """One parallel pass → `VITSInferenceOutput`, field-compatible with
        the Tacotron-2 output: `audio` in the place of the mel, the hard
        duration alignment as `attention_weights`.  `noise`: as
        `infer_latent`'s."""
        z, cond, lengths, durations, align = self.infer_latent(
            params, tokens, speaker_embedding = speaker_embedding, speaker_ids = speaker_ids,
            max_frames = max_frames, noise_scale = noise_scale, noise_scale_w = noise_scale_w,
            d_control = d_control, min_duration = min_duration, dtype = dtype,
            generator = generator, noise = noise)
        audio = self.decode_frames(params, z, cond, dtype = dtype)
        return VITSInferenceOutput(audio = audio.float(), lengths = lengths, stop_tokens = None,
                                   attention_weights = align, decoder_output = None,
                                   durations = durations)
