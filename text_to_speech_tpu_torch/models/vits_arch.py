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

Noise comes from a `torch.Generator` (``jax.random`` in the JAX package),
so only runs with ``noise_scale = noise_scale_w = 0`` or given noise are
comparable between the packages.  Under `dtype` every float32 leaf is
cast; the spline flows compute in float32 inside.  The JAX package runs
all of it in XLA, outside any Pallas kernel; the port runs it as plain
tensor code and launches no kernel of its own.  Training (`train_forward`,
the posterior, `sdp_nll`, the monotonic alignment, the losses) is not
ported.
"""

import collections
import math

import torch
import torch.nn.functional as F

from ..hparams import HParams
from ..nn import layers as nn
from ..nn.flows import rational_quadratic_spline
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


class VITS:
    """Static hyper-parameters and the inference functions."""

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
        → tanh · sigmoid with the global cond added → res / skip."""
        C = x.shape[-1]
        cond = nn.dense(wn['cond'], g) if g is not None and 'cond' in wn else None
        skip = torch.zeros_like(x)
        for i in range(n_layers):
            h = nn.conv1d(wn['in_conv_{}'.format(i)], x)
            if cond is not None:
                h = h + cond[:, None, i * 2 * C: (i + 1) * 2 * C].to(h.dtype)
            a, b = h.chunk(2, dim = -1)
            out = nn.conv1d(wn['res_skip_conv_{}'.format(i)], torch.tanh(a) * torch.sigmoid(b))
            if i < n_layers - 1:
                res, s = out.chunk(2, dim = -1)
                x = (x + res) * mask
                skip = skip + s
            else:
                skip = skip + out
        return skip * mask

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

    def _dds(self, dds, x, mask, *, g = None):
        """Dilated depth-separable convs: depthwise (dilation kernel ** i) →
        LN → GELU → pointwise → LN → GELU → residual, masked."""
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
            x = (x + h) * mask
        return x

    def _flow_stack(self, stack, z, mask, cond, *, reverse = False, skip_conv_flow_0 = False):
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
            h = self._dds(p['dds'], nn.conv1d(p['pre'], z0), mask, g = cond)
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
            noise = torch.randn(mask.shape[:2] + (2,), generator = generator, device = h.device)
        z = noise.to(h.dtype) * torch.as_tensor(noise_scale_w, dtype = h.dtype,
                                                device = h.device) * mask
        z, _ = self._flow_stack(p['flows'], z, mask, x, reverse = True, skip_conv_flow_0 = True)
        return z[..., 0].float() * token_mask.float()

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
        if 'rel_k' not in blk:
            return mha(blk['attention'], x, n_heads = hp.n_heads, mask = attn_mask)[0]
        B, L, _ = x.shape
        H = hp.n_heads
        p = blk['attention']
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

        rel_local = (q @ table_for(blk['rel_k']).T) * scale                     # (B, H, L, 2L-1)
        logits = logits + torch.gather(rel_local, -1, idx.expand(B, H, L, L))
        logits = logits.masked_fill(~attn_mask, -1e9)
        attn = torch.softmax(logits.float(), dim = -1).to(x.dtype)
        out = attn @ v + torch.einsum('bhlm,lmd->bhld', attn, table_for(blk['rel_v'])[idx])
        out = out.transpose(1, 2).reshape(B, L, H * D)
        return nn.dense(p['output'], out)

    def encode_text(self, params, tokens):
        """tokens (B, L) → (h (B, L, H), m_p, logs_p (B, L, C), token mask (B, L))."""
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
        x = x * fmask.to(x.dtype)
        for i in range(hp.n_text_layers):
            blk = params['text_encoder']['layer_{}'.format(i)]
            h = self._text_attention(blk, x, attn_mask)
            x = nn.layer_norm(blk['attention_norm'], x + h, hp.epsilon) * fmask.to(x.dtype)
            h = torch.relu(nn.conv1d(blk['conv1'], x))
            # masked between the convs: conv1's bias and relu make pad rows non-zero
            h = nn.conv1d(blk['conv2'], h * fmask.to(h.dtype))
            x = nn.layer_norm(blk['ffn_norm'], x + h, hp.epsilon) * fmask.to(x.dtype)
        stats = nn.conv1d(params['text_proj'], x) * fmask.to(x.dtype)
        m_p, logs_p = stats.chunk(2, dim = -1)
        return x, m_p, logs_p, valid

    def predict_log_durations(self, params, h, token_mask, *, g = None):
        """The conv duration predictor over the text states → (B, L)."""
        hp = self.hp
        x = h
        if g is not None and 'duration_cond' in params:
            x = x + nn.dense(params['duration_cond'], g)[:, None, :]
        p = params['duration_predictor']
        fmask = token_mask[..., None].to(x.dtype)
        x = x * fmask
        x = nn.layer_norm(p['norm1'], torch.relu(nn.conv1d(p['conv1'], x)), hp.epsilon)
        x = x * fmask
        x = nn.layer_norm(p['norm2'], torch.relu(nn.conv1d(p['conv2'], x)), hp.epsilon)
        return nn.dense(p['proj'], x)[..., 0] * token_mask

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

    # -- inference ---------------------------------------------------------------------

    def infer_latent(self, params, tokens, *, speaker_embedding = None, speaker_ids = None,
                     max_frames = None, noise_scale = 0.667, noise_scale_w = 0.8,
                     d_control = 1., min_duration = 0, dtype = None, generator = None):
        """Text → durations → expanded prior → latent `z` (B, max_frames, C)
        through the reverse flow.  Returns ``(z, cond, lengths, durations,
        align)``; the noise of the SDP, then of the prior, is drawn from
        `generator`."""
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
                                   generator = generator)
        else:
            logw = self.predict_log_durations(params, h, tok_mask, g = g)
        w = torch.exp(logw.float()) * tok_mask.float() * d_control
        durations = torch.clamp(torch.ceil(w), min = float(min_duration)).to(torch.int32)
        durations = durations * tok_valid

        stats, frame_mask, lengths, idx = length_regulator(
            torch.cat([m_p, logs_p], dim = -1), durations, max_frames)
        m_p_f, logs_p_f = stats.chunk(2, dim = -1)
        eps = torch.randn(m_p_f.shape, generator = generator, device = m_p_f.device) \
            .to(m_p_f.dtype)
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
        return self.generator.apply(gen, z, cond = cond)

    def infer(self, params, state, tokens, *, speaker_embedding = None, speaker_ids = None,
              max_frames = None, noise_scale = 0.667, noise_scale_w = 0.8, d_control = 1.,
              min_duration = 0, dtype = None, generator = None, ** _):
        """One parallel pass → `VITSInferenceOutput`, field-compatible with
        the Tacotron-2 output: `audio` in the place of the mel, the hard
        duration alignment as `attention_weights`."""
        z, cond, lengths, durations, align = self.infer_latent(
            params, tokens, speaker_embedding = speaker_embedding, speaker_ids = speaker_ids,
            max_frames = max_frames, noise_scale = noise_scale, noise_scale_w = noise_scale_w,
            d_control = d_control, min_duration = min_duration, dtype = dtype,
            generator = generator)
        audio = self.decode_frames(params, z, cond, dtype = dtype)
        return VITSInferenceOutput(audio = audio.float(), lengths = lengths, stop_tokens = None,
                                   attention_weights = align, decoder_output = None,
                                   durations = durations)
