"""FastSpeech-2 inference over dictionaries of tensors.

Counterpart of ``text_to_speech_tpu/models/fastspeech2_arch.py``
(inference): the encoder and decoder stacks of post-LN feed-forward
transformer blocks (self-attention, then a conv FFN with kernels 9 and 1),
the variance adaptor (duration, pitch and energy predictors, the quantized
pitch and energy embeddings, at phoneme or frame level), the length
regulator and the conv + batch-norm postnet.  Parameters are the port's
layouts (`weights.convert_tree` of the JAX trees).

Every frame comes out of one parallel pass: the predicted durations drive
`length_regulator`, which expands the phoneme states into a fixed
`max_frames` buffer and masks the frames past each row's total, so one set
of shapes serves any utterance.  The JAX package computes all of it in
XLA, outside any Pallas kernel: the port runs it as plain tensor code (no
CUDA kernel of the port is on this path; the vocoder's are).

Dtypes follow the JAX package's promotion: under `dtype` every float32
leaf of the params and state is cast, the pad masks stay float32 where the
JAX code builds them so, and a control passed as a tensor (as the task
model passes them) promotes the prediction it scales as a JAX array does,
where a Python float keeps its dtype.  `__call__` is the teacher-forced
training pass (ground-truth durations, pitch and energy; dropout and the
postnet's batch norms in train mode), as the JAX package's.
"""

import collections

import torch
import torch.nn.functional as F

from ..hparams import HParams
from ..nn import layers as nn
from ..weights import cast_tree
from .transformers.attention import mha
from .transformers.transformer_arch import sinusoidal_embedding

FastSpeech2InferenceOutput = collections.namedtuple(
    'FastSpeech2InferenceOutput',
    ['mel', 'lengths', 'stop_tokens', 'attention_weights', 'decoder_output',
     'durations', 'pitch', 'energy'],
)

HParamsFastSpeech2 = HParams(
    vocab_size = 148,
    pad_token = 0,
    n_mel_channels = 80,

    dim = 256,
    n_heads = 2,
    encoder_layers = 4,
    decoder_layers = 6,
    ffn_dim = 1024,
    ffn_kernels = (9, 1),
    drop_rate = 0.2,
    epsilon = 1e-9,
    max_position = 2048,        # the positional table's length (mel frames)

    # variance adaptor
    variance_filters = 256,
    variance_kernel_size = 3,
    variance_drop_rate = 0.5,
    variance_level = 'phoneme',     # 'phoneme' | 'frame' (pitch and energy)
    use_pitch = True,
    use_energy = True,
    n_bins = 256,
    pitch_min = -3.,
    pitch_max = 3.,
    energy_min = -3.,
    energy_max = 3.,

    # speaker conditioning (an external embedding, projected)
    speaker_embedding_dim = None,

    # postnet (Tacotron-style conv + batch norm)
    use_postnet = True,
    postnet_n_conv = 5,
    postnet_filters = 256,
    postnet_kernel_size = 5,
    postnet_drop_rate = 0.5,
    postnet_epsilon = 1e-5,
    postnet_momentum = 0.1,

    max_frames = 1024,          # the default expansion buffer
)


def length_regulator(x, durations, max_frames):
    """Expand phoneme states to frames without data-dependent shapes.

    x (B, L, D); durations (B, L) int, frames per token.  Frame t belongs to
    token i iff ``cum[i-1] <= t < cum[i]``: the index counts the cumulative
    ends at or below t, is clamped to L - 1 and gathers the rows; frames
    past a row's total are zeroed.  Returns (expanded (B, max_frames, D),
    frame mask (B, max_frames), lengths (B,) = min(total, max_frames),
    token index per frame (B, max_frames))."""
    L = x.shape[1]
    ends = torch.cumsum(durations.to(torch.int32), dim = 1, dtype = torch.int32)
    total = ends[:, -1]
    t = torch.arange(max_frames, dtype = torch.int32, device = x.device)
    idx = (t[None, :, None] >= ends[:, None, :]).sum(dim = -1)
    mask = t[None, :] < total[:, None]
    idx = torch.clamp(idx, max = L - 1)
    expanded = torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[2]))
    expanded = expanded * mask[..., None].to(x.dtype)
    return expanded, mask, torch.clamp(total, max = max_frames), idx


def _scaled(values, control):
    """``values * control`` with JAX's promotion: a tensor control (a
    float32 array there) promotes `values`, a Python float does not."""
    if torch.is_tensor(control):
        values = values.to(torch.promote_types(values.dtype, control.dtype))
    return values * control


class FastSpeech2:
    """Static hyper-parameters and the inference functions."""

    def __init__(self, ** kwargs):
        self.hp = HParamsFastSpeech2.extract(kwargs)
        self._positions = {}

    def get_config(self):
        return self.hp.get_config()

    def _position_table(self, device):
        """`sinusoidal_embedding(max_position, dim)`, made once per device."""
        if device not in self._positions:
            self._positions[device] = sinusoidal_embedding(
                self.hp.max_position, self.hp.dim, device = device)
        return self._positions[device]

    # -- blocks ----------------------------------------------------------------------

    def _fft_block(self, params, x, *, mask = None, pad_mask = None, train = False,
                   generator = None):
        """Post-LN feed-forward-transformer block: self-attention, then the
        conv FFN, each added (after dropout in train mode) and normalized;
        padded rows re-zeroed after each."""
        hp = self.hp
        h, _ = mha(params['attention'], x, n_heads = hp.n_heads, mask = mask)
        if train:
            h = nn.dropout(h, hp.drop_rate, generator = generator)
        x = nn.layer_norm(params['attention_norm'], x + h, hp.epsilon)
        if pad_mask is not None:
            x = x * pad_mask.to(x.dtype)
        h = torch.relu(nn.conv1d(params['conv1'], x))
        h = nn.conv1d(params['conv2'], h)
        if train:
            h = nn.dropout(h, hp.drop_rate, generator = generator)
        x = nn.layer_norm(params['ffn_norm'], x + h, hp.epsilon)
        if pad_mask is not None:
            x = x * pad_mask.to(x.dtype)
        return x

    def _variance_predictor(self, params, x, *, pad_mask = None, train = False,
                            generator = None):
        """2 x [conv → relu → layer norm → dropout] → linear → (B, T)."""
        hp = self.hp
        h = torch.relu(nn.conv1d(params['conv1'], x))
        h = nn.layer_norm(params['norm1'], h, hp.epsilon)
        if train:
            h = nn.dropout(h, hp.variance_drop_rate, generator = generator)
        h = torch.relu(nn.conv1d(params['conv2'], h))
        h = nn.layer_norm(params['norm2'], h, hp.epsilon)
        if train:
            h = nn.dropout(h, hp.variance_drop_rate, generator = generator)
        out = nn.dense(params['proj'], h)[..., 0]
        if pad_mask is not None:
            out = out * pad_mask[..., 0]
        return out

    def _bucketize(self, values, lo, hi):
        """Bin indices: the scaled value truncated toward zero, then clipped
        to [0, n_bins - 1]."""
        n_bins = self.hp.n_bins
        scaled = (values - lo) / max(hi - lo, 1e-9) * n_bins
        return torch.clamp(scaled.to(torch.int32), 0, n_bins - 1)

    def _variance_embedding(self, params, name, values, lo, hi):
        return nn.embedding(params[name + '_embedding'], self._bucketize(values, lo, hi).long())

    def _apply_variances(self, params, x, *, pad_mask, p_control = 1., e_control = 1.,
                         pitch_target = None, energy_target = None, train = False,
                         generator = None):
        """Predict pitch then energy on `x` and add the embeddings of the
        targets where given (teacher forcing), else of the predictions
        scaled by the controls.  Returns (x, pitch_pred, energy_pred)."""
        hp = self.hp
        pitch_pred = energy_pred = None
        if hp.use_pitch:
            pitch_pred = self._variance_predictor(params['pitch_predictor'], x,
                                                  pad_mask = pad_mask, train = train,
                                                  generator = generator)
            pitch = pitch_target if pitch_target is not None \
                else _scaled(pitch_pred, p_control)
            x = x + self._variance_embedding(params, 'pitch', pitch, hp.pitch_min,
                                             hp.pitch_max)
        if hp.use_energy:
            energy_pred = self._variance_predictor(params['energy_predictor'], x,
                                                   pad_mask = pad_mask, train = train,
                                                   generator = generator)
            energy = energy_target if energy_target is not None \
                else _scaled(energy_pred, e_control)
            x = x + self._variance_embedding(params, 'energy', energy, hp.energy_min,
                                             hp.energy_max)
        if pad_mask is not None:
            x = x * pad_mask.to(x.dtype)
        return x, pitch_pred, energy_pred

    # -- encoder / decoder -------------------------------------------------------------

    def encode(self, params, tokens, *, speaker_embedding = None, train = False,
               generator = None):
        """tokens (B, L) → (hidden (B, L, D), attention mask (B, 1, 1, L),
        pad mask (B, L, 1) float32)."""
        hp = self.hp
        L = tokens.shape[1]
        valid = tokens != hp.pad_token
        attn_mask = valid[:, None, None, :]
        pad_mask = valid[..., None].to(torch.float32)
        x = nn.embedding(params['embedding'], tokens)
        x = x + self._position_table(x.device)[None, :L].to(x.dtype)
        if train:
            x = nn.dropout(x, hp.drop_rate, generator = generator)
        for i in range(hp.encoder_layers):
            x = self._fft_block(params['encoder']['layer_{}'.format(i)], x, mask = attn_mask,
                                pad_mask = pad_mask, train = train, generator = generator)
        if speaker_embedding is not None and 'speaker_projection' in params:
            spk = nn.dense(params['speaker_projection'], speaker_embedding)
            x = x + spk[:, None, :] * pad_mask.to(x.dtype)
        return x, attn_mask, pad_mask

    def decode(self, params, x, frame_mask, *, train = False, generator = None):
        """Frame-rate states (B, T, D) → mel (B, T, n_mel); T <= max_position."""
        hp = self.hp
        T = x.shape[1]
        attn_mask = frame_mask[:, None, None, :]
        pad_mask = frame_mask[..., None].to(torch.float32)
        x = x + self._position_table(x.device)[None, :T].to(x.dtype)
        if train:
            x = nn.dropout(x, hp.drop_rate, generator = generator)
        for i in range(hp.decoder_layers):
            x = self._fft_block(params['decoder']['layer_{}'.format(i)], x, mask = attn_mask,
                                pad_mask = pad_mask, train = train, generator = generator)
        return nn.dense(params['mel_linear'], x)

    def postnet(self, params, state, mel, *, frame_mask = None, train = False,
                generator = None):
        """The residual conv + batch-norm refiner → (mel + residual, new
        state): tanh between the convs, the frames past each row's length
        zeroed in the result.  In `train` mode the batch norms run on the
        batch's statistics over the valid frames and move the running ones,
        and dropout follows every conv."""
        hp = self.hp
        if not hp.use_postnet:
            return mel, state
        x = mel
        new_state = {}
        for i in range(hp.postnet_n_conv):
            name = 'conv_{}'.format(i)
            p, bn_state = params['postnet'][name], state['postnet'][name]['bn']
            x = nn.conv1d(p['conv'], x)
            if train:
                x, bn_state = nn.batch_norm_train(
                    p['bn'], bn_state, x, momentum = hp.postnet_momentum,
                    epsilon = hp.postnet_epsilon, mask = frame_mask)
            else:
                x = nn.batch_norm(p['bn'], bn_state, x, epsilon = hp.postnet_epsilon)
            new_state[name] = {'bn': bn_state}
            if i < hp.postnet_n_conv - 1:
                x = torch.tanh(x)
            if train:
                x = nn.dropout(x, hp.postnet_drop_rate, generator = generator)
        out = mel + x
        if frame_mask is not None:
            out = out * frame_mask[..., None].to(out.dtype)
        return out, {** state, 'postnet': new_state}

    # -- teacher forcing -------------------------------------------------------------

    def __call__(self, params, state, tokens, *, durations, pitch = None, energy = None,
                 speaker_embedding = None, max_frames = None, train = False,
                 generator = None):
        """The teacher-forced training pass: the ground-truth `durations`
        (B, L) drive the length regulator, the ground-truth `pitch` and
        `energy` (phoneme-level (B, L) or frame-level (B, T), per
        `variance_level`) are embedded, the predictors still predict.  In
        `train` mode dropout draws from `generator` and the postnet's batch
        norms run on the batch.  Returns ((mel, mel_postnet,
        log_duration_pred, pitch_pred, energy_pred, frame_mask,
        token_mask), new_state)."""
        hp = self.hp
        if max_frames is None:
            max_frames = hp.max_frames
        drop = dict(train = train, generator = generator)
        enc, _, pad_mask = self.encode(params, tokens, speaker_embedding = speaker_embedding,
                                       ** drop)
        log_d_pred = self._variance_predictor(params['duration_predictor'], enc,
                                              pad_mask = pad_mask, ** drop)
        pitch_pred = energy_pred = None
        if hp.variance_level == 'phoneme':
            enc, pitch_pred, energy_pred = self._apply_variances(
                params, enc, pad_mask = pad_mask, pitch_target = pitch,
                energy_target = energy, ** drop)
        x, frame_mask, _, _ = length_regulator(enc, durations, max_frames)
        if hp.variance_level == 'frame':
            fmask = frame_mask[..., None].to(torch.float32)
            x, pitch_pred, energy_pred = self._apply_variances(
                params, x, pad_mask = fmask, pitch_target = pitch, energy_target = energy,
                ** drop)
        mel = self.decode(params, x, frame_mask, ** drop)
        mel = mel * frame_mask[..., None].to(mel.dtype)
        mel_post, new_state = self.postnet(params, state, mel, frame_mask = frame_mask,
                                           ** drop)
        return (mel, mel_post, log_d_pred, pitch_pred, energy_pred, frame_mask,
                pad_mask[..., 0]), new_state

    # -- the forward --------------------------------------------------------------------

    def infer(self, params, state, tokens, *, speaker_embedding = None, max_frames = None,
              d_control = 1., p_control = 1., e_control = 1., min_duration = 0, dtype = None,
              ** _):
        """One parallel pass: the predicted durations, scaled by `d_control`,
        rounded half to even and floored at `min_duration` (pad tokens get
        0), drive the length regulator; `p_control` / `e_control` scale the
        predicted pitch and energy before they are binned.  Under `dtype`
        the params, state and speaker embedding are cast.

        Returns `FastSpeech2InferenceOutput`, field-compatible with
        `Tacotron2InferenceOutput`: `attention_weights` is the hard duration
        alignment (B, T, L) and `stop_tokens` is None."""
        hp = self.hp
        if max_frames is None:
            max_frames = hp.max_frames
        if dtype is not None:
            params = cast_tree(params, dtype)
            state = cast_tree(state, dtype) if state else state
            if speaker_embedding is not None:
                speaker_embedding = speaker_embedding.to(dtype)

        enc, _, pad_mask = self.encode(params, tokens, speaker_embedding = speaker_embedding)
        log_d = self._variance_predictor(params['duration_predictor'], enc, pad_mask = pad_mask)
        durations = torch.round(_scaled(torch.exp(log_d.float()) - 1., d_control))
        durations = torch.clamp(durations, min = float(min_duration)).to(torch.int32)
        durations = durations * (pad_mask[..., 0] > 0)

        pitch_pred = energy_pred = None
        if hp.variance_level == 'phoneme':
            enc, pitch_pred, energy_pred = self._apply_variances(
                params, enc, pad_mask = pad_mask, p_control = p_control, e_control = e_control)

        x, frame_mask, lengths, idx = length_regulator(enc, durations, max_frames)

        if hp.variance_level == 'frame':
            fmask = frame_mask[..., None].to(x.dtype)
            x, pitch_pred, energy_pred = self._apply_variances(
                params, x, pad_mask = fmask, p_control = p_control, e_control = e_control)

        mel = self.decode(params, x, frame_mask)
        mel = mel * frame_mask[..., None].to(mel.dtype)
        mel_post, _ = self.postnet(params, state, mel, frame_mask = frame_mask)

        # the hard alignment of the duration map, in the place of attention
        align = F.one_hot(idx.long(), tokens.shape[1]).to(torch.float32)
        align = align * frame_mask[..., None]
        return FastSpeech2InferenceOutput(
            mel = mel_post.float(), lengths = lengths, stop_tokens = None,
            attention_weights = align, decoder_output = mel.float(),
            durations = durations, pitch = pitch_pred, energy = energy_pred)
