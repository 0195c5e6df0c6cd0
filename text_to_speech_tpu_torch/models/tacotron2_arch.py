"""Tacotron-2 over dictionaries of tensors.

Counterpart of ``text_to_speech_tpu/models/tacotron2_arch.py``: `encode`
(`encode_train`, the JAX package's, also returns the moved batch-norm
state), `prenet`, location-sensitive attention (`process_memory`,
`attention_step`), `decoder_cell`, `init_cell_state`, `_project`,
`postnet`, the teacher-forced `__call__` (training: the prenet over the
whole target sequence, a Python loop of `decoder_cell` steps, the
projections after it, the r frames of a step unfolded to frame rate, batch
norms on the batch in train mode) and the autoregressive `infer` with the
gate stop and the sliding attention window.  Parameters are the port's
layouts (`weights.tacotron2_from_jax`).

Speaker conditioning (SV2TTS): with `speaker_embedding_dim`, a (B, spk)
embedding enters where `speaker_concat_pos` (any of 'start', 'end',
'prenet') says: 'start' projects ``[embedding | spk]`` back to the
embedding width before the convs, 'end' appends it to the encoder output
(the attention memory widens to ``encoder_output_dim``), 'prenet' appends
it to every step's prenet input.

`infer` is the JAX package's XLA while-loop decoder, run as a Python loop
of small library calls.  `infer_fused` runs the same decode on the fused
decoder-step kernel (`ops.decoder_kernel.decoder_steps`), 64 steps a launch,
optionally with int8 LSTM weights; `supports_fused_decoder` is its envelope.
There the prenet concat is folded into the kernel's per-row addend ``extra``.
`decode_chunk` runs a chunk of steps from an explicit carry for the serving
stepper (`runtimes.serving.make_tacotron_stepper`), on the plain loop or on
the kernel, one launch for each group of at most 8 rows.  The
teacher-forced loop runs no kernel of the port: the JAX package's is a
`lax.scan`, outside Pallas.
"""

import collections

import torch

from ..hparams import HParams
from ..nn import layers as nn
from ..ops.decoder_kernel import (
    MAX_ROWS, decoder_steps, init_decoder_state, pack_decoder_weights, quantize_lstm_weights)
from ..weights import cast_tree

Tacotron2InferenceOutput = collections.namedtuple(
    'Tacotron2InferenceOutput',
    ['mel', 'lengths', 'stop_tokens', 'attention_weights', 'decoder_output'],
)

HParamsTacotron2 = HParams(
    vocab_size = 148,
    pad_token = 0,
    n_mel_channels = 80,

    # encoder
    encoder_embedding_dim = 512,
    encoder_n_conv = 3,
    encoder_kernel_size = 5,
    encoder_drop_rate = 0.5,
    encoder_epsilon = 1e-5,
    encoder_momentum = 0.1,

    # speaker conditioning (SV2TTS)
    speaker_embedding_dim = None,
    speaker_concat_pos = 'end',        # subset of {'start', 'end', 'prenet'}

    # prenet
    prenet_sizes = (256, 256),
    prenet_use_bias = False,
    prenet_drop_rate = 0.5,
    prenet_deterministic = False,

    # location-sensitive attention
    lsa_attention_dim = 128,
    lsa_attention_filters = 32,
    lsa_attention_kernel_size = 31,

    # decoder
    attention_rnn_dim = 1024,
    decoder_n_lstm = 1,
    decoder_rnn_dim = 1024,
    scan_native_bf16 = True,
    n_frames_per_step = 1,
    with_logits = True,
    pred_stop_on_mel = False,
    max_decoder_steps = 1024,
    gate_threshold = 0.5,

    # postnet
    postnet_n_conv = 5,
    postnet_filters = 512,
    postnet_kernel_size = 5,
    postnet_drop_rate = 0.5,
    postnet_epsilon = 1e-5,
    postnet_momentum = 0.1,
)


class Tacotron2:
    """Stateless architecture object: static hyper-parameters; all apply
    methods are functions of (params, state, inputs)."""

    def __init__(self, ** kwargs):
        self.hp = HParamsTacotron2.extract(kwargs)
        hp = self.hp
        self.spk_dim = hp.speaker_embedding_dim
        self.concat_pos = ()
        if self.spk_dim:
            pos = hp.speaker_concat_pos
            self.concat_pos = (pos,) if isinstance(pos, str) else tuple(pos)
        self.encoder_output_dim = hp.encoder_embedding_dim + (
            self.spk_dim if 'end' in self.concat_pos else 0)
        self.prenet_in_dim = hp.n_mel_channels + (
            self.spk_dim if 'prenet' in self.concat_pos else 0)

    def get_config(self):
        return self.hp.get_config()

    # -- encoder ---------------------------------------------------------------

    def _speaker(self, speaker_embedding, shape):
        """The (B, spk) embedding broadcast over the leading axes `shape`."""
        if speaker_embedding is None:
            raise ValueError('this model is speaker-conditioned ({}): pass a speaker_embedding'
                             .format('/'.join(self.concat_pos)))
        spk = speaker_embedding.reshape((-1,) + (1,) * (len(shape) - 1) + (self.spk_dim,))
        return spk.expand(tuple(shape) + (self.spk_dim,))

    def encode(self, params, state, tokens, *, speaker_embedding = None):
        """tokens (B, S) → (encoder_output (B, S, D), mask (B, S)) on the
        running statistics."""
        x, mask, _ = self.encode_train(params, state, tokens,
                                       speaker_embedding = speaker_embedding, train = False)
        return x, mask

    def encode_train(self, params, state, tokens, *, speaker_embedding = None, train = True,
                     generator = None):
        """The JAX package's `encode`: tokens → (encoder_output, mask,
        new_state).  In `train` mode the convs' batch norms run on the batch's statistics
        over the valid tokens and move the running ones, and dropout draws
        from `generator`."""
        hp = self.hp
        enc, enc_state = params['encoder'], state['encoder']
        mask = tokens != hp.pad_token
        x = nn.embedding(enc['embedding'], tokens)
        if 'start' in self.concat_pos:
            spk = self._speaker(speaker_embedding, x.shape[:2]).to(x.dtype)
            x = nn.dense(enc['speaker_projection'], torch.cat([x, spk], dim = -1))
        new_state = {}
        for i in range(hp.encoder_n_conv):
            name = 'conv_{}'.format(i)
            x = nn.conv1d(enc[name]['conv'], x, padding = 'SAME')
            if train:
                x, bn_state = nn.batch_norm_train(
                    enc[name]['bn'], enc_state[name]['bn'], x, momentum = hp.encoder_momentum,
                    epsilon = hp.encoder_epsilon, mask = mask)
            else:
                x = nn.batch_norm(enc[name]['bn'], enc_state[name]['bn'], x,
                                  epsilon = hp.encoder_epsilon)
                bn_state = enc_state[name]['bn']
            x = torch.relu(x)
            if train:
                x = nn.dropout(x, hp.encoder_drop_rate, generator = generator)
            new_state[name] = {'bn': bn_state}
            x = torch.where(mask[..., None], x, torch.zeros_like(x))
        x = nn.bilstm(enc['bilstm'], x, mask = mask)
        if 'end' in self.concat_pos:
            spk = self._speaker(speaker_embedding, x.shape[:2]).to(x.dtype)
            x = torch.cat([x, spk], dim = -1)
            x = torch.where(mask[..., None], x, torch.zeros_like(x))
        return x, mask, {** state, 'encoder': new_state}

    # -- prenet ----------------------------------------------------------------

    def prenet(self, params, x, *, generator = None, deterministic = None,
               speaker_embedding = None):
        """Bottleneck with always-on dropout (intentional inference noise),
        drawn from `generator` unless `deterministic`."""
        hp = self.hp
        if deterministic is None: deterministic = hp.prenet_deterministic
        if 'prenet' in self.concat_pos and speaker_embedding is not None:
            x = torch.cat([x, self._speaker(speaker_embedding, x.shape[:-1]).to(x.dtype)],
                          dim = -1)
        for i in range(len(hp.prenet_sizes)):
            x = torch.relu(nn.dense(params['prenet']['layer_{}'.format(i)], x))
            if not deterministic:
                x = nn.dropout(x, hp.prenet_drop_rate, generator = generator)
        return x

    # -- attention -------------------------------------------------------------

    def process_memory(self, params, memory, mask):
        memory = torch.where(mask[..., None], memory, torch.zeros_like(memory))
        return memory, nn.dense(params['attention']['memory'], memory)

    def attention_step(self, params, query, memory, processed_memory,
                       prev_attn, cum_attn, mask):
        """Location-sensitive attention: content score + convolutional
        features over the [previous, cumulative] alignments."""
        att = params['attention']
        compute_dtype = memory.dtype
        native = compute_dtype == torch.bfloat16 and self.hp.scan_native_bf16
        processed_query = nn.dense(att['query'], query)[:, None, :]
        attn_cat = torch.stack([prev_attn, cum_attn], dim = -1).to(compute_dtype)
        loc = nn.dense(att['location_dense'],
                       nn.conv1d(att['location_conv'], attn_cat, padding = 'SAME'))
        energies = nn.dense(
            att['value'], torch.tanh(processed_query + processed_memory + loc))[..., 0]
        # large-negative (not -inf): a fully masked row softmaxes to uniform
        if not native:
            energies = energies.float()
        energies = torch.where(mask, energies, torch.full_like(energies, -1e9))
        weights = torch.softmax(energies, dim = -1)
        context = torch.einsum('bs,bsd->bd', weights.to(compute_dtype), memory)
        return context, weights

    # -- decoder cell ----------------------------------------------------------

    def decoder_cell(self, params, prenet_out, memory, processed_memory,
                     attn_mask, cell_state):
        """One decoder step.  cell_state = (attn_rnn, dec_rnns, context,
        (prev_attn, cum_attn))."""
        hp = self.hp
        attn_rnn_state, dec_rnn_states, context, (prev_attn, cum_attn) = cell_state

        x = torch.cat([prenet_out, context], dim = -1)
        attn_out, attn_rnn_state = nn.lstm_cell(params['attention_rnn'], x, attn_rnn_state)

        context, attn_weights = self.attention_step(
            params, attn_out, memory, processed_memory, prev_attn, cum_attn, attn_mask)
        cum_attn = cum_attn + attn_weights

        y = torch.cat([attn_out, context], dim = -1)
        new_rnn_states = []
        for i in range(hp.decoder_n_lstm):
            y, s = nn.lstm_cell(params['decoder_rnn']['cell_{}'.format(i)], y,
                                dec_rnn_states[i])
            new_rnn_states.append(s)

        cell_out = torch.cat([y, context], dim = -1)
        new_state = (attn_rnn_state, tuple(new_rnn_states), context,
                     (attn_weights, cum_attn))
        return cell_out, attn_weights, new_state

    def init_cell_state(self, batch, seq_len, dtype = torch.float32, device = None):
        hp = self.hp
        attn_dtype = dtype if (dtype == torch.bfloat16 and hp.scan_native_bf16) \
            else torch.float32
        zeros = lambda n, dt = dtype: torch.zeros((batch, n), dtype = dt, device = device)
        return (
            nn.lstm_init_carry(batch, hp.attention_rnn_dim, dtype, device),
            tuple(nn.lstm_init_carry(batch, hp.decoder_rnn_dim, dtype, device)
                  for _ in range(hp.decoder_n_lstm)),
            zeros(self.encoder_output_dim),
            (zeros(seq_len, attn_dtype), zeros(seq_len, attn_dtype)),
        )

    def _project(self, params, cell_out):
        hp = self.hp
        frame = nn.dense(params['linear_projection'], cell_out)
        gate_in = torch.cat([cell_out, frame], dim = -1) if hp.pred_stop_on_mel else cell_out
        gate = nn.dense(params['gate_layer'], gate_in)
        if hp.with_logits: gate = torch.sigmoid(gate)
        return frame, gate

    # -- postnet ---------------------------------------------------------------

    def postnet(self, params, state, x, *, mask = None, train = False, generator = None):
        """The postnet → (residual, new_state).  With `mask`, padded frames
        are zeroed between layers, so that a padded batch matches unpadded
        runs.  In `train` mode the batch norms run on the batch's
        statistics over the masked frames and dropout follows every layer."""
        hp = self.hp
        post, post_state = params['postnet'], state['postnet']
        new_state = {}
        for i in range(hp.postnet_n_conv):
            name = 'conv_{}'.format(i)
            x = nn.conv1d(post[name]['conv'], x, padding = 'SAME')
            if train:
                x, bn_state = nn.batch_norm_train(
                    post[name]['bn'], post_state[name]['bn'], x, momentum = hp.postnet_momentum,
                    epsilon = hp.postnet_epsilon, mask = mask)
            else:
                x = nn.batch_norm(post[name]['bn'], post_state[name]['bn'], x,
                                  epsilon = hp.postnet_epsilon)
                bn_state = post_state[name]['bn']
            if i < hp.postnet_n_conv - 1:
                x = torch.tanh(x)
            if train:
                x = nn.dropout(x, hp.postnet_drop_rate, generator = generator)
            if mask is not None:
                x = torch.where(mask[..., None], x, torch.zeros_like(x))
            new_state[name] = {'bn': bn_state}
        return x, {** state, 'postnet': new_state}

    # -- chunked decoding (continuous-batching serving) --------------------------

    def decode_chunk(self, params, frame, cell_state, memory, processed_memory, enc_mask, *,
                     n_steps, generator = None, deterministic = None,
                     speaker_embedding = None, step_offset = 0, weights = None, seed = None):
        """Decode ``n_steps`` autoregressive steps from an explicit carry: the
        serving engine calls this once per chunk and may admit new requests
        into free batch rows between calls.

        Without `weights` (the plain route) the steps are a loop of
        `prenet` / `decoder_cell` / `_project`, the prenet's dropout drawn
        from `generator`.  With `weights` (the decoder packed for the fused
        kernel, `ops.decoder_kernel.pack_decoder_weights`) the chunk runs on
        `decoder_steps`: one launch of ``n_steps`` steps for each group of at
        most 8 rows, each on its own contiguous slice of the state (rows do
        not interact, so this is exact); the cell-state tuple maps to the
        kernel's state dict and back.  The dropout is then the kernel's own,
        keyed by `seed` ((1,) int64, zero when None; each row group adds its
        index) at the absolute step ``step_offset + t``, so a caller passes a
        monotonically advancing `step_offset` and no row re-draws a mask of
        an earlier chunk.  The 'prenet' speaker concat enters as the kernel's
        addend (`prenet_addend`).  Outside `supports_fused_decoder` that
        route raises; on CUDA tensors a failed build or launch raises too.

        Returns (frames (B, K, n_mel * r), gates (B, K) after the sigmoid,
        the group's last subframe, (frame, cell_state))."""
        hp = self.hp
        if deterministic is None: deterministic = hp.prenet_deterministic
        if weights is not None:
            return self._decode_chunk_fused(
                params, frame, cell_state, memory, processed_memory, enc_mask,
                n_steps = n_steps, deterministic = deterministic,
                speaker_embedding = speaker_embedding, step_offset = step_offset,
                weights = weights, seed = seed)
        frames, gates = [], []
        for _ in range(n_steps):
            pre = self.prenet(params['decoder'], frame[:, -hp.n_mel_channels:],
                              generator = generator, deterministic = deterministic,
                              speaker_embedding = speaker_embedding)
            cell_out, _, cell_state = self.decoder_cell(
                params['decoder'], pre, memory, processed_memory, enc_mask, cell_state)
            frame, gate = self._project(params['decoder'], cell_out)
            frames.append(frame)
            gates.append(gate[..., -1])
        return torch.stack(frames, dim = 1), torch.stack(gates, dim = 1), (frame, cell_state)

    def _decode_chunk_fused(self, params, frame, cell_state, memory, pm, enc_mask, *,
                            n_steps, deterministic, speaker_embedding, step_offset, weights,
                            seed):
        hp = self.hp
        B, S = enc_mask.shape
        if not self.supports_fused_decoder(min(B, MAX_ROWS), S):
            raise ValueError('the fused decoder does not support this configuration or '
                             'shape ({} tokens)'.format(S))
        device, dt = memory.device, memory.dtype
        (h_att, c_att), ((h_dec, c_dec),), ctx, (prev, cum) = cell_state
        copy = lambda t, dtype: t.to(dtype).clone(memory_format = torch.contiguous_format)
        f32 = torch.float32
        # a copy: the kernel updates its state in place, the carry stays the caller's
        state = dict(frame = copy(frame, f32), h_att = copy(h_att, dt), c_att = copy(c_att, f32),
                     h_dec = copy(h_dec, dt), c_dec = copy(c_dec, f32), ctx = copy(ctx, dt),
                     prev = copy(prev, f32), cum = copy(cum, f32),
                     main = torch.argmax(prev, dim = 1).to(torch.int32))
        memory, pm = memory.contiguous(), pm.contiguous()
        mask = enc_mask.float()
        enc_len = enc_mask.sum(dim = 1).to(torch.int32)
        extra = self.prenet_addend(params, speaker_embedding, B, device)
        if seed is None:
            seed = torch.zeros((1,), dtype = torch.int64, device = device)
        steps = []
        for g, lo in enumerate(range(0, B, MAX_ROWS)):
            rows = slice(lo, min(B, lo + MAX_ROWS))
            out, _, _ = decoder_steps(
                weights, memory[rows], pm[rows], mask[rows], enc_len[rows], extra[rows],
                {k: v[rows] for k, v in state.items()}, seed + g if g else seed,
                n_steps = n_steps, step0 = int(step_offset),
                deterministic = bool(deterministic), drop_rate = float(hp.prenet_drop_rate))
            steps.append(out)
        steps = torch.cat(steps, dim = 1).transpose(0, 1)              # (B, K, n_mel + 1)
        n_mel = hp.n_mel_channels
        cell_state = ((state['h_att'], state['c_att']), ((state['h_dec'], state['c_dec']),),
                      state['ctx'], (state['prev'], state['cum']))
        return steps[..., :n_mel], steps[..., n_mel], (state['frame'], cell_state)

    # -- teacher-forced forward (training) ----------------------------------------

    def __call__(self, params, state, tokens, mel_input, *, mel_lengths = None,
                 speaker_embedding = None, train = False, generator = None):
        """The teacher-forced forward.  tokens (B, S) int; mel_input (B, T,
        n_mel), the previous frames (group rate with a reduction factor r:
        each step emits r frames).  The decoder mask is ``t < mel_lengths``,
        or the non-zero frames without lengths.  The prenet runs over the
        whole sequence and drops in train mode whatever
        `prenet_deterministic` says; the cell loop is `decoder_cell`; the
        projections run after the loop over the whole sequence.  Returns
        ((decoder_output (B, T r, n_mel), mel_postnet, gates (B, T r)),
        new_state)."""
        hp = self.hp
        encoder_output, enc_mask, state = self.encode_train(
            params, state, tokens, speaker_embedding = speaker_embedding, train = train,
            generator = generator)
        memory, processed_memory = self.process_memory(
            params['decoder'], encoder_output, enc_mask)

        steps = mel_input.shape[1]
        if mel_lengths is not None:
            dec_mask = torch.arange(steps, device = mel_input.device)[None, :] \
                < mel_lengths.to(mel_input.device)[:, None]
        else:
            dec_mask = torch.any(mel_input != 0., dim = -1)

        prenet_out = self.prenet(params['decoder'], mel_input, generator = generator,
                                 speaker_embedding = speaker_embedding,
                                 deterministic = hp.prenet_deterministic and not train)
        cell_state = self.init_cell_state(tokens.shape[0], tokens.shape[1], mel_input.dtype,
                                          mel_input.device)
        cell_outputs = []
        for t in range(steps):
            cell_out, _, cell_state = self.decoder_cell(
                params['decoder'], prenet_out[:, t], memory, processed_memory, enc_mask,
                cell_state)
            cell_outputs.append(cell_out)
        cell_outputs = torch.stack(cell_outputs, dim = 1)

        frames, gates = self._project(params['decoder'], cell_outputs)
        frames = torch.where(dec_mask[..., None], frames, torch.zeros_like(frames))
        r = hp.n_frames_per_step
        if r == 1:
            gates = gates[..., 0]
            out_mask = dec_mask
        else:
            # each step emitted r frames: unfold to frame rate for the postnet
            gates = gates.reshape(gates.shape[0], -1)
            frames = frames.reshape(frames.shape[0], -1, hp.n_mel_channels)
            out_mask = torch.repeat_interleave(dec_mask, r, dim = 1)
        postnet_out, state = self.postnet(params, state, frames, mask = out_mask, train = train,
                                          generator = generator)
        return (frames, frames + postnet_out, gates), state

    # -- autoregressive inference -----------------------------------------------

    def infer(self, params, state, tokens, *,
              speaker_embedding = None,
              generator = None,
              max_length = None,
              early_stopping = True,
              attn_mask_win_len = None,
              attn_mask_offset = 0.5,
              deterministic = None,
              dtype = None):
        """Generate mel frames autoregressively into buffers of
        ``max_length`` frames; stop when every row's gate has fired (with
        `early_stopping`).  With ``attn_mask_win_len``, attention is
        restricted to a window around the previous argmax alignment.
        ``dtype`` runs the matmuls in that type; alignments and the stop
        gate stay f32 and the outputs return f32.  `speaker_embedding`
        (B, spk): the speaker of each row, for a speaker-conditioned model.
        Returns `Tacotron2InferenceOutput`."""
        hp = self.hp
        r = hp.n_frames_per_step
        if max_length is None:
            max_length = hp.max_decoder_steps * r
        max_length = -(-int(max_length) // r)

        compute_dtype = dtype or torch.float32
        if dtype is not None:
            params = cast_tree(params, dtype)
            state = cast_tree(state, dtype)
            if speaker_embedding is not None:
                speaker_embedding = speaker_embedding.to(dtype)

        device = tokens.device
        batch, seq_len = tokens.shape
        encoder_output, enc_mask = self.encode(params, state, tokens,
                                               speaker_embedding = speaker_embedding)
        memory, processed_memory = self.process_memory(
            params['decoder'], encoder_output, enc_mask)
        encoder_lengths = enc_mask.sum(dim = 1)

        use_window = attn_mask_win_len is not None
        if use_window:
            win_len = int(attn_mask_win_len)
            offset = int(attn_mask_win_len * attn_mask_offset) \
                if isinstance(attn_mask_offset, float) else int(attn_mask_offset)
            positions = torch.arange(seq_len, device = device)[None, :]

        n_mel = hp.n_mel_channels * r
        frame = torch.zeros((batch, n_mel), dtype = compute_dtype, device = device)
        outputs = torch.zeros((batch, max_length, n_mel), dtype = compute_dtype,
                              device = device)
        stop_tokens = torch.zeros((batch, max_length, r), device = device)
        attention_weights = torch.zeros((batch, max_length, seq_len), device = device)
        lengths = torch.zeros((batch,), dtype = torch.int32, device = device)
        finished = torch.zeros((batch,), dtype = torch.bool, device = device)
        main_attention = torch.zeros((batch,), dtype = torch.long, device = device)
        cell_state = self.init_cell_state(batch, seq_len, compute_dtype, device)

        for t in range(max_length):
            if early_stopping and bool(finished.all()):
                break
            if use_window:
                center = torch.clamp(main_attention, min = offset)
                center = torch.minimum(center, encoder_lengths - win_len + offset)
                lo = (center - offset)[:, None]
                attn_mask = (positions >= lo) & (positions <= lo + win_len) & enc_mask
            else:
                attn_mask = enc_mask
            prenet_out = self.prenet(params['decoder'], frame[:, -hp.n_mel_channels:],
                                     generator = generator, deterministic = deterministic,
                                     speaker_embedding = speaker_embedding)
            cell_out, attn_weights, cell_state = self.decoder_cell(
                params['decoder'], prenet_out, memory, processed_memory,
                attn_mask, cell_state)
            frame, gate = self._project(params['decoder'], cell_out)

            finished = finished | (gate[:, -1] > hp.gate_threshold)
            lengths = lengths + (~finished).to(torch.int32)
            outputs[:, t] = frame
            stop_tokens[:, t] = gate.float()
            attention_weights[:, t] = attn_weights.float()
            main_attention = torch.argmax(attn_weights, dim = 1)

        if r > 1:
            outputs = outputs.reshape(batch, -1, hp.n_mel_channels)
            stop_tokens = stop_tokens.reshape(batch, -1)
        else:
            stop_tokens = stop_tokens[..., 0]

        postnet_out, _ = self.postnet(params, state, outputs)
        return Tacotron2InferenceOutput(
            mel = (outputs + postnet_out).float(),
            lengths = lengths * r,
            stop_tokens = stop_tokens,
            attention_weights = attention_weights,
            decoder_output = outputs.float(),
        )

    def supports_fused_decoder(self, batch, seq_len):
        """The envelope of the fused decoder, the JAX package's: the prenet →
        attention LSTM → LSA → decoder LSTM → projection topology, the gate
        from the cell output, at most 8 rows, tokens a multiple of 8.  The
        CUDA kernel's own alignment limits are not part of it: a model inside
        this envelope that breaks them raises in `decoder_steps`."""
        hp = self.hp
        return (batch <= MAX_ROWS and seq_len % 8 == 0
                and hp.decoder_n_lstm == 1
                and hp.n_frames_per_step == 1
                and not hp.pred_stop_on_mel
                and hp.with_logits
                and len(hp.prenet_sizes) == 2
                and hp.attention_rnn_dim == hp.decoder_rnn_dim
                and hp.lsa_attention_kernel_size == 31)

    def prenet_addend(self, params, speaker_embedding, batch, device):
        """The fused decoder's per-row addend ``extra`` (B, P0), float32: the
        'prenet' speaker concat folded out of the first prenet layer,
        ``spk @ in0[n_mel:]`` (in0 its (in, out) kernel), from the values in
        their compute dtype; zeros without it."""
        if 'prenet' in self.concat_pos and speaker_embedding is not None:
            in0 = params['decoder']['prenet']['layer_0']['weight'][:, self.hp.n_mel_channels:]
            return (speaker_embedding.float() @ in0.float().T).expand(
                batch, in0.shape[0]).contiguous()
        return torch.zeros((batch, self.hp.prenet_sizes[0]), device = device)

    def infer_fused(self, params, state, tokens, *,
                    speaker_embedding = None,
                    generator = None,
                    max_length = None,
                    early_stopping = True,
                    attn_mask_win_len = None,
                    attn_mask_offset = 0.5,
                    deterministic = None,
                    dtype = None,
                    chunk = 64,
                    int8_lstm = False,
                    weights = None):
        """`infer` on the fused decoder-step kernel: a host loop of
        ``ceil(max_length / chunk)`` launches of `chunk` steps each, the
        decode state carried from launch to launch in device buffers.  With
        `early_stopping` the host reads ``finished.all()`` once per launch
        (one synchronisation per `chunk` steps instead of one per step), so
        a decode may overshoot its stop to the launch's end; `lengths` does
        not.  Same contract as `infer`; prenet dropout draws from the
        kernel's own generator, keyed by one seed taken from `generator`.
        `weights`: the decoder already packed (`pack_decoder_weights`) in
        the compute dtype, to skip the packing.  ``int8_lstm=True`` runs the
        two LSTM products on int8 weights with per-column scales and per-row
        activation quantization (`ops.decoder_kernel.quantize_lstm_weights`),
        quantizing `weights` unless they already are.  The 'prenet' speaker
        concat enters the kernel as its per-row addend ``extra``:
        ``layer_0([mel | spk]) = layer_0_mel(mel) + spk @ in0[n_mel:]``, in
        float32 (from the compute-dtype values, as the JAX package folds it)."""
        hp = self.hp
        if deterministic is None: deterministic = hp.prenet_deterministic
        if max_length is None: max_length = hp.max_decoder_steps
        max_length = int(max_length)
        n_chunks = -(-max_length // chunk)

        batch, seq_len = tokens.shape
        if not self.supports_fused_decoder(batch, seq_len):
            raise ValueError('the fused decoder does not support this configuration or '
                             'shape (batch {}, {} tokens)'.format(batch, seq_len))

        compute_dtype = dtype or torch.float32
        if dtype is not None:
            params = cast_tree(params, dtype)
            state = cast_tree(state, dtype)
            if speaker_embedding is not None:
                speaker_embedding = speaker_embedding.to(dtype)

        device = tokens.device
        encoder_output, enc_mask = self.encode(params, state, tokens,
                                               speaker_embedding = speaker_embedding)
        memory, pm = self.process_memory(params['decoder'], encoder_output, enc_mask)
        n_mel = hp.n_mel_channels
        if weights is None:
            weights = pack_decoder_weights(params['decoder'], n_mel = n_mel,
                                           dtype = compute_dtype)
        if int8_lstm and 's_att_w' not in weights:
            weights = quantize_lstm_weights(weights)
        mask = enc_mask.float()
        enc_len = enc_mask.sum(dim = 1).to(torch.int32)
        extra = self.prenet_addend(params, speaker_embedding, batch, device)

        use_window = attn_mask_win_len is not None
        win_len = int(attn_mask_win_len) if use_window else 0
        offset = 0
        if use_window:
            offset = int(attn_mask_win_len * attn_mask_offset) \
                if isinstance(attn_mask_offset, float) else int(attn_mask_offset)

        if deterministic:
            seed = torch.zeros((1,), dtype = torch.int64, device = device)
        else:
            seed = torch.randint(
                0, 2 ** 62, (1,), generator = generator, dtype = torch.int64,
                device = generator.device if generator is not None else device).to(device)

        st = init_decoder_state(batch, seq_len, memory.shape[-1], hp.attention_rnn_dim,
                                n_mel, compute_dtype, device)
        finished = torch.zeros((batch,), dtype = torch.bool, device = device)
        lengths = torch.zeros((batch,), dtype = torch.int32, device = device)
        all_steps, all_attn = [], []
        for c in range(n_chunks):
            steps, attn, st = decoder_steps(
                weights, memory.contiguous(), pm.contiguous(), mask, enc_len, extra, st,
                seed, n_steps = chunk, step0 = c * chunk,
                deterministic = bool(deterministic), use_window = use_window,
                win_len = win_len, win_offset = offset,
                drop_rate = float(hp.prenet_drop_rate))
            gates = steps[:, :, n_mel] > hp.gate_threshold
            fin_k = finished[None, :] | (torch.cumsum(gates, dim = 0) > 0)
            lengths = lengths + (~fin_k).sum(dim = 0).to(torch.int32)
            finished = fin_k[-1]
            all_steps.append(steps)
            all_attn.append(attn)
            if early_stopping and bool(finished.all()):
                break

        # launches that early stopping skipped leave their frames at zero
        steps = torch.cat(all_steps).transpose(0, 1)
        attention_weights = torch.cat(all_attn).transpose(0, 1)
        missing = max_length - steps.shape[1]
        if missing > 0:
            steps = torch.nn.functional.pad(steps, (0, 0, 0, missing))
            attention_weights = torch.nn.functional.pad(attention_weights, (0, 0, 0, missing))
        steps, attention_weights = steps[:, :max_length], attention_weights[:, :max_length]
        outputs = steps[..., :n_mel].contiguous()

        postnet_out, _ = self.postnet(params, state, outputs.to(compute_dtype))
        return Tacotron2InferenceOutput(
            mel = outputs + postnet_out.float(),
            # a row that never gates counts every step of every launch: cap
            # at max_length, as `infer` and the sliced buffers do
            lengths = torch.clamp(lengths, max = max_length),
            stop_tokens = steps[..., n_mel],
            attention_weights = attention_weights.contiguous(),
            decoder_output = outputs,
        )
