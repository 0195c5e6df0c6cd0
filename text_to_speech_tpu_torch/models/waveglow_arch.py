"""WaveGlow flow vocoder over dictionaries of tensors.

Counterpart of ``text_to_speech_tpu/models/waveglow_arch.py``:
`upsample_mel`; the WN coupling block `wn_block` with its fused branches
(the `ops.wn_block` kernel, and the `ops.wn_block_int8` kernel on the
weights of `quantize_kernel_params`) and its per-layer chain, which runs
each layer in the `ops.wn_layer` kernel under ``use_pallas``; `infer` with
the int8 route's mixed-precision contract; and the training direction:
`forward` (with per-flow remat and the mixed-precision cast), `loss`, and
`wn_block_train`, the whole-block kernel forward with a recomputed backward
that ``wn_train_fused`` selects; and the XLA-level int8 path
(`quantize_params`, `_conv_int8`): the per-layer chain on int8 convs whose
products accumulate in int32 (`int8_conv1d` on `torch._int_mm`).
Parameters are the port's layouts (`weights.waveglow_from_jax`).  Each
flow's 1×1 invertible conv is a (c, c) ``weight`` with ``y = audio @ weight.T``.
"""

import functools

import torch
import torch.utils.checkpoint

from ..hparams import HParams
from ..nn import layers as nn
from ..ops.wn_block import fused_wn_block, pack_wn_weights
from ..ops.wn_block_int8 import fused_wn_block_int8, pack_wn_int8, quantize_wn_weights
from ..ops.wn_layer import fused_wn_layer
from ..weights import cast_tree, flatten_tree, unflatten_tree

HParamsWaveGlow = HParams(
    n_mel_channels = 80,
    n_flows = 12,
    n_group = 8,
    n_early_every = 4,
    n_early_size = 2,
    wn_layers = 8,
    wn_channels = 512,
    wn_kernel_size = 3,
    wn_fused = False,          # one cond conv per block (NVIDIA's layout); the
                               # blocks' params say which layout they hold
    use_pallas = False,        # the chain runs each layer in `ops.wn_layer`
    wn_train_conv = 'dilated', # read so a JAX config loads; the port runs nn.conv1d
    wn_train_fused = False,    # training forward on `ops.wn_block` (wn_block_train)
    upsample_width = 1024,
    upsample_stride = 256,
    sigma = 1.0,
)


class WaveGlow:
    """Stateless architecture: static hparams + pure apply functions."""

    def __init__(self, ** kwargs):
        self.hp = HParamsWaveGlow.extract(kwargs)
        hp = self.hp
        self.flow_channels = []
        n_remaining = hp.n_group
        for k in range(hp.n_flows):
            if k % hp.n_early_every == 0 and k > 0:
                n_remaining -= hp.n_early_size
            self.flow_channels.append(n_remaining)
        self.n_remaining_channels = n_remaining
        self.cond_channels = hp.n_mel_channels * hp.n_group

    # -- kernel weights --------------------------------------------------------

    def _stack_block(self, block):
        """One block's WN weights stacked per layer in the JAX package's
        layout (its `_pack_block`): ``w_cond (L, S, 2C)``, ``w_in (L, 3, C,
        2C)``, ``w_rs (L-1, C, 2C)``, ``w_rs_last (C, C)`` and the biases."""
        L = self.hp.wn_layers
        if 'cond_layer' in block:
            w = block['cond_layer']['weight'][..., 0].T            # (S, L*2C)
            w_cond = w.reshape(w.shape[0], L, -1).transpose(0, 1)
            b_cond = block['cond_layer']['bias'].reshape(L, -1)
        else:
            w_cond = torch.stack([block['cond_conv_{}'.format(i)]['weight'][..., 0].T
                                  for i in range(L)])
            b_cond = torch.stack([block['cond_conv_{}'.format(i)]['bias']
                                  for i in range(L)])
        # conv weight (2C, C, 3) → taps (3, C, 2C)
        w_in = torch.stack([block['in_conv_{}'.format(i)]['weight'].permute(2, 1, 0)
                            for i in range(L)])
        b_in = torch.stack([block['in_conv_{}'.format(i)]['bias'] for i in range(L)])
        w_rs = torch.stack([block['res_skip_conv_{}'.format(i)]['weight'][..., 0].T
                            for i in range(L - 1)])
        b_rs = torch.stack([block['res_skip_conv_{}'.format(i)]['bias']
                            for i in range(L - 1)])
        last = block['res_skip_conv_{}'.format(L - 1)]
        return {'w_cond': w_cond, 'b_cond': b_cond, 'w_in': w_in, 'b_in': b_in,
                'w_rs': w_rs, 'b_rs': b_rs, 'w_rs_last': last['weight'][..., 0].T,
                'b_rs_last': last['bias']}

    def _pack_block(self, block, dtype = torch.float32):
        """One block's WN weights → the `ops.wn_block` kernel layout."""
        return pack_wn_weights(** self._stack_block(block), dtype = dtype)

    def _check_kernel_envelope(self):
        if self.hp.wn_layers < 2 or self.hp.wn_kernel_size != 3:
            raise ValueError('the WN block kernels need wn_layers >= 2 and '
                             'wn_kernel_size == 3, got {} and {}'.format(
                                 self.hp.wn_layers, self.hp.wn_kernel_size))

    def _check_layer_kernel_envelope(self):
        if self.hp.wn_channels % 128 or self.hp.wn_kernel_size != 3:
            raise ValueError('the WN layer kernel needs wn_channels % 128 == 0 and '
                             'wn_kernel_size == 3, got {} and {}'.format(
                                 self.hp.wn_channels, self.hp.wn_kernel_size))

    def pack_kernel_params(self, params, dtype = torch.bfloat16):
        """Add each block's kernel-layout weights under ``'packed'``, in the
        kernel's buffer dtype: bf16 by default, as the JAX package's kernel
        takes 16-bit buffers for f32 callers (its `pack_pallas_params`);
        float32 selects the kernel's f32 instantiation.  Call once at load
        time."""
        self._check_kernel_envelope()
        packed_params = {}
        for name, value in params.items():
            if not name.startswith('flow_'):
                packed_params[name] = value
                continue
            block = dict(value['block'])
            block['packed'] = self._pack_block(block, dtype)
            packed_params[name] = {'convinv': value['convinv'], 'block': block}
        return packed_params

    def quantize_kernel_params(self, params):
        """Add each block's int8 weights for `ops.wn_block_int8` under
        ``'packed_q'`` (the JAX package's `quantize_pallas_params`):
        per-output-channel scales computed here once, from the float32
        weights; activations quantize per row inside the kernel.  Call once
        at load time, on float32 params."""
        self._check_kernel_envelope()
        out = {}
        for name, value in params.items():
            if not name.startswith('flow_'):
                out[name] = value
                continue
            block = dict(value['block'])
            block['packed_q'] = pack_wn_int8(quantize_wn_weights(self._stack_block(block)))
            out[name] = {'convinv': value['convinv'], 'block': block}
        return out

    def quantize_params(self, params):
        """The XLA-level int8 path of the JAX package (its `quantize_params`,
        EXPERIMENTAL there): every WN conv (``in_conv_*``, ``cond_*``,
        ``res_skip_conv_*``) becomes ``{'weight_q': (out, in, W) int8,
        'scale': (out,) float32, 'bias'}``, symmetric with per-output-channel
        scales, rounded half to even; activations quantize per tensor when
        the conv runs (`_conv_int8`).  `infer` then runs the per-layer chain
        on these convs (without ``use_kernel``)."""
        def quantize_conv(conv):
            w = conv['weight'].float()
            scale = torch.clamp(w.abs().amax(dim = (1, 2)) / 127., min = 1e-8)
            out = {'weight_q': torch.clamp(torch.round(w / scale[:, None, None]), -127, 127)
                   .to(torch.int8), 'scale': scale}
            if 'bias' in conv: out['bias'] = conv['bias']
            return out

        quantized = {}
        for name, value in params.items():
            if not name.startswith('flow_'):
                quantized[name] = value
                continue
            block = {key: quantize_conv(conv) if key.startswith(('in_conv', 'cond', 'res_skip'))
                     else conv for key, conv in value['block'].items()}
            quantized[name] = {'convinv': value['convinv'], 'block': block}
        return quantized

    @staticmethod
    def _conv_int8(q, x, *, dilation = 1):
        """A conv of `quantize_params` with dynamic per-tensor activation
        scale: ``y = (x_q ⊛ w_q) · (a_scale · w_scale) + bias``, the int8
        products accumulated in int32 (`int8_conv1d`), never in float32."""
        a_scale = torch.clamp(x.abs().max().float() / 127., min = 1e-8)
        x_q = torch.clamp(torch.round(x.float() / a_scale), -127, 127).to(torch.int8)
        y = int8_conv1d(x_q, q['weight_q'], dilation = dilation)
        y = y.float() * (a_scale * q['scale'])
        if 'bias' in q: y = y + q['bias']
        return y

    # -- WN coupling block -----------------------------------------------------

    def wn_block(self, block, audio_half, spect, fused = True):
        """WaveNet-like stack conditioned on the mel; returns (B, T, 2*n_half)
        [b | s].  With ``fused``, the layers run in the `ops.wn_block_int8`
        kernel when the block holds int8 weights (``'packed_q'``), else in
        the `ops.wn_block` kernel when it holds packed ones (``'packed'``);
        otherwise as the per-layer chain, whose layers run in the
        `ops.wn_layer` kernel under ``fused`` or ``hp.use_pallas`` wherever
        C % 128 == 0 and the convs have 3 taps (the JAX package's condition
        without its T % 512: the CUDA kernel takes any length)."""
        hp = self.hp
        n_ch = hp.wn_channels
        if fused and 'packed_q' in block:
            # int8 mixed precision: bf16 buffers unless the caller's dtype
            # is narrower, and f32 b / s back for the f32 audio stream
            buf_dtype = spect.dtype if spect.dtype.itemsize <= 2 else torch.bfloat16
            x = nn.conv1d(block['start'], audio_half.to(block['start']['weight'].dtype))
            skip_sum = fused_wn_block_int8(
                x.to(buf_dtype).contiguous(), spect.to(buf_dtype).contiguous(),
                block['packed_q'])
            return self._end_conv(block, skip_sum)
        if fused and 'packed' in block:
            return self._fused_block(block, block['packed'], audio_half, spect)

        # the XLA-level int8 path (`quantize_params`): every conv but the
        # start and end ones in int8 with int32 accumulation
        int8 = 'weight_q' in block.get('in_conv_0', {})
        layer_kernel = (fused or hp.use_pallas) and n_ch % 128 == 0 \
            and hp.wn_kernel_size == 3 and not int8
        conv = self._conv_int8 if int8 else nn.conv1d
        x = nn.conv1d(block['start'], audio_half)
        cond_all = None
        if 'cond_layer' in block:
            cond_all = conv(block['cond_layer'], spect)
        output = None
        for i in range(hp.wn_layers):
            if cond_all is not None:
                cond = cond_all[..., i * 2 * n_ch: (i + 1) * 2 * n_ch]
            else:
                cond = conv(block['cond_conv_{}'.format(i)], spect)
            in_conv = block['in_conv_{}'.format(i)]
            rs_conv = block['res_skip_conv_{}'.format(i)]
            last = i == hp.wn_layers - 1
            if int8:
                acts = self._conv_int8(in_conv, x, dilation = 2 ** i) + cond
                gated = torch.tanh(acts[..., :n_ch]) * torch.sigmoid(acts[..., n_ch:])
                res_skip = self._conv_int8(rs_conv, gated)
                if not last:
                    x = x + res_skip[..., :n_ch].to(x.dtype)
                    skip = res_skip[..., n_ch:]
                else:
                    skip = res_skip
            elif layer_kernel:
                # the in-conv bias folded into the conditioning, as the JAX
                # package does; conv weights (out, in, W) → taps (W, in, out)
                if 'bias' in in_conv: cond = cond + in_conv['bias']
                w_rs = rs_conv['weight'].permute(2, 1, 0).contiguous()
                b_rs = rs_conv['bias'] if 'bias' in rs_conv else \
                    torch.zeros(w_rs.shape[-1], dtype = x.dtype, device = x.device)
                x, skip = fused_wn_layer(
                    x.contiguous(), cond.contiguous(),
                    in_conv['weight'].permute(2, 1, 0).contiguous(),
                    torch.zeros(2 * n_ch, dtype = x.dtype, device = x.device),
                    w_rs, b_rs.contiguous(), dilation = 2 ** i, residual = not last)
            else:
                acts = nn.conv1d(in_conv, x, dilation = 2 ** i) + cond
                gated = torch.tanh(acts[..., :n_ch]) * torch.sigmoid(acts[..., n_ch:])
                res_skip = nn.conv1d(rs_conv, gated)
                if not last:
                    x = x + res_skip[..., :n_ch]
                    skip = res_skip[..., n_ch:]
                else:
                    skip = res_skip
            output = skip if output is None else output + skip
        return nn.conv1d(block['end'], output.to(block['end']['weight'].dtype))

    def _fused_block(self, block, packed, audio_half, spect):
        """A block on the `ops.wn_block` kernel: buffers in the packed
        weights' dtype (bf16 for f32 callers), f32 accumulation and skip
        sum, the caller's dtype returned.  CUDA tensors launch the kernel,
        which raises outside its envelope; CPU tensors take its plain
        version."""
        buf_dtype = packed['w_in_cond'].dtype
        x = nn.conv1d(block['start'], audio_half.to(block['start']['weight'].dtype))
        skip_sum = fused_wn_block(
            x.to(buf_dtype).contiguous(), spect.to(buf_dtype).contiguous(),
            packed['w_in_cond'], packed['b_in_cond'], packed['w_rs'], packed['b_rs'],
            packed['w_rs_last'], packed['b_rs_last'])
        return self._end_conv(block, skip_sum).to(spect.dtype)

    def wn_block_train(self, block, audio_half, spect):
        """The WN block with the `ops.wn_block` kernel forward and a backward
        recomputed through the per-layer chain (`wn_block(fused=False)`), as
        the JAX package's `wn_block_train` (a `jax.custom_vjp`): neither has
        a backward kernel.  The block is packed each call, in bf16 buffers
        unless the caller's dtype is narrower, as the weights change every
        step."""
        names = sorted(flatten_tree(block))
        leaves = [flatten_tree(block)[name] for name in names]
        return _WNBlockTrain.apply(self, tuple(names), audio_half, spect, * leaves)

    def wn_block_acts(self, block, audio_half, spect, spect_cf = None):
        """`wn_block(fused=False)` for ``remat='acts'``: the start conv, the
        conditioning convs and the end conv under autograd, the layer stack
        in `_WNStackActs`, which keeps each layer's input (the residual
        stream) and activations (in-conv + conditioning, before the gate)
        and recomputes only the gates in the backward.  The same ops in the
        same order as the chain, so the gradients are the chain's.  The
        1-tap conditioning convs read `spect_cf`, the channels-first copy of
        `spect` that `nn.conv1d` would make for each of them, so that
        autograd keeps one copy for all of them (`forward` passes one for
        every flow)."""
        hp = self.hp
        L = hp.wn_layers
        if spect_cf is None:
            spect_cf = _channels_first(spect)

        def cond_conv(p):
            if p['weight'].shape[2] != 1:
                return nn.conv1d(p, spect)
            return torch.nn.functional.conv1d(spect_cf, p['weight'], p.get('bias')).transpose(1, 2)

        x = nn.conv1d(block['start'], audio_half)
        if 'cond_layer' in block:
            cond_all = cond_conv(block['cond_layer'])
            width = cond_all.shape[-1] // L
            conds = [cond_all[..., i * width: (i + 1) * width] for i in range(L)]
        else:
            conds = [cond_conv(block['cond_conv_{}'.format(i)]) for i in range(L)]
        convs = [block['{}_{}'.format(kind, i)] for i in range(L)
                 for kind in ('in_conv', 'res_skip_conv')]
        leaves = [c.get(key) for c in convs for key in ('weight', 'bias')]
        output = _WNStackActs.apply(hp.wn_channels, x, * conds, * leaves)
        return nn.conv1d(block['end'], output.to(block['end']['weight'].dtype))

    @staticmethod
    def _end_conv(block, skip_sum):
        """The `end` conv of a fused block: operands in the buffer dtype,
        f32 accumulation, f32 result."""
        w_end = block['end']['weight'][..., 0].to(skip_sum.dtype)
        out = skip_sum.float() @ w_end.float().T
        if 'bias' in block['end']:
            out = out + block['end']['bias'].float()
        return out

    # -- mel conditioning ------------------------------------------------------

    def upsample_mel(self, params, mel):
        """mel (B, F, n_mel) → grouped conditioning (B, Lg, n_mel*n_group).

        Fast path: the stride-s, width-w conv-transpose as a causal
        (w/s)-tap conv over frames whose output channels enumerate the s
        within-frame phases, run as an im2col and one matmul, with the
        n_group interleave folded into the weight's column order."""
        hp = self.hp
        w, s, g = hp.upsample_width, hp.upsample_stride, hp.n_group
        n_mel = hp.n_mel_channels
        weight = params['upsample']['weight']                  # (in, out, w)
        if w % s == 0 and s % g == 0 and weight.shape[2] == w:
            taps = w // s
            kernel = weight.permute(2, 0, 1).flip(0)           # JAX (w, in, out)
            wk = kernel.reshape(taps, s // g, g, weight.shape[0], n_mel)
            wk = wk.flip(1).flip(2).permute(0, 3, 1, 4, 2)     # (j, cin, rr, m, gg)
            wk = wk.reshape(taps * weight.shape[0], s * n_mel)
            padded = torch.nn.functional.pad(mel, (0, 0, taps - 1, 0))
            windows = torch.cat(
                [padded[:, i: i + mel.shape[1]] for i in range(taps)], dim = -1)
            spect = windows @ wk
            if 'bias' in params['upsample']:
                spect = spect + params['upsample']['bias'].repeat_interleave(g) \
                    .repeat(s // g).to(spect.dtype)
            return spect.reshape(mel.shape[0], mel.shape[1] * (s // g), n_mel * g)
        spect = nn.conv1d_transpose(params['upsample'], mel, stride = s)
        time_cutoff = w - s
        spect = spect[:, :spect.shape[1] - time_cutoff, :]
        lg = spect.shape[1] // g
        spect = spect[:, : lg * g, :]
        spect = spect.reshape(spect.shape[0], lg, g, n_mel)
        return spect.transpose(2, 3).reshape(spect.shape[0], lg, -1)

    # -- inference (inverse flow) ----------------------------------------------

    def infer(self, params, mel, *, generator = None, sigma = None, z = None,
              deterministic = False, dtype = None, use_kernel = False):
        """mel (B, F, n_mel) → waveform (B, F*upsample_stride).

        `dtype` casts the parameters and the mel (the 1×1 inverses are
        computed in f32, then cast).  `use_kernel` runs each coupling block
        through a kernel (the JAX package's `use_pallas`): `ops.wn_block_int8`
        on params from `quantize_kernel_params`, else `ops.wn_block`, packing
        first if needed; a model of one layer a block runs its layers in
        `ops.wn_layer`.  The int8 route runs mixed precision: under a
        `dtype` its int8 weights and the 1×1 convs keep their types, and the
        audio stream, the noise and the inverses stay f32, as a bf16 stream
        through the inverse flows loses the waveform.  Noise comes from
        `generator` unless `z` (B, Lg, n_group) or `deterministic` (zeros)
        is given."""
        hp = self.hp
        if sigma is None: sigma = hp.sigma
        block0 = params['flow_0']['block']
        int8 = use_kernel and 'packed_q' in block0
        if dtype is not None:
            keep = ('packed', 'packed_q') + (('convinv',) if int8 else ())
            params = cast_tree(params, dtype, keep = keep)
            mel = mel.to(dtype)
        if use_kernel and 'packed' not in block0 and 'packed_q' not in block0:
            if hp.wn_layers > 1:
                params = self.pack_kernel_params(params)
            else:
                # one layer a block: the per-layer chain on `ops.wn_layer`,
                # as the JAX package packs for its block kernel only when
                # wn_layers > 1
                self._check_layer_kernel_envelope()

        spect = self.upsample_mel(params, mel)
        batch, lg = spect.shape[0], spect.shape[1]
        audio_dtype = torch.float32 if int8 else spect.dtype

        def noise(channels):
            shape = (batch, lg, channels)
            if deterministic:
                return torch.zeros(shape, dtype = audio_dtype, device = spect.device)
            return torch.randn(shape, generator = generator, dtype = audio_dtype,
                               device = spect.device)

        if z is not None:
            audio = sigma * z[:, :, :self.n_remaining_channels]
            z_rest = z[:, :, self.n_remaining_channels:]
        else:
            audio = sigma * noise(self.n_remaining_channels)
            z_rest = None

        for k in reversed(range(hp.n_flows)):
            flow = params['flow_{}'.format(k)]
            n_half = audio.shape[-1] // 2
            audio_0, audio_1 = audio[..., :n_half], audio[..., n_half:]
            wn_out = self.wn_block(flow['block'], audio_0, spect, fused = use_kernel)
            b, s = wn_out[..., :n_half], wn_out[..., n_half:]
            audio_1 = (audio_1 - b) * torch.exp(-s)
            audio = torch.cat([audio_0, audio_1], dim = -1)
            # forward: audio @ weight.T, so the inverse is audio @ inv(weight.T)
            w_inv = torch.linalg.inv(flow['convinv']['weight'].float().T)
            audio = audio @ w_inv.to(audio.dtype)
            if k % hp.n_early_every == 0 and k > 0:
                if z_rest is not None:
                    z_i = sigma * z_rest[..., :hp.n_early_size]
                    z_rest = z_rest[..., hp.n_early_size:]
                else:
                    z_i = sigma * noise(hp.n_early_size)
                audio = torch.cat([z_i, audio], dim = -1)
        return audio.reshape(batch, -1)

    # -- forward (training direction) ------------------------------------------

    def forward(self, params, mel, audio, *, remat = False, compute_dtype = None):
        """audio (B, T) + mel (B, F, n_mel) → (z, log_s_total, log_det_w_total)
        for the flow negative log-likelihood, z in the JAX package's order
        ([early outputs, first to last | the final audio]).

        ``remat=True`` checkpoints each flow (its activations are recomputed
        in the backward); ``remat='acts'`` runs each WN block's layers as
        `wn_block_acts`, which keeps each layer's activations and residual
        stream, the tensors the JAX package's 'acts' policy saves by name,
        and recomputes only the gates in the backward, never a conv.
        ``compute_dtype`` (e.g. bfloat16) is the mixed-precision path:
        params (except the 1×1 convs, whose slogdet stays float32) and the
        mel are cast, the WN blocks and the upsample
        run in that dtype, and the audio stream, the log-determinants and
        every log-likelihood sum stay float32.  Under ``hp.wn_train_fused``
        (with C % 128 == 0 and 3 taps) the blocks run `wn_block_train`."""
        hp = self.hp
        if compute_dtype is not None and compute_dtype != torch.float32:
            from ..train.precision import cast_floating
            params = cast_floating(params, compute_dtype, exempt = ('convinv',))
            mel = mel.to(compute_dtype)
        spect = self.upsample_mel(params, mel)
        batch, lg = spect.shape[0], spect.shape[1]
        audio = audio[:, : lg * hp.n_group].reshape(batch, lg, hp.n_group)

        fused_train = hp.wn_train_fused and hp.wn_channels % 128 == 0 \
            and hp.wn_kernel_size == 3
        if fused_train:
            wn_block = self.wn_block_train
        elif remat == 'acts':
            wn_block = functools.partial(self.wn_block_acts, spect_cf = _channels_first(spect))
        else:
            wn_block = functools.partial(self.wn_block, fused = False)

        def flow_step(audio, flow, spect):
            w = flow['convinv']['weight']
            audio = audio @ w.T
            logdet = torch.linalg.slogdet(w)[1]
            n_half = audio.shape[-1] // 2
            audio_0, audio_1 = audio[..., :n_half], audio[..., n_half:]
            # the block's operands in the compute dtype, b / s back in f32
            wn_out = wn_block(flow['block'], audio_0.to(spect.dtype), spect)
            b, s = wn_out[..., :n_half], wn_out[..., n_half:].float()
            audio_1 = torch.exp(s) * audio_1 + b.float()
            return torch.cat([audio_0, audio_1], dim = -1), s.sum(), logdet

        z_out = []
        log_s_total = log_det_total = 0.
        for k in range(hp.n_flows):
            if k % hp.n_early_every == 0 and k > 0:
                z_out.append(audio[..., :hp.n_early_size])
                audio = audio[..., hp.n_early_size:]
            flow = params['flow_{}'.format(k)]
            if remat and remat != 'acts':
                audio, log_s, logdet = torch.utils.checkpoint.checkpoint(
                    flow_step, audio, flow, spect, use_reentrant = False)
            else:
                audio, log_s, logdet = flow_step(audio, flow, spect)
            log_s_total = log_s_total + log_s
            log_det_total = log_det_total + batch * lg * logdet
        z_out.append(audio)
        return torch.cat(z_out, dim = -1), log_s_total, log_det_total

    def loss(self, params, mel, audio, sigma = None, *, remat = False,
             compute_dtype = None):
        """WaveGlow negative log-likelihood (per element)."""
        if sigma is None: sigma = self.hp.sigma
        z, log_s, log_det = self.forward(params, mel, audio, remat = remat,
                                         compute_dtype = compute_dtype)
        return (torch.sum(z * z) / (2 * sigma * sigma) - log_s - log_det) / z.numel()

    def get_config(self):
        return self.hp.get_config()


def _int_mm(a, b):
    """(M, K) int8 @ (K, N) int8 → (M, N) int32 through `torch._int_mm`,
    the operands zero-padded to its shape limits (M > 16, K and N multiples
    of 8), which leaves the sums exact."""
    m, k = a.shape
    n = b.shape[1]
    pad_m, pad_k, pad_n = max(17 - m, 0), -k % 8, -n % 8
    if pad_m or pad_k:
        a = torch.nn.functional.pad(a, (0, pad_k, 0, pad_m))
    if pad_k or pad_n:
        b = torch.nn.functional.pad(b, (0, pad_n, 0, pad_k))
    return torch._int_mm(a.contiguous(), b)[:m, :n]


def int8_conv1d(x_q, w_q, *, dilation = 1):
    """x_q (B, T, C) int8 ⊛ w_q (out, C, W) int8 with XLA's SAME padding →
    (B, T, out) int32: one int8 product a tap over the shifted input, the
    taps summed in int32."""
    batch, steps, channels = x_q.shape
    width = w_q.shape[2]
    left, right = nn._same_pads(width, dilation)
    padded = torch.nn.functional.pad(x_q, (0, 0, left, right))
    out = None
    for k in range(width):
        rows = padded[:, k * dilation: k * dilation + steps].reshape(-1, channels)
        # (C, out) column-major, as cuBLASLt takes the second operand
        y = _int_mm(rows, w_q[:, :, k].contiguous().t())
        out = y if out is None else out + y
    return out.reshape(batch, steps, -1)


def _channels_first(x):
    """(B, T, C) → the (B, C, T) copy that `nn.conv1d` convolves for a 1-tap
    conv (a transpose padded by nothing)."""
    return torch.nn.functional.pad(x.transpose(1, 2), nn._same_pads(1, 1, 1, x.shape[1]))


def _conv1d_grads(weight, bias, x, grad, dilation):
    """(grad x, grad weight, grad bias) of ``nn.conv1d({'weight', 'bias'}, x,
    dilation)`` under the output gradient `grad`, from its input: the
    convolution's own backward, which autograd would call, with no conv
    forward."""
    pads = nn._same_pads(weight.shape[2], dilation, 1, x.shape[1])
    h = torch.nn.functional.pad(x.transpose(1, 2), pads)
    g_h, g_w, g_b = torch.ops.aten.convolution_backward(
        grad.transpose(1, 2), h, weight, None if bias is None else [bias.shape[0]], [1], [0],
        [dilation], False, [0], 1, [True, True, bias is not None])
    return g_h[..., pads[0]: pads[0] + x.shape[1]].transpose(1, 2), g_w, g_b


class _WNStackActs(torch.autograd.Function):
    """The layers of a WN block (`WaveGlow.wn_block_acts`): the residual
    stream x and the conditioning of each layer in, the skip sum out.  The
    forward saves each layer's x and ``acts = in_conv(x) + cond`` (three
    channel widths a layer, what the JAX package's policy keeps as
    'wn_x' and 'wn_acts'); the backward recomputes the gate from `acts` and
    takes each conv's gradients from its saved input."""

    @staticmethod
    def forward(ctx, n_ch, x, * args):
        n_layers = len(args) // 5
        conds, leaves = args[:n_layers], args[n_layers:]
        saved, output = [], None
        for i in range(n_layers):
            w_in, b_in, w_rs, b_rs = leaves[4 * i: 4 * i + 4]
            acts = nn.conv1d({'weight': w_in, 'bias': b_in}, x, dilation = 2 ** i) + conds[i]
            gated = torch.tanh(acts[..., :n_ch]) * torch.sigmoid(acts[..., n_ch:])
            res_skip = nn.conv1d({'weight': w_rs, 'bias': b_rs}, gated)
            saved += [x, acts]
            if i < n_layers - 1:
                x = x + res_skip[..., :n_ch]
                skip = res_skip[..., n_ch:]
            else:
                skip = res_skip
            output = skip if output is None else output + skip
        ctx.n_ch, ctx.n_layers, ctx.biases = n_ch, n_layers, [
            b is not None for b in leaves[1::2]]
        ctx.save_for_backward(* saved, * [w for w in leaves if w is not None])
        return output

    @staticmethod
    def backward(ctx, grad):
        n_ch, n_layers = ctx.n_ch, ctx.n_layers
        saved = ctx.saved_tensors
        weights = iter(saved[2 * n_layers:])
        leaves = [next(weights) if k % 2 == 0 or ctx.biases[k // 2] else None
                  for k in range(4 * n_layers)]
        g_conds, g_leaves = [None] * n_layers, [None] * len(leaves)
        g_x = None
        for i in reversed(range(n_layers)):
            x, acts = saved[2 * i], saved[2 * i + 1]
            w_in, b_in, w_rs, b_rs = leaves[4 * i: 4 * i + 4]
            last = i == n_layers - 1
            g_rs = grad if last else torch.cat([g_x, grad], dim = -1)
            # the gate again, from the kept activations
            t, s = torch.tanh(acts[..., :n_ch]), torch.sigmoid(acts[..., n_ch:])
            g_gated, g_w_rs, g_b_rs = _conv1d_grads(w_rs, b_rs, t * s, g_rs, 1)
            g_acts = torch.cat([torch.ops.aten.tanh_backward(g_gated * s, t),
                                torch.ops.aten.sigmoid_backward(g_gated * t, s)], dim = -1)
            g_conds[i] = g_acts
            g_in, g_w_in, g_b_in = _conv1d_grads(w_in, b_in, x, g_acts, 2 ** i)
            g_x = g_in if last else g_x + g_in
            g_leaves[4 * i: 4 * i + 4] = [g_w_in, g_b_in, g_w_rs, g_b_rs]
        return (None, g_x, * g_conds, * g_leaves)


class _WNBlockTrain(torch.autograd.Function):
    """`WaveGlow.wn_block_train`: the block's leaves are flattened into the
    arguments (sorted `weights.flatten_tree` paths) so that autograd hands
    each its gradient."""

    @staticmethod
    def forward(ctx, arch, names, audio_half, spect, * leaves):
        ctx.arch, ctx.names = arch, names
        ctx.save_for_backward(audio_half, spect, * leaves)
        block = unflatten_tree(dict(zip(names, leaves)))
        buf_dtype = spect.dtype if spect.dtype.itemsize <= 2 else torch.bfloat16
        return arch._fused_block(block, arch._pack_block(block, buf_dtype),
                                 audio_half, spect)

    @staticmethod
    def backward(ctx, grad):
        wanted = ctx.needs_input_grad[2:]
        inputs = [t.detach().requires_grad_(w) for t, w in zip(ctx.saved_tensors, wanted)]
        with torch.enable_grad():
            block = unflatten_tree(dict(zip(ctx.names, inputs[2:])))
            out = ctx.arch.wn_block(block, inputs[0], inputs[1], fused = False)
            need = [t for t, w in zip(inputs, wanted) if w]
            grads = iter(torch.autograd.grad(out, need, grad, allow_unused = True))
        return (None, None) + tuple(next(grads) if w else None for w in wanted)
