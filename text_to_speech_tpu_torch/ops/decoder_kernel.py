"""K fused Tacotron-2 decoder steps: CUDA kernel wrapper and plain version.

Replaces the TPU kernel `decoder_steps`
(``text_to_speech_tpu/ops/decoder_kernel.py``).  The kernel is
``csrc/decoder_steps.cu`` (see its header for the design and its bound).

`decoder_steps` launches the kernel for CUDA tensors and counts its calls in
``decoder_steps.launches``.  For CPU tensors it computes
`decoder_steps_plain`, the same steps in plain PyTorch; any other device
raises.  On CUDA tensors it never falls back: outside the kernel's envelope
it raises.

Weights come from `pack_decoder_weights` under the JAX package's names, in
their logical shapes.  What the TPU layout needed is not carried over: there
is no 8-row padding (the state has B rows), no 128-lane padding of the frame
(``w0 (n_mel, P)``, ``proj_w (U + D, n_mel + 1)``), and ``loc_w`` is the plain
fold of the location conv with ``location_dense``, ``(2 * 31, A)`` with row
``c * 31 + k`` for channel c (previous, cumulative) and tap k.

Numerical contract (the TPU kernel's): products accumulate in float32;
``h_att``, ``h_dec``, ``ctx`` and the prenet activations round to the
compute dtype (float32 or bfloat16); ``c``, ``frame`` and the alignments stay
float32; the location conv reads the alignments in the compute dtype; the
context multiplies in the compute dtype and sums in float32.

int8 LSTM mode (`quantize_lstm_weights`, the TPU kernel's ``int8_lstm``):
``att_w`` and ``dec_w`` are int8 with per-output-column float32 scales
``s_att_w`` / ``s_dec_w``, quantized from the packed weights in the compute
dtype; every step quantizes each LSTM input row ``[x | ctx | h]`` on its own
(``scale = max(amax, 1e-8) * (1 / 127.)``, ties to even), and ``z =
float(int32 product) * row scale * column scale + bias``.  `decoder_steps`
takes that mode when ``att_w`` is int8, as the JAX wrapper does.

Prenet dropout is a counter-based generator: a value is kept iff word 0 of
``philox4x32-10(key = seed, counter = (absolute step, row, unit, layer))``
is ``>= round(rate * 2**32)``, and survivors scale by ``1 / (1 - rate)``.
Kernel and plain version compute the same bits, so they agree with dropout
on; the mask does not depend on how the steps are split into launches.
"""

import ctypes

import torch
import torch.nn.functional as F

from ._build import load_library

LOC_KERNEL = 31                 # location conv taps
LOC_PAD = LOC_KERNEL // 2
MAX_ROWS = 8                    # batch rows of one launch
SLAB_UNITS = 8                  # LSTM units per weight slab of the kernel

_STATE_KEYS = ('frame', 'h_att', 'c_att', 'h_dec', 'c_dec', 'ctx', 'prev', 'cum', 'main')


def pack_decoder_weights(dec, *, n_mel = 80, dtype = torch.float32):
    """The port's ``params['decoder']`` → the fused decoder's weights.

    Returns (matrices in `dtype`, biases and ``v_w`` float32):
      w0 (n_mel, P0), b0 (P0,), w1 (P0, P1), b1 (P1,): the prenet;
      att_w (P1 + D + U, 4U) = [Wx; Wh] so that ``[x | ctx | h] @ att_w`` is
        one product, att_b (4U,); gate columns ordered i, f, g, o;
      q_w (U, A); loc_w (62, A): location_conv folded with location_dense;
      v_w (A,);
      dec_w (2U + D, 4U), dec_b (4U,): the same stacking for the decoder LSTM;
      proj_w (U + D, n_mel + 1): linear_projection and gate_layer side by
        side, proj_b (n_mel + 1,).
    """
    f32 = lambda t: t.float()
    p0, p1 = dec['prenet']['layer_0'], dec['prenet']['layer_1']
    w0 = f32(p0['weight']).T[:n_mel]                                # (n_mel, P0)
    w1 = f32(p1['weight']).T
    zeros = lambda n: torch.zeros((n,), dtype = torch.float32, device = w0.device)
    b0 = f32(p0['bias']) if 'bias' in p0 else zeros(w0.shape[1])
    b1 = f32(p1['bias']) if 'bias' in p1 else zeros(w1.shape[1])

    att = dec['attention']
    # conv weight (F, 2, 31) and dense weight (A, F) → (2, 31, A) → (62, A)
    loc_w = torch.einsum('fck,af->cka', f32(att['location_conv']['weight']),
                         f32(att['location_dense']['weight']))
    loc_w = loc_w.reshape(2 * loc_w.shape[1], -1)

    a_rnn, d_rnn = dec['attention_rnn'], dec['decoder_rnn']['cell_0']
    stack = lambda rnn: torch.cat([rnn['weight_ih'].T, rnn['weight_hh'].T], dim = 0)
    proj, gate = dec['linear_projection'], dec['gate_layer']
    proj_w = torch.cat([f32(proj['weight']).T, f32(gate['weight']).T], dim = 1)
    proj_b = torch.cat([f32(proj['bias']), f32(gate['bias'])])

    as_dt = lambda t: t.to(dtype).contiguous()
    return {
        'w0': as_dt(w0), 'b0': b0.contiguous(),
        'w1': as_dt(w1), 'b1': b1.contiguous(),
        'att_w': as_dt(stack(a_rnn)), 'att_b': f32(a_rnn['bias']).contiguous(),
        'q_w': as_dt(att['query']['weight'].T),
        'loc_w': as_dt(loc_w), 'v_w': f32(att['value']['weight'])[0].contiguous(),
        'dec_w': as_dt(stack(d_rnn)), 'dec_b': f32(d_rnn['bias']).contiguous(),
        'proj_w': as_dt(proj_w), 'proj_b': proj_b.contiguous(),
    }


def quantize_lstm_weights(weights):
    """int8 copies of the two LSTM weights of a packed decoder (a copy of
    the JAX package's `quantize_lstm_weights`): symmetric, one float32 scale
    per output column, under ``s_att_w`` / ``s_dec_w``; the other weights
    stay as they are.  Kernel layouts made from `weights` are not carried
    over."""
    out = {k: v for k, v in weights.items() if k != '_kernel'}
    for key in ('att_w', 'dec_w'):
        w = weights[key].float()
        # a true division on every device (a card multiplies by 1 / 127 for `/ 127.`)
        scale = torch.clamp(w.abs().amax(dim = 0), min = 1e-8) / w.new_tensor(127.)
        out[key] = torch.clamp(torch.round(w / scale), -127., 127.).to(torch.int8)
        out['s_' + key] = scale
    return out


def _row_quant8(x):
    """Per-row symmetric int8 (as float values) and the row scales (B, 1)."""
    scale = torch.clamp(x.abs().amax(dim = -1, keepdim = True), min = 1e-8) * (1. / 127.)
    return torch.clamp(torch.round(x / scale), -127., 127.), scale


def init_decoder_state(B, S, D, U, n_mel = 80, dtype = torch.float32, device = None):
    """Fresh decode state for `decoder_steps`: h and ctx in the compute
    dtype, c, frame and the alignments float32, the argmax int32."""
    zeros = lambda shape, dt: torch.zeros(shape, dtype = dt, device = device)
    return dict(
        frame = zeros((B, n_mel), torch.float32),
        h_att = zeros((B, U), dtype), c_att = zeros((B, U), torch.float32),
        h_dec = zeros((B, U), dtype), c_dec = zeros((B, U), torch.float32),
        ctx = zeros((B, D), dtype),
        prev = zeros((B, S), torch.float32), cum = zeros((B, S), torch.float32),
        main = zeros((B,), torch.int32),
    )


# -- the dropout generator ------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mulhilo(m, x):
    """(high, low) 32 bits of the 64-bit product of the constant `m` and the
    int64 tensor `x` of 32-bit values, without overflowing int64."""
    m_hi, m_lo = m >> 16, m & 0xFFFF
    a, b = x * m_hi, x * m_lo                        # each below 2**48
    hi = (a + (b >> 16)) >> 16
    lo = (((a & 0xFFFF) << 16) + b) & _M32
    return hi, lo


def philox_bits(seed, step, row, unit, layer):
    """Word 0 of philox4x32-10 with key `seed` (int64 tensor, one element)
    and counter (step, row, unit, layer), int64 tensors of 32-bit values that
    broadcast against each other; returns int64 values in [0, 2**32)."""
    seed = seed.reshape(()).to(torch.int64)
    k0, k1 = seed & _M32, (seed >> 32) & _M32
    c0, c1, c2, c3 = torch.broadcast_tensors(step, row, unit, layer)
    for r in range(10):
        if r:
            k0, k1 = (k0 + 0x9E3779B9) & _M32, (k1 + 0xBB67AE85) & _M32
        hi0, lo0 = _mulhilo(0xD2511F53, c0)
        hi1, lo1 = _mulhilo(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0


def drop_threshold(drop_rate):
    """Keep iff bits >= this: ``round(rate * 2**32)``, capped to 32 bits."""
    if not 0. <= drop_rate < 1.:
        raise ValueError('drop_rate must be in [0, 1), got {}'.format(drop_rate))
    return min(int(round(drop_rate * 4294967296.)), 4294967295)


def _dropout(x, seed, step, layer, drop_rate):
    B, P = x.shape
    i64 = lambda v: torch.as_tensor(v, dtype = torch.int64, device = x.device)
    bits = philox_bits(seed.to(x.device), i64(step),
                       torch.arange(B, device = x.device)[:, None],
                       torch.arange(P, device = x.device)[None, :], i64(layer))
    keep = bits >= drop_threshold(drop_rate)
    return torch.where(keep, x * (1. / (1. - drop_rate)), torch.zeros_like(x))


# -- the plain version ------------------------------------------------------------

def _lstm(z, c, U):
    i = torch.sigmoid(z[:, :U])
    f = torch.sigmoid(z[:, U: 2 * U])
    g = torch.tanh(z[:, 2 * U: 3 * U])
    o = torch.sigmoid(z[:, 3 * U:])
    c = f * c + i * g
    return o * torch.tanh(c), c


def _prenet(w, frame, extra, seed, step, deterministic, drop_rate, rnd):
    """The prenet of one step, with its dropout: float32 weights `w`."""
    x = torch.relu(rnd(frame) @ w['w0'] + w['b0'] + extra)
    if not deterministic:
        x = _dropout(x, seed, step, 0, drop_rate)
    x = torch.relu(rnd(x) @ w['w1'] + w['b1'])
    if not deterministic:
        x = _dropout(x, seed, step, 1, drop_rate)
    return x


def decoder_steps_plain(weights, mem, pm, mask, enc_len, extra, state, seed, *,
                        n_steps, step0 = 0, deterministic = False, use_window = False,
                        win_len = 0, win_offset = 0, drop_rate = 0.5):
    """`decoder_steps` in plain PyTorch on the packed weights: float32
    arithmetic on values of the compute dtype, rounding where the kernel
    rounds.  Same arguments, same in-place update of `state`, same result."""
    dt = mem.dtype
    rnd = lambda t: t.to(dt).float()
    int8 = weights['att_w'].dtype == torch.int8
    w = {k: v.float() for k, v in weights.items() if torch.is_tensor(v)}

    def lstm_matmul(xin, key, bias):
        if int8:
            # exact int32 sums in float64, then the TPU kernel's scale order
            q, sx = _row_quant8(xin)
            z = (q.double() @ w[key].double()).float()
            return z * sx * w['s_' + key] + bias
        return xin @ w[key] + bias

    B, S, D = mem.shape
    U = w['att_w'].shape[1] // 4
    n_mel = w['w0'].shape[0]
    memf, pmf = mem.float(), pm.float()
    keep = mask > 0
    positions = torch.arange(S, device = mem.device)[None, :]
    loc_w = w['loc_w'].reshape(2, LOC_KERNEL, -1)

    frame = state['frame'].clone()
    h_att, c_att = state['h_att'].float(), state['c_att'].clone()
    h_dec, c_dec = state['h_dec'].float(), state['c_dec'].clone()
    ctx = state['ctx'].float()
    prev, cum = state['prev'].clone(), state['cum'].clone()
    main = state['main'].to(torch.int64)

    steps_out, attn_out = [], []
    for t in range(n_steps):
        x = _prenet(w, frame, extra, seed, step0 + t, deterministic, drop_rate, rnd)
        z = lstm_matmul(torch.cat([rnd(x), ctx, h_att], dim = -1), 'att_w', w['att_b'])
        h, c_att = _lstm(z, c_att, U)
        h_att = rnd(h)

        pq = h_att @ w['q_w']                                           # (B, A)
        # windows[b, c, s, k] = alignment c of row b at s + k - 15, zero outside
        windows = F.pad(torch.stack([rnd(prev), rnd(cum)], dim = 1), (LOC_PAD, LOC_PAD)) \
            .unfold(2, LOC_KERNEL, 1)
        feat = torch.einsum('bcsk,cka->bsa', windows, loc_w)
        energies = (torch.tanh(pq[:, None, :] + pmf + feat) * w['v_w']).sum(dim = -1)
        valid = keep
        if use_window:
            center = torch.clamp(main, min = win_offset)
            center = torch.minimum(center, enc_len.to(torch.int64) - win_len + win_offset)
            lo = (center - win_offset)[:, None]
            valid = valid & (positions >= lo) & (positions <= lo + win_len)
        energies = torch.where(valid, energies, torch.full_like(energies, -1e9))
        energies = energies - energies.max(dim = 1, keepdim = True).values
        ew = torch.exp(energies)
        attn = ew / ew.sum(dim = 1, keepdim = True)
        cum = cum + attn
        prev = attn
        main = torch.argmax(attn, dim = 1)
        ctx = rnd((attn.to(dt)[:, :, None] * mem).float().sum(dim = 1))

        z = lstm_matmul(torch.cat([h_att, ctx, h_dec], dim = -1), 'dec_w', w['dec_b'])
        h, c_dec = _lstm(z, c_dec, U)
        h_dec = rnd(h)

        out = torch.cat([h_dec, ctx], dim = -1) @ w['proj_w'] + w['proj_b']
        out = torch.cat([out[:, :n_mel], torch.sigmoid(out[:, n_mel:])], dim = -1)
        frame = out[:, :n_mel]
        steps_out.append(out)
        attn_out.append(attn)

    new = dict(frame = frame, h_att = h_att, c_att = c_att, h_dec = h_dec, c_dec = c_dec,
               ctx = ctx, prev = prev, cum = cum, main = main)
    for key in _STATE_KEYS:
        state[key].copy_(new[key])
    empty = lambda n: torch.zeros((0, B, n), dtype = torch.float32, device = mem.device)
    return (torch.stack(steps_out) if steps_out else empty(n_mel + 1),
            torch.stack(attn_out) if attn_out else empty(S), state)


# -- the kernel --------------------------------------------------------------------

def _kernel(name = 'decoder_steps_forward'):
    fn = getattr(load_library('decoder_steps'), name)
    if fn.argtypes is None:
        if name == 'decoder_steps_plan':
            fn.argtypes = [ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_longlong)]
        else:
            fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_longlong),
                           ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _slabs(w):
    """LSTM weight (K, 4U), gate columns i, f, g, o → the kernel's slabs
    (U / 8, K, 32): slab s holds, for every input k, column ``4 * unit +
    gate`` of its 8 units."""
    K, U = w.shape[0], w.shape[1] // 4
    if U % SLAB_UNITS:
        raise ValueError('decoder_steps needs U % {} == 0, got U={}'.format(SLAB_UNITS, U))
    return w.reshape(K, 4, U // SLAB_UNITS, SLAB_UNITS).permute(2, 0, 3, 1) \
        .reshape(U // SLAB_UNITS, K, 4 * SLAB_UNITS).contiguous()


def _slabs_int8(w):
    """int8 LSTM weight (K, 4U) → the kernel's slabs (U / 8, K / 4, 32, 4):
    slab s holds, for every group of 4 inputs, column ``4 * unit + gate`` of
    its 8 units as the group's 4 bytes (one `__dp4a` operand).  The column
    scales stay in the logical order, as the biases do."""
    K, U = w.shape[0], w.shape[1] // 4
    if U % SLAB_UNITS or K % 4:
        raise ValueError('decoder_steps in int8 needs U % {} == 0 and K % 4 == 0, got '
                         'U={}, K={}'.format(SLAB_UNITS, U, K))
    return w.reshape(K // 4, 4, 4, U // SLAB_UNITS, SLAB_UNITS).permute(3, 0, 4, 2, 1) \
        .reshape(U // SLAB_UNITS, K // 4, 4 * SLAB_UNITS, 4).contiguous()


_LOGICAL_ONLY = ('att_w', 'dec_w')


def _kernel_weights(weights):
    """The kernel's slab layouts of the two LSTM weights, made once per packed
    dictionary and kept in it."""
    if '_kernel' not in weights:
        slabs = _slabs_int8 if weights['att_w'].dtype == torch.int8 else _slabs
        weights['_kernel'] = {'att_k': slabs(weights['att_w']),
                              'dec_k': slabs(weights['dec_w'])}
    return weights['_kernel']


def kernel_weights_only(weights):
    """`weights` with the two LSTM weights in the kernel's slab layouts alone,
    their logical copies left out: what a model keeps on a card, where only
    the kernel reads them.  `decoder_steps_plain` does not take the result."""
    _kernel_weights(weights)
    return {k: v for k, v in weights.items() if k not in _LOGICAL_ONLY}


def _check(weights, mem, pm, mask, enc_len, extra, state, seed, n_steps):
    dt = mem.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError('decoder_steps takes float32 or bfloat16, got {}'.format(dt))
    B, S, D = mem.shape
    n_mel, P0 = weights['w0'].shape
    P1 = weights['w1'].shape[1]
    U, A = weights['q_w'].shape
    if not (1 <= B <= MAX_ROWS and U % SLAB_UNITS == 0 and P0 % 4 == 0 and P1 % 4 == 0
            and A % 4 == 0 and (U + D) % 4 == 0):
        raise ValueError(
            'decoder_steps needs 1 <= B <= {}, U % {} == 0, and P0, P1, A, U + D '
            'multiples of 4; got B={}, U={}, P0={}, P1={}, A={}, D={}'.format(
                MAX_ROWS, SLAB_UNITS, B, U, P0, P1, A, D))
    if mem.device.type == 'cuda':
        # a block of the persistent grid owns one slab of each LSTM
        sms = torch.cuda.get_device_properties(mem.device).multi_processor_count
        if U // SLAB_UNITS > sms:
            raise ValueError('decoder_steps needs U / {} <= {} (the SMs of {}), got U={}'
                             .format(SLAB_UNITS, sms, mem.device, U))
    if n_steps < 1:
        raise ValueError('n_steps must be positive, got {}'.format(n_steps))
    f32, i32 = torch.float32, torch.int32
    kw = _kernel_weights(weights)
    slabs, width = U // SLAB_UNITS, 4 * SLAB_UNITS
    k_att, k_dec = P1 + D + U, 2 * U + D
    if kw['att_k'].dtype == torch.int8:
        lstm = {'att_w slabs': (kw['att_k'], (slabs, k_att // 4, width, 4), torch.int8),
                'dec_w slabs': (kw['dec_k'], (slabs, k_dec // 4, width, 4), torch.int8),
                's_att_w': (weights.get('s_att_w'), (4 * U,), f32),
                's_dec_w': (weights.get('s_dec_w'), (4 * U,), f32)}
    else:
        lstm = {'att_w slabs': (kw['att_k'], (slabs, k_att, width), dt),
                'dec_w slabs': (kw['dec_k'], (slabs, k_dec, width), dt)}
    expected = {
        'w0': (weights['w0'], (n_mel, P0), dt), 'b0': (weights['b0'], (P0,), f32),
        'w1': (weights['w1'], (P0, P1), dt), 'b1': (weights['b1'], (P1,), f32),
        'att_b': (weights['att_b'], (4 * U,), f32),
        'q_w': (weights['q_w'], (U, A), dt),
        'loc_w': (weights['loc_w'], (2 * LOC_KERNEL, A), dt),
        'v_w': (weights['v_w'], (A,), f32),
        'dec_b': (weights['dec_b'], (4 * U,), f32),
        'proj_w': (weights['proj_w'], (U + D, n_mel + 1), dt),
        'proj_b': (weights['proj_b'], (n_mel + 1,), f32),
        'pm': (pm, (B, S, A), dt), 'mask': (mask, (B, S), f32),
        'enc_len': (enc_len, (B,), i32), 'extra': (extra, (B, P0), f32),
        'seed': (seed, (1,), torch.int64),
        'frame': (state['frame'], (B, n_mel), f32),
        'h_att': (state['h_att'], (B, U), dt), 'c_att': (state['c_att'], (B, U), f32),
        'h_dec': (state['h_dec'], (B, U), dt), 'c_dec': (state['c_dec'], (B, U), f32),
        'ctx': (state['ctx'], (B, D), dt),
        'prev': (state['prev'], (B, S), f32), 'cum': (state['cum'], (B, S), f32),
        'main': (state['main'], (B,), i32),
        ** lstm,
    }
    for name, (t, shape, dtype) in expected.items():
        if t is None:
            raise ValueError('{} is missing'.format(name))
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError('{}: expected {} {}, got {} {}'.format(
                name, shape, dtype, tuple(t.shape), t.dtype))
    for name, t in [('mem', mem)] + [(n, v[0]) for n, v in expected.items()]:
        if t.device != mem.device:
            raise ValueError('{} is on {}, mem on {}'.format(name, t.device, mem.device))
        if not t.is_contiguous() or (t.data_ptr() % 16 and t.numel() * t.element_size() >= 16):
            raise ValueError('{} must be contiguous and 16-byte aligned'.format(name))
    return B, S, D, n_mel, P0, P1, U, A


PHASES = ('prenet_0', 'prenet_1', 'attention_lstm', 'energies', 'context', 'decoder_lstm',
          'frame')


def stamps_size(n_steps):
    """Elements of the `stamps` tensor of a launch of `n_steps` steps."""
    return 2 * len(PHASES) * n_steps + 4


def phase_times_us(stamps):
    """The kernel's clock stamps (`decoder_steps(..., stamps = ...)`) → microseconds
    per step of each phase in `PHASES`, as block 0 saw them (it takes the
    first item of every phase): ``work`` (n_steps, 7), from the previous
    barrier to its arrival at this phase's, and ``barrier`` (n_steps, 7),
    its wait there (for the slowest block, then the barrier itself)."""
    stamps = stamps.cpu().double()
    ns0, clock0, ns1, clock1 = stamps[-4:]
    us_per_clock = 1e-3 * (ns1 - ns0) / (clock1 - clock0)
    per_phase = stamps[:-4].reshape(-1, len(PHASES), 2)
    passed = torch.cat([clock0.reshape(1), per_phase[..., 1].reshape(-1)[:-1]])
    work = per_phase[..., 0] - passed.reshape(per_phase.shape[:2])
    barrier = per_phase[..., 1] - per_phase[..., 0]
    return {'work': work * us_per_clock, 'barrier': barrier * us_per_clock}


def _ints(mem, B, S, n_mel, P0, P1, D, U, A, n_steps, step0, deterministic, use_window,
          win_len, win_offset, drop_rate, int8):
    return (ctypes.c_longlong * 17)(
        int(mem.dtype == torch.bfloat16), B, S, n_mel, P0, P1, D, U, A, n_steps, step0,
        int(bool(deterministic)), int(bool(use_window)), int(win_len), int(win_offset),
        drop_threshold(drop_rate), int(int8))


_PLAN_KEYS = ('smem_bytes', 'resident_bytes_per_block', 'streamed_bytes_per_step', 'blocks',
              'slab_blocks', 'resident_att_units', 'resident_dec_units', 'unit_bytes',
              'scratch_floats')


def kernel_plan(ints):
    """The kernel's shared-memory plan for a launch (its `_ints`), on the
    current CUDA device: resident bytes per block, bytes streamed per step
    from device memory, the blocks; see ``decoder_steps_plan`` in the source."""
    out = (ctypes.c_longlong * len(_PLAN_KEYS))()
    err = _kernel('decoder_steps_plan')(ints, out)
    if err != 0:
        raise RuntimeError('decoder_steps: no shared-memory plan fits (CUDA error {})'
                           .format(err))
    return dict(zip(_PLAN_KEYS, out))


def decoder_steps(weights, mem, pm, mask, enc_len, extra, state, seed, *,
                  n_steps, step0 = 0, deterministic = False, use_window = False,
                  win_len = 0, win_offset = 0, drop_rate = 0.5, stamps = None,
                  prenet_out = None):
    """Run `n_steps` fused decoder steps in one kernel launch.

    - weights: dict from `pack_decoder_weights`, in the compute dtype, or
      from `quantize_lstm_weights` (the int8 LSTM mode);
    - mem (B, S, D): encoder memory, zero where masked; pm (B, S, A):
      processed memory; both in the compute dtype;
    - mask (B, S) float32 1/0; enc_len (B,) int32 (for the window);
    - extra (B, P0) float32: addend of the first prenet layer's
      pre-activation (the folded speaker embedding; zeros otherwise);
    - state: dict from `init_decoder_state`, **updated in place** and
      returned: the next call continues where this one stopped;
    - seed (1,) int64 tensor: key of the prenet dropout; `step0` is the
      absolute index of this launch's first step, so that the mask does
      not depend on how the steps are split into launches;
    - stamps: optional int64 CUDA tensor of `stamps_size(n_steps)` elements
      that receives the kernel's clock stamps (see `phase_times_us`);
    - prenet_out: optional float32 CUDA tensor (B, P1) that receives the
      prenet output of the launch's last step, the first segment of the
      attention LSTM's input row (see `int8_lstm_lockstep`).

    Returns (steps (n_steps, B, n_mel + 1) float32 — ``[..., :n_mel]`` the
    frame, ``[..., n_mel]`` the gate after its sigmoid —, attn
    (n_steps, B, S) float32, state).  On a card, `decoder_steps.last_plan`
    holds the launch's shared-memory plan (`kernel_plan`).
    """
    options = dict(n_steps = n_steps, step0 = step0, deterministic = deterministic,
                   use_window = use_window, win_len = win_len, win_offset = win_offset,
                   drop_rate = drop_rate)
    if mem.device.type == 'cpu':
        if stamps is not None or prenet_out is not None:
            raise ValueError('stamps and prenet_out are taken by the CUDA kernel only')
        return decoder_steps_plain(weights, mem, pm, mask, enc_len, extra, state, seed,
                                   ** options)
    if mem.device.type != 'cuda':
        raise ValueError('decoder_steps runs on cuda (or cpu via its plain version), '
                         'got {}'.format(mem.device))
    B, S, D, n_mel, P0, P1, U, A = _check(
        weights, mem, pm, mask, enc_len, extra, state, seed, n_steps)
    kw = _kernel_weights(weights)
    f32 = dict(dtype = torch.float32, device = mem.device)
    if prenet_out is not None and (prenet_out.dtype != torch.float32
                                   or prenet_out.device != mem.device
                                   or tuple(prenet_out.shape) != (B, P1)
                                   or not prenet_out.is_contiguous()):
        raise ValueError('prenet_out: expected contiguous float32 ({}, {}) on {}'.format(
            B, P1, mem.device))
    if stamps is not None and (stamps.dtype != torch.int64 or stamps.device != mem.device
                               or tuple(stamps.shape) != (stamps_size(n_steps),)):
        raise ValueError('stamps: expected int64 ({},) on {}'.format(
            stamps_size(n_steps), mem.device))
    int8 = kw['att_k'].dtype == torch.int8
    ints = _ints(mem, B, S, n_mel, P0, P1, D, U, A, n_steps, step0, deterministic, use_window,
                 win_len, win_offset, drop_rate, int8)
    with torch.cuda.device(mem.device):
        plan = kernel_plan(ints)
        x = prenet_out if prenet_out is not None else torch.empty((B, P1), ** f32)
        h_att_alt, h_dec_alt = torch.empty_like(state['h_att']), torch.empty_like(state['h_dec'])
        scratch = torch.zeros((plan['scratch_floats'],), ** f32)   # the barrier's count at 0
        steps = torch.empty((n_steps, B, n_mel + 1), ** f32)
        attn = torch.empty((n_steps, B, S), ** f32)
        tensors = [weights['w0'], weights['w1'], kw['att_k'], weights['q_w'], weights['loc_w'],
                   kw['dec_k'], weights['proj_w'], weights['b0'], weights['b1'],
                   weights['att_b'], weights['v_w'], weights['dec_b'], weights['proj_b'], mem,
                   pm, mask, enc_len, extra, seed] + [state[k] for k in _STATE_KEYS] \
            + [x, h_att_alt, h_dec_alt, scratch, steps, attn]
        optional = [stamps] + ([weights['s_att_w'], weights['s_dec_w']] if int8 else [None, None])
        ptrs = (ctypes.c_void_p * (len(tensors) + len(optional)))(
            * (t.data_ptr() for t in tensors),
            * (t.data_ptr() if t is not None else None for t in optional))
        stream = torch.cuda.current_stream(mem.device).cuda_stream
        err = _kernel()(ptrs, ints, 1. / (1. - drop_rate), stream)
    if err != 0:
        raise RuntimeError('decoder_steps kernel launch failed: CUDA error {}'.format(err))
    decoder_steps.launches += 1
    decoder_steps.last_plan = plan
    return steps, attn, state


decoder_steps.launches = 0
decoder_steps.last_plan = None


# -- holding the int8 LSTM mode step by step ------------------------------------

def _rel_err(out, ref):
    out, ref = out.float(), ref.float()
    return float((out - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)


def _grid_difference(row_k, row_p, segments):
    """Where the int8 values of two staged LSTM input rows (B, K) differ,
    or None (row scales that differ by a rounding move no value and are
    float32 noise): how many values, by how many grid steps, whether the
    row scales agree, how far apart the rows are (relative to their amax),
    and the first differing value on both sides, in units of the row scale
    and in float32 ulps of each other."""
    q_k, s_k = _row_quant8(row_k)
    q_p, s_p = _row_quant8(row_p)
    if torch.equal(q_k, q_p):
        return None
    out = {'values': int((q_k != q_p).sum()), 'max_grid_steps': float((q_k - q_p).abs().max()),
           'scales_equal': bool(torch.equal(s_k, s_p)),
           'row_diff_rel_amax': float(((row_k - row_p).abs() / s_p / 127.).max())}
    where = (q_k != q_p).nonzero()
    if len(where):
        b, k = (int(i) for i in where[0])
        start = 0
        for name, width in segments:
            if k < start + width:
                break
            start += width
        vk, vp = row_k[b, k], row_p[b, k]
        ulp = torch.nextafter(vp.abs(), vp.new_tensor(float('inf'))) - vp.abs()
        out['first'] = {'row': b, 'segment': name, 'index': k - start,
                        'kernel': float(vk), 'plain': float(vp),
                        'ulps_apart': float((vk - vp).abs() / ulp),
                        'kernel_over_scale': float(vk / s_k[b, 0]),
                        'plain_over_scale': float(vp / s_p[b, 0])}
    return out


def int8_lstm_lockstep(weights, mem, pm, mask, enc_len, extra, state, seed, *, n_steps,
                       control = None, step0 = 0, deterministic = False, use_window = False,
                       win_len = 0, win_offset = 0, drop_rate = 0.5):
    """Trace the int8 LSTM mode of the CUDA kernel against its plain
    version one step at a time.

    The two LSTM input rows carry an int8 grid set by their amax, so a
    rounding-level difference in a staged value (the prenet's or the
    attention's sums, taken in another order) can move a value across a
    rounding tie; a decode carries such a step on.  The kernel runs its
    decode as one-step launches (the same steps as one launch of
    `n_steps`); each step, the plain version runs once from the kernel's
    state (the same state on both sides) and once along its own decode.
    The rows each side staged are rebuilt (the kernel's prenet output read
    back through ``prenet_out``) and quantized as the kernel quantizes them.
    With `control` (other packed weights for the same inputs, e.g. the
    float32 ones) the kernel on `control` also runs from the kernel's state.

    Returns (a list of per-step dicts, the kernel's steps (n_steps, B,
    n_mel + 1)).  Per step, from the same state: ``grids_equal``,
    ``rel_err`` (largest over the frame and gate, the alignment and every
    state tensor, relative to each one's largest magnitude),
    ``control_rel_err`` and, where the int8 values differ, ``att`` / ``dec``:
    `_grid_difference` of that LSTM's row; along the two decodes:
    ``path_grids_equal``, ``path_rel_err``, ``path_att`` / ``path_dec``.
    """
    if weights['att_w'].dtype != torch.int8 or mem.dtype != torch.float32:
        raise ValueError('int8_lstm_lockstep holds the int8 LSTM mode in float32 compute')
    w = {k: v.float() for k, v in weights.items() if torch.is_tensor(v)}
    B, D, U = mem.shape[0], mem.shape[2], state['h_att'].shape[1]
    P1 = w['w1'].shape[1]
    options = dict(n_steps = 1, deterministic = deterministic, use_window = use_window,
                   win_len = win_len, win_offset = win_offset, drop_rate = drop_rate)
    inputs = (mem, pm, mask, enc_len, extra)
    keys = ('h_att', 'c_att', 'h_dec', 'c_dec', 'ctx', 'prev', 'cum')
    err = lambda a, b: max([_rel_err(a[0], b[0]), _rel_err(a[1], b[1])]
                           + [_rel_err(a[2][k], b[2][k]) for k in keys])
    copy = lambda st: {k: v.clone() for k, v in st.items()}
    prenet = lambda st, t: _prenet(w, st['frame'], extra, seed, t, deterministic, drop_rate,
                                   lambda v: v)

    def rows(x, before, after):
        """The attention and decoder LSTMs' input rows of one step."""
        return (torch.cat([x, before['ctx'], before['h_att']], dim = -1),
                torch.cat([after['h_att'], after['ctx'], before['h_dec']], dim = -1))

    def differences(rows_k, rows_p):
        att = _grid_difference(rows_k[0], rows_p[0], (('x', P1), ('ctx', D), ('h_att', U)))
        dec = _grid_difference(rows_k[1], rows_p[1], (('h_att', U), ('ctx', D), ('h_dec', U)))
        return {k: v for k, v in (('att', att), ('dec', dec)) if v is not None}

    kernel_state, plain_state, steps, frames = state, copy(state), [], []
    for t in range(step0, step0 + n_steps):
        x_k = torch.empty((B, P1), dtype = torch.float32, device = mem.device)
        kern = decoder_steps(weights, * inputs, copy(kernel_state), seed, step0 = t,
                             prenet_out = x_k, ** options)
        same = decoder_steps_plain(weights, * inputs, copy(kernel_state), seed, step0 = t,
                                   ** options)
        path = decoder_steps_plain(weights, * inputs, copy(plain_state), seed, step0 = t,
                                   ** options)
        rows_k = rows(x_k, kernel_state, kern[2])
        moved = differences(rows_k, rows(prenet(kernel_state, t), kernel_state, same[2]))
        moved_path = differences(rows_k, rows(prenet(plain_state, t), plain_state, path[2]))
        step = {'step': t, 'grids_equal': not moved, 'rel_err': err(kern, same),
                'path_grids_equal': not moved_path, 'path_rel_err': err(kern, path), ** moved}
        step.update({'path_' + k: v for k, v in moved_path.items()})
        if control is not None:
            step['control_rel_err'] = err(
                decoder_steps(control, * inputs, copy(kernel_state), seed, step0 = t,
                              ** options), same)
        steps.append(step)
        frames.append(kern[0])
        kernel_state, plain_state = kern[2], path[2]
    return steps, torch.cat(frames)
