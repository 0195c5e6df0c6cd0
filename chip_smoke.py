"""Drive the PyTorch port on one NVIDIA GPU: build its CUDA kernels, hold
each against its plain PyTorch version, run `tts()` end to end at the full
NVIDIA width of Tacotron-2 and WaveGlow with random weights (also imported
from NVIDIA-layout checkpoints, and with FastSpeech-2 in the Tacotron-2's
place), train WaveGlow at that width, train the synthesizers (Tacotron-2
and SV2TTS by teacher forcing, FastSpeech-2 distilled from the trained
Tacotron-2, the speaker encoder by GE2E) and serve the trained ones,
clone a voice from the trained Tacotron-2 and fine-tune it on a corpus, and
serve the other families (HiFi-GAN and Vocos behind Tacotron-2, VITS and
SV2TTS-VITS) imported from seeded state dicts in their published layouts,
and serve Tacotron-2 + WaveGlow and VITS over HTTP with continuous batching,
and train HiFi-GAN, Vocos, VITS and SV2TTS-VITS adversarially, and serve
GPT-2 small token by token with continuous batching, and run the parallel
axes (data-parallel serving and training, the GPipe pipeline, expert
parallelism) across two ranks on the card.

    python3 chip_smoke.py

Phases, one JSON line each:
  device   the card (nvidia-smi), the kernels' build time and ptxas report,
           and the SASS check: K1's and K4's bf16 kernels must hold HGMMA
           (wgmma) and UTMALDG (TMA loads), K2's GEMMs IGMMA and UTMALDG,
           K5's int8 kernel IGMMA and its bf16 one HGMMA, both UTMALDG
           (cuobjdump of build/torch_kernels/lib<name>.so);
  kernels  every ported kernel at the main path's shapes (one utterance,
           the batch of four, and for K1 and K2 the long text's window batch
           of 32 windows of 128 frames): error against its plain version, median time
           of the kernel (7 after 2 warm-ups) and of the plain version (3
           after 1; K3's, host-bound, its one reference call; CUDA events),
           and the bound.  The WN block (K1) in float32 and bfloat16 and its int8
           variant (K2, equal to its plain version to the bit) with bf16
           buffers, one float32 case and one with the static gate scale,
           both also at a length that is no multiple of any tile; for each
           timed bf16 / int8 case the L2 bytes by the kernels' tiling, the
           waves of each GEMM on the SMs and the clocks under it, with the
           registers and spills of every kernel; then K1's and K2's rates as
           shares of K5's of the same type, measured in the same run (K4's
           too); the decoder steps (K3) in float32, bfloat16 and the
           int8 LSTM mode, deterministic and with dropout, with the attention
           window at a memory length that is no multiple of 64, float32 also
           at a memory of 256, and as two launches of 32 steps against one of
           64; for each timed case the kernel's shared-memory plan (bytes
           resident per block, bytes streamed per step), the serial floor it
           implies, the µs of each of its seven phases from its clock stamps,
           and every instantiation's ptxas registers and spills; one WN layer (K4) in
           float32 and bfloat16 at the training batch and at one utterance,
           dilations 1, 16, 128 and 200, residual and last layer, also at a
           length that is no multiple of any tile, with the L2 bytes, waves,
           registers, spills and clocks of the timed bf16 cases;
           the rate probe (K5) in int8 (to the bit) and bfloat16 at the
           probe's shapes and a small one, one bfloat16 product, and four
           beside a control that must miss their limit, the kernel's L2 bytes,
           cluster shape, waves of clusters, clock stamps (a product, the
           hand-off of the next x) and rate, the library yardstick (stacked rows, `torch._int_mm` / bf16
           `matmul`, one CUDA graph); then the probe (`main`) as
           `python -m text_to_speech_tpu_torch.ops.matmul_rate` runs it.
           Around one timed case of each kernel (K1 and K2 bfloat16 at one
           utterance, K3 float32 with dropout at B=1, K4 bfloat16 at B=8 and 1, K5
           both types), nvidia-smi's SM clock and power draw: just after the
           timed runs, 0.15 s into 0.3 s of calls back to back, and after them;
  e2e      `tts()` on one sentence (the one-launch path: fused decoder →
           vocoder → int16, no retry) and on a batch of four on both decoder
           routes, then, after `quantize_for_serving` passes its SNR gate on
           the card, both routes again in int8 serving, and one sentence after
           a gate forced to fail (the float32 chain): decode and vocode
           seconds, real-time factor, every kernel's launch count, the span
           tree of each run (`loggers.timer_report`); the fused
           decode against the plain decode at full width, and the int8 LSTM
           decode (`infer_fused(int8_lstm=True)`) with its launches; the
           vocoder's bf16 and int8 kernel routes against its float32 chain on
           a short mel; `torch.profiler` traces of one sentence through
           `loggers.start_profiler_trace` (its CUDA kernel events, K3's and
           K1's among them: 2L a block), and of one in int8 serving (K2's
           device kernels a block, at most 2L + 2); the card's memory
           (`devices.get_memory_stats`);
  windowed a paragraph of 8 sentences (`max_text_length=-2`, 256 frames each)
           vocoded in windows of 128 frames cut from the device mel
           (`vocode_windowed_from_device`, 24 windows in one batch of 32: 12
           K1 launches at B=32, T=4096; 4 K3 launches at B=8), in the default
           and the int8 serving mode: total, decode and vocode ms, RTF,
           launches, spans; the device slicer against the host one
           (`vocode_windowed_batch`) on the decoded mels with ragged lengths;
           one mel of 2,048 frames through `WaveGlow.infer` direct, windowed
           one call a window and windowed in one batch: ms and peak memory
           (the one-call-a-window peak must be below the direct one);
  surface  `tts()` of the four sentences with `directory=`: map.json, each
           saved WAV against the returned audio, and a second call answered
           from the cache with no kernel launch; `stream()` over a queue of
           three texts into a `QueueCallback`: order and launches (the two
           `precompile_for_stream` texts included);
  families the other families at their published widths, seeded: HiFi-GAN
           V1 and Vocos, each imported by `from_torch_pretrained` from a
           state dict in its official layout (HiFi-GAN weight-normed) and
           equal to the bit to the same weights made in memory and to the
           model reloaded by name, behind the NVIDIA-width Tacotron-2: one
           256-frame sentence through `tts()` (4 K3, no K1 / K2: the
           one-launch path with the vocoder's `device_vocoder_fn`), for
           HiFi-GAN also a batch of four and `win_len=128` (the sequential
           path, each whole mel vocoded): total, decode and vocode ms, RTF;
           the vocode of a 256-frame mel (CUDA events); a 64-frame mel on
           the card against the port on the CPU (1e-4 of scale).  VITS at
           the LJSpeech release's widths (use_sdp), imported from its seeded
           `SynthesizerTrn` dict: `tts()` of one sentence and of four (no
           launch), `d_control` scaling the random durations to ~256
           frames; the forward (CUDA events); at noise 0 on the four
           sentences the card against the CPU (durations equal or apart by
           one on a tie, the waveform within 1e-4 of scale on the rows that
           agree, at least one) and bfloat16 against the card's float32 (the
           whole pass finite, log-durations within 1e-1, the waveform from
           float32's durations within 1e-1 of scale); SV2TTS-VITS (`create`,
           a 256-wide embedding) cloning one sentence from a saved table by
           label;
  serving  serving over HTTP with continuous batching at NVIDIA width: K3's
           `decode_chunk` against the plain route at B = 1, 4, 8 and 16 (two
           row groups of 8): a chunk at S = 64, the batch re-bucketed to 128,
           a second chunk (1e-4 of scale), and the wall ms of a K3 chunk; K3
           against its plain version at a row group (B = 8, S = 64, timed);
           `serve()` on Tacotron-2 + WaveGlow (sigma 0, deterministic prenet,
           256 frames a request, stream_context 192) on the native scheduler
           after its warm-up: 16 requests over HTTP from threads, 8 at once
           and 8 after the first chunk, half streamed (`?stream=1`), four in
           the next token bucket; each mel against `infer_fused` on its
           padded tokens (1e-4 of scale), each WAV body the request's audio,
           each stream's last emission against the offline vocode (2e-2 of
           scale); K3 launches (one a chunk for each group of <= 8 rows) and
           K1 launches (12 a vocoder call) counted; time to first audio,
           latency, audio seconds per second, ms per chunk by row bucket;
           then `serve()` on the families phase's VITS (int16 chunks, noise
           0) answering 4 requests, against one-shot `compiled_infer`
           (1/32767 + 1e-4), no launch.  K1 is held against its plain
           version at the emissions' (B, T) after the transfer phase;
  sv2tts   voice cloning at NVIDIA width (random seeded weights, a 256-wide
           speaker embedding): the speaker encoder at its defaults, saved and
           loaded by name, embeds four clips of 1-3 s at 16 kHz and a WAV at
           22,050 Hz on the card (ms, norms 1 within 1e-5, the port on the CPU
           within 1e-4); K3 at D = 768 with the prenet addend of an ('end',
           'prenet') model against its plain version in float32, bfloat16 and
           the int8 LSTM mode, deterministic and with dropout, B = 1 and 4, S
           = 64, as in the kernels phase (and the kernel without the addend
           must miss the limit); `tts()` of one sentence cloned from reference
           audio (the `encoder_name` route) in both serving modes, from a saved
           table by label, four texts through `predict_batched`: launches (4
           K3, 12 K1 or K2), decode, vocode and embed ms, spans; two speakers
           give two mels, and a second speaker with the same `directory=` is
           decoded again, not answered from map.json;
  nvidia_import  NVIDIA's Tacotron-2 and WaveGlow checkpoints at full width
           (seeded synthetic state dicts in NVIDIA's layout: the stop gate's
           bias at -4, the WaveGlow weight-normed with fused cond layers and
           early outputs every 4 flows), saved with `torch.save` and imported
           by `from_nvidia_pretrained` into a temporary root (ms of each);
           K3 at the imported widths against its plain version (as in the
           kernels phase, B = 1, S = 64); `tts(lang='en', root=...)` loading
           both by name (4 K3 and 12 K1 launches; its mel equal to the
           in-memory model's, deterministic); one sentence timed in each
           serving mode (12 K1, then 12 K2); the imported vocoder's K1 route
           against its float32 chain;
  fastspeech2  FastSpeech-2 at the JAX package's defaults (dim 256, 4 + 6
           blocks, FFN 1,024, 256 bins), random seeded weights, durations
           floored so that one sentence is ~256 frames, on the imported
           NVIDIA-width WaveGlow: one sentence through `tts()` (the
           one-launch path, 12 K1), in bfloat16 and in int8 serving (12 K2),
           four through `predict_batched`: total, forward and vocode ms,
           RTF, launches; the forward alone (CUDA events); the float32
           forward on the card against the port on the CPU (durations
           equal or apart by one on a tie; the rest within 1e-4 of the
           mel's scale, against the CPU's forward given the card's
           durations); then K1 and K2 against their plain versions, as in
           the kernels phase, at the (B, T) of the vocoder's buffer on the
           one-sentence and the batched route (the whole decode buffer,
           padded to 256 frames);
  train    WaveGlow training at NVIDIA width (12 flows, 8 WN layers, C=512),
           random seeded weights: the train step (B=8 x 256 frames, per-flow
           remat, Adam at 1e-4) on the default route in float32 and under
           mixed_bfloat16 and on `wn_train_fused` (K1 forward) under
           mixed_bfloat16 (2 steps, the loss falling; the second timed):
           ms per step, audio seconds per second, peak
           memory, K1 launches per step; `fit` on the four in-repo WAVs for 2
           epochs on K1 (the loss falls, a checkpoint is written) and one
           more that resumes the optimizer state; the eval step of a
           `use_pallas` model (K4 in every layer) against the plain chain in
           float32 and mixed_bfloat16, and its train step refused; the eval
           forward of a `use_pallas` model at the train step's shape (B=8 x
           256 frames, mixed_bfloat16: 96 K4 launches) beside the plain chain;
           the gradients of a step with ``remat='acts'`` (each layer's
           activations and residual stream kept, the gates recomputed)
           against per-flow remat at B=8 x 256 frames, mixed_bfloat16 (1e-5
           of scale), ms of two steps and peak memory of each.
  training the synthesizers at full width, random seeded weights (each
           family's float32 train step without dropout on a batch of 2 rows
           held against the port on the CPU: loss within 1e-4, the
           gradients' global norm within 1e-3, relative): Tacotron-2 at
           NVIDIA width made by `Tacotron2.create`, decoded once on K3,
           `fit` for 2 epochs on the four in-repo WAVs (each twice, their
           text, batch 4, 320 teacher-forced steps) in float32 and in
           mixed_bfloat16 (the loss must fall), ms per step and peak memory;
           the fitted teacher's K3 decode equal, within 1e-5 of its scale,
           to that of a model rebuilt from the fitted weights; its `tts()` of the text:
           K3 decodes (held against its plain version on the fitted
           weights, as in the kernels phase), K1 vocodes, launches counted,
           the attention turned into durations; SV2TTS at D = 768 ('end'),
           two steps; FastSpeech-2 at the JAX defaults fitted for 2 epochs
           on the teacher's alignment (the loss must fall), then its
           `tts()` (12 K1); the speaker encoder by GE2E (4 speakers × 4
           utterances, one epoch); the XLA-level int8 WaveGlow path on the
           random vocoder: one layer's int8 conv on the card equal to the
           CPU's to the bit, the waveform's SNR against the float32 chain.
  transfer a voice clone from the training phase's fitted teacher, in a
           root of its own: `SV2TTSTacotron2.from_pretrained('clone',
           'teacher', embedding_dim = 256)` (every teacher leaf arrives
           exact, the rows the speaker widens are zero, and the clone
           decodes on K3 as the teacher within 1e-5 of scale); a VoxForge
           tree of the four in-repo WAVs (two speakers, 8 rows each, one WAV
           at 16 kHz) through `get_dataset`, split by speaker, each row
           embedded by the fitted speaker encoder; `fit` 3 epochs with Lion
           on a `FileCacheDataset` (every WAV row decoded by the native
           pool, the later passes read the cache files, the map never
           called again), the held-out speaker as validation data, two
           checkpoints kept; the best checkpoint equal to
           `History.get_best`, kept while three worse epochs saved after
           the fit rotate out a later one; an Adafactor step card vs CPU;
           the best epoch's `tts()` with the held-out speaker (K3 >= 1, 12
           K1), its K3 against the plain version and K1 at the (B, T) its
           vocoder call got; MCD and mel SNR of its teacher-forced mels.
  gan      the adversarial training at the published widths, seeded weights:
           HiFi-GAN V1 (MPD 2/3/5/7/11, 3 MSD scales) and Vocos on 16 × 8,192
           samples of the in-repo WAVs with the L1 mel term, VITS (use_sdp,
           the LJSpeech widths) and SV2TTS-VITS (256-wide) on 16 of their
           utterances with seeded texts and 32-frame windows: ms a step
           (median of 5 after 2 warm-ups; VITS and SV2TTS-VITS 3 after 1) and peak
           memory in float32 and mixed_bfloat16, the disc loss falling on the
           fixed batch; VITS's step in parts (CUDA events) and the monotonic
           alignment alone; one step on the card against the CPU from the
           same weights, batch and draws (each loss 1e-4, both gradient norms
           1e-3, relative; VITS's alignment equal); `fit` of HiFi-GAN and VITS
           for 1 epoch and 1 resumed from `gan_state.npz`.  No kernel of the
           port runs in it.
  mesh     the parallel axes on torch.distributed: two gloo ranks spawned
           on the one card (`parallel.spawn`; NCCL takes one rank a card;
           send / recv stage CUDA tensors through host memory, the other
           collectives take them as they are): (a) Tacotron-2 + WaveGlow at
           NVIDIA width, deterministic, 8 requests of 256 frames over
           {'dp': 2} with streamed audio, each mel (1e-4) and audio (2e-2,
           relative) against the one-rank stepper, K3 and K1 launches, row
           groups and emission shapes per rank; (b) two data-parallel SGD
           `mixed_bfloat16` WaveGlow steps (8 × 256 frames, 4 rows a rank):
           each step's reduced gradients within 1e-2 (relative, L2 over
           every leaf) of one process's on the whole batch, the losses (1e-5,
           then 1e-4), bit-equal weights on both ranks, and two controls
           that must miss the bound (the second rank's own rows' gradient
           without the reduce; the reduce summed, not averaged); (c) two
           GPipe steps over {'pp': 2} (2 × 64 frames, float32) against
           `arch.loss` (loss 1e-5, gradients 1e-4 relative); the tensor
           and sequence axes: (e) NVIDIA WaveGlow over {'tp': 2}, a
           deterministic 32-frame vocode (1e-4 of scale) and one SGD step
           at 2 × 16 frames (loss 1e-5 relative, every gathered gradient
           and leaf 1e-4 of its scale, the replicated leaves bit-equal on
           both ranks, and a control that must miss: the exits through
           `all_reduce_sum`), the kernels refused; (f) over {'sp': 2}, 256
           frames with noise: 12 K1 launches a rank on its shard and halo,
           the audio within 2.5e-3 of the one-device K1 route (bf16; twice
           the route's own spread between a row alone and in a batch of
           two) and 1e-2 of the chain, K1's rows on each shard and halo, the
           float32 chain and K1's float32 instantiation over sp within 1e-5
           of one device; (g) FastSpeech-2 and (h) VITS over {'tp': 2}, the
           mel and the audio 1e-4 of scale, durations by the tie rule; (i)
           NVIDIA Tacotron-2's teacher-forced loss (2 × 64 frames) over
           {'tp': 2}, 1e-5 relative, its decode refused; (d) Mixtral
           8x7B's widths at 2 layers in bfloat16 over {'ep': 2}, its logits
           (2e-2 of scale) and 8 greedy tokens (the tie rule, at twice the
           logits' gap) against one rank holding every expert; then one NCCL
           rank in this process calling each collective on the card.  The
           one-process references of (a), (b) and (e) to (i) run in this
           process while the ranks start.  Both ranks share one card: its times are not
           two cards'.  K3 at each rank's row groups and K1 at its emission
           shapes, and K1 at a rank's sp shard and halo, are held against
           their plain versions after the `llm` phase.  (``--probe-gloo-p2p`` runs instead of the script: whether
           gloo's send / recv take a CUDA tensor as it is; ``--probe-k1-rows``:
           which op of the bf16 K1 route gives a row other bits in another
           shape, `_k1_rows`.)
  llm      token-level LLM serving and the transformer zoo: GPT-2 small at
           its published widths (124,439,808 parameters), a seeded state dict
           in HF's layout through `convert_gpt2_state_dict`; the prefill of 4
           right-padded prompts (8-32 tokens) on the card against the CPU
           (1e-4 of scale); greedy `generate` (4 rows, 32 tokens) and beam
           search (4 beams) against the CPU, equal up to a step whose CPU
           margin is below 1e-4 (`_tie_rule`), sampling twice with one seed
           equal and ``top_k=1`` equal to greedy; 64 requests at once through
           `make_llm_engine` (32-token prompts, 96 new tokens, max_length
           256, chunk 8, 32 slots): tokens/s, requests/s, median and p90
           first-token and end-to-end latency, chunks, occupancy, peak
           memory, every row equal to the offline `generate`, and the card's
           busy share over one chunk of 32 rows (`torch.profiler`); the
           narrow families card against CPU from seeded HF-layout dicts
           (Mistral 4/2 heads, Mixtral 4 experts top 2 with its
           load-balancing loss, BERT with the MLM head, T5, BART, Whisper:
           1e-4 of scale, 8 greedy tokens by the tie rule); no K1-K5 launch.
  export   the serving forwards through `torch.export` and the `Runtime`
           registry (K1, K2 and K3 as `torch.library` ops in the programs),
           on the e2e phase's models: (a) WaveGlow's bf16 vocode of 1 × 256
           frames exported, saved and loaded by ``build_runtime('export',
           path)``: 12 K1 a call, audio equal to eager to the bit; (b) the
           int8 route: 12 K2; (c) the stepper's 64-step `decode_chunk` at B
           = 1 and 8 rows, one K3 launch a call, deterministic and with
           dropout at two seeds and step offsets 0 and 64 from one program,
           frames and state equal to eager; (d) `AOTRuntime` of (a): flops
           within 1 % of 12 x K1's count plus the convs', memory, another
           shape refused; (e) (a) exported on the CPU and moved onto the card
           at load: 12 K1, (a)'s audio; (f) export and load seconds, the
           host ms of a call eager and exported.
The files of the families, serving, sv2tts, nvidia_import, fastspeech2,
training, transfer, gan and mesh phases go in one temporary directory, removed when they end (the transfer
phase's own root when it ends).  Then the kernel summary, the
card's name and power limit, and the result.
Any failure raises: the script then exits non-zero without a result line.
It needs a CUDA device and imports neither JAX nor the JAX package.
"""

import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_INT8_OPS = 1979e12       # H100 SXM dense int8
PEAK_F32_FLOPS = 67e12        # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
SMEM_BYTES_PER_CLOCK = 128    # shared memory read per SM and clock (Hopper)
BOOST_HZ = 1.98e9             # H100 SXM maximum SM clock


_START = time.perf_counter()


def emit(record):
    """Print `record` as a JSON line; a phase's record gains ``t_s``, the
    seconds since the script started."""
    if 'phase' in record:
        record = dict(record, t_s = time.perf_counter() - _START)
    print(json.dumps(record), flush = True)


def section_clock(sections):
    """``section(name)``: the seconds since the previous call (the first:
    since this one) into ``sections[name]``."""
    mark = [time.perf_counter()]

    def section(name):
        now = time.perf_counter()
        sections[name] = now - mark[0]
        mark[0] = now
    return section


def check(condition, message):
    if not condition:
        raise AssertionError(message)


def time_ms(fn, *, reps = 7, warmup = 2):
    """Median of `reps` timed calls (CUDA events), each after evicting the
    L2 cache, as the main path meets every flow's weights cold."""
    flush = torch.empty(256 * 2 ** 20, dtype = torch.uint8, device = 'cuda')
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing = True)
        end = torch.cuda.Event(enable_timing = True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def smi_sample():
    """The SM clock (MHz), power draw (W) and temperature, from nvidia-smi."""
    out = subprocess.run(['nvidia-smi', '--query-gpu=clocks.sm,power.draw,temperature.gpu',
                          '--format=csv,noheader,nounits'],
                         capture_output = True, text = True, check = True).stdout
    sm, power, temp = (float(v) for v in out.strip().splitlines()[0].split(','))
    return {'sm_clock_mhz': sm, 'power_w': power, 'temperature_c': temp}


def clocks_under(fn):
    """nvidia-smi's readings just after a kernel's timed runs, 0.15 s into
    0.3 s of its calls back to back (taken from a second thread: the host
    blocks once the launch queue is full, so the card stays busy), and
    after."""
    clocks = {'before': smi_sample()}
    sampler = threading.Timer(0.15, lambda: clocks.update(during = smi_sample()))
    sampler.start()
    start = time.perf_counter()
    while time.perf_counter() - start < 0.3:
        fn()
    sampler.join()
    torch.cuda.synchronize()
    clocks['after'] = smi_sample()
    return clocks


def waves(tiles):
    """Tiles over the card's SMs: {name: tiles / SMs} of one layer."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {name: n / sms for name, n in tiles.items()}


def ptxas_report(name):
    """{kernel: {'registers', 'spill_bytes', 'serialized'}} of library
    `name` from its nvcc -Xptxas -v output (empty when it was not built in
    this run)."""
    from text_to_speech_tpu_torch.ops import _build
    out, kernel = {}, None
    for line in _build.build_logs.get(name, '').splitlines():
        found = re.search(r"Compiling entry function '(\w+)'", line)
        if found:
            kernel = found.group(1)
            out[kernel] = {'registers': None, 'spill_bytes': 0, 'serialized': False}
        elif kernel is not None:
            used = re.search(r'Used (\d+) registers', line)
            spill = re.search(r'(\d+) bytes spill stores', line)
            if used: out[kernel]['registers'] = int(used.group(1))
            if spill: out[kernel]['spill_bytes'] = int(spill.group(1))
        if 'wgmma.mma_async instructions are serialized' in line:
            found = re.search(r"function '(\w+)'", line)
            if found and found.group(1) in out: out[found.group(1)]['serialized'] = True
    return out


def cuobjdump():
    """The toolkit's cuobjdump, or the copy bundled with Triton."""
    import shutil
    for path in (shutil.which('cuobjdump'),
                 os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'), 'bin', 'cuobjdump')):
        if path and os.path.exists(path):
            return path
    try:
        import triton
        path = os.path.join(os.path.dirname(triton.__file__), 'backends', 'nvidia', 'bin',
                            'cuobjdump')
        if os.path.exists(path):
            return path
    except ImportError:
        pass
    raise RuntimeError('cuobjdump not found (CUDA toolkit or Triton)')


def sass_check():
    """The SASS of the built wgmma libraries: K1's and K4's bf16 kernels must
    hold HGMMA (wgmma) and UTMALDG (TMA loads), K2's GEMMs IGMMA and UTMALDG,
    K5's int8 instantiation IGMMA and its bf16 one HGMMA, both UTMALDG (the
    multicast loads of w).  Kernels are found by a piece of their mangled
    name (`ILb1E`: the template argument true)."""
    from text_to_speech_tpu_torch.ops import _build
    wanted = [('wn_block', ('wn_in_wgmma', 'wn_rs_wgmma'), ('HGMMA', 'UTMALDG')),
              ('wn_block_int8', ('in_wgmma', 'rs_wgmma'), ('IGMMA', 'UTMALDG')),
              ('wn_layer', ('wn_in_wgmma', 'wn_rs_wgmma'), ('HGMMA', 'UTMALDG')),
              ('matmul_rate', ('rate_wgmmaILb1E',), ('IGMMA', 'UTMALDG')),
              ('matmul_rate', ('rate_wgmmaILb0E',), ('HGMMA', 'UTMALDG'))]
    report = {}
    for lib, kernels, opcodes in wanted:
        sass = subprocess.run([cuobjdump(), '--dump-sass', _build._paths(lib)[1]],
                              capture_output = True, text = True, check = True).stdout
        functions = re.split(r'\n\s*Function : ', sass)[1:]
        for kernel in kernels:
            bodies = [f for f in functions if kernel in f.split('\n', 1)[0]]
            counts = {op: sum(f.count(op) for f in bodies) for op in opcodes}
            report['{}:{}'.format(lib, kernel)] = dict(counts, functions = len(bodies))
            check(bodies and all(all(op in f for op in opcodes) for f in bodies),
                  'SASS of {} in lib{}.so lacks {}: {}'.format(kernel, lib, opcodes, counts))
    return report


def wn_block_phase(shapes = None, label = 'fused_wn_block', clocks = True):
    """K1 against its plain version: by default at the Tacotron-2 cells'
    shapes (below), else at `shapes`, ((dtype, B, T), ...), each timed
    (with `clocks`, nvidia-smi's readings under the bf16 cases too).
    Emits the cases under `label` and returns them."""
    from text_to_speech_tpu_torch.ops.wn_block import (
        fused_wn_block, grid_tiles, l2_bytes, pack_wn_weights, wn_block_plain, wn_block_work)

    C, L, S = 512, 8, 640
    rng = np.random.default_rng(0)

    def inputs(B, T, dtype):
        f = lambda * shape, scale = 1.: torch.from_numpy(
            (scale * rng.standard_normal(shape)).astype(np.float32)).cuda()
        packed = pack_wn_weights(
            f(L, S, 2 * C, scale = S ** -0.5), f(L, 2 * C, scale = 0.1),
            f(L, 3, C, 2 * C, scale = (3 * C) ** -0.5), f(L, 2 * C, scale = 0.1),
            f(L - 1, C, 2 * C, scale = C ** -0.5), f(L - 1, 2 * C, scale = 0.1),
            f(C, C, scale = C ** -0.5), f(C, scale = 0.1), dtype = dtype)
        args = (f(B, T, C).to(dtype), f(B, T, S).to(dtype), packed['w_in_cond'],
                packed['b_in_cond'], packed['w_rs'], packed['b_rs'],
                packed['w_rs_last'], packed['b_rs_last'])
        return args

    # (dtype, error bound relative to the output's largest magnitude): f32
    # FMA tiles against f32 cuBLAS differ in summation order only; bf16
    # rounds gated activations and the residual stream every layer, where
    # another f32 summation order can flip a bf16 rounding.  Shapes: one
    # 256-frame utterance (B=1, T=8192), a ragged length, the batch of four
    # (B=4: rows of one utterance must not tap the next), the training
    # batch (B=8), where `wn_train_fused` launches it, and in bf16 a batch of
    # 32 windows of 128 frames (B=32, T=4096), the long text's window batch.
    tolerance = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    timed = lambda T: True
    if shapes is None:
        shapes = [(dtype, B, T) for dtype in tolerance
                  for B, T in ((1, 8192), (1, 8000), (4, 8192), (8, 8192))
                  + (((32, 4096),) if dtype == torch.bfloat16 else ())]
        timed = lambda T: T in (8192, 4096)
    cases = {}
    for dtype, B, T in shapes:
        rel_tol, name = tolerance[dtype], str(dtype).split('.')[-1]
        args = inputs(B, T, dtype)
        out = fused_wn_block(* args)
        torch.cuda.synchronize()
        ref = wn_block_plain(* args)
        check(out.shape == (B, T, C) and out.dtype == dtype, 'wn_block output shape')
        check(bool(torch.isfinite(out.float()).all()), 'wn_block output not finite')
        err = float((out.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        case = {'dtype': name, 'B': B, 'T': T, 'max_abs_err': err, 'max_rel_err': err / scale,
                'tolerance_rel': rel_tol}
        if timed(T):
            flops, nbytes = wn_block_work(B, T, C, S, L, args[0].element_size())
            peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
            case.update(
                kernel_ms = time_ms(lambda: fused_wn_block(* args)),
                # the plain version is 10-150 ms a call: 3 after a warm-up
                plain_ms = time_ms(lambda: wn_block_plain(* args), reps = 3, warmup = 1),
                flops = flops, bytes = nbytes,
                bound_ms = 1e3 * max(flops / peak, nbytes / PEAK_BYTES),
                bound_by = 'operations' if flops / peak > nbytes / PEAK_BYTES
                else 'bytes')
        if dtype == torch.bfloat16 and timed(T):
            # the wgmma kernels: L2 bytes by their tiling, waves on the SMs
            case.update(l2_bytes = l2_bytes(B, T, C, S, L),
                        waves = waves(grid_tiles(B, T, C)))
            if clocks:
                case['clocks'] = clocks_under(lambda: fused_wn_block(* args))
            case['l2_bytes_per_s'] = case['l2_bytes'] / (case['kernel_ms'] * 1e-3)
        cases['{}_B{}_T{}'.format(name, B, T)] = case
        check(err <= rel_tol * scale,
              'wn_block {} B={} T={}: max abs err {} > {} x {}'.format(
                  name, B, T, err, rel_tol, scale))
        del args, out, ref
    emit({'phase': 'kernels', label: cases,
          'shape': {'C': C, 'S': S, 'L': L}, 'ptxas': ptxas_report('wn_block'),
          'library_ms': None,
          'library_note': 'no single PyTorch call computes the WN block'})
    return cases


def wn_layer_work(B, T, C, residual, itemsize):
    """(operations, bytes) of one WN layer call: both products, each input
    (x, cond, weights, biases) read once and each output written once."""
    N = 2 * C if residual else C
    flops = 2 * B * T * (3 * C * 2 * C + C * N)
    weights = (3 * C * 2 * C + C * N + 2 * C + N) * itemsize
    activations = B * T * (C + 2 * C + (2 * C if residual else C)) * itemsize
    return flops, weights + activations


def wn_layer_phase():
    """K4 against its plain version: float32 and bfloat16, the training
    batch (B=8) and one utterance (B=1) at T=8192 and a ragged T=8000,
    dilations 1, 16, 128 and 200 (beyond a 128-row tile, no power of two),
    residual and last layer; for the timed bf16 cases the L2 bytes by the
    tiling, the waves, the clocks and the share of the bound."""
    from text_to_speech_tpu_torch.ops.wn_layer import (
        fused_wn_layer, grid_tiles, l2_bytes, wn_layer_plain)

    C = 512
    rng = np.random.default_rng(6)
    f = lambda * shape, scale = 1.: torch.from_numpy(
        (scale * rng.standard_normal(shape)).astype(np.float32)).cuda()
    # Tolerances, relative to the output's largest magnitude: float32 FMA
    # tiles against float32 cuBLAS differ in summation order only (1e-5);
    # bf16 against a plain version with the same dtype contract (bf16
    # operands and gate, float32 sums, bf16 outputs): a sum in another order
    # can flip one bf16 rounding of the gate, which moves an output by far
    # less than it, or of an output, 2^-8 of a value: 2^-7.
    tolerance = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}
    cases = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split('.')[-1]
        for B, T in ((8, 8192), (1, 8192), (1, 8000)):
            x, cond = f(B, T, C).to(dtype), f(B, T, 2 * C, scale = 0.5).to(dtype)
            w_in = f(3, C, 2 * C, scale = (3 * C) ** -0.5).to(dtype)
            b_in = f(2 * C, scale = 0.1).to(dtype)
            for residual in (True, False):
                N = 2 * C if residual else C
                w_rs = f(1, C, N, scale = C ** -0.5).to(dtype)
                b_rs = f(N, scale = 0.1).to(dtype)
                args = (x, cond, w_in, b_in, w_rs, b_rs)
                for dilation in (1, 16, 128, 200):
                    kw = dict(dilation = dilation, residual = residual)
                    out = fused_wn_layer(* args, ** kw)
                    torch.cuda.synchronize()
                    ref = wn_layer_plain(* args, ** kw)
                    errs = []
                    for o, r in zip(out, ref):
                        check(o.shape == (B, T, C) and o.dtype == dtype, 'wn_layer output shape')
                        check(bool(torch.isfinite(o.float()).all()), 'wn_layer output not finite')
                        errs.append((float((o.float() - r.float()).abs().max()),
                                     float(r.float().abs().max())))
                    case = {'dtype': name, 'B': B, 'T': T, 'dilation': dilation,
                            'residual': residual,
                            'max_abs_err': max(e for e, _ in errs),
                            'max_rel_err': max(e / m for e, m in errs),
                            'tolerance_rel': tolerance[dtype]}
                    if T == 8192 and dilation == 1 and residual:
                        flops, nbytes = wn_layer_work(B, T, C, residual, x.element_size())
                        peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
                        case.update(
                            kernel_ms = time_ms(lambda: fused_wn_layer(* args, ** kw)),
                            plain_ms = time_ms(lambda: wn_layer_plain(* args, ** kw),
                                               reps = 3, warmup = 1),
                            flops = flops, bytes = nbytes,
                            bound_ms = 1e3 * max(flops / peak, nbytes / PEAK_BYTES),
                            bound_by = 'operations' if flops / peak > nbytes / PEAK_BYTES
                            else 'bytes')
                    if 'kernel_ms' in case and dtype == torch.bfloat16:
                        # the wgmma kernels: L2 bytes by their tiling, waves on the SMs
                        case.update(l2_bytes = l2_bytes(B, T, C, residual),
                                    waves = waves(grid_tiles(B, T, C, residual)),
                                    clocks = clocks_under(lambda: fused_wn_layer(* args, ** kw)))
                        case['l2_bytes_per_s'] = case['l2_bytes'] / (case['kernel_ms'] * 1e-3)
                        case['share_of_bound'] = case['bound_ms'] / case['kernel_ms']
                    key = '{}_B{}_T{}_d{}_{}'.format(name, B, T, dilation,
                                                    'residual' if residual else 'last')
                    cases[key] = case
                    check(case['max_rel_err'] <= tolerance[dtype],
                          'wn_layer {}: {}'.format(key, case))
                    del out, ref
            del x, cond, args
    emit({'phase': 'kernels', 'fused_wn_layer': cases, 'shape': {'C': C},
          'ptxas': ptxas_report('wn_layer'), 'library_ms': None,
          'library_note': 'no single PyTorch call computes the WN layer'})
    return cases


def wn_block_int8_phase(shapes = None, label = 'fused_wn_block_int8'):
    """K2 against its plain version at the main path's shapes: bf16 buffers
    at one utterance, a ragged length and the batch of four, one float32
    case and one with the static gate scale; or, when given, at `shapes`,
    ((B, T), ...) with bf16 buffers, each timed.  Emits the cases under
    `label` and returns them."""
    from text_to_speech_tpu_torch.ops import wn_block_int8 as module
    from text_to_speech_tpu_torch.ops.wn_block_int8 import (
        fused_wn_block_int8, grid_tiles, l2_bytes, pack_wn_int8, quantize_wn_weights,
        wn_block_int8_plain, wn_block_int8_work)

    C, L, S = 512, 8, 640
    rng = np.random.default_rng(4)
    f = lambda * shape, scale = 1.: torch.from_numpy(
        (scale * rng.standard_normal(shape)).astype(np.float32)).cuda()
    q = pack_wn_int8(quantize_wn_weights(dict(
        w_cond = f(L, S, 2 * C, scale = S ** -0.5), b_cond = f(L, 2 * C, scale = 0.1),
        w_in = f(L, 3, C, 2 * C, scale = (3 * C) ** -0.5), b_in = f(L, 2 * C, scale = 0.1),
        w_rs = f(L - 1, C, 2 * C, scale = C ** -0.5), b_rs = f(L - 1, 2 * C, scale = 0.1),
        w_rs_last = f(C, C, scale = C ** -0.5), b_rs_last = f(C, scale = 0.1))))

    # The kernel must equal its plain version to the bit: the integer sums
    # are exact on both sides, every scale product is rounded in the same
    # order, the row maxima are maxima and the gate takes the same device
    # functions as PyTorch's.  The tolerances below, relative to the
    # output's largest magnitude, are what the control must miss: a value
    # on a rounding tie of its row's int8 grid moves one product by a grid
    # step; in bf16 that can flip one rounding of the stored stream and one
    # of the output, 2^-8 of a value each: max 2^-7 (bf16), 1e-3 (float32),
    # mean 1e-6, under the JAX package's own max 1e-2 and mean 1e-5
    # (tests/test_pallas.py).  The control: the plain version with every
    # float32 tensor it quantizes rounded to bf16 first (the next layer's x
    # from the stored stream, not the float32 sum, and the gate as bf16).
    mean_tol = 1e-6
    specs = (('bfloat16_B1_T8192', 1, 8192, torch.bfloat16, False),
             ('bfloat16_B1_T8000', 1, 8000, torch.bfloat16, False),
             ('bfloat16_B4_T8192', 4, 8192, torch.bfloat16, False),
             ('bfloat16_B32_T4096', 32, 4096, torch.bfloat16, False),   # the window batch
             ('float32_B1_T8192', 1, 8192, torch.float32, False),
             ('bfloat16_B1_T8192_static_gate', 1, 8192, torch.bfloat16, True))
    timed = lambda B, T, dtype: T in (8192, 4096) and (dtype == torch.bfloat16 or B == 1)
    if shapes is not None:
        specs = [('bfloat16_B{}_T{}'.format(B, T), B, T, torch.bfloat16, False)
                 for B, T in shapes]
        timed = lambda B, T, dtype: True
    cases = {}
    for name, B, T, dtype, static in specs:
        x, spect = f(B, T, C).to(dtype), f(B, T, S).to(dtype)
        out = fused_wn_block_int8(x, spect, q, static)
        torch.cuda.synchronize()
        ref = wn_block_int8_plain(x, spect, q, static)
        check(out.shape == (B, T, C) and out.dtype == dtype, 'wn_block_int8 output shape')
        check(bool(torch.isfinite(out.float()).all()), 'wn_block_int8 output not finite')
        err = (out.float() - ref.float()).abs()
        scale = float(ref.float().abs().max())
        max_tol = 2 ** -7 if dtype == torch.bfloat16 else 1e-3
        case = {'dtype': str(dtype).split('.')[-1], 'B': B, 'T': T, 'static_gate_scale': static,
                'equal': bool(torch.equal(out, ref)),
                'max_abs_err': float(err.max()), 'max_rel_err': float(err.max()) / scale,
                'mean_rel_err': float(err.mean()) / scale, 'scale': scale,
                'tolerance_max_rel': max_tol, 'tolerance_mean_rel': mean_tol}
        if name == 'bfloat16_B1_T8192':
            row_quant = module._row_quant
            module._row_quant = lambda t: row_quant(t.to(torch.bfloat16).float())
            try:
                ctrl = (wn_block_int8_plain(x, spect, q, static).float() - ref.float()).abs()
            finally:
                module._row_quant = row_quant
            case['control'] = {'what': 'plain version quantizing bf16-rounded tensors',
                               'max_rel_err': float(ctrl.max()) / scale,
                               'mean_rel_err': float(ctrl.mean()) / scale}
            check(case['control']['max_rel_err'] > max_tol
                  or case['control']['mean_rel_err'] > mean_tol,
                  'wn_block_int8: the control meets the limits: {}'.format(case))
            del ctrl
        if timed(B, T, dtype):
            ops, nbytes = wn_block_int8_work(B, T, C, S, L, x.element_size())
            case.update(
                kernel_ms = time_ms(lambda: fused_wn_block_int8(x, spect, q, static)),
                plain_ms = time_ms(lambda: wn_block_int8_plain(x, spect, q, static),
                                   reps = 3, warmup = 1),
                ops = ops, bytes = nbytes,
                bound_ms = 1e3 * max(ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES),
                bound_by = 'operations' if ops / PEAK_INT8_OPS > nbytes / PEAK_BYTES
                else 'bytes',
                l2_bytes = l2_bytes(B, T, C, S, L, x.element_size(), static),
                waves = waves(grid_tiles(B, T, C)),
                clocks = clocks_under(lambda: fused_wn_block_int8(x, spect, q, static)))
            case['l2_bytes_per_s'] = case['l2_bytes'] / (case['kernel_ms'] * 1e-3)
        cases[name] = case
        check(case['equal'], 'wn_block_int8 {} differs from its plain version: {}'.format(
            name, case))
        del x, spect, out, ref, err
    emit({'phase': 'kernels', label: cases,
          'shape': {'C': C, 'S': S, 'L': L}, 'ptxas': ptxas_report('wn_block_int8'),
          'library_ms': None,
          'library_note': 'no single PyTorch call computes the int8 WN block'})
    return cases


def decoder_steps_work(weights, B, S, K, itemsize, peak):
    """(least seconds for the operations, bytes, weight bytes) of one launch
    of K decoder steps: every product of every step (`decoder_steps_ops`,
    the op's flop formula), the LSTM products at
    the int8 rate when their weights are int8 and the rest at `peak`; each
    input read once and each output written once (state in and out, frames
    and alignments out)."""
    from text_to_speech_tpu_torch.ops.decoder_kernel import decoder_steps_ops
    n_mel, P0 = weights['w0'].shape
    P1 = weights['w1'].shape[1]
    U, A = weights['q_w'].shape
    D = weights['proj_w'].shape[0] - U
    other, lstm = decoder_steps_ops(B, S, K, n_mel, P0, P1, U, A, D)
    lstm_peak = PEAK_INT8_OPS if weights['att_w'].dtype == torch.int8 else peak
    ops_s = other / peak + lstm / lstm_peak
    matrices = sum(weights[k].numel() * weights[k].element_size() for k in
                   ('w0', 'w1', 'att_w', 'q_w', 'loc_w', 'dec_w', 'proj_w'))
    biases = sum(weights[k].numel() for k in ('b0', 'b1', 'att_b', 'v_w', 'dec_b', 'proj_b',
                                              's_att_w', 's_dec_w') if k in weights) * 4
    inputs = B * S * (D + A) * itemsize + B * S * 4 + B * 4 + B * P0 * 4 + 8
    state = B * (n_mel * 4 + 2 * U * (itemsize + 4) + D * itemsize + 2 * S * 4 + 4)
    outputs = K * B * (n_mel + 1 + S) * 4
    return ops_s, matrices + biases + inputs + 2 * state + outputs, matrices + biases


def int8_lockstep(key, steps, limit):
    """Summary and checks of one `int8_lstm_lockstep` trace (see the int8
    tolerance in `decoder_steps_phase`)."""
    held = [s for s in steps if s['grids_equal']]
    moved = [s for s in steps if not s['grids_equal']]
    control = [s['control_rel_err'] for s in held]
    path_moved = [s for s in steps if not s['path_grids_equal']]
    first = path_moved[0]['step'] if path_moved else None
    before = [s['path_rel_err'] for s in steps if first is None or s['step'] < first]
    out = {'steps': len(steps), 'grids_equal_steps': len(held),
           'max_rel_err_grids_equal': max(s['rel_err'] for s in held) if held else None,
           'control_rel_err_grids_equal': {'min': min(control), 'median':
                                           statistics.median(control), 'max': max(control)}
           if held else None,
           'steps_grids_differ': [s['step'] for s in moved],
           'rel_err_grids_differ': [s['rel_err'] for s in moved],
           'first_grid_difference': moved[0] if moved else None,
           'path_first_grid_difference': path_moved[0] if path_moved else None,
           'path_max_rel_err_before_it': max(before) if before else None,
           'path_max_rel_err': max(s['path_rel_err'] for s in steps)}
    check(len(held) >= len(steps) // 2, 'int8 lockstep {}: {}'.format(key, out))
    check(out['max_rel_err_grids_equal'] <= limit and max(control) > limit,
          'int8 lockstep {}: {}'.format(key, out))
    check(not before or max(before) <= limit, 'int8 lockstep {}: {}'.format(key, out))
    for s, prefix in [(s, '') for s in moved] + [(s, 'path_') for s in path_moved[:1]]:
        # the first LSTM whose int8 values moved: its rows differ by a
        # rounding, far under one grid step (1/127 of the amax), and no value
        # moves by two
        first = s.get(prefix + 'att', s.get(prefix + 'dec'))
        check(first['row_diff_rel_amax'] <= 1e-5 and first['max_grid_steps'] <= 1.,
              'int8 lockstep {} step {}: {}'.format(key, s['step'], s))
    return out


def decoder_steps_phase(model, *, speaker = None, shapes = None, name = 'decoder_steps'):
    """K3 against its plain version on `model`'s decoder at the main path's
    launches.  With `speaker` (B → a (B, spk) embedding on the card), the
    memory and the prenet addend ``extra`` are the speaker-conditioned ones
    `infer_fused` makes (`Tacotron2.prenet_addend`); `shapes`: the (B, S,
    window) cases of every mode, instead of the default ones."""
    from text_to_speech_tpu_torch.ops.decoder_kernel import (
        PHASES, decoder_steps, decoder_steps_plain, init_decoder_state, int8_lstm_lockstep,
        pack_decoder_weights, phase_times_us, quantize_lstm_weights, stamps_size)
    from text_to_speech_tpu_torch.weights import cast_tree

    arch, hp, K = model.arch, model.arch.hp, 64
    n_mel, U = hp.n_mel_channels, hp.attention_rnn_dim
    # token batches of the main path: one sentence, and four of unequal
    # length; S = 72 is no multiple of 64 and takes the attention window
    rng = np.random.default_rng(2)
    sentence = lambda n: rng.integers(1, hp.vocab_size, n)

    # packed here with the logical matrices, which the plain version reads
    # (the model keeps the kernel's layouts only)
    packed = {dtype: pack_decoder_weights(
        cast_tree(model.params['decoder'], dtype), n_mel = n_mel, dtype = dtype)
        for dtype in (torch.float32, torch.bfloat16)}
    # the int8 LSTM mode of `infer_fused(int8_lstm=True)`: float32 compute
    modes = (('float32', torch.float32, packed[torch.float32]),
             ('bfloat16', torch.bfloat16, packed[torch.bfloat16]),
             ('int8_lstm', torch.float32, quantize_lstm_weights(packed[torch.float32])))

    def inputs(B, S, dtype, weights):
        lengths = [S] if B == 1 else [S, S - 9, S - 23, S - 40][:B]
        tokens = np.zeros((B, S), np.int64)
        for i, n in enumerate(lengths):
            tokens[i, :n] = sentence(n)
        tokens = torch.from_numpy(tokens).cuda()
        params = cast_tree(model.params, dtype) if dtype != torch.float32 else model.params
        state = cast_tree(model.state, dtype) if dtype != torch.float32 else model.state
        spk = speaker(B).to(dtype) if speaker is not None else None
        with torch.no_grad():
            enc, enc_mask = arch.encode(params, state, tokens, speaker_embedding = spk)
            mem, pm = arch.process_memory(params['decoder'], enc, enc_mask)
            extra = arch.prenet_addend(params, spk, B, 'cuda')
        args = (weights, mem.contiguous(), pm.contiguous(), enc_mask.float(),
                enc_mask.sum(dim = 1).to(torch.int32), extra)
        fresh = lambda: init_decoder_state(B, S, mem.shape[-1], U, n_mel, dtype, 'cuda')
        return args, fresh

    seed = torch.tensor([20261016], dtype = torch.int64, device = 'cuda')
    # Tolerances, relative to the largest magnitude of each compared tensor
    # (frames and gates, alignments, and every state tensor).  float32: the
    # kernel and the plain version sum the same products in another order
    # and take expf and tanhf from another library; over 64 autoregressive
    # steps that stays near 1e-6 (measured on an H100: 3e-7), 1e-4 leaves
    # room and a wrong index misses it by orders of magnitude.  bfloat16: h
    # and ctx round to 8 bits of mantissa every step, so another float32
    # sum flips single roundings that the next
    # steps carry on: one rounding is up to 2^-7 = 7.8e-3 of a value
    # (measured 5.7e-3 on the state, 2.9e-3 on the frames); 2e-2 is 2.5
    # roundings.  int8 LSTM mode (float32 compute): the integer sums are
    # exact on both sides and the scales apply in the same order, so it is
    # held as float32 is, wherever both sides' LSTM input rows quantize to
    # the same int8 values (row scales a rounding apart are float32 noise).  A staged value that differs by a rounding (the
    # prenet's and the attention's sums run in another order) can cross a
    # rounding tie of its grid and move one product by a grid step, which
    # the next steps carry on.  So with dropout each case is also held step
    # by step (`int8_lstm_lockstep`), from the same state on both sides:
    # every step whose int8 values agree within 1e-4, every step whose
    # values differ (at most half) only where the staged rows differ by a
    # rounding and by one grid step; and the float32-LSTM kernel on the same
    # inputs (the control) must miss 1e-4.  Along the two decodes, every
    # step before the first that moves an int8 value is held at 1e-4, and
    # that first one as above.
    tolerance = {'float32': 1e-4, 'bfloat16': 2e-2, 'int8_lstm': 1e-4}

    def rel_err(out, ref):
        out, ref = out.float(), ref.float()
        return float((out - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)

    cases = {}
    for mode, dtype, weights in modes:
        # float32 also at S = 256, where the attention takes more items
        mode_shapes = shapes or ((1, 64, False), (4, 64, False), (2, 72, True)) \
            + (((1, 256, False),) if mode == 'float32' else ())
        for B, S, window in mode_shapes:
            args, fresh = inputs(B, S, dtype, weights)
            for deterministic in (True, False):
                kw = dict(n_steps = K, deterministic = deterministic, use_window = window,
                          win_len = 16, win_offset = 8, drop_rate = float(hp.prenet_drop_rate))
                st = fresh()
                steps, attn, _ = decoder_steps(* args, st, seed, ** kw)
                torch.cuda.synchronize()
                ref_st = fresh()
                # the reference call is the plain version's timing too: it
                # is host-bound (0.4-0.9 s a launch's worth), one call
                ref_start = torch.cuda.Event(enable_timing = True)
                ref_end = torch.cuda.Event(enable_timing = True)
                ref_start.record()
                ref_steps, ref_attn, _ = decoder_steps_plain(* args, ref_st, seed, ** kw)
                ref_end.record()
                ref_end.synchronize()
                check(steps.shape == (K, B, n_mel + 1) and attn.shape == (K, B, S),
                      'decoder_steps output shape')
                check(bool(torch.isfinite(steps).all() and torch.isfinite(attn).all()),
                      'decoder_steps output not finite')
                err = float((steps - ref_steps).abs().max())
                rel = {'steps': rel_err(steps, ref_steps), 'attn': rel_err(attn, ref_attn)}
                keys = ('h_att', 'c_att', 'h_dec', 'c_dec', 'ctx', 'prev', 'cum')
                rel.update({k: rel_err(st[k], ref_st[k]) for k in keys})
                case = {'dtype': mode, 'B': B, 'S': S, 'K': K, 'window': window,
                        'dropout': not deterministic, 'max_abs_err': err,
                        'frame_scale': float(ref_steps[..., :n_mel].abs().max()),
                        'rel_err': rel, 'max_rel_err': max(rel.values()),
                        'tolerance_rel': tolerance[mode]}
                key = '{}_B{}_S{}_{}'.format(mode, B, S, 'dropout' if not deterministic else 'det')
                cases[key] = case
                if speaker is not None and deterministic and 'prenet' in arch.concat_pos:
                    # the addend is in use: the kernel without it misses the limit
                    zero_extra = args[:5] + (torch.zeros_like(args[5]),)
                    case['extra_max_abs'] = float(args[5].abs().max())
                    case['without_extra_rel_err'] = rel_err(
                        decoder_steps(* zero_extra, fresh(), seed, ** kw)[0], ref_steps)
                    check(case['without_extra_rel_err'] > tolerance[mode],
                          'decoder_steps {}: the addend moves nothing: {}'.format(key, case))
                if mode == 'int8_lstm':
                    # the control: the float32-LSTM kernel on the same inputs
                    ctrl_st = fresh()
                    ctrl = decoder_steps(packed[torch.float32], * args[1:], ctrl_st, seed, ** kw)
                    case['control_max_rel_err'] = max(
                        [rel_err(ctrl[0], ref_steps), rel_err(ctrl[1], ref_attn)]
                        + [rel_err(ctrl_st[k], ref_st[k]) for k in keys])
                    check(case['control_max_rel_err'] > tolerance[mode],
                          'decoder_steps {}: the control meets the limit: {}'.format(key, case))
                    # with dropout the decode carries a moved value on (traced
                    # below), but stays nearer the int8 plain version than the
                    # float32 LSTM does
                    check(case['max_rel_err'] < case['control_max_rel_err'],
                          'decoder_steps {}: not under the control: {}'.format(key, case))
                # a deterministic int8 decode meets rounding ties too, as the
                # data has them (B=4 at D=768 here, and at D=512 with other
                # tokens): past the limit it is held step by step as well, and
                # a moved int8 value must be what put it there
                tie = mode == 'int8_lstm' and deterministic \
                    and case['max_rel_err'] > tolerance[mode]
                if mode == 'int8_lstm' and (tie or not deterministic):
                    trace, frames = int8_lstm_lockstep(
                        * args, fresh(), seed, control = packed[torch.float32], ** kw)
                    check(torch.equal(frames, steps),
                          'decoder_steps {}: 64 launches of one step differ from one of 64'
                          .format(key))
                    case['lockstep'] = int8_lockstep(key, trace, tolerance[mode])
                    check(not tie or case['lockstep']['path_first_grid_difference'] is not None,
                          'decoder_steps {}: past the limit with no int8 value moved: {}'
                          .format(key, case))
                else:
                    check(torch.equal(st['main'], ref_st['main']), 'decoder_steps argmax differs')
                    check(case['max_rel_err'] <= tolerance[mode],
                          'decoder_steps {}: relative errors {} > {}'.format(
                              key, rel, tolerance[mode]))
                if not window and not deterministic:
                    # the main path's mode: dropout on.  Two launches of 32
                    # steps must equal one of 64 to the bit (same products,
                    # same order, the dropout keyed by the absolute step)
                    st = fresh()
                    half = dict(kw, n_steps = K // 2)
                    a = decoder_steps(* args, st, seed, ** half)[0]
                    b = decoder_steps(* args, st, seed, step0 = K // 2, ** half)[0]
                    check(torch.equal(torch.cat([a, b]), steps),
                          'decoder_steps {}: 2 x 32 steps differ from 64'.format(key))
                    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
                    ops_s, nbytes, weight_bytes = decoder_steps_work(
                        args[0], B, S, K, args[1].element_size(), peak)
                    st = fresh()
                    kernel_ms = time_ms(lambda: decoder_steps(* args, st, seed, ** kw))
                    plain_ms = ref_start.elapsed_time(ref_end)
                    # where a step's time goes: the kernel's own clock stamps
                    stamps = torch.zeros((stamps_size(K),), dtype = torch.int64, device = 'cuda')
                    decoder_steps(* args, st, seed, stamps = stamps, ** kw)
                    torch.cuda.synchronize()
                    times = phase_times_us(stamps)
                    case['phase_us'] = {
                        kind: dict(zip(PHASES, spans.median(dim = 0).values.tolist()))
                        for kind, spans in times.items()}
                    # the shared-memory plan: what stays resident, what streams
                    plan = decoder_steps.last_plan
                    sms = torch.cuda.get_device_properties(0).multi_processor_count
                    resident = plan['resident_bytes_per_block'] * plan['slab_blocks']
                    streamed = weight_bytes - resident
                    case.update(
                        chunked_equal = True, kernel_ms = kernel_ms,
                        us_per_step = 1e3 * kernel_ms / K, plain_ms = plain_ms,
                        ops_ms = 1e3 * ops_s, bytes = nbytes,
                        bound_ms = 1e3 * max(ops_s, nbytes / PEAK_BYTES),
                        bound_by = 'operations' if ops_s > nbytes / PEAK_BYTES else 'bytes',
                        plan = plan,
                        # the steps are serial; each reads every weight: the
                        # resident ones from shared memory, the rest (the
                        # slabs' streamed rows and the row phases' weights)
                        # from device memory
                        serial_floor_ms = 1e3 * K * max(
                            streamed / PEAK_BYTES,
                            resident / (sms * SMEM_BYTES_PER_CLOCK * BOOST_HZ)),
                        # the floor if every weight came from device memory every step
                        serial_floor_all_streamed_ms = 1e3 * K * weight_bytes / PEAK_BYTES)
                    if key == 'float32_B1_S64_dropout' and speaker is None:
                        case['clocks'] = clocks_under(
                            lambda: decoder_steps(* args, st, seed, ** kw))
            del args, fresh
    emit({'phase': 'kernels', name: cases,
          'ptxas': ptxas_report('decoder_steps'),
          'shape': {'P': list(hp.prenet_sizes), 'U': U, 'D': arch.encoder_output_dim,
                    'A': hp.lsa_attention_dim, 'n_mel': n_mel},
          'library_ms': None,
          'library_note': 'no single PyTorch call computes K decoder steps'})
    return cases


WAVS = 'pretrained_models/overfit_demo*/predictions/overfit/*.wav'


def matmul_rate_library(x, w, reps, grid):
    """The yardstick: the grid's repeats stacked as rows (32,768 at the
    probe's shapes), REPS PyTorch products (`torch._int_mm` int8 → int32,
    `matmul` bf16 → bf16, which rounds its output) with the same feedback,
    captured in one CUDA graph so that launches do not set the pace.
    Returns (replay, output of the capture)."""
    int8 = x.dtype == torch.int8
    K = x.shape[1]
    x_all = x.repeat(grid, 1)

    def run():
        acc = torch.zeros((x_all.shape[0], w.shape[-1]), device = 'cuda',
                          dtype = torch.int32 if int8 else torch.float32)
        xs = x_all
        for r in range(reps):
            acc += torch._int_mm(xs, w[r % 8]) if int8 else torch.matmul(xs, w[r % 8])
            xs = (acc[:, :K] & 127).to(torch.int8) if int8 else acc[:, :K].to(torch.bfloat16)
        return acc

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run()
    return graph.replay, out


def matmul_rate_phase():
    """K5 against its plain version at the probe's shapes (M = K = 512,
    N = 1024, REPS = GRID = 64) and a small one, with its time, rate, L2
    bytes and the library yardstick; then the probe's main path."""
    from text_to_speech_tpu_torch.ops import matmul_rate as module
    from text_to_speech_tpu_torch.ops.matmul_rate import (
        cluster_shape, l2_bytes, matmul_rate, matmul_rate_plain, max_clusters,
        product_times_us, ring_stages, shared_bytes, stamps_size)

    M, K, N, reps, grid = 512, 512, 1024, 64, 64
    rng = np.random.default_rng(8)

    def inputs(dtype, M, K, N):
        # int8 over its whole range (exact in int32: K * 128 * 128 * 64 < 2^31);
        # bf16 x ~ N(0, 1), w ~ N(0, 0.25 / K): the chain grows by about
        # sqrt(1.25) a product and stays finite over 64 (the probe's own
        # ones and 0.01 overflow to inf at the 49th)
        if dtype == torch.int8:
            return (torch.from_numpy(rng.integers(-128, 128, (M, K)).astype(np.int8)).cuda(),
                    torch.from_numpy(rng.integers(-128, 128, (8, K, N)).astype(np.int8)).cuda())
        return (torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).cuda()
                .to(dtype),
                torch.from_numpy((0.5 / np.sqrt(K) * rng.standard_normal((8, K, N)))
                                 .astype(np.float32)).cuda().to(dtype))

    def errs(out, ref):
        diff = (out.double() - ref.double()).abs()
        scale = float(ref.double().abs().max())
        return float(diff.max()), float(diff.max()) / scale, float(diff.mean()) / scale

    # Tolerances, relative to the output's largest magnitude (max, mean).
    # int8: exact in int32 on both sides, so equal to the bit.  bf16: both
    # sum exact products of bf16 values in float32, in another order (the
    # tensor cores add into acc as they go), and round acc to bf16 at every
    # feedback; the chain carries every flipped rounding on.  One product,
    # no rounding to bf16 yet: the float32 sums alone, 1e-5 and 1e-6.  Over
    # 64 products: 1e-2 and 1e-3 (two other float32 orders of the plain
    # version, on the CPU at these shapes: 3.2e-3 and 3.6e-3, 3.5e-4 and
    # 3.8e-4 on average, benchmarks/torch_port_bf16_chain.py; the kernel on
    # an H100: 3.3e-3, 4.3e-4).  Over 4
    # products: 2e-3 and 5e-5 (other orders on the CPU 3.9e-4, 1.3e-6; the
    # kernel on an H100 5.9e-4, 8.5e-6), which the control, the feedback
    # left in float32, must miss (1.2e-3, 2.1e-4).
    one, long, short = (1e-5, 1e-6), (1e-2, 1e-3), (2e-3, 5e-5)
    cases = {}
    for name, dtype in (('int8', torch.int8), ('bfloat16', torch.bfloat16)):
        for shape in ((M, K, N, reps, grid), (64, 64, 128, 10, 2)):
            m, k, n, r, g = shape
            x, w = inputs(dtype, m, k, n)
            out = matmul_rate(x, w, r, g)
            torch.cuda.synchronize()
            ref = matmul_rate_plain(x, w, r, g)
            check(out.shape == (m, n) and out.dtype == ref.dtype, 'matmul_rate output')
            check(bool(torch.isfinite(out.float()).all()), 'matmul_rate output not finite')
            err, max_rel, mean_rel = errs(out, ref)
            case = {'dtype': name, 'M': m, 'K': k, 'N': n, 'reps': r, 'grid': g,
                    'max_abs_err': err, 'max_rel_err': max_rel, 'mean_rel_err': mean_rel,
                    'tolerance_rel': 0. if dtype == torch.int8 else long}
            key = '{}_M{}_reps{}'.format(name, m, r)
            cases[key] = case
            if dtype == torch.int8:
                check(torch.equal(out, ref), 'matmul_rate {}: {}'.format(key, case))
            else:
                check(max_rel <= long[0] and mean_rel <= long[1],
                      'matmul_rate {}: {}'.format(key, case))
            if m != M:
                continue
            itemsize = x.element_size()
            ops = 2 * M * K * N * reps * grid
            nbytes = M * K * itemsize + 8 * K * N * itemsize + M * N * 4
            peak = PEAK_INT8_OPS if dtype == torch.int8 else PEAK_BF16_FLOPS
            case['kernel_ms'] = time_ms(lambda: matmul_rate(x, w, reps, grid))
            clocks = clocks_under(lambda: matmul_rate(x, w, reps, grid))
            case['plain_ms'] = time_ms(lambda: matmul_rate_plain(x, w, reps, grid),
                                       reps = 3, warmup = 1)
            replay, lib = matmul_rate_library(x, w, reps, grid)
            case['library_ms'] = time_ms(replay)
            lib_err = errs(lib[:M].float(), ref.float())
            case['library'] = {
                'what': '{} REPS products on 32,768 stacked rows, one CUDA graph'.format(
                    'torch._int_mm' if dtype == torch.int8 else 'torch.matmul (bf16 output)'),
                'max_rel_err_vs_plain': lib_err[1], 'mean_rel_err_vs_plain': lib_err[2]}
            del lib, replay
            l2 = l2_bytes(M, K, N, reps, grid, itemsize)
            R, P = cluster_shape(M, N, grid)
            clusters, resident = grid * M // 64 // R, max_clusters(x, N, grid)
            # the clock stamps of one more call: a product, the hand-off
            stamps = torch.zeros(stamps_size(M, N, reps, grid), dtype = torch.int64,
                                 device = 'cuda')
            matmul_rate(x, w, reps, grid, stamps = stamps)
            case.update(
                cluster = {'row_tiles': R, 'column_blocks': P, 'blocks': R * P,
                           'clusters': clusters, 'resident_clusters': resident,
                           'waves': clusters / resident},
                stamps_us = product_times_us(stamps, M, N, reps, grid),
                ring_stages = ring_stages(K, itemsize), shared_bytes = shared_bytes(K, itemsize),
                ops = ops, bytes = nbytes, l2_bytes = l2,
                bound_ms = 1e3 * max(ops / peak, nbytes / PEAK_BYTES),
                bound_by = 'operations' if ops / peak > nbytes / PEAK_BYTES else 'bytes',
                rate = ops / (case['kernel_ms'] * 1e-3),
                l2_bytes_per_s = l2 / (case['kernel_ms'] * 1e-3), clocks = clocks)
            case['share_of_bound'] = case['bound_ms'] / case['kernel_ms']
            del x, w, out, ref

    # one bf16 product (float32 sums only), and the 4-product chain and its
    # control
    x, w = inputs(torch.bfloat16, M, K, N)
    one_case = {'reps': 1, 'tolerance_rel': one,
                'kernel': errs(matmul_rate(x, w, 1, grid), matmul_rate_plain(x, w, 1, grid))[1:]}
    cases['bfloat16_M512_reps1'] = one_case
    check(one_case['kernel'][0] <= one[0] and one_case['kernel'][1] <= one[1],
          'matmul_rate, one bf16 product: {}'.format(one_case))
    out, ref = matmul_rate(x, w, 4, grid), matmul_rate_plain(x, w, 4, grid)
    xs, acc = x.float(), torch.zeros_like(ref)
    for r in range(4):
        acc += xs @ w[r].float()
        xs = acc[:, :K]
    short_case = {'reps': 4, 'tolerance_rel': short,
                  'kernel': errs(out, ref)[1:], 'control_unrounded_feedback': errs(acc, ref)[1:]}
    cases['bfloat16_M512_reps4'] = short_case
    check(short_case['kernel'][0] <= short[0] and short_case['kernel'][1] <= short[1],
          'matmul_rate, 4 bf16 products: {}'.format(short_case))
    check(short_case['control_unrounded_feedback'][0] > short[0]
          or short_case['control_unrounded_feedback'][1] > short[1],
          'matmul_rate: the control meets the 4-product limits: {}'.format(short_case))
    del x, w, out, ref, acc, xs

    # the probe's main path: `main` is its two probes; each is driven with
    # the count set to 0 just before it and read just after, then `main`
    launches = {}
    for name in ('int8', 'bf16'):
        matmul_rate.launches = 0
        module.probe(name, M, K, N, reps, grid, torch.device('cuda'))
        launches[name] = matmul_rate.launches
    matmul_rate.launches = 0
    probe = module.main()
    check(matmul_rate.launches == sum(launches.values()) == 2 * (2 + module.ITERS),
          'matmul_rate probe launches: {} then {}'.format(launches, matmul_rate.launches))
    emit({'phase': 'kernels', 'matmul_rate': cases, 'ptxas': ptxas_report('matmul_rate'),
          'probe': {'launches': launches, 'main': probe},
          'shape': {'M': M, 'K': K, 'N': N, 'reps': reps, 'grid': grid}})
    return cases, launches


def remat_acts(task, mel, audio, reps = 2):
    """WaveGlow train steps with ``remat='acts'`` (each layer's activations
    and residual stream kept, the gates recomputed) against per-flow remat,
    under mixed_bfloat16, `reps` steps of each in turn: the loss equal, the
    first steps' gradients within 1e-5 of each leaf's scale; ms of each step
    and the peak memory above the start of each mode."""
    from text_to_speech_tpu_torch.train.trainer import _trainable
    from text_to_speech_tpu_torch.weights import flatten_tree
    remat = {str(mode): {'ms': [], 'peak_rise_gb': 0.} for mode in (True, 'acts')}
    grads = {}
    for rep in range(reps):
        for mode in (True, 'acts'):
            p = _trainable(task.params)                 # new leaves, their own grads
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            start = time.perf_counter()
            loss = task.arch.loss(p, mel, audio, remat = mode, compute_dtype = torch.bfloat16)
            loss.backward()
            torch.cuda.synchronize()
            entry = remat[str(mode)]
            entry['ms'].append(1e3 * (time.perf_counter() - start))
            entry['loss'] = float(loss.detach())
            entry['peak_rise_gb'] = max(entry['peak_rise_gb'], (
                torch.cuda.max_memory_allocated() - before) / 2 ** 30)
            if rep == 0:
                grads[str(mode)] = {k: t.grad for k, t in flatten_tree(p).items()}
            del p, loss
    for entry in remat.values():
        entry['median_ms'] = statistics.median(entry['ms'])
    remat['max_grad_rel_err'] = max(
        float((grads['acts'][k] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
        for k, g in grads['True'].items())
    remat['tolerance_rel'] = 1e-5
    del grads
    torch.cuda.empty_cache()
    check(remat['max_grad_rel_err'] <= 1e-5 and remat['acts']['loss'] == remat['True']['loss'],
          "remat='acts' against remat=True: {}".format(remat))
    return remat


def train_phase():
    """WaveGlow training at NVIDIA width (the `HParamsWaveGlow` defaults),
    random weights from a seed with the `end` convs at scale 1e-2."""
    import glob
    import shutil
    from text_to_speech_tpu_torch.init import init_waveglow
    from text_to_speech_tpu_torch.models.tts import WaveGlow
    from text_to_speech_tpu_torch.models.waveglow_arch import WaveGlow as WaveGlowArch
    from text_to_speech_tpu_torch.ops.wn_block import fused_wn_block
    from text_to_speech_tpu_torch.ops.wn_layer import fused_wn_layer
    from text_to_speech_tpu_torch.train.losses import WaveGlowLoss
    from text_to_speech_tpu_torch.train.optimizers import get_optimizer
    from text_to_speech_tpu_torch.train.trainer import (
        _to_device, _trainable, bucket_pad, make_eval_step, make_train_step)

    arch = WaveGlowArch()
    hp = arch.hp
    start = time.perf_counter()
    params = init_waveglow(hp, arch.flow_channels, seed = 3)
    init_s = time.perf_counter() - start
    directory = tempfile.mkdtemp(prefix = 'chip_smoke_train_')
    new_model = lambda name, params = params, ** change: WaveGlow.from_jax(
        params, device = 'cuda', name = name, root = directory, ** change)
    try:
        # 1. the timed train step, the JAX benchmark's shape: B=8 x 256 frames
        B, frames = 8, 256
        rng = np.random.default_rng(7)
        mel = torch.from_numpy(rng.standard_normal((B, frames, hp.n_mel_channels))
                               .astype(np.float32)).cuda()
        audio = torch.from_numpy((0.1 * rng.standard_normal((B, frames * hp.upsample_stride)))
                                 .astype(np.float32)).cuda()
        audio_s = B * frames * hp.upsample_stride / 22050.
        steps = {}
        for route, precision in (('default', 'float32'), ('default', 'mixed_bfloat16'),
                                 ('wn_train_fused', 'mixed_bfloat16')):
            task = new_model('step', wn_train_fused = route == 'wn_train_fused')
            tx = get_optimizer('adam', lr = 1e-4)
            p = _trainable(task.params)
            opt = tx.init(p)
            step = make_train_step(task, WaveGlowLoss(), tx, precision = precision)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            times, losses = [], []
            for i in range(2):
                if i == 1:        # the launches of the timed step
                    fused_wn_block.launches = fused_wn_layer.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, _, _, metrics = step(p, {}, opt, None, (mel, audio), audio)
                losses.append(float(metrics['loss']))       # waits for the step
                times.append(1e3 * (time.perf_counter() - t0))
            ms = statistics.median(times[1:])
            key = '{}_{}'.format(route, precision)
            steps[key] = {
                'route': route, 'precision': precision, 'B': B, 'frames': frames,
                'ms_per_step': ms, 'step_ms': times, 'steps_per_s': 1e3 / ms,
                'audio_s_per_s': audio_s / (ms / 1e3),
                # the peak, and its rise over what the earlier phases hold
                'peak_memory_gb': torch.cuda.max_memory_allocated() / 2 ** 30,
                'peak_rise_gb': (torch.cuda.max_memory_allocated() - before) / 2 ** 30,
                'wn_block_launches_per_step': fused_wn_block.launches,
                'wn_layer_launches_per_step': fused_wn_layer.launches,
                'first_loss': losses[0], 'losses': losses,
                'grad_norm': float(metrics['grad_norm'])}
            check(all(np.isfinite(losses)), '{}: loss not finite: {}'.format(key, losses))
            # on the one repeated batch the loss falls for 6 steps (Adam's 7th
            # step overshoots the noise's optimum, as in the JAX package:
            # tests/test_torch_port_train.py::test_repeated_batch_spike_matches_jax)
            check(losses[1] < losses[0],
                  '{}: the loss did not fall over the 2 steps: {}'.format(key, losses))
            expected = 2 * hp.n_flows if route == 'wn_train_fused' else 0
            check(steps[key]['wn_block_launches_per_step'] == expected
                  and fused_wn_layer.launches == 0,
                  '{}: {} K1 launches a step, expected {}'.format(
                      key, steps[key]['wn_block_launches_per_step'], expected))
            del task, p, opt, step, metrics
            torch.cuda.empty_cache()
        fused, default = steps['wn_train_fused_mixed_bfloat16'], steps['default_mixed_bfloat16']
        gap = abs(fused['first_loss'] - default['first_loss']) / abs(default['first_loss'])
        check(gap <= 1e-2, 'fused vs default first loss: {} vs {}'.format(
            fused['first_loss'], default['first_loss']))
        emit({'phase': 'train', 'train_step': steps, 'init_s': init_s,
              'fused_vs_default_first_loss_rel': gap, 'tolerance_rel': 1e-2})

        # 1a. remat='acts' against per-flow remat at the same shape
        acts_task = new_model('acts')
        emit({'phase': 'train', 'remat_acts_B8_mixed_bfloat16': remat_acts(acts_task, mel, audio,
                                                                           reps = 1)})
        del acts_task
        torch.cuda.empty_cache()

        # 1b. the eval forward of a use_pallas model (K4 in all 96 layers) at
        #     the train step's shape and weights under mixed_bfloat16, beside
        #     the plain chain in mixed_bfloat16 and in float32 (the limit of
        #     section 3: 5e-2 of the float32 chain's loss)
        eval_full = {}
        for name, use_pallas, precision in (('use_pallas', True, 'mixed_bfloat16'),
                                            ('plain_chain', False, 'mixed_bfloat16'),
                                            ('plain_chain_float32', False, 'float32')):
            task = new_model('eval_full', use_pallas = use_pallas)
            run = make_eval_step(task, WaveGlowLoss(), precision = precision)
            float(run(task.params, {}, None, (mel, audio), audio)['loss'])
            times = []
            for _ in range(1):
                fused_wn_layer.launches = fused_wn_block.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss = float(run(task.params, {}, None, (mel, audio), audio)['loss'])
                times.append(1e3 * (time.perf_counter() - t0))
            eval_full[name] = {'precision': precision, 'loss': loss,
                               'ms': statistics.median(times), 'eval_ms': times,
                               'wn_layer_launches': fused_wn_layer.launches,
                               'wn_block_launches': fused_wn_block.launches}
            del task, run
        k4_eval, f32_eval = eval_full['use_pallas'], eval_full['plain_chain_float32']
        k4_eval['rel_err_float32_chain'] = abs(k4_eval['loss'] - f32_eval['loss']) / abs(
            f32_eval['loss'])
        k4_eval['tolerance_rel'] = 5e-2
        check(k4_eval['wn_layer_launches'] == hp.n_flows * hp.wn_layers
              and k4_eval['wn_block_launches'] == 0
              and eval_full['plain_chain']['wn_layer_launches'] == 0,
              'use_pallas eval at B={} x {} frames: {}'.format(B, frames, eval_full))
        check(np.isfinite(k4_eval['loss']) and k4_eval['rel_err_float32_chain'] <= 5e-2,
              'use_pallas eval at B={} x {} frames: {}'.format(B, frames, eval_full))
        emit({'phase': 'train', 'use_pallas_eval_train_shape': eval_full, 'B': B,
              'frames': frames})

        # 2. fit on the four in-repo WAVs on K1 (wn_train_fused), 2 epochs,
        #    validation on two of them; then one more epoch, resumed
        wavs = sorted(glob.glob(WAVS))
        check(len(wavs) == 4, 'in-repo WAVs: {}'.format(wavs))
        rows = [{'filename': w} for w in wavs]
        task = new_model('fit', wn_train_fused = True)
        fit_kw = dict(valid_data = rows[:2], batch_size = 4, lr = 1e-4, device = 'cuda')
        fused_wn_block.launches = fused_wn_layer.launches = 0
        t0 = time.perf_counter()
        history = task.fit(rows, epochs = 2, ** fit_kw)
        fit_s = time.perf_counter() - t0
        launches = {'wn_block': fused_wn_block.launches, 'wn_layer': fused_wn_layer.launches}
        losses, val_losses = history.get_metric('loss'), history.get_metric('val_loss')
        manifest = os.path.join(task.folder, 'saving', 'checkpoint', 'checkpoint.json')
        with open(manifest) as file:
            saved = [c['epoch'] for c in json.load(file)['checkpoints']]
        # a step a epoch (4 rows, batch 4): 2 x 12 K1 launches with remat,
        # and 12 for the validation batch
        per_epoch = 3 * hp.n_flows
        check(launches == {'wn_block': 2 * per_epoch, 'wn_layer': 0},
              'fit launches: {}'.format(launches))
        check(all(np.isfinite(losses)) and losses[1] < losses[0],
              'fit: the training loss did not fall: {}'.format(losses))
        check(saved == [1, 2] and os.path.exists(os.path.join(
            task.folder, 'saving', 'checkpoint', 'ckpt-2.params.npz')),
            'fit: checkpoints {}'.format(saved))
        history = task.fit(rows, epochs = 1, ** fit_kw)
        resumed = history.trainings[-1]['config']['resumed_optimizer_from_epoch']
        check(resumed == 2 and task.epochs == 3,
              'resume: optimizer state from epoch {}, {} epochs'.format(resumed, task.epochs))
        fit = {'rows': len(rows), 'valid_rows': 2, 'epochs': 2, 'fit_s': fit_s,
               'loss': losses, 'val_loss': val_losses, 'launches': launches,
               'checkpoints': saved, 'resumed_optimizer_from_epoch': resumed,
               'resume_loss': history.get_metric('loss')[-1],
               'grouped_length': None}

        # 3. the eval step of a use_pallas model on the fitted params: K4 in
        #    every layer, against the plain chain on the validation batch
        fitted = task.params
        batch = task.collate([task.prepare_data(r) for r in rows[:2]])
        inputs, targets = bucket_pad(batch, task)
        inputs, targets = _to_device(inputs, 'cuda'), _to_device(targets, 'cuda')
        fit['grouped_length'] = inputs[1].shape[1] // hp.n_group
        pallas = WaveGlow(fitted, device = 'cuda', name = 'eval', root = directory,
                          use_pallas = True)
        plain = WaveGlow(fitted, device = 'cuda', name = 'eval', root = directory)
        # Limits, relative to the reference loss.  float32: K4 is equal to
        # its plain version to the bit (kernels phase) and the cuDNN chain
        # sums in another order: 1e-5.  mixed_bfloat16: the cuDNN bf16 chain
        # rounds the acts, the gate and every residual and skip sum to bf16,
        # where K4 rounds the gate and its outputs only, and the loss of the
        # fitted model is a difference of terms several times its size, so
        # the two bf16 routes land 1.7e-2 apart and 2.5e-2 (K4) and 4.1e-2
        # (the chain) from the float32 chain (measured on an H100).  K4's
        # route is held to the chain with K4's plain version in every layer
        # (the same dtype contract) at 1e-3, and to the float32 chain at
        # 5e-2, the bf16 chain's own distance with room; its distance to the
        # bf16 chain is reported.
        from text_to_speech_tpu_torch.models import waveglow_arch
        from text_to_speech_tpu_torch.ops.wn_layer import wn_layer_plain
        evals = {}
        rel = lambda a, b: abs(a - b) / abs(b)
        for precision in ('float32', 'mixed_bfloat16'):
            run = lambda model: float(make_eval_step(model, WaveGlowLoss(), precision = precision)(
                model.params, {}, None, inputs, targets)['loss'])
            run(pallas)
            torch.cuda.synchronize()
            fused_wn_layer.launches = fused_wn_block.launches = 0
            t0 = time.perf_counter()
            loss = run(pallas)
            pallas_ms = 1e3 * (time.perf_counter() - t0)
            k4, k1 = fused_wn_layer.launches, fused_wn_block.launches
            t0 = time.perf_counter()
            ref = run(plain)
            plain_ms = 1e3 * (time.perf_counter() - t0)
            layer, waveglow_arch.fused_wn_layer = waveglow_arch.fused_wn_layer, wn_layer_plain
            try:
                contract = run(pallas)
            finally:
                waveglow_arch.fused_wn_layer = layer
            evals[precision] = {'loss': loss, 'plain_chain_loss': ref,
                                'plain_version_chain_loss': contract,
                                'rel_err_plain_chain': rel(loss, ref),
                                'rel_err_plain_version_chain': rel(loss, contract),
                                'wn_layer_launches': k4, 'wn_block_launches': k1,
                                'ms': pallas_ms, 'plain_chain_ms': plain_ms}
            check(k4 == hp.n_flows * hp.wn_layers and k1 == 0,
                  'use_pallas eval: {} K4 and {} K1 launches'.format(k4, k1))
        f32, bf16 = evals['float32'], evals['mixed_bfloat16']
        bf16['rel_err_float32_chain'] = rel(bf16['loss'], f32['plain_chain_loss'])
        bf16['plain_chain_rel_err_float32_chain'] = rel(bf16['plain_chain_loss'],
                                                        f32['plain_chain_loss'])
        f32['tolerance_rel'] = 1e-5
        bf16['tolerance_rel'] = {'plain_version_chain': 1e-3, 'float32_chain': 5e-2}
        check(f32['rel_err_plain_chain'] <= 1e-5 and f32['rel_err_plain_version_chain'] <= 1e-5,
              'use_pallas eval, float32: {}'.format(f32))
        check(bf16['rel_err_plain_version_chain'] <= 1e-3
              and bf16['rel_err_float32_chain'] <= 5e-2,
              'use_pallas eval, mixed_bfloat16: {}'.format(bf16))
        tx = get_optimizer('adam', lr = 1e-4)
        p = _trainable(pallas.params)
        try:
            make_train_step(pallas, WaveGlowLoss(), tx)(p, {}, tx.init(p), None, inputs, targets)
        except RuntimeError as err:
            refused = 'wn_train_fused' in str(err)
        else:
            refused = False
        check(refused, 'the train step of a use_pallas model was not refused')
        emit({'phase': 'train', 'fit': fit, 'use_pallas_eval': evals,
              'use_pallas_train_step_refused': refused})
    finally:
        shutil.rmtree(directory, ignore_errors = True)
    return steps, eval_full


SENTENCES = ['The quick brown fox jumps over the lazy dog.',
             'Printing, in the only sense with which we are concerned,',
             'differs from most if not from all the arts and crafts.',
             'It was invented in the fifteenth century.']


# kernel names in a profiler trace: K1's bf16 GEMMs, K2's GEMMs and row
# quantization, K3
KERNEL_PATTERNS = {'wn_block': r'wn_(in|rs)_wgmma',
                   'wn_block_int8': r'(?<![a-z_])(row_quant|in_wgmma|rs_wgmma)',
                   'decoder_steps': r'decoder_steps_kernel'}


def kernel_trace(fn, wrapper):
    """`fn` under the loggers' `torch.profiler` trace: its CUDA kernel
    events, their device time, the events of each kernel family and the
    calls of `wrapper` (its launch count) in the run."""
    from text_to_speech_tpu_torch.loggers import start_profiler_trace, stop_profiler_trace
    torch.cuda.synchronize()
    start_profiler_trace()
    wrapper.launches = 0
    fn()
    torch.cuda.synchronize()
    calls = wrapper.launches
    with open(stop_profiler_trace()) as f:
        kernels = [e for e in json.load(f)['traceEvents'] if e.get('cat') == 'kernel']
    return {'kernel_events': len(kernels),
            'kernel_ms': 1e-3 * sum(e.get('dur', 0) for e in kernels),
            'events': {name: sum(bool(re.search(pattern, e['name'])) for e in kernels)
                       for name, pattern in KERNEL_PATTERNS.items()},
            'wrapper_calls': calls}


def e2e_phase(model, vocoder, setup_s):
    from text_to_speech_tpu_torch import tts
    from text_to_speech_tpu_torch.devices import get_memory_stats
    from text_to_speech_tpu_torch.loggers import reset_timers, timer_report
    from text_to_speech_tpu_torch.models.tts.tacotron2 import pad_batch
    from text_to_speech_tpu_torch.ops.decoder_kernel import decoder_steps
    from text_to_speech_tpu_torch.ops.wn_block import fused_wn_block
    from text_to_speech_tpu_torch.ops.wn_block_int8 import fused_wn_block_int8

    wg_arch = vocoder.arch
    n_flows = wg_arch.hp.n_flows
    generator = torch.Generator(device = 'cuda').manual_seed(0)
    max_frames, vocoder_batch, chunk = 256, 8, 64
    # the random stop gate is biased off, so every run decodes max_frames
    # frames; the gates are opened wide so that this fixed length passes.
    # Nothing is saved (no map.json cache) or displayed: every run synthesizes
    gates = dict(min_fpt_ratio = 0., max_fpt_ratio = 1e9, save = False, display = False)
    retries = []
    synthesize_chunks = model._synthesize_chunks
    model._synthesize_chunks = lambda * a, ** kw: \
        retries.append(1) or synthesize_chunks(* a, ** kw)
    mel_of = lambda frames, seed: torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (1, frames, wg_arch.hp.n_mel_channels)).astype(np.float32) - 5.).to('cuda')

    def drive(name, texts, route, serving):
        """One `tts()` run after a warm-up, the launch counts read around it."""
        kw = dict(model = model, vocoder = vocoder, vocoder_batch = vocoder_batch,
                  generator = generator, ** gates, ** route)
        tts(texts, max_length = 64, ** kw)                              # warm-up
        torch.cuda.synchronize()
        reset_launches()
        reset_timers()
        start = time.perf_counter()
        outputs = tts(texts, max_length = max_frames, ** kw)
        total_s = time.perf_counter() - start
        spans = timer_report()
        launches = read_launches()
        rows = sum(len(out['mel']) for out in outputs)
        vocoder_calls = -(-rows // vocoder_batch)
        # each vocoder call runs every flow on the mode's kernel, and no other
        expected = {'default': (n_flows * vocoder_calls, 0), 'int8': (0, n_flows * vocoder_calls),
                    'float32_xla': (0, 0)}[serving]
        check(vocoder.serving_mode == serving and launches['wn_layer'] == 0 and
              (launches['wn_block'], launches['wn_block_int8']) == expected,
              '{}: {} launches for {} vocoder calls in mode {}'.format(
                  name, launches, vocoder_calls, vocoder.serving_mode))
        fused = route.get('use_fused_decoder', True)
        check(launches['decoder_steps'] == (-(-max_frames // chunk) if fused else 0),
              '{}: {} decoder_steps launches'.format(name, launches['decoder_steps']))
        check(not retries, '{}: the retry path was taken'.format(name))
        audio_s = 0.
        for out in outputs:
            frames = out['mel'][0].shape[0]
            check(frames == max_frames, 'decoded {} frames'.format(frames))
            check(out['audio'].shape == (frames * vocoder.upsample_rate,), 'audio length')
            check(bool(np.isfinite(out['audio']).all()), 'audio not finite')
            check(bool(np.isfinite(out['mel'][0]).all()), 'mel not finite')
            audio_s += out['time']
        if isinstance(texts, str):
            # the one-launch path: 16-bit PCM from the device, / 32767 on the host
            grid = outputs[0]['audio'].astype(np.float64) * 32767.
            check(float(np.abs(grid - np.round(grid)).max()) < 1e-2
                  and float(np.abs(outputs[0]['audio']).max()) <= 1.,
                  '{} audio is not on the int16 grid'.format(name))
            check(outputs[0]['attention'] == [None], 'attention fetched on the one-launch path')
        timings = model.last_timings
        runs[name] = {
            'serving_mode': serving, 'texts': len(outputs), 'frames': max_frames,
            'audio_s': audio_s, 'decode_ms': 1e3 * timings['decode_s'],
            'vocode_ms': 1e3 * timings['vocode_s'], 'total_ms': 1e3 * total_s,
            'rtf': audio_s / total_s, 'launches': launches, 'vocoder_calls': vocoder_calls,
            'spans': spans.splitlines(),
        }
        # the task model's spans: host time around dispatch, the device not waited for
        for span in (('predict', 'inference', 'processing', 'compiled_tts')
                     if isinstance(texts, str) else ('predict', 'compiled_infer')):
            check('- {} : '.format(span) in spans, '{}: no span {!r} in\n{}'.format(
                name, span, spans))

    runs = {}
    one, batch = dict(), dict(batch_size = 4, use_fused_decoder = True)
    drive('one_sentence', SENTENCES[0], one, 'default')
    print('\n'.join(runs['one_sentence']['spans']), flush = True)
    drive('batch_of_4', SENTENCES, batch, 'default')
    drive('batch_of_4_plain_decoder', SENTENCES,
          dict(batch_size = 4, use_fused_decoder = False), 'default')

    # int8 serving: the quality gate on the card, then both routes on K2
    gate_mel = mel_of(32, 5)
    vocoder.quantize_for_serving(validate = gate_mel)
    gate_snr = vocoder._last_serving_snr_db
    check(vocoder.serving_mode == 'int8' and gate_snr >= 25.,
          'int8 gate: mode {}, SNR {} dB'.format(vocoder.serving_mode, gate_snr))
    drive('one_sentence_int8', SENTENCES[0], one, 'int8')
    drive('batch_of_4_int8', SENTENCES, batch, 'int8')
    # K2's device kernels a block: a torch.profiler trace of one int8 sentence
    int8_trace = kernel_trace(lambda: tts(
        SENTENCES[0], model = model, vocoder = vocoder, vocoder_batch = vocoder_batch,
        generator = generator, max_length = max_frames, ** gates), fused_wn_block_int8)
    layers = wg_arch.hp.wn_layers
    k2 = int8_trace['events']['wn_block_int8']
    int8_trace['wn_block_int8_kernels_per_block'] = k2 / int8_trace['wrapper_calls']
    int8_trace['limit'] = 2 * layers + 2
    check(int8_trace['wrapper_calls'] == n_flows and k2 > 0
          and k2 <= (2 * layers + 2) * int8_trace['wrapper_calls'],
          'int8 sentence trace: {}'.format(int8_trace))
    # a gate that fails: the float32 chain serves, neither WN kernel runs
    vocoder.quantize_for_serving(validate = gate_mel, gate_db = 1e9)
    check(vocoder._last_serving_snr_db < 1e9, 'gate failure SNR')
    drive('one_sentence_gate_failed', SENTENCES[0], one, 'float32_xla')
    vocoder.quantize_for_serving(False)
    model._synthesize_chunks = synthesize_chunks

    # the loggers' device trace (torch.profiler) of one sentence: it must
    # hold the card's kernels, K3's and K1's among them
    trace = kernel_trace(lambda: tts(
        SENTENCES[0], model = model, vocoder = vocoder, vocoder_batch = vocoder_batch,
        generator = generator, max_length = max_frames, ** gates), fused_wn_block)
    trace['wn_block_kernels_per_block'] = trace['events']['wn_block'] / trace['wrapper_calls']
    check(trace['events']['decoder_steps'] > 0 and trace['wrapper_calls'] == n_flows
          and trace['events']['wn_block'] == 2 * wg_arch.hp.wn_layers * n_flows,
          'profiler trace of one sentence: {}'.format(trace))

    # the fused decode against the plain decode on the card: float32, no
    # dropout, full width, two sentences, 256 steps.  Tolerance 1e-4 of each
    # tensor's largest magnitude: both routes are float32, the kernel sums
    # in another order, and 256 autoregressive steps carry every difference
    # on (measured on an H100: under 1e-6); an indexing fault misses it by
    # orders of magnitude.  The gates sit near 0 (their bias is far
    # negative), so their scale is floored.
    tokens = pad_batch([model.encode_text(t) for t in SENTENCES[:2]],
                       pad_value = model.blank_token_idx)
    kw = dict(max_length = max_frames, deterministic = True, early_stopping = False)
    fused = model.compiled_infer(tokens, use_fused_decoder = True, ** kw)
    plain = model.compiled_infer(tokens, use_fused_decoder = False, ** kw)
    compared = ('mel', 'decoder_output', 'stop_tokens', 'attention_weights')
    rel = lambda a, b, name: float((getattr(a, name) - getattr(b, name)).abs().max()) \
        / max(float(getattr(b, name).abs().max()), 1e-3)
    routes = {name: rel(fused, plain, name) for name in compared}
    worst = max(routes.values())
    routes.update(lengths_equal = bool(torch.equal(fused.lengths, plain.lengths)),
                  tolerance_rel = 1e-4)
    check(routes['lengths_equal'] and worst <= 1e-4,
          'fused decode vs plain decode: {}'.format(routes))

    # the int8 LSTM decode, `infer_fused(int8_lstm=True)`, on the same two
    # sentences: its launches, and how far it lands from the float32 decode
    # (reported; the kernel is held to its plain version in the kernels phase)
    # the tokens as `compiled_infer` padded them
    tokens_dev = torch.as_tensor(model._bucket(tokens, max_frames, 64)[0], dtype = torch.long,
                                 device = 'cuda')
    with torch.no_grad():
        decoder_steps.launches = 0
        int8_decode = model.arch.infer_fused(model.params, model.state, tokens_dev,
                                             int8_lstm = True, ** kw)
        int8_launches = decoder_steps.launches
    check(int8_launches == max_frames // chunk and
          bool(torch.isfinite(int8_decode.mel).all()) and
          int8_decode.mel.shape == fused.mel.shape,
          'int8 LSTM decode: {} launches'.format(int8_launches))
    int8_lstm = {'launches': int8_launches,
                 'vs_float32_decode_rel': {name: rel(int8_decode, fused, name)
                                           for name in compared}}

    # the vocoder's kernel routes against its float32 chain on a short mel.
    # bf16 route: tolerance 1e-2 of the waveform's largest magnitude: bf16
    # buffers (8-bit mantissa) through 12 flows measured 1.3e-3 with these
    # seeds on an H100; 1e-2 leaves room for another summation order, and a
    # wrong tap or row would miss it by orders of magnitude.  int8 route:
    # the serving gate, 25 dB.
    mel = mel_of(16, 3)
    lg = 16 * wg_arch.hp.upsample_stride // wg_arch.hp.n_group
    snr_db = lambda ref, out: 10 * float(torch.log10(
        (ref.double() ** 2).mean() / ((out.double() - ref.double()) ** 2).mean()))
    with torch.no_grad():
        z = torch.randn((1, lg, wg_arch.hp.n_group), generator = generator, device = 'cuda')
        fast = wg_arch.infer(vocoder._serving_params(True, False), mel, z = z, use_kernel = True)
        fast8 = wg_arch.infer(vocoder._serving_params(True, True), mel, z = z, use_kernel = True)
        plain = wg_arch.infer(vocoder.params, mel, z = z, use_kernel = False)
    err = float((fast - plain).abs().max()) / float(plain.abs().max())
    check(err < 1e-2, 'vocoder kernel path vs f32 chain: rel err {}'.format(err))
    int8_snr = snr_db(plain, fast8)
    check(int8_snr >= 25., 'int8 vocoder vs f32 chain: {} dB'.format(int8_snr))
    memory = get_memory_stats()
    check(0 < memory['bytes_in_use'] <= memory['peak_bytes_in_use'] <= memory['bytes_limit'],
          'memory stats: {}'.format(memory))
    emit({'phase': 'e2e', 'setup_s': setup_s, 'runs': runs, 'memory_stats': memory,
          'profiler_trace': trace, 'int8_profiler_trace': int8_trace,
          'fused_vs_plain_decode': routes, 'int8_lstm_decode': int8_lstm,
          'int8_gate': {'snr_db': gate_snr, 'gate_db': 25., 'frames': 32},
          'vocoder_kernel_vs_f32': {'max_rel_err': err, 'snr_db': snr_db(plain, fast),
                                    'tolerance_rel': 1e-2},
          'vocoder_int8_vs_f32': {'snr_db': int8_snr, 'limit_db': 25.,
                                  'max_rel_err': float((fast8 - plain).abs().max())
                                  / float(plain.abs().max())}})
    return runs, int8_lstm


def counted_launches():
    """Every kernel wrapper's launch count: {name: count}."""
    from text_to_speech_tpu_torch.ops.decoder_kernel import decoder_steps
    from text_to_speech_tpu_torch.ops.wn_block import fused_wn_block
    from text_to_speech_tpu_torch.ops.wn_block_int8 import fused_wn_block_int8
    from text_to_speech_tpu_torch.ops.wn_layer import fused_wn_layer
    return {'wn_block': fused_wn_block, 'wn_block_int8': fused_wn_block_int8,
            'decoder_steps': decoder_steps, 'wn_layer': fused_wn_layer}


def reset_launches():
    for wrapper in counted_launches().values():
        wrapper.launches = 0


def read_launches():
    return {name: wrapper.launches for name, wrapper in counted_launches().items()}


def windowed_phase(model, vocoder):
    """A long text vocoded in windows cut from the device mel, in both
    serving modes, the device slicer against the host one, and one long mel
    through `WaveGlow.infer` direct and windowed (time and peak memory)."""
    from text_to_speech_tpu_torch import tts
    from text_to_speech_tpu_torch.loggers import reset_timers, timer_report
    from text_to_speech_tpu_torch.models.tts.waveglow import _get_steps

    generator = torch.Generator(device = 'cuda').manual_seed(2)
    rate, n_mel = vocoder.upsample_rate, vocoder.arch.hp.n_mel_channels
    frames, win_len, hop_len = 256, 128, -32
    # eight sentences, one a line (SENTENCES[1] ends in a comma: joined by
    # spaces it would run into SENTENCES[2])
    paragraph = '\n'.join(SENTENCES * 2)
    kw = dict(model = model, vocoder = vocoder, max_text_length = -2, max_length = frames,
              vocoder_config = {'win_len': win_len, 'hop_len': hop_len}, generator = generator,
              min_fpt_ratio = 0., max_fpt_ratio = 1e9, save = False, display = False)
    retries = []
    synthesize_chunks = model._synthesize_chunks
    model._synthesize_chunks = lambda * a, ** k: retries.append(1) or synthesize_chunks(* a, ** k)
    # 8 chunks decode as one K3 batch of 8 (frames / 64 launches); 3 windows
    # a chunk, 24 in all, one window batch under the auto policy: min(64,
    # 32 x 8192 / (128 x 256 / 8), 32) = 32 windows of T = 4096, one launch
    # of the serving mode's WN kernel a flow
    n_flows = vocoder.arch.hp.n_flows
    windows = 8 * len(_get_steps(frames, win_len, win_len + hop_len))
    batch = vocoder._auto_vocoder_batch(win_len, windows, None)
    check(windows == 24 and batch == 32, 'windows {} batch {}'.format(windows, batch))
    runs = {}

    def drive(name, serving):
        tts(paragraph, ** kw)                                           # warm-up
        torch.cuda.synchronize()
        reset_launches()
        reset_timers()
        start = time.perf_counter()
        out = tts(paragraph, ** kw)[0]
        total_s = time.perf_counter() - start
        launches = read_launches()
        spans = timer_report()
        kernel = {'default': 'wn_block', 'int8': 'wn_block_int8'}[serving]
        expected = dict(wn_block = 0, wn_block_int8 = 0, wn_layer = 0,
                        decoder_steps = frames // 64)
        expected[kernel] = n_flows * -(-windows // batch)
        check(vocoder.serving_mode == serving and launches == expected and not retries,
              '{}: launches {} (expected {}), retries {}'.format(name, launches, expected,
                                                                 len(retries)))
        check(len(out['mel']) == 8 and all(m.shape == (frames, n_mel) for m in out['mel']),
              '{}: mels {}'.format(name, [m.shape for m in out['mel']]))
        check(out['audio'].shape == (8 * frames * rate,) and bool(np.isfinite(out['audio']).all()),
              '{}: audio {}'.format(name, out['audio'].shape))
        timings = model.last_timings
        runs[name] = {'serving_mode': serving, 'chunks': len(out['mel']), 'frames': frames,
                      'win_len': win_len, 'hop_len': hop_len, 'windows': windows,
                      'window_batch': batch, 'audio_s': out['time'],
                      'total_ms': 1e3 * total_s, 'decode_ms': 1e3 * timings['decode_s'],
                      'vocode_ms': 1e3 * timings['vocode_s'], 'rtf': out['time'] / total_s,
                      'launches': launches, 'spans': spans.splitlines()}
        for span in ('predict', 'inference', 'processing', 'compiled_infer'):
            check('- {} : '.format(span) in spans,
                  '{}: no span {!r} in\n{}'.format(name, span, spans))
        return out

    out = drive('long_text_windowed', 'default')
    print('\n'.join(runs['long_text_windowed']['spans']), flush = True)

    # the device slicer against the host one on the decoded mels, ragged
    # lengths (100: one window, its last 28 frames padding), deterministic:
    # the same windows in the same batches
    lengths = [256, 256, 200, 256, 100, 256, 129, 256]
    buffer = torch.from_numpy(np.stack(out['mel'])).cuda()       # every chunk: 256 frames
    device = vocoder.vocode_windowed_from_device(buffer, lengths, win_len = win_len,
                                                 hop_len = hop_len, deterministic = True)
    host = vocoder.vocode_windowed_batch([m[:n] for m, n in zip(out['mel'], lengths)],
                                         win_len = win_len, hop_len = hop_len,
                                         deterministic = True)
    slicer_err = max(float(np.abs(d - h).max()) for d, h in zip(device, host))
    check([len(d) for d in device] == [len(h) for h in host] == [n * rate for n in lengths]
          and slicer_err <= 1e-5, 'device slicer vs host slicer: {}'.format(slicer_err))

    gate_mel = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, 32, n_mel)).astype(np.float32) - 5.).cuda()
    vocoder.quantize_for_serving(validate = gate_mel)
    gate_snr = getattr(vocoder, '_last_serving_snr_db', None)
    check(vocoder.serving_mode == 'int8', 'int8 gate: {} dB'.format(gate_snr))
    drive('long_text_windowed_int8', 'int8')
    vocoder.quantize_for_serving(False)
    model._synthesize_chunks = synthesize_chunks

    # one long mel, three ways: direct, windowed one call a window, windowed
    # in one batch; peak memory from a reset before each (after a warm-up)
    mel = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (1, 2048, n_mel)).astype(np.float32) - 5.).cuda()
    memory = {}
    for name, options in (('direct', {}), ('windowed', dict(win_len = 256, batch = False)),
                          ('windowed_batch', dict(win_len = 256, batch = True))):
        vocoder.infer(mel, ** options)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        start = time.perf_counter()
        audio = vocoder.infer(mel, ** options)
        ms = 1e3 * (time.perf_counter() - start)
        peak = torch.cuda.max_memory_allocated()
        check(audio.shape == (1, 2048 * rate) and bool(np.isfinite(audio).all()),
              'long mel {}: {}'.format(name, audio.shape))
        memory[name] = {'ms': ms, 'peak_bytes': peak, 'peak_above_start_bytes': peak - base,
                        'rtf': 2048 * rate / vocoder.rate / (ms * 1e-3)}
    check(memory['windowed']['peak_bytes'] < memory['direct']['peak_bytes'],
          'windowed peak not below direct: {}'.format(memory))
    emit({'phase': 'windowed', 'runs': runs, 'int8_gate_snr_db': gate_snr,
          'slicer_vs_host_max_abs': slicer_err,
          'slicer_tolerance': 1e-5, 'long_mel': dict(memory, frames = 2048, win_len = 256,
                                                     hop_len = -64)})
    return runs


def surface_phase(model, vocoder):
    """`tts()` with `directory=`: map.json, the saved WAVs and a second call
    answered from the cache; `stream()` over a queue into a `QueueCallback`."""
    import queue
    from scipy.io import wavfile
    from text_to_speech_tpu_torch import stream, tts
    from text_to_speech_tpu_torch.utils.file_utils import load_json

    generator = torch.Generator(device = 'cuda').manual_seed(3)
    frames, n_flows = 256, vocoder.arch.hp.n_flows
    kw = dict(model = model, vocoder = vocoder, max_length = frames, generator = generator,
              min_fpt_ratio = 0., max_fpt_ratio = 1e9, display = False)
    one_text = {'decoder_steps': frames // 64, 'wn_block': n_flows}
    runs = {}
    with tempfile.TemporaryDirectory() as directory:
        for name in ('callbacks_and_cache', 'callbacks_and_cache_hit'):
            reset_launches()
            start = time.perf_counter()
            outputs = tts(SENTENCES, directory = directory, ** kw)
            total_s = time.perf_counter() - start
            launches = read_launches()
            entries = load_json(os.path.join(directory, 'map.json'))
            runs[name] = {'texts': len(outputs), 'total_ms': 1e3 * total_s,
                          'map_entries': len(entries), 'launches': launches}
            check(len(entries) == 4 and list(entries) == SENTENCES,
                  '{}: map.json {}'.format(name, list(entries)))
            if name == 'callbacks_and_cache':
                expected = {k: len(SENTENCES) * one_text.get(k, 0) for k in launches}
                for text, out in zip(SENTENCES, outputs):
                    wav_rate, audio = wavfile.read(entries[text]['audio'])
                    check(wav_rate == vocoder.rate and np.array_equal(audio, out['audio']),
                          '{}: the WAV of {!r} differs from the audio'.format(name, text))
            else:
                expected = {k: 0 for k in launches}
                check(outputs == [entries[t] for t in SENTENCES], 'cache hit outputs')
            check(launches == expected, '{}: launches {} (expected {})'.format(
                name, launches, expected))

    texts, inputs, delivered = SENTENCES[:3], queue.Queue(), queue.Queue()
    for text in texts + [None]:
        inputs.put(text)
    reset_launches()
    start = time.perf_counter()
    results = stream(inputs, play = False, save = False, post_processing = delivered, ** kw)
    total_s = time.perf_counter() - start
    launches = read_launches()
    got = [delivered.get_nowait() for _ in range(delivered.qsize())]
    # `precompile_for_stream` synthesizes one text at each of two token buckets first
    expected = {k: (len(texts) + 2) * one_text.get(k, 0) for k in launches}
    check([r['text'] for r in results] == [g['text'] for g in got] == texts
          and launches == expected and all(np.isfinite(g['audio']).all() for g in got),
          'stream: {} results, {} delivered, launches {} (expected {})'.format(
              len(results), len(got), launches, expected))
    runs['stream'] = {'texts': len(results), 'total_ms': 1e3 * total_s, 'launches': launches,
                      'warmups': 2}
    emit({'phase': 'surface', 'runs': runs})
    return runs


def sv2tts_phase(vocoder, root):
    """SV2TTS voice cloning at NVIDIA width: K3 at D = 768 with a non-zero
    prenet addend against its plain version, the speaker encoder on the
    card (against the port on the CPU), and `tts()` conditioned on reference
    audio, a saved table and two speakers; its files go under `root`.
    Returns (kernel cases, runs)."""
    from text_to_speech_tpu_torch import tts
    from text_to_speech_tpu_torch.init import init_audio_encoder, init_tacotron2
    from text_to_speech_tpu_torch.loggers import reset_timers, timer_report
    from text_to_speech_tpu_torch.loggers.time_logging import ROOT_TIMER
    from text_to_speech_tpu_torch.models.encoder import SpeakerEncoder
    from text_to_speech_tpu_torch.models.encoder_arch import HParamsAudioEncoder
    from text_to_speech_tpu_torch.models.tacotron2_arch import HParamsTacotron2
    from text_to_speech_tpu_torch.models.tts import SV2TTSTacotron2
    from text_to_speech_tpu_torch.ops.audio_io import write_wav
    from text_to_speech_tpu_torch.text import default_english_tokenizer, en_symbols
    from text_to_speech_tpu_torch.utils.file_utils import load_json

    spk_dim, max_frames, chunk = 256, 256, 64
    n_flows = vocoder.arch.hp.n_flows

    def sv2tts_model(concat_pos, seed):
        """Random seeded weights at NVIDIA width, the stop gate biased off."""
        config = dict(vocab_size = len(en_symbols), speaker_concat_pos = concat_pos)
        params, state = init_tacotron2(
            HParamsTacotron2(speaker_embedding_dim = spk_dim, ** config), seed = seed)
        params['decoder']['gate_layer']['bias'][:] = -50.
        return SV2TTSTacotron2.from_jax(
            params, state, tokenizer = default_english_tokenizer(), device = 'cuda',
            root = root, name = 'sv2tts_' + '_'.join(concat_pos), embedding_dim = spk_dim,
            encoder_name = 'sv2tts_encoder', ** config)

    # the speaker encoder at its defaults, seeded batch-norm statistics, saved
    # in the JAX package's layout: the model loads it by name
    enc_params, enc_state = init_audio_encoder(HParamsAudioEncoder(), seed = 3,
                                               statistics = True)
    SpeakerEncoder.from_jax(enc_params, enc_state, name = 'sv2tts_encoder', root = root,
                            device = 'cuda').save()
    model = sv2tts_model(('end',), 5)
    check(model.arch.encoder_output_dim == 768, 'SV2TTS memory width')

    # reference audio: four seeded clips of 1-3 s at 16 kHz, and a WAV at 22,050 Hz
    rng = np.random.default_rng(4)

    def clip(seconds, f0, rate = 16000):
        t = np.arange(int(seconds * rate)) / rate
        return (0.5 * np.sin(2 * np.pi * f0 * t) + 0.3 * np.sin(2 * np.pi * 2.7 * f0 * t)
                + 0.05 * rng.standard_normal(len(t))).astype(np.float32)
    clips = [{'audio': clip(seconds, f0), 'rate': 16000}
             for seconds, f0 in ((1.0, 110.), (1.7, 180.), (2.3, 240.), (3.0, 320.))]
    wav = os.path.join(root, 'reference_22050.wav')
    write_wav(wav, clip(2.0, 150., 22050), 22050)
    references = clips + [wav]

    encoder = model.speaker_encoder
    check(encoder.device.type == 'cuda', 'the speaker encoder is not on the card')
    emb = encoder.embed(references)

    def host_ms(fn, reps = 5):
        """Median host time of `fn` after a warm-up (`embed` ends in a read)."""
        fn()
        times = []
        for _ in range(reps):
            start = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - start))
        return statistics.median(times)
    embed_ms = host_ms(lambda: encoder.embed(references))
    embed_one_ms = host_ms(lambda: encoder.embed(clips[3]))
    norms = np.linalg.norm(emb, axis = 1)
    cpu = SpeakerEncoder.from_pretrained('sv2tts_encoder', root = root, device = 'cpu') \
        .embed(references)
    embedding = {'clips': len(references), 'embed_ms': embed_ms, 'embed_one_3s_ms': embed_one_ms,
                 'norm_max_dev': float(np.abs(norms - 1.).max()),
                 'vs_cpu_max_abs': float(np.abs(cpu - emb).max()), 'tolerance_cpu': 1e-4,
                 'min_pair_cosine_distance': float(min(
                     1. - emb[i] @ emb[j] for i in range(len(emb)) for j in range(i)))}
    check(emb.shape == (5, spk_dim) and embedding['norm_max_dev'] <= 1e-5
          and embedding['vs_cpu_max_abs'] <= 1e-4, 'speaker encoder: {}'.format(embedding))

    # K3 at D = 768 with the prenet addend ('end' and 'prenet' concat)
    kernel_model = sv2tts_model(('end', 'prenet'), 6)
    speakers = torch.from_numpy(emb).cuda()
    cases = decoder_steps_phase(kernel_model, speaker = lambda B: speakers[:B],
                                shapes = ((1, 64, False), (4, 64, False)),
                                name = 'decoder_steps_sv2tts')
    del kernel_model

    generator = torch.Generator(device = 'cuda').manual_seed(6)
    gates = dict(min_fpt_ratio = 0., max_fpt_ratio = 1e9, display = False)
    runs = {}

    def drive(name, texts, serving, ** kw):
        """One `tts()` run after a warm-up, the launch counts read around it."""
        kw = dict(model = model, vocoder = vocoder, generator = generator, ** gates, ** kw)
        kw.setdefault('save', False)
        tts(texts, max_length = 64, ** dict(kw, directory = None, save = False))   # warm-up
        torch.cuda.synchronize()
        reset_launches()
        reset_timers()
        start = time.perf_counter()
        outputs = tts(texts, max_length = max_frames, ** kw)
        total_s = time.perf_counter() - start
        launches, spans = read_launches(), timer_report()
        calls = -(-len(outputs) // 8)
        expected = (n_flows * calls, 0) if serving == 'default' else (0, n_flows * calls)
        check(vocoder.serving_mode == serving and launches['decoder_steps'] == max_frames // chunk
              and (launches['wn_block'], launches['wn_block_int8']) == expected,
              '{}: launches {}'.format(name, launches))
        for out in outputs:
            check(out['mel'][0].shape[0] == max_frames and bool(np.isfinite(out['audio']).all())
                  and out['audio'].shape == (max_frames * vocoder.upsample_rate,),
                  '{}: output'.format(name))
        # the `embed` span of each thread's tree (the report rounds to ms)
        embed_s = [root.children['embed'].total for root in ROOT_TIMER._roots.values()
                   if 'embed' in root.children]
        runs[name] = {'serving_mode': serving, 'texts': len(outputs),
                      'decode_ms': 1e3 * model.last_timings['decode_s'],
                      'vocode_ms': 1e3 * model.last_timings['vocode_s'],
                      'embed_ms': 1e3 * sum(embed_s) if embed_s else None,
                      'total_ms': 1e3 * total_s, 'launches': launches,
                      'spans': spans.splitlines()}
        return outputs

    # the `encoder_name` route: reference audio in, on the one-launch path
    drive('sv2tts_one_sentence_audio', SENTENCES[0], 'default', audio = clips[1])
    check(runs['sv2tts_one_sentence_audio']['embed_ms'] is not None,
          'no embed span: {}'.format(runs['sv2tts_one_sentence_audio']['spans']))
    print('\n'.join(runs['sv2tts_one_sentence_audio']['spans']), flush = True)
    vocoder.quantize_for_serving(validate = torch.from_numpy(
        rng.standard_normal((1, 32, 80)).astype(np.float32) - 5.).cuda())
    check(vocoder.serving_mode == 'int8', 'int8 gate: {}'.format(vocoder._last_serving_snr_db))
    drive('sv2tts_one_sentence_audio_int8', SENTENCES[0], 'int8', audio = wav)
    vocoder.quantize_for_serving(False)

    # a saved table, selected by label; four texts through `predict_batched`
    table = model.save_embeddings('speakers.npz', emb[:4], speaker = ['a', 'b', 'a', 'b'])
    check(np.allclose(model.get_speaker_embedding(table, mode = 'label', label = 'a'),
                      emb[[0, 2]].mean(axis = 0)), 'label selection')
    drive('sv2tts_table_label', SENTENCES[0], 'default', embeddings = table, mode = 'label',
          label = 'a')
    drive('sv2tts_batch_of_4', SENTENCES, 'default', batch_size = 4, embeddings = table,
          mode = 'label', label = 'b', use_fused_decoder = True)

    # two speakers give two mels; a second speaker is not answered from map.json
    tokens = model.encode_text(SENTENCES[0])
    kw = dict(max_length = max_frames, deterministic = True, early_stopping = False)
    mel_a = model.compiled_infer(tokens, embeddings = emb[0], ** kw).mel
    mel_b = model.compiled_infer(tokens, embeddings = emb[1], ** kw).mel
    speakers_rel = float((mel_a - mel_b).abs().max() / mel_a.abs().max())
    check(speakers_rel > 1e-2, 'two speakers, one mel: {}'.format(speakers_rel))
    directory = os.path.join(root, 'predictions')
    first = drive('sv2tts_directory_speaker_a', SENTENCES[0], 'default', directory = directory,
                  embeddings = emb[0], save = True)
    second = drive('sv2tts_directory_speaker_b', SENTENCES[0], 'default', directory = directory,
                   embeddings = emb[1], save = True)
    cached = load_json(os.path.join(directory, 'map.json'))
    check(SENTENCES[0] in cached and not np.array_equal(first[0]['audio'], second[0]['audio']),
          'second speaker: map.json {}'.format(sorted(cached)))
    emit({'phase': 'sv2tts', 'embedding': embedding, 'runs': runs,
          'two_speakers_mel_rel_diff': speakers_rel, 'memory_width': 768,
          'spk_dim': spk_dim})
    return cases, runs


def _drive_counted(runs, name, texts, expected, ** kw):
    """One `tts()` run of `texts` after a warm-up at the same options, the
    launch counts read around it and checked against `expected`; records
    total ms, the task model's decode and vocode ms and the real-time
    factor under `runs[name]`."""
    from text_to_speech_tpu_torch import tts
    model = kw['model']
    tts(texts, ** kw)                                                    # warm-up
    torch.cuda.synchronize()
    reset_launches()
    start = time.perf_counter()
    outputs = tts(texts, ** kw)
    total_s = time.perf_counter() - start
    launches = read_launches()
    check(launches == dict(expected), '{}: launches {} (expected {})'.format(
        name, launches, expected))
    audio_s = 0.
    for out in outputs:
        check(bool(np.isfinite(out['audio']).all()) and bool(np.isfinite(out['mel'][0]).all())
              and out['audio'].shape == (out['mel'][0].shape[0] * 256,),
              '{}: output {}'.format(name, out['audio'].shape))
        audio_s += out['time']
    runs[name] = {'texts': len(outputs), 'frames': [o['mel'][0].shape[0] for o in outputs],
                  'total_ms': 1e3 * total_s, 'decode_ms': 1e3 * model.last_timings['decode_s'],
                  'vocode_ms': 1e3 * model.last_timings['vocode_s'], 'audio_s': audio_s,
                  'rtf': audio_s / total_s, 'launches': launches}
    return outputs


def nvidia_import_phase(root):
    """NVIDIA's Tacotron-2 and WaveGlow checkpoints imported at their full
    width (synthetic, seeded, in NVIDIA's layout; the WaveGlow weight-normed
    with fused cond layers) into `root`, saved, and `tts(lang='en',
    root=...)` run from them: K3 decodes, K1 (K2 in int8 serving) vocodes.
    Returns (K3 cases, runs, the imported vocoder)."""
    from text_to_speech_tpu_torch import tts
    from text_to_speech_tpu_torch.init import (
        nvidia_tacotron2_state_dict, nvidia_waveglow_state_dict)
    from text_to_speech_tpu_torch.models.tts import Tacotron2, WaveGlow

    phase_start = time.perf_counter()
    tacotron2_pt = os.path.join(root, 'tacotron2_statedict.pt')
    waveglow_pt = os.path.join(root, 'waveglow.pt')
    # the stop gate's bias at -4 keeps a random decoder running
    torch.save({'state_dict': {k: torch.from_numpy(v) for k, v in
                               nvidia_tacotron2_state_dict(11, gate_bias = -4.).items()}},
               tacotron2_pt)
    torch.save({'model': nvidia_waveglow_state_dict(12)}, waveglow_pt)
    start = time.perf_counter()
    model = Tacotron2.from_nvidia_pretrained(tacotron2_pt, root = root, device = 'cuda')
    tacotron2_s = time.perf_counter() - start
    start = time.perf_counter()
    vocoder = WaveGlow.from_nvidia_pretrained(waveglow_pt, root = root, device = 'cuda')
    waveglow_s = time.perf_counter() - start
    hp, wg = model.arch.hp, vocoder.arch.hp
    check(hp.lsa_attention_kernel_size == 31 and hp.attention_rnn_dim == 1024
          and model.arch.supports_fused_decoder(1, 64), 'imported Tacotron-2: {}'.format(hp))
    check((wg.n_flows, wg.wn_layers, wg.wn_channels, wg.n_early_every, wg.wn_fused)
          == (12, 8, 512, 4, True), 'imported WaveGlow: {}'.format(wg))
    n_flows, frames, chunk = wg.n_flows, 256, 64
    gates = dict(min_fpt_ratio = 0., max_fpt_ratio = 1e9, save = False, display = False,
                 max_length = frames)
    # K3 at the imported widths against its plain version, as the kernels phase holds it
    cases = decoder_steps_phase(model, shapes = ((1, 64, False),), name = 'decoder_steps_nvidia')

    runs = {}
    # `tts(lang='en')` loads 'pretrained_tacotron2' and 'waveglow' from the root by name
    reset_launches()
    start = time.perf_counter()
    by_name = tts(SENTENCES[0], lang = 'en', root = root, device = 'cuda', deterministic = True,
                  ** gates)
    by_name_ms = 1e3 * (time.perf_counter() - start)
    launches = read_launches()
    expected = dict(wn_block = n_flows, wn_block_int8 = 0, wn_layer = 0,
                    decoder_steps = frames // chunk)
    check(launches == expected and by_name[0]['mel'][0].shape[0] == frames,
          'tts(lang=en): launches {}, frames {}'.format(launches, by_name[0]['mel'][0].shape))
    kw = dict(model = model, vocoder = vocoder, ** gates)
    in_memory = tts(SENTENCES[0], deterministic = True, ** kw)
    reload_err = float(np.abs(in_memory[0]['mel'][0] - by_name[0]['mel'][0]).max())
    check(reload_err <= 1e-5 * float(np.abs(in_memory[0]['mel'][0]).max()),
          'the model reloaded by name decodes another mel: {}'.format(reload_err))
    runs['nvidia_by_name'] = {'total_ms_with_load': by_name_ms, 'launches': launches,
                              'mel_vs_in_memory_max_abs': reload_err}
    _drive_counted(runs, 'nvidia_one_sentence', SENTENCES[0], expected, ** kw)
    # the vocoder's kernel route against its float32 chain on the imported
    # weights (the tolerance of the e2e phase: 1e-2 of the largest sample)
    mel = torch.from_numpy(in_memory[0]['mel'][0][None, :16].copy()).cuda()
    lg = 16 * wg.upsample_stride // wg.n_group
    with torch.no_grad():
        z = torch.randn((1, lg, wg.n_group), generator = torch.Generator(device = 'cuda')
                        .manual_seed(4), device = 'cuda')
        fast = vocoder.arch.infer(vocoder._serving_params(True, False), mel, z = z,
                                  use_kernel = True)
        plain = vocoder.arch.infer(vocoder.params, mel, z = z, use_kernel = False)
    vocoder_err = float((fast - plain).abs().max()) / float(plain.abs().max())
    check(vocoder_err < 1e-2, 'imported vocoder, K1 vs f32 chain: {}'.format(vocoder_err))
    vocoder.quantize_for_serving(validate = mel)
    check(vocoder.serving_mode == 'int8', 'int8 gate: {}'.format(vocoder._last_serving_snr_db))
    _drive_counted(runs, 'nvidia_one_sentence_int8', SENTENCES[0],
                   dict(expected, wn_block = 0, wn_block_int8 = n_flows), ** kw)
    runs['nvidia_one_sentence_int8']['gate_snr_db'] = vocoder._last_serving_snr_db
    vocoder.quantize_for_serving(False)
    emit({'phase': 'nvidia_import', 'import_ms': {'tacotron2': 1e3 * tacotron2_s,
                                                  'waveglow': 1e3 * waveglow_s},
          'runs': runs, 'vocoder_kernel_vs_f32_rel': vocoder_err, 'tolerance_rel': 1e-2,
          'gate_bias': -4., 'phase_s': time.perf_counter() - phase_start})
    del model
    return cases, runs, vocoder


def fastspeech2_with_durations(model, tokens, durations, max_frames):
    """`FastSpeech2.compiled_infer` in float32 with the controls at 1 and the
    `durations` (B, L) given in the place of the predicted ones: the
    variances, length regulator, decoder and postnet of `arch.infer`."""
    from text_to_speech_tpu_torch.models.fastspeech2_arch import length_regulator
    arch, params = model.arch, model.params
    with torch.no_grad():
        enc, _, pad_mask = arch.encode(params, tokens)
        pitch = energy = None
        if arch.hp.variance_level == 'phoneme':
            enc, pitch, energy = arch._apply_variances(params, enc, pad_mask = pad_mask,
                                                       p_control = 1., e_control = 1.)
        x, frame_mask, lengths, _ = length_regulator(enc, durations, max_frames)
        if arch.hp.variance_level == 'frame':
            x, pitch, energy = arch._apply_variances(
                params, x, pad_mask = frame_mask[..., None].to(x.dtype), p_control = 1.,
                e_control = 1.)
        mel = arch.decode(params, x, frame_mask) * frame_mask[..., None]
        return {'mel': arch.postnet(params, model.state, mel, frame_mask = frame_mask)[0],
                'decoder_output': mel, 'pitch': pitch, 'energy': energy, 'lengths': lengths}


def fastspeech2_phase(vocoder, root):
    """FastSpeech-2 at the JAX package's default widths, random seeded
    weights saved under `root`, vocoding on the NVIDIA-width `vocoder`: one
    sentence through `tts()` (the one-launch path) in both serving modes,
    four through `predict_batched`, bfloat16, and the float32 forward on the
    card against the port on the CPU.  Returns the runs and the (B, T) that
    K1 and K2 get on the one-sentence and the batched route."""
    from text_to_speech_tpu_torch.init import init_fastspeech2
    from text_to_speech_tpu_torch.models.fastspeech2_arch import HParamsFastSpeech2
    from text_to_speech_tpu_torch.models.tts import FastSpeech2
    from text_to_speech_tpu_torch.models.tts.tacotron2 import pad_batch, pad_to_multiple
    from text_to_speech_tpu_torch.text import default_english_tokenizer, en_symbols

    phase_start = time.perf_counter()
    hp = HParamsFastSpeech2(vocab_size = len(en_symbols))
    params, state = init_fastspeech2(hp, seed = 13)
    build = lambda device: FastSpeech2.from_jax(
        params, state, tokenizer = default_english_tokenizer(), device = device, root = root,
        vocab_size = len(en_symbols))
    model = build('cuda')
    tokens = model.encode_text(SENTENCES[0])
    # random predictors give durations near 0: the floor makes the sentence ~256 frames
    min_duration = -(-256 // len(tokens))
    n_flows = vocoder.arch.hp.n_flows
    kw = dict(model = model, vocoder = vocoder, min_duration = min_duration, save = False,
              display = False)
    one = dict(wn_block = n_flows, wn_block_int8 = 0, wn_layer = 0, decoder_steps = 0)
    runs = {}
    single = _drive_counted(runs, 'fastspeech2_one_sentence', SENTENCES[0], one, ** kw)
    frames = single[0]['mel'][0].shape[0]
    check(frames >= 256, 'FastSpeech-2: {} frames for {} tokens'.format(frames, len(tokens)))
    grid = single[0]['audio'].astype(np.float64) * 32767.
    check(float(np.abs(grid - np.round(grid)).max()) < 1e-2, 'not on the int16 grid')
    _drive_counted(runs, 'fastspeech2_batch_of_4', SENTENCES, one, batch_size = 4,
                   min_fpt_ratio = 0., max_fpt_ratio = 1e9, ** kw)
    _drive_counted(runs, 'fastspeech2_one_sentence_bf16', SENTENCES[0], one,
                   dtype = torch.bfloat16, ** kw)
    mel = torch.from_numpy(single[0]['mel'][0][None, :32].copy()).cuda()
    vocoder.quantize_for_serving(validate = mel)
    check(vocoder.serving_mode == 'int8', 'int8 gate: {}'.format(vocoder._last_serving_snr_db))
    _drive_counted(runs, 'fastspeech2_one_sentence_int8', SENTENCES[0],
                   dict(one, wn_block = 0, wn_block_int8 = n_flows), ** kw)
    vocoder.quantize_for_serving(False)

    # the WN blocks' (B, T) on the two routes: the decode buffer, padded to
    # the vocoder's multiple of frames, at upsample_rate / n_group steps a frame
    def wn_shape(texts):
        encoded = [e for text in texts for e in model._split_and_encode(text, -1)[1]]
        mel = model.compiled_infer(pad_batch(encoded, pad_value = model.blank_token_idx),
                                   max_length = 10., min_duration = min_duration).mel
        frames = -(-mel.shape[1] // vocoder.serving_pad_multiple) * vocoder.serving_pad_multiple
        return mel.shape[0], frames * vocoder.upsample_rate // vocoder.arch.hp.n_group
    shapes = {'one_sentence': wn_shape(SENTENCES[:1]), 'batch_of_4': wn_shape(SENTENCES)}

    # the forward alone (CUDA events), and the float32 forward on the card
    # against the port on the CPU: durations equal, or apart by one only
    # where the value before rounding is within 1e-5 of a tie; the rest
    # against the CPU's forward given the card's durations, so that a tie
    # leaves nothing uncompared: the mel within 1e-4 of its largest
    # magnitude (float32 on both sides, TF32 off, another summation order)
    forward = lambda: model.compiled_infer(tokens, max_length = 10., min_duration = min_duration)
    forward_ms = time_ms(forward, reps = 5)
    card = forward()
    cpu_model = build('cpu')
    cpu = cpu_model.compiled_infer(tokens, max_length = 10., min_duration = min_duration)
    durations = card.durations.cpu()
    moved = durations != cpu.durations
    padded = torch.as_tensor(pad_to_multiple(tokens[None], 64, axis = 1,
                                             constant_values = model.blank_token_idx),
                             dtype = torch.long)
    with torch.no_grad():
        enc, _, pad = cpu_model.arch.encode(cpu_model.params, padded)
        log_d = cpu_model.arch._variance_predictor(cpu_model.params['duration_predictor'], enc,
                                                   pad_mask = pad)
    pre = torch.exp(log_d) - 1.
    ties = float((pre[moved] - (torch.floor(pre[moved]) + 0.5)).abs().max()) \
        if bool(moved.any()) else None
    check(ties is None or (ties <= 1e-5 and int((durations - cpu.durations).abs().max()) <= 1),
          'durations differ off a tie: {}'.format(ties))
    ref = fastspeech2_with_durations(cpu_model, padded, durations, cpu.mel.shape[1])
    compared = {name: float((getattr(card, name).cpu() - ref[name]).abs().max())
                / float(ref['mel'].abs().max())
                for name in ('mel', 'decoder_output', 'pitch', 'energy')}
    # with no duration moved, the CPU's forward given its own durations
    helper = None if bool(moved.any()) else \
        float((cpu.mel - ref['mel']).abs().max()) / float(ref['mel'].abs().max())
    check(max(compared.values()) <= 1e-4 and torch.equal(card.lengths.cpu(), ref['lengths'])
          and (helper is None or helper <= 1e-6),
          'FastSpeech-2 card vs CPU: {}, given durations vs infer {}'.format(compared, helper))
    emit({'phase': 'fastspeech2', 'runs': runs, 'min_duration': min_duration,
          'tokens': len(tokens), 'forward_ms': forward_ms, 'wn_block_shapes': shapes,
          'card_vs_cpu': {'durations_moved': int(moved.sum()), 'tie_distance': ties,
                          'rel_err': compared, 'tolerance_rel': 1e-4,
                          'given_durations_vs_infer_rel': helper},
          'phase_s': time.perf_counter() - phase_start})
    return runs, shapes


def _card_vs_cpu_rel(card, cpu):
    """max |card - cpu| / max |cpu| (float32 on both sides, TF32 off)."""
    card, cpu = card.float().cpu(), cpu.float().cpu()
    return float((card - cpu).abs().max()) / float(cpu.abs().max())


def _vocoder_checks(name, cls, sd, config_fn, convert, root, model, runs):
    """One of the phase's vocoders: imported from its seeded published-layout
    dict by `from_torch_pretrained` (saved under `root`), reloaded by name,
    and the same weights made in memory through the JAX tree; one sentence
    through `tts()` (4 K3, no WN kernel) after a warm-up; the vocode of a
    256-frame mel (CUDA events); one 64-frame mel on the card against the
    port on the CPU.  Returns (vocoder, the `tts()` options, the expected
    launches, the record)."""
    from text_to_speech_tpu_torch.models import get_pretrained
    from text_to_speech_tpu_torch.models.tts_checkpoints import remove_torch_weight_norm

    start = time.perf_counter()
    vocoder = cls.from_torch_pretrained(sd, name = name, root = root, device = 'cuda')
    import_ms = 1e3 * (time.perf_counter() - start)
    folded = remove_torch_weight_norm(sd)
    seeded = cls.from_jax(convert(folded), device = 'cuda', root = root, ** config_fn(folded))
    by_name = get_pretrained(name, root = root, device = 'cuda')
    mel = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 256, 80))
                           .astype(np.float32) - 5.).cuda()
    with torch.no_grad():
        want = seeded.compiled_infer(mel)
        imported_err = max(float((vocoder.compiled_infer(mel) - want).abs().max()),
                           float((by_name.compiled_infer(mel) - want).abs().max()))
    check(imported_err == 0., '{}: the imported vocoder differs from the seeded one by {}'
          .format(name, imported_err))
    vocode_ms = time_ms(lambda: vocoder.compiled_infer(mel), reps = 5)
    cpu = cls.from_jax(convert(folded), device = 'cpu', ** config_fn(folded))
    with torch.no_grad():
        card_cpu = _card_vs_cpu_rel(vocoder.compiled_infer(mel[:, :64]),
                                    cpu.compiled_infer(mel[:, :64].cpu()))
    check(card_cpu <= 1e-4, '{}: card vs CPU {}'.format(name, card_cpu))
    one = dict(wn_block = 0, wn_block_int8 = 0, wn_layer = 0, decoder_steps = 256 // 64)
    kw = dict(model = model, vocoder = vocoder, max_length = 256, min_fpt_ratio = 0.,
              max_fpt_ratio = 1e9, save = False, display = False)
    _drive_counted(runs, name + '_one_sentence', SENTENCES[0], one, ** kw)
    return vocoder, kw, one, {'import_ms': import_ms, 'vocode_ms_256_frames': vocode_ms,
                              'imported_vs_seeded_max_abs': imported_err,
                              'card_vs_cpu_rel_64_frames': card_cpu, 'tolerance_rel': 1e-4}


def _vits_durations_check(card, cpu, pre):
    """VITS's durations card against CPU: equal, or apart by one where the
    value before `ceil` is within 1e-5 of an integer; returns (rows where
    every duration agrees, the number moved)."""
    durations, ref = card.durations.cpu(), cpu.durations
    moved = durations != ref
    if bool(moved.any()):
        ties = float((pre[moved] - torch.round(pre[moved])).abs().max())
        check(ties <= 1e-5 and int((durations - ref).abs().max()) <= 1,
              'VITS durations differ off a tie: {}'.format(ties))
    return ~moved.any(dim = 1), int(moved.sum())


def _vits_bfloat16_on(vits, tokens, durations, max_frames):
    """VITS in bfloat16 at noise 0 on the given durations: the text encoder,
    the reverse flow and the generator in bfloat16 (the path of
    `infer_latent` after `ceil`).  Returns (max |log-durations - float32's|
    over the tokens, the audio in float32)."""
    from text_to_speech_tpu_torch.models.fastspeech2_arch import length_regulator

    arch = vits.arch
    params = vits._cast_params(torch.bfloat16)
    with torch.no_grad():
        h, _, _, valid = arch.encode_text(vits.params, tokens)
        want = arch.sdp_sample(vits.params, h, valid, noise_scale_w = 0.)
        h, m_p, logs_p, valid = arch.encode_text(params, tokens)
        logw = arch.sdp_sample(params, h, valid, noise_scale_w = 0.)
        logw_err = float(((logw.float() - want.float()) * valid).abs().max())
        stats, frame_mask, _, _ = length_regulator(torch.cat([m_p, logs_p], dim = -1),
                                                   durations, max_frames)
        mask = frame_mask[..., None].to(stats.dtype)
        z = arch.flow(params, stats.chunk(2, dim = -1)[0] * mask, frame_mask, reverse = True)
        audio = arch.decode_frames(params, z * mask, dtype = torch.bfloat16)
    return logw_err, audio.float()


def families_phase(model, root):
    """The other families at their published widths, seeded weights: HiFi-GAN
    V1 and Vocos behind the NVIDIA-width Tacotron-2 (K3 decodes, no WN
    kernel), VITS (use_sdp, the LJSpeech release's layout) and SV2TTS-VITS
    (a 256-wide embedding), each imported or made under `root`.  Returns the
    runs, the VITS model and the `d_control` that gives it ~256 frames a
    sentence."""
    from text_to_speech_tpu_torch import tts
    from text_to_speech_tpu_torch.init import (
        hifigan_state_dict, vits_state_dict, vocos_state_dict)
    from text_to_speech_tpu_torch.models.tts import HiFiGAN, SV2TTSVITS, VITS, Vocos
    from text_to_speech_tpu_torch.models.tts_checkpoints import (
        convert_hifigan, convert_vocos, hifigan_config_from_state_dict,
        vocos_config_from_state_dict)
    from text_to_speech_tpu_torch.text import default_english_tokenizer, en_symbols
    from text_to_speech_tpu_torch.utils.sequence_utils import pad_batch, pad_to_multiple

    phase_start = time.perf_counter()
    runs, out = {}, {}
    # HiFi-GAN V1: one sentence, a batch of four, win_len=128 (the sequential
    # path, which vocodes each whole mel)
    hifigan, kw, one, out['hifigan'] = _vocoder_checks(
        'hifigan', HiFiGAN, hifigan_state_dict(21), hifigan_config_from_state_dict,
        convert_hifigan, root, model, runs)
    _drive_counted(runs, 'hifigan_batch_of_4', SENTENCES, one, batch_size = 4, ** kw)
    _drive_counted(runs, 'hifigan_win_len_128', SENTENCES[0], one, win_len = 128, ** kw)
    _, _, _, out['vocos'] = _vocoder_checks(
        'vocos', Vocos, vocos_state_dict(22), vocos_config_from_state_dict, convert_vocos,
        root, model, runs)

    # VITS at the HParamsVITS widths, the official LJSpeech layout (use_sdp)
    start = time.perf_counter()
    vits = VITS.from_torch_pretrained(vits_state_dict(23, vocab_size = len(en_symbols)),
                                      name = 'vits', root = root, device = 'cuda',
                                      tokenizer = default_english_tokenizer())
    import_ms = 1e3 * (time.perf_counter() - start)
    check(vits.arch.hp.use_sdp and vits.arch.hp.hidden_channels == 192
          and vits.upsample_rate == 256, 'imported VITS: {}'.format(vits.arch.hp))
    tokens = vits.encode_text(SENTENCES[0])
    deterministic = dict(max_length = 10., noise_scale = 0., noise_scale_w = 0.)
    # d_control scales the random predictor's durations to ~256 frames a sentence
    base = int(vits.compiled_infer(tokens, ** deterministic).lengths[0])
    d_control = 256. / max(base, 1)
    none = dict(wn_block = 0, wn_block_int8 = 0, wn_layer = 0, decoder_steps = 0)

    def drive_vits(name, texts, model, ** extra):
        kw = dict(model = model, d_control = d_control, save = False, display = False, ** extra)
        tts(texts, ** kw)
        torch.cuda.synchronize()
        reset_launches()
        start = time.perf_counter()
        outputs = tts(texts, ** kw)
        total_s = time.perf_counter() - start
        launches = read_launches()
        check(launches == none, '{}: launches {}'.format(name, launches))
        audio_s = sum(o['time'] for o in outputs)
        check(all(np.isfinite(o['audio']).all() and o['audio'].size > 0 for o in outputs),
              '{}: output'.format(name))
        runs[name] = {'texts': len(outputs), 'samples': [int(o['audio'].size) for o in outputs],
                      'total_ms': 1e3 * total_s,
                      'latent_ms': 1e3 * model.last_timings['decode_s'],
                      'generator_ms': 1e3 * model.last_timings['vocode_s'],
                      'audio_s': audio_s, 'rtf': audio_s / total_s, 'launches': launches}
    drive_vits('vits_one_sentence', SENTENCES[0], vits)
    drive_vits('vits_batch_of_4', SENTENCES, vits, batch_size = 4)

    # deterministic at the phase's d_control on the batch of four, card
    # against CPU; then bfloat16 against the card's float32
    deterministic['d_control'] = d_control
    cpu_vits = VITS.from_jax(vits.jax_trees()['params'], device = 'cpu',
                             tokenizer = default_english_tokenizer(), ** vits.arch.get_config())
    batch = pad_batch([vits.encode_text(text) for text in SENTENCES],
                      pad_value = vits.blank_token_idx)
    card = vits.compiled_infer(batch, ** deterministic)
    cpu = cpu_vits.compiled_infer(batch, ** deterministic)
    tok = torch.as_tensor(pad_to_multiple(batch, 64, axis = 1,
                                          constant_values = vits.blank_token_idx))
    with torch.no_grad():
        arch, params = cpu_vits.arch, cpu_vits.params
        h, _, _, valid = arch.encode_text(params, tok)
        pre = torch.exp(arch.sdp_sample(params, h, valid, noise_scale_w = 0.)) * valid \
            * d_control
    rows, moved = _vits_durations_check(card, cpu, pre)
    check(bool(rows.any()), 'VITS card vs CPU: no row with every duration equal '
          '({} moved)'.format(moved))
    vits_err = _card_vs_cpu_rel(card.audio[rows.cuda()], cpu.audio[rows])
    check(vits_err <= 1e-4, 'VITS card vs CPU: {}'.format(vits_err))
    # bfloat16: the entry point's whole pass finite; its log-durations
    # within 1e-1 of float32's; its audio from float32's durations
    bf16 = vits.compiled_infer(batch, dtype = torch.bfloat16, ** deterministic)
    logw_err, bf16_audio = _vits_bfloat16_on(vits, tok.cuda(), card.durations,
                                             card.audio.shape[1] // vits.upsample_rate)
    bf16_err = _card_vs_cpu_rel(bf16_audio, card.audio)
    check(bool(torch.isfinite(bf16.audio).all()) and logw_err <= 1e-1 and bf16_err <= 1e-1,
          'VITS bfloat16 vs float32: log-durations {}, audio {}'.format(logw_err, bf16_err))
    forward_ms = time_ms(lambda: vits.compiled_infer(tokens, d_control = d_control), reps = 5)
    out['vits'] = {'import_ms': import_ms, 'tokens': len(tokens), 'd_control': d_control,
                   'frames_at_d_control_1': base, 'forward_ms': forward_ms,
                   'card_vs_cpu': {'texts': len(SENTENCES), 'durations_moved': moved,
                                   'rows_compared': int(rows.sum()), 'rel_err': vits_err,
                                   'tolerance_rel': 1e-4},
                   'bfloat16_vs_float32': {'durations_moved': int((bf16.durations
                                                                   != card.durations).sum()),
                                           'log_durations_max_abs': logw_err,
                                           'tolerance_log_durations': 1e-1,
                                           'rel_err_on_float32_durations': bf16_err,
                                           'tolerance_rel': 1e-1}}

    # SV2TTS-VITS: one sentence cloned from a saved table of 256-wide embeddings
    config = {k: v for k, v in vits.arch.get_config().items()
              if k not in ('vocab_size', 'pad_token', 'spec_channels')}
    clone = SV2TTSVITS.create(name = 'sv2tts_vits', root = root, device = 'cuda', seed = 24,
                              embedding_dim = 256, ** config)
    emb = np.random.default_rng(25).standard_normal((4, 256)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis = 1, keepdims = True)
    table = clone.save_embeddings('speakers.npz', emb, speaker = ['a', 'b', 'a', 'b'])
    drive_vits('sv2tts_vits_one_sentence', SENTENCES[0], clone, embeddings = table,
               mode = 'label', label = 'a')
    emit({'phase': 'families', ** out, 'runs': runs,
          'phase_s': time.perf_counter() - phase_start})
    return runs, vits, d_control


# the serving phase's requests: twelve sentences of one token bucket (64) and
# four of the next (128), so that a later admission re-buckets the batch
SERVING_TEXTS = SENTENCES + [
    'The birch canoe slid on the smooth planks.',
    'Glue the sheet to the dark blue background.',
    'It is easy to tell the depth of a well.',
    'These days a chicken leg is a rare dish.',
    'Rice is often served in round bowls.',
    'The juice of lemons makes fine punch.',
    'The box was thrown beside the parked truck.',
    'The hogs were fed chopped corn and garbage.',
    'Four hours of steady work faced us, and the night was long and cold, '
    'but nobody spoke of it.',
    'A large size in stockings is hard to sell, said the clerk, and he put '
    'the box back on the shelf.',
    'The boy was there when the sun rose, and he stayed on the hill until '
    'the last light went out.',
    'A rod is used to catch pink salmon, and the best of them are caught in '
    'the early morning hours.']


def _rebucket(carry, s_new, memory, pm, mask):
    """A decode carry and its memory at S tokens re-bucketed to `s_new`,
    as the stepper does when a longer request joins: zero padding."""
    frame, (att, (dec,), ctx, (prev, cum)) = carry
    pad = lambda t: torch.nn.functional.pad(t, (0, 0) * (t.ndim - 2) + (0, s_new - t.shape[1]))
    return ((frame, (att, (dec,), ctx, (pad(prev), pad(cum)))),
            pad(memory), pad(pm), pad(mask))


def _decode_chunk_routes(model, B):
    """`decode_chunk` on K3 (one launch a group of <= 8 rows) against the
    plain route at B rows: a chunk of 64 steps at S = 64, the batch
    re-bucketed to S = 128, a second chunk.  Relative errors to each
    compared tensor's scale, K3 launches, and the wall ms of a K3 chunk."""
    from text_to_speech_tpu_torch.ops.decoder_kernel import decoder_steps

    arch, hp = model.arch, model.arch.hp
    rng = np.random.default_rng(30 + B)
    tokens = np.zeros((B, 64), np.int64)
    for i in range(B):
        n = 64 - (7 * i) % 40
        tokens[i, :n] = rng.integers(1, hp.vocab_size, n)
    weights = model._decoder_weights(None)
    with torch.no_grad():
        enc, mask = arch.encode(model.params, model.state, torch.from_numpy(tokens).cuda())
        memory, pm = arch.process_memory(model.params['decoder'], enc, mask)
    zero = (torch.zeros((B, hp.n_mel_channels), device = 'cuda'),
            arch.init_cell_state(B, 64, device = 'cuda'))

    def run(fused):
        kw = dict(weights = weights) if fused else {}
        carry, mem, p, m, out = zero, memory, pm, mask, []
        with torch.no_grad():
            for off in (0, 64):
                if off:
                    carry, mem, p, m = _rebucket(carry, 128, mem, p, m)
                frames, gates, carry = arch.decode_chunk(
                    model.params, * carry, mem, p, m, n_steps = 64, step_offset = off,
                    deterministic = True, ** kw)
                out += [frames, gates]
        leaves = lambda t: [x for y in t for x in leaves(y)] if isinstance(t, tuple) else [t]
        return out + leaves(carry)

    decoder_steps.launches = 0
    fused = run(True)
    launches = decoder_steps.launches
    plain = run(False)
    rel = [float((a.float() - b.float()).abs().max()) / max(float(b.abs().max()), 1e-30)
           for a, b in zip(fused, plain)]
    # the wall time of one K3 chunk (64 steps) at this batch, synchronised
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        start = time.perf_counter()
        with torch.no_grad():
            arch.decode_chunk(model.params, * zero, memory, pm, mask, n_steps = 64,
                              deterministic = True, weights = weights)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - start))
    return {'B': B, 'launches_two_chunks': launches, 'max_rel_err': max(rel),
            'rel_err_frames': max(rel[0], rel[2]), 'rel_err_gates': max(rel[1], rel[3]),
            'tolerance_rel': 1e-4, 'chunk_ms': statistics.median(times)}


def _k3_serving_case(model, B = 8, S = 64):
    """K3 against its plain version at a serving row group (by default B = 8,
    S = 64; 64 steps, float32, deterministic prenet): error, ms, plain ms,
    bound."""
    from text_to_speech_tpu_torch.ops.decoder_kernel import (
        decoder_steps, decoder_steps_plain, init_decoder_state, pack_decoder_weights)

    arch, hp, K = model.arch, model.arch.hp, 64
    weights = pack_decoder_weights(model.params['decoder'], n_mel = hp.n_mel_channels)
    tokens = torch.from_numpy(np.random.default_rng(40).integers(
        1, hp.vocab_size, (B, S))).cuda()
    with torch.no_grad():
        enc, mask = arch.encode(model.params, model.state, tokens)
        mem, pm = arch.process_memory(model.params['decoder'], enc, mask)
    args = (weights, mem.contiguous(), pm.contiguous(), mask.float(),
            mask.sum(dim = 1).to(torch.int32), torch.zeros((B, hp.prenet_sizes[0]), device = 'cuda'))
    fresh = lambda: init_decoder_state(B, S, mem.shape[-1], hp.attention_rnn_dim,
                                       hp.n_mel_channels, device = 'cuda')
    seed = torch.zeros((1,), dtype = torch.int64, device = 'cuda')
    kw = dict(n_steps = K, deterministic = True)
    steps = decoder_steps(* args, fresh(), seed, ** kw)[0]
    torch.cuda.synchronize()
    # the reference call, timed: the plain version's one call
    start = time.perf_counter()
    ref = decoder_steps_plain(* args, fresh(), seed, ** kw)[0]
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - start)
    err = float((steps - ref).abs().max())
    scale = float(ref.abs().max())
    check(err <= 1e-4 * scale, 'K3 at the serving row group: {} > 1e-4 x {}'.format(err, scale))
    ops_s, nbytes, _ = decoder_steps_work(weights, B, S, K, 4, PEAK_F32_FLOPS)
    st = fresh()
    return {'B': B, 'S': S, 'K': K, 'max_abs_err': err, 'max_rel_err': err / scale,
            'tolerance_rel': 1e-4,
            'kernel_ms': time_ms(lambda: decoder_steps(* args, st, seed, ** kw)),
            'plain_ms': plain_ms,
            'bound_ms': 1e3 * max(ops_s, nbytes / PEAK_BYTES),
            'bound_by': 'operations' if ops_s > nbytes / PEAK_BYTES else 'bytes'}


def _http_clients(server, jobs, engine = None):
    """POST each (text, stream) job from a thread of its own: the first half
    at once, the second once `engine` has stepped a chunk more (at once
    when `engine` is None).  Returns,
    per job, the status, the request id, the WAV body, and seconds to the
    first audio bytes (streamed) or to the whole body, and to the end; and
    the wall seconds of all."""
    import http.client
    host, port = server._httpd.server_address[:2]
    results = [None] * len(jobs)

    def client(i, text, stream):
        conn = http.client.HTTPConnection(host, port, timeout = 300)
        try:
            start = time.perf_counter()
            conn.request('POST', '/tts?stream=1' if stream else '/tts',
                         body = json.dumps({'text': text}),
                         headers = {'Content-Type': 'application/json'})
            resp = conn.getresponse()
            if stream:
                head = resp.read(46)            # the WAV header, then the first sample
                first = time.perf_counter() - start
                body = head + resp.read()
            else:
                body = resp.read()
                first = time.perf_counter() - start
            results[i] = {'status': resp.status, 'id': resp.getheader('X-Request-Id'),
                          'body': body, 'first_s': first,
                          'total_s': time.perf_counter() - start, 'stream': stream}
        except Exception as e:                  # reported by the check below
            results[i] = {'status': None, 'error': repr(e)}
        finally:
            conn.close()

    threads = [threading.Thread(target = client, args = (i, * job), daemon = True)
               for i, job in enumerate(jobs)]
    half = len(jobs) // 2
    chunks = engine.stats['chunks'] if engine is not None else 0
    start = time.perf_counter()
    for t in threads[:half]:
        t.start()
    if engine is not None:
        deadline = time.perf_counter() + 120
        while engine.stats['chunks'] <= chunks and time.perf_counter() < deadline:
            time.sleep(0.001)
    for t in threads[half:]:
        t.start()
    for t in threads:
        t.join(timeout = 300)
    wall_s = time.perf_counter() - start
    check(all(r is not None and r['status'] == 200 for r in results),
          'HTTP requests: {}'.format([None if r is None else {k: v for k, v in r.items()
                                                              if k != 'body'} for r in results]))
    return results, wall_s


def _pcm(body):
    return np.frombuffer(body[44:], '<i2')


def _latency_summary(results, outputs, engine):
    """Time to first audio (the streamed requests, at the client) and
    latency (all, at the client); the engine's own first-audio seconds
    (from admission) and its loop's split (admission, steps, finishes)."""
    first = [r['first_s'] for r in results if r['stream']]
    total = [r['total_s'] for r in results]
    engine_first = [o['first_audio_s'] for o in outputs if 'first_audio_s' in o]
    return {'first_audio_ms_median': 1e3 * statistics.median(first),
            'first_audio_ms_max': 1e3 * max(first),
            'latency_ms_median': 1e3 * statistics.median(total),
            'latency_ms_max': 1e3 * max(total),
            'engine_first_audio_ms_median': 1e3 * statistics.median(engine_first),
            'engine': {k: engine.stats[k] for k in ('chunks', 'rows_stepped', 'step_s',
                                                     'admit_s', 'finish_s')},
            'chunks_by_rows': {b: {'chunks': n, 'ms_per_chunk': 1e3 * s / n}
                               for b, (n, s) in sorted(engine.stats.get(
                                   'chunk_s_by_rows', {}).items())}}


def _synced_ms(fn):
    """(result, wall ms) of `fn()` between two synchronisations."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - start)


def _device_busy(fn):
    """`fn()` under `torch.profiler` (host and CUDA): its wall ms, the
    device's busy ms (the union of its kernels' intervals), the busy share
    and the kernel launches."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities = [torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - start)
    kernels = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end = 0., float('-inf')
    for start_us, stop_us in kernels:
        busy_us += max(0., stop_us - max(start_us, end))
        end = max(end, stop_us)
    return {'wall_ms': wall_ms, 'device_busy_ms': busy_us / 1e3,
            'device_busy_share': busy_us / 1e3 / wall_ms, 'kernel_launches': len(kernels)}


def _stepper_alone(engine, texts, max_chunks = 16):
    """A served stepper driven alone on this thread, the engine idle: wall
    ms of the admission of one text and of `texts` in one burst, then of
    each chunk (`step_fn`: decode, reads, emissions) of the burst's rows
    and of the one row, until each is done."""
    record = {}
    for label, batch in (('one', texts[:1]), ('burst', texts)):
        if len(batch) == 1:
            states, ms = _synced_ms(lambda: [engine.start_fn(batch[0])])
        else:
            states, ms = _synced_ms(lambda: engine.start_fn.start_many(
                batch, [{}] * len(batch)))
        chunks = []
        for _ in range(max_chunks):
            (states, done), step_ms = _synced_ms(lambda: engine.step_fn(states))
            chunks.append(step_ms)
            if all(done):
                break
        _, finish_ms = _synced_ms(lambda: engine.finish_fn.finish_many(states))
        record[label] = {'rows': len(batch), 'admit_ms': ms, 'chunk_ms': chunks,
                         'finish_ms': finish_ms}
    return record


def serving_phase(model, vocoder, vits, d_control):
    """Serving over HTTP with continuous batching at NVIDIA width: K3's
    `decode_chunk` against the plain route (B = 1, 4, 16, re-bucketed),
    `serve()` on Tacotron-2 + WaveGlow (``sigma=0``) answering 16 requests
    (8 at once, 8 after the first chunk; half streamed), each mel against
    `infer_fused`, the streams' tails against the offline vocode, launches
    counted, K1 at the emission shapes; then `serve()` on the families
    phase's VITS with 4 requests.  Returns (K3 case, K1 cases, runs)."""
    from text_to_speech_tpu_torch.models.tts import serve
    from text_to_speech_tpu_torch.runtimes.http_server import pcm16
    from text_to_speech_tpu_torch.utils.sequence_utils import pad_to_multiple

    phase_start = time.perf_counter()
    out = {'decode_chunk': {}}
    for B in (1, 4, 8, 16):
        case = _decode_chunk_routes(model, B)
        out['decode_chunk']['B{}'.format(B)] = case
        check(case['max_rel_err'] <= 1e-4 and case['launches_two_chunks'] == 2 * -(-B // 8),
              'decode_chunk K3 against plain: {}'.format(case))
    k3_case = _k3_serving_case(model)
    out['decoder_steps_B8_S64'] = k3_case

    # the streamed WaveGlow at sigma = 0, so that a window vocodes as the
    # whole mel does
    sigma, vocoder.arch.hp.sigma = vocoder.arch.hp.sigma, 0.
    vocoded, device_vocoder_fn = [], vocoder.device_vocoder_fn

    def recording_vocoder_fn(** config):
        fn, params, tag = device_vocoder_fn(** config)

        def recorded(params, mel, generator = None):
            vocoded.append(tuple(mel.shape))
            return fn(params, mel, generator)
        return recorded, params, tag

    n_flows = vocoder.arch.hp.n_flows
    server = vits_server = None
    try:
        start = time.perf_counter()
        # 256 frames a request (the gate is biased off); the vocoder pads
        # every emission window to 256 frames, so a context of 192 frames
        # costs no more than the default 32 here and gives each emission of
        # a 256-frame request its whole left context (12 flows of random
        # weights reach far beyond 32 frames)
        server = serve(model = model, vocoder = vocoder, port = 0, block = False,
                       max_batch_size = 16, max_steps = 256, deterministic = True,
                       stream_context = 192, warmup = SERVING_TEXTS[0])
        engine = server.engine
        setup_s = time.perf_counter() - start
        check(engine.native_scheduler, 'serve(): the engine is not on the native scheduler')
        check(engine.step_fn.fused, 'serve(): the Tacotron-2 stepper is not on K3')
        vocoder.device_vocoder_fn = recording_vocoder_fn
        torch.cuda.synchronize()
        for key in ('chunks', 'rows_stepped', 'step_s', 'admit_s', 'finish_s'):
            engine.stats[key] = 0
        engine.stats['chunk_s_by_rows'] = {}
        reset_launches()
        jobs = [(text, i % 2 == 1) for i, text in enumerate(SERVING_TEXTS)]
        results, wall_s = _http_clients(server, jobs, engine)
        torch.cuda.synchronize()
        launches = read_launches()
        del vocoder.device_vocoder_fn                   # the class's method again
        chunk_by_rows = dict(engine.stats['chunk_s_by_rows'])
        outputs = [server._requests[r['id']].result.get(timeout = 60) for r in results]
        timings = _latency_summary(results, outputs, engine)
        timings['scheduler'] = engine.scheduler_stats
        # the same 16 requests again under the profiler: the device's busy share
        timings['profiled_run'] = _device_busy(lambda: _http_clients(server, jobs, engine))
        # where a request's time goes without concurrency: the stepper alone
        timings['stepper_alone'] = _stepper_alone(engine, SERVING_TEXTS)
        server.stop()
        server = None

        # launches: K3 one a chunk for each group of <= 8 rows, 12 K1 a vocode
        expected_k3 = sum(n * -(-bucket // 8) for bucket, (n, _) in chunk_by_rows.items())
        check(launches['decoder_steps'] == expected_k3 and launches['decoder_steps'] > 0
              and 16 in chunk_by_rows, 'serving: K3 launches {} for chunks {}'.format(
                  launches, chunk_by_rows))
        check(launches['wn_block'] == n_flows * len(vocoded) and launches['wn_block'] > 0
              and launches['wn_block_int8'] == 0 and launches['wn_layer'] == 0,
              'serving: K1 launches {} for {} vocoder calls'.format(launches, vocoded))
        # every mel against infer_fused on its own padded tokens; the frame
        # where a stream's final emission starts: the emissions at the chunk
        # boundaries hold the postnet's lookahead back
        hp = model.arch.hp
        last_emitted = 0
        for steps in (64, 128, 192):
            hi = steps - hp.postnet_n_conv * (hp.postnet_kernel_size // 2)
            if hi - last_emitted >= 64:
                last_emitted = hi
        mel_err, tail_err = 0., 0.
        for (text, stream), res, output in zip(jobs, results, outputs):
            tokens = pad_to_multiple(np.asarray(model.encode_text(text))[None], 64, axis = 1,
                                     constant_values = model.blank_token_idx)
            with torch.no_grad():
                ref = model.arch.infer_fused(
                    model.params, model.state, torch.from_numpy(tokens).cuda(),
                    deterministic = True, max_length = 256,
                    weights = model._decoder_weights(None)).mel[0].cpu().numpy()
            check(output['mel'].shape == ref.shape == (256, 80) and output['steps'] == 256,
                  'serving: mel {} steps {}'.format(output['mel'].shape, output['steps']))
            err = float(np.abs(output['mel'] - ref).max()) / float(np.abs(ref).max())
            mel_err = max(mel_err, err)
            audio = output['audio']
            check(audio.shape == (256 * vocoder.upsample_rate,) and np.isfinite(audio).all(),
                  'serving: audio {}'.format(audio.shape))
            check(np.array_equal(_pcm(res['body']), np.frombuffer(pcm16(audio), '<i2')),
                  'serving: the WAV body is not the request\'s audio')
            if stream:
                # the final emission vocodes the whole mel as the offline call does
                offline = vocoder(output['mel'])[0]
                tail = slice(last_emitted * vocoder.upsample_rate, 256 * vocoder.upsample_rate)
                err = float(np.abs(audio[tail] - offline[tail]).max()) \
                    / float(np.abs(offline).max())
                tail_err = max(tail_err, err)
        check(mel_err <= 1e-4, 'serving: mel against infer_fused {} > 1e-4'.format(mel_err))
        check(tail_err <= 2e-2, 'serving: streamed tail against the offline vocode {} > '
              '2e-2'.format(tail_err))
        audio_s = sum(len(o['audio']) for o in outputs) / model.rate
        out['tacotron2_waveglow'] = dict(
            requests = len(jobs), streamed = sum(s for _, s in jobs), setup_s = setup_s,
            wall_s = wall_s, audio_s = audio_s, audio_s_per_s = audio_s / wall_s,
            ** timings,
            launches = launches, launches_per_request = {k: v / len(jobs)
                                                         for k, v in launches.items()},
            vocoder_calls = len(vocoded), emission_shapes = sorted(set(vocoded)),
            mel_rel_err = mel_err, mel_tolerance_rel = 1e-4,
            stream_tail_rel_err = tail_err, stream_tail_tolerance_rel = 2e-2)

        # VITS (the families phase's, at d_control): 4 requests, int16 chunks
        start = time.perf_counter()
        vits_server = serve(model = vits, port = 0, block = False, max_batch_size = 4,
                            noise_scale = 0., noise_scale_w = 0., d_control = d_control,
                            warmup = SENTENCES[0])
        vits_setup_s = time.perf_counter() - start
        check(vits_server.engine.native_scheduler, 'VITS serve(): not on the native scheduler')
        reset_launches()
        vjobs = [(text, i % 2 == 1) for i, text in enumerate(SENTENCES)]
        vresults, vwall_s = _http_clients(vits_server, vjobs)
        vlaunches = read_launches()
        voutputs = [vits_server._requests[r['id']].result.get(timeout = 60) for r in vresults]
        vtimings = _latency_summary(vresults, voutputs, vits_server.engine)
        vtimings['stepper'] = dict(vits_server.engine.step_fn.stats)
        vtimings['scheduler'] = vits_server.engine.scheduler_stats
        vtimings['stepper_alone'] = _stepper_alone(vits_server.engine, SENTENCES)
        vits_server.stop()
        vits_server = None
        check(sum(vlaunches.values()) == 0, 'VITS serving launches {}'.format(vlaunches))
        verr = 0.
        for (text, _), res, output in zip(vjobs, vresults, voutputs):
            one = vits.compiled_infer(vits.encode_text(text), noise_scale = 0.,
                                      noise_scale_w = 0., d_control = d_control)
            n = int(one.lengths[0]) * vits.upsample_rate
            ref = one.audio[0, :n].cpu().numpy()
            check(output['audio'].shape == ref.shape and np.isfinite(output['audio']).all(),
                  'VITS serving: {} samples, one-shot {}'.format(output['audio'].shape,
                                                                   ref.shape))
            verr = max(verr, float(np.abs(output['audio'] - np.clip(ref, -1., 1.)).max()))
        check(verr <= 1. / 32767. + 1e-4, 'VITS serving against one-shot: {}'.format(verr))
        vaudio_s = sum(len(o['audio']) for o in voutputs) / vits.rate
        out['vits'] = dict(requests = len(vjobs), setup_s = vits_setup_s, wall_s = vwall_s,
                           audio_s = vaudio_s, audio_s_per_s = vaudio_s / vwall_s,
                           ** vtimings, launches = vlaunches,
                           max_abs_err_vs_one_shot = verr,
                           tolerance_abs = 1. / 32767. + 1e-4)
    finally:
        vocoder.__dict__.pop('device_vocoder_fn', None)
        vocoder.arch.hp.sigma = sigma
        for srv in (server, vits_server):
            if srv is not None:
                srv.stop()
    emit({'phase': 'serving', ** out, 'phase_s': time.perf_counter() - phase_start})
    return k3_case, sorted(set(vocoded)), out


# the text of the in-repo WAVs (examples/overfit_single_utterance.py)
TRAIN_TEXT = 'the birch canoe slid on the smooth planks of the lake.'


def _train_steps(model, batch, precision = None, n = 3, device = 'cuda', loss = None,
                 optimizer = 'adam'):
    """`n` train steps of `model` on one bucketed batch from a fresh
    `optimizer` at lr 1e-3 (the model's own weights stay as they are):
    losses, gradient norms, host ms of each step (synchronised), peak
    memory."""
    from text_to_speech_tpu_torch.train.losses import get_loss
    from text_to_speech_tpu_torch.train.optimizers import get_optimizer
    from text_to_speech_tpu_torch.train.trainer import _to_device, _trainable, make_train_step

    tx = get_optimizer(optimizer, lr = 1e-3)
    params = _trainable(_clone(model.params))
    opt = tx.init(params)
    step = make_train_step(model, loss or get_loss(model._default_loss), tx,
                           precision = precision)
    inputs, targets = _to_device(batch[0], device), _to_device(batch[1], device)
    generator = torch.Generator(device = device).manual_seed(0)
    state = model.state
    cuda = device == 'cuda'
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
    out = {'losses': [], 'grad_norms': [], 'step_ms': []}
    for _ in range(n):
        start = time.perf_counter()
        params, state, opt, metrics = step(params, state, opt, generator, inputs, targets)
        out['losses'].append(float(metrics['loss']))
        out['grad_norms'].append(float(metrics['grad_norm']))
        if cuda: torch.cuda.synchronize()
        out['step_ms'].append(1e3 * (time.perf_counter() - start))
    check(all(np.isfinite(out['losses'])), 'non-finite train loss: {}'.format(out['losses']))
    if cuda:
        # the card's peak, and the part the steps added to what was resident
        out['peak_bytes'] = torch.cuda.max_memory_allocated()
        out['peak_above_start_bytes'] = out['peak_bytes'] - before
    return out


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.detach().clone()


def _card_vs_cpu(build, batch, loss = None, optimizer = 'adam', n = 1):
    """`n` train steps (float32, dropout off) of the model `build(device)`
    makes, on the card and on the CPU from the same weights and batch, with
    `optimizer`: each step's loss within 1e-4 (from the second on, the loss
    reads the optimizer's update) and the last gradients' global norm within
    1e-3, relative."""
    steps = {device: _train_steps(build(device), batch, n = n, device = device, loss = loss,
                                  optimizer = optimizer)
             for device in ('cuda', 'cpu')}
    card, cpu = steps['cuda'], steps['cpu']
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(card['losses'], cpu['losses']))
    norm_rel = abs(card['grad_norms'][-1] - cpu['grad_norms'][-1]) / abs(cpu['grad_norms'][-1])
    check(loss_rel <= 1e-4 and norm_rel <= 1e-3,
          'train step, card vs CPU: losses {} vs {}, grad norm {} vs {}'.format(
              card['losses'], cpu['losses'], card['grad_norms'][-1], cpu['grad_norms'][-1]))
    return {'optimizer': optimizer, 'loss_card': card['losses'], 'loss_cpu': cpu['losses'],
            'loss_rel': loss_rel, 'grad_norm_card': card['grad_norms'][-1],
            'grad_norm_cpu': cpu['grad_norms'][-1], 'grad_norm_rel': norm_rel,
            'tolerance_rel': {'loss': 1e-4, 'grad_norm': 1e-3}}


def _rebuild(model, device, root, ** change):
    """`model`'s weights in a new model on `device` with `change`d hparams."""
    from text_to_speech_tpu_torch.models.encoder import SpeakerEncoder
    trees = model.jax_trees()
    extra = {'tokenizer': model.tokenizer} if hasattr(model, 'tokenizer') else {}
    if hasattr(model, 'get_speaker_config'):          # SV2TTS: its speaker's width
        extra['embedding_dim'] = model.embedding_dim
    config = {k: v for k, v in {** model.arch.get_config(), ** change}.items()
              if not (isinstance(model, SpeakerEncoder) and k == 'n_mel_channels')}
    return type(model).from_jax(trees['params'], trees.get('state', {}),
                                name = model.name + '_' + device, root = root,
                                device = device, mel_fn = model.mel_fn, ** extra, ** config)


def _fit_record(model, rows, epochs, precision, ** kw):
    """`fit` for `epochs` epochs: the epoch losses (finite, and the last
    below the first), seconds of each epoch and ms per step after the
    first epoch (which also computes the rows' mels), peak memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    start = time.perf_counter()
    history = model.fit(rows, epochs = epochs, valid_size = 0., device = 'cuda',
                        precision = precision, ** kw)
    fit_s = time.perf_counter() - start
    logs = history.epoch_logs[-epochs:]
    losses = [log['metrics']['loss'] for log in logs]
    check(len(logs) == epochs and all(np.isfinite(losses)),
          '{} fit ({}): epoch losses {}'.format(type(model).__name__, precision, losses))
    steps = -(-len(rows) // kw.get('batch_size', 8))
    return {'epoch_losses': losses, 'epoch_s': [log['time'] for log in logs], 'fit_s': fit_s,
            'steps_per_epoch': steps,
            'ms_per_step_after_first_epoch': 1e3 * statistics.median(
                [log['time'] for log in logs[1:]]) / steps,
            'peak_bytes': torch.cuda.max_memory_allocated(),
            'peak_above_start_bytes': torch.cuda.max_memory_allocated() - before}


def synthesizer_training_phase(vocoder, root):
    """Train the synthesizers at full width on the card, random seeded
    weights: Tacotron-2 at NVIDIA width (`create`, `fit` on the four in-repo
    WAVs, float32 and mixed_bfloat16), its `tts()` (K3 decodes, K1 vocodes)
    and the durations of its attention; SV2TTS at D = 768 (two steps);
    FastSpeech-2 at the JAX defaults distilled from the teacher's alignment,
    then its `tts()` (K1); the speaker encoder by GE2E; the XLA-level int8
    WaveGlow path on `vocoder`'s weights.  Each family's train step on the
    card is held against the port on the CPU.  Returns (the teacher's K3
    cases, runs, the student's K1 (B, T))."""
    import glob
    from text_to_speech_tpu_torch import tts
    from text_to_speech_tpu_torch.models.encoder import SpeakerEncoder
    from text_to_speech_tpu_torch.models.tts import FastSpeech2, SV2TTSTacotron2, Tacotron2
    from text_to_speech_tpu_torch.models.waveglow_arch import int8_conv1d
    from text_to_speech_tpu_torch.ops.pitch import durations_from_attention
    from text_to_speech_tpu_torch.train.trainer import bucket_pad
    from text_to_speech_tpu_torch.weights import tree_to

    phase_start = time.perf_counter()
    out, runs, sections = {}, {}, {}
    section = section_clock(sections)
    wavs = sorted(glob.glob(WAVS))
    check(len(wavs) == 4, 'in-repo WAVs: {}'.format(wavs))
    rows = [{'text': TRAIN_TEXT, 'filename': wav} for wav in wavs for _ in range(2)]
    fit_kw = dict(batch_size = 4, token_multiple = 32, frame_multiple = 64)

    def batch_of(model, items):
        return bucket_pad(model.collate(items), model, token_multiple = 32,
                          frame_multiple = 64)

    def rebuild(model, device, ** change):
        return _rebuild(model, device, root, ** change)

    taco_no_drop = dict(encoder_drop_rate = 0., prenet_drop_rate = 0., postnet_drop_rate = 0.)

    # 1. Tacotron-2 at NVIDIA width (the HParamsTacotron2 defaults, location kernel 31)
    teacher = Tacotron2.create('en', name = 'teacher', root = root, device = 'cuda', seed = 21)
    check(teacher.arch.hp.lsa_attention_kernel_size == 31
          and teacher.arch.hp.attention_rnn_dim == 1024, 'teacher: {}'.format(teacher.arch.hp))
    items = [teacher.prepare_data(row) for row in rows[::2]]
    batch = batch_of(teacher, items)
    steps_bucket = batch[0][1].shape[1]
    check(steps_bucket == 320, 'teacher-forced steps {} (frames {})'.format(
        steps_bucket, [i[0][2] for i in items]))
    # the teacher decodes on K3 once before `fit`, which caches its packed
    # decoder; after `fit` it must decode as a model rebuilt from the fitted
    # weights does, not with the packed copy of the old ones
    probe_tokens = teacher.encode_text(TRAIN_TEXT)
    probe_kw = dict(max_length = 64, deterministic = True, early_stopping = False,
                    use_fused_decoder = True)

    def probe(model):
        return model.compiled_infer(probe_tokens, ** probe_kw).mel.float().cpu().numpy()

    before_fit = probe(teacher)
    check(bool(teacher._derived), 'teacher: no packed decoder cached by the K3 decode')
    # the mixed_bfloat16 fit starts from the same seeded weights: kept here,
    # not drawn again (an NVIDIA-width init is ~10 s on the host)
    initial = teacher.jax_trees()
    fits = {'float32': _fit_record(teacher, rows, 2, 'float32', ** fit_kw)}
    section('tacotron2_fit_float32')
    after_fit, rebuilt = probe(teacher), probe(rebuild(teacher, 'cuda'))
    scale = float(np.abs(rebuilt).max())
    refit = {'max_abs_err_vs_rebuilt': float(np.abs(after_fit - rebuilt).max()),
             'max_abs_change_by_fit': float(np.abs(after_fit - before_fit).max()),
             'scale': scale, 'tolerance': 1e-5 * scale}
    check(refit['max_abs_err_vs_rebuilt'] <= refit['tolerance']
          and refit['max_abs_change_by_fit'] > 1e-3 * scale,
          'teacher K3 decode after fit against a rebuilt model: {}'.format(refit))
    teacher_bf16 = Tacotron2.from_jax(
        initial['params'], initial['state'], tokenizer = teacher.tokenizer, lang = 'en',
        root = root, device = 'cuda', mel_fn = teacher.mel_fn, name = 'teacher_bf16',
        ** teacher.arch.get_config())
    teacher_bf16.save()
    del initial
    fits['mixed_bfloat16'] = _fit_record(teacher_bf16, rows, 2, 'mixed_bfloat16', ** fit_kw)
    del teacher_bf16
    section('tacotron2_fit_mixed_bfloat16')
    for precision, record in fits.items():
        check(record['epoch_losses'][-1] < record['epoch_losses'][0],
              'Tacotron-2 fit ({}): the loss did not fall: {}'.format(
                  precision, record['epoch_losses']))
    out['tacotron2'] = {
        'fit': fits, 'steps_bucket': steps_bucket, 'k3_decode_after_fit': refit,
        'frames': [int(i[0][2]) for i in items],
        'step_B4': {p: _train_steps(teacher, batch, p, n = 2)
                    for p in ('float32', 'mixed_bfloat16')},
        'card_vs_cpu_B2': _card_vs_cpu(
            lambda device: rebuild(teacher, device, ** taco_no_drop), batch_of(teacher, items[:2]))}
    section('tacotron2_steps_and_card_vs_cpu')

    # 2. the fitted teacher's `tts()`: K3 decodes (float32, dropout on), K1 vocodes
    teacher_cases = decoder_steps_phase(teacher, shapes = ((1, 64, False),),
                                        name = 'decoder_steps_teacher')
    kw = dict(model = teacher, vocoder = vocoder, max_length = 320, min_fpt_ratio = 0.,
              max_fpt_ratio = 1e9, fetch_attention = True, save = False, display = False)
    tts(TRAIN_TEXT, ** kw)                                                  # warm-up
    # the mel each vocoder call of the counted run gets: K1's (B, T) there
    vocoded, device_vocoder_fn = [], vocoder.device_vocoder_fn

    def recording_vocoder_fn(** config):
        fn, params, tag = device_vocoder_fn(** config)

        def recorded(params, mel, generator = None):
            vocoded.append(tuple(mel.shape))
            return fn(params, mel, generator)
        return recorded, params, tag
    vocoder.device_vocoder_fn = recording_vocoder_fn
    try:
        torch.cuda.synchronize()
        reset_launches()
        start = time.perf_counter()
        spoken = tts(TRAIN_TEXT, ** kw)[0]
        total_s = time.perf_counter() - start
        launches = read_launches()
    finally:
        del vocoder.device_vocoder_fn                   # the class's method again
    check(len(vocoded) == 1, 'clone tts(): vocoder calls {}'.format(vocoded))
    wn_shape = (vocoded[0][0], vocoded[0][1] * vocoder.upsample_rate // vocoder.arch.hp.n_group)
    frames = spoken['mel'][0].shape[0]
    n_flows = vocoder.arch.hp.n_flows
    check(launches['decoder_steps'] >= 1 and launches['decoder_steps'] <= 5
          and launches['wn_block'] == n_flows and launches['wn_layer'] == 0
          and launches['wn_block_int8'] == 0, 'teacher tts(): launches {}'.format(launches))
    check(bool(np.isfinite(spoken['audio']).all()), 'teacher tts(): audio not finite')
    tokens = teacher.encode_text(TRAIN_TEXT)
    alignment = np.asarray(spoken['attention'][0], np.float32)[:frames, :len(tokens)]
    durations = durations_from_attention(alignment, n_tokens = len(tokens))
    check(int(durations.sum()) == alignment.shape[0], 'durations {} for {} frames'.format(
        int(durations.sum()), alignment.shape[0]))
    runs['teacher_one_sentence'] = {'frames': frames, 'total_ms': 1e3 * total_s,
                                    'decode_ms': 1e3 * teacher.last_timings['decode_s'],
                                    'vocode_ms': 1e3 * teacher.last_timings['vocode_s'],
                                    'launches': launches, 'tokens': len(tokens),
                                    'durations': durations.tolist()}
    section('teacher_tts')

    # 3. SV2TTS at D = 768 ('end'): two train steps, and the card against the CPU
    sv2tts = SV2TTSTacotron2.create('en', name = 'sv2tts_train', root = root, device = 'cuda',
                                    seed = 22, embedding_dim = 256)
    check(sv2tts.arch.encoder_output_dim == 768, 'SV2TTS D = {}'.format(
        sv2tts.arch.encoder_output_dim))
    rng = np.random.default_rng(23)
    spk_rows = [dict(row, embedding = rng.standard_normal(256).astype(np.float32))
                for row in rows[::2]]
    sv_items = [sv2tts.prepare_data(row) for row in spk_rows]
    out['sv2tts'] = {
        'steps_B4': _train_steps(sv2tts, batch_of(sv2tts, sv_items), n = 2),
        'card_vs_cpu_B2': _card_vs_cpu(lambda device: rebuild(sv2tts, device, ** taco_no_drop),
                                       batch_of(sv2tts, sv_items[:2]))}
    del sv2tts
    section('sv2tts')

    # 4. FastSpeech-2 at the JAX package's defaults, distilled from the teacher's alignment
    student = FastSpeech2.create('en', name = 'student', root = root, device = 'cuda', seed = 24)
    # each WAV 4 times: at 2 steps an epoch its loss rose between the epochs
    fs_rows = [dict(row, alignment = alignment) for row in rows for _ in range(2)]
    fs_items = [student.prepare_data(row) for row in fs_rows[::4]]
    fs_fit = _fit_record(student, fs_rows, 2, 'float32', ** fit_kw)
    check(fs_fit['epoch_losses'][-1] < fs_fit['epoch_losses'][0],
          'FastSpeech-2 fit: the loss did not fall: {}'.format(fs_fit['epoch_losses']))
    fs_no_drop = dict(drop_rate = 0., variance_drop_rate = 0., postnet_drop_rate = 0.)
    out['fastspeech2'] = {
        'fit': fs_fit,
        'step_B4': {p: _train_steps(student, batch_of(student, fs_items), p)
                    for p in ('float32', 'mixed_bfloat16')},
        'card_vs_cpu_B2': _card_vs_cpu(lambda device: rebuild(student, device, ** fs_no_drop),
                                       batch_of(student, fs_items[:2]))}
    min_duration = -(-256 // len(tokens))
    student_kw = dict(model = student, vocoder = vocoder, min_duration = min_duration,
                      save = False, display = False)
    _drive_counted(runs, 'student_one_sentence', TRAIN_TEXT,
                   dict(wn_block = n_flows, wn_block_int8 = 0, wn_layer = 0, decoder_steps = 0),
                   ** student_kw)
    # the (B, T) of the student's WN blocks: its decode buffer padded to the
    # vocoder's multiple of frames
    mel = student.compiled_infer(tokens, max_length = 10., min_duration = min_duration).mel
    buffer = -(-mel.shape[1] // vocoder.serving_pad_multiple) * vocoder.serving_pad_multiple
    student_shape = (mel.shape[0], buffer * vocoder.upsample_rate // vocoder.arch.hp.n_group)
    del student, teacher
    section('fastspeech2')

    # 5. the speaker encoder at its defaults: GE2E, 4 speakers x 4 utterances
    encoder = SpeakerEncoder.create(name = 'encoder_train', root = root, device = 'cuda',
                                    seed = 25)
    t = np.arange(32000) / 16000.
    enc_rows = [{'speaker': 'spk{}'.format(s), 'rate': 16000,
                 'audio': (0.4 * np.sin(2 * np.pi * (110. + 45. * s) * t * (1 + 0.05 * u))
                           + 0.05 * np.random.default_rng(10 * s + u).standard_normal(len(t)))
                 .astype(np.float32)} for s in range(4) for u in range(4)]
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    start = time.perf_counter()
    history = encoder.fit(enc_rows, n_speakers = 4, n_utterances = 4, epochs = 1,
                          device = 'cuda')
    ge2e_s = time.perf_counter() - start
    ge2e_loss = history.epoch_logs[-1]['metrics']['loss']
    check(np.isfinite(ge2e_loss), 'GE2E loss {}'.format(ge2e_loss))
    ge2e_batch = encoder.collate_ge2e([[encoder.prepare_data(r) for r in enc_rows[4 * s: 4 * s + 2]]
                                       for s in range(2)])
    encoder.ge2e_shape = (2, 2)
    cmp = {}
    for device in ('cuda', 'cpu'):
        built = rebuild(encoder, device, drop_rate = 0.)
        built.ge2e_shape = (2, 2)
        cmp[device] = built
    out['speaker_encoder'] = {
        'fit_s': ge2e_s, 'epoch_loss': ge2e_loss, 'peak_bytes': torch.cuda.max_memory_allocated(),
        'peak_above_start_bytes': torch.cuda.max_memory_allocated() - before, 'step_4x4': None,
        'card_vs_cpu_2x2': _card_vs_cpu(lambda device: cmp[device], ge2e_batch)}
    encoder.ge2e_shape = (4, 4)
    out['speaker_encoder']['step_4x4'] = _train_steps(
        encoder, encoder.collate_ge2e([[encoder.prepare_data(r) for r in enc_rows[4 * s: 4 * s + 4]]
                                       for s in range(4)]))
    del encoder, cmp
    section('speaker_encoder')

    # 6. the XLA-level int8 WaveGlow path on `vocoder`'s weights: one layer's
    # int8 conv on the card equal to the CPU's to the bit, and the waveform
    # against the float32 chain (SNR recorded: the path is EXPERIMENTAL in
    # the JAX package, no gate)
    arch = vocoder.arch
    quantized = arch.quantize_params(vocoder.params)
    q = quantized['flow_0']['block']['in_conv_1']
    x = torch.randn((1, 8192, arch.hp.wn_channels), generator = torch.Generator(device = 'cuda')
                    .manual_seed(26), device = 'cuda')
    card_y = arch._conv_int8(q, x, dilation = 2)
    cpu_y = arch._conv_int8(tree_to(q, 'cpu'), x.cpu(), dilation = 2)
    a_scale = torch.clamp(x.abs().max() / 127., min = 1e-8)
    x_q = torch.clamp(torch.round(x / a_scale), -127, 127).to(torch.int8)
    ints_equal = torch.equal(int8_conv1d(x_q, q['weight_q'], dilation = 2).cpu(),
                             int8_conv1d(x_q.cpu(), q['weight_q'].cpu(), dilation = 2))
    check(ints_equal and torch.equal(card_y.cpu(), cpu_y),
          'int8 conv: card vs CPU, max diff {}'.format(float((card_y.cpu() - cpu_y).abs().max())))
    mel = torch.from_numpy(np.random.default_rng(27).standard_normal((1, 64, 80))
                           .astype(np.float32) - 5.).cuda()
    z = torch.randn((1, 64 * arch.hp.upsample_stride // arch.hp.n_group, arch.hp.n_group),
                    generator = torch.Generator(device = 'cuda').manual_seed(28), device = 'cuda')
    with torch.no_grad():
        int8_ms = time_ms(lambda: arch.infer(quantized, mel, z = z), reps = 3, warmup = 1)
        f32_ms = time_ms(lambda: arch.infer(vocoder.params, mel, z = z), reps = 3, warmup = 1)
        wave8 = arch.infer(quantized, mel, z = z)
        wave = arch.infer(vocoder.params, mel, z = z)
    check(bool(torch.isfinite(wave8).all()), 'int8 XLA path: waveform not finite')
    snr = 10. * float(torch.log10((wave ** 2).sum() / ((wave - wave8) ** 2).sum()))
    out['int8_xla'] = {'conv_card_equals_cpu': True, 'conv_shape': list(x.shape),
                       'waveform_snr_db': snr, 'frames': 64, 'int8_ms': int8_ms,
                       'float32_ms': f32_ms}
    del quantized
    section('int8_xla')
    emit({'phase': 'training', ** out, 'runs': runs, 'section_s': sections,
          'phase_s': time.perf_counter() - phase_start})
    return teacher_cases, runs, student_shape


def transfer_phase(vocoder, root, source_root):
    """Cloning a voice from a single-speaker checkpoint at NVIDIA width, in
    `root`: the Tacotron-2 teacher and the speaker encoder the training
    phase fitted (linked from `source_root`; seeded `create`s where they are
    missing) → ``SV2TTSTacotron2.from_pretrained('clone', 'teacher',
    embedding_dim = 256)`` → `fit` on a two-speaker VoxForge-layout corpus
    of the in-repo WAVs (the native loader pool, a disk cache, Lion, the
    held-out speaker as validation data) → the best epoch's `tts()` (K3 at
    D = 768, K1).  Returns (the clone's K3 cases, runs, the (B, T) that K1
    gets in its `tts()`)."""
    import glob
    from scipy.io import wavfile
    from scipy.signal import resample
    from text_to_speech_tpu_torch import tts
    from text_to_speech_tpu_torch.loggers import reset_timers, timer_report
    from text_to_speech_tpu_torch.models.encoder import SpeakerEncoder
    from text_to_speech_tpu_torch.models.tts import SV2TTSTacotron2, Tacotron2
    from text_to_speech_tpu_torch.native import data_loader
    from text_to_speech_tpu_torch.train.datasets import FileCacheDataset, train_test_split
    from text_to_speech_tpu_torch.train.loader import get_dataset
    from text_to_speech_tpu_torch.train.metrics import get_metric
    from text_to_speech_tpu_torch.train.trainer import (
        _item_length, _to_device, bucket_pad, model_forward)
    from text_to_speech_tpu_torch.weights import flatten_tree, tacotron2_from_jax

    phase_start = time.perf_counter()
    out, runs, sections = {}, {}, {}
    section = section_clock(sections)
    n_flows = vocoder.arch.hp.n_flows
    fit_kw = dict(token_multiple = 32, frame_multiple = 64)

    def batch_of(model, items):
        return bucket_pad(model.collate(items), model, ** fit_kw)

    # 1. the source: the training phase's fitted teacher (NVIDIA width,
    #    location kernel 31) and its GE2E-fitted speaker encoder
    for name in ('teacher', 'encoder_train'):
        if os.path.exists(os.path.join(source_root, name, 'config.json')):
            os.symlink(os.path.join(source_root, name), os.path.join(root, name))
    out['source'] = 'fitted' if os.path.exists(os.path.join(root, 'teacher')) else 'seeded'
    if out['source'] == 'seeded':
        Tacotron2.create('en', name = 'teacher', root = root, device = 'cuda', seed = 21)
    if not os.path.exists(os.path.join(root, 'encoder_train')):
        SpeakerEncoder.create(name = 'encoder_train', root = root, device = 'cuda', seed = 25)
    teacher = Tacotron2.from_pretrained('teacher', root = root, device = 'cuda')
    check(teacher.arch.hp.lsa_attention_kernel_size == 31
          and teacher.arch.encoder_output_dim == 512, 'teacher: {}'.format(teacher.arch.hp))
    section('source')

    # 2. the corpus: the four in-repo WAVs as two VoxForge sessions, two WAVs
    #    a speaker, each prompt four times (8 rows a speaker); one WAV at
    #    16 kHz, which the pool's sinc resamples to the model's rate
    wavs = sorted(glob.glob(WAVS))
    check(len(wavs) == 4, 'in-repo WAVs: {}'.format(wavs))
    corpus = os.path.join(root, 'voxforge')
    for s, session in enumerate(('alice-20240101-tts', 'bruno-20240102-tts')):
        os.makedirs(os.path.join(corpus, session, 'etc'))
        os.makedirs(os.path.join(corpus, session, 'wav'))
        prompts = []
        for w, wav in enumerate(wavs[2 * s: 2 * s + 2]):
            rate, audio = wavfile.read(wav)
            if (s, w) == (0, 0):
                audio = resample(audio, int(len(audio) * 16000 / rate)).astype(np.float32)
                rate = 16000
            for k in range(4):
                utt = 'u{}{}'.format(w, k)
                wavfile.write(os.path.join(corpus, session, 'wav', utt + '.wav'), rate, audio)
                prompts.append('mfc/{} {}\n'.format(utt, TRAIN_TEXT.upper()))
        with open(os.path.join(corpus, session, 'etc', 'PROMPTS'), 'w') as f:
            f.writelines(prompts)
    rows = get_dataset('voxforge', directory = corpus)
    check(len(rows) == 16 and sorted({r['speaker'] for r in rows}) == ['alice', 'bruno'],
          'voxforge rows: {}'.format([(r['id'], r['speaker']) for r in rows]))
    section('corpus')

    # 3. the transfer: every teacher leaf arrives, exact in its block, and the
    #    rows the 256-wide speaker adds are zero
    torch.cuda.synchronize()
    reset_timers()
    start = time.perf_counter()
    clone = SV2TTSTacotron2.from_pretrained('clone', 'teacher', embedding_dim = 256,
                                            encoder_name = 'encoder_train', root = root,
                                            device = 'cuda')
    torch.cuda.synchronize()
    out['transfer_ms'] = 1e3 * (time.perf_counter() - start)
    out['transfer_spans'] = timer_report().splitlines()
    check(clone.arch.encoder_output_dim == 768, 'clone D = {}'.format(
        clone.arch.encoder_output_dim))
    widened = []
    for tree in ('params', 'state'):
        src = flatten_tree(teacher.jax_trees()[tree])
        dst = flatten_tree(clone.jax_trees()[tree])
        check(sorted(src) == sorted(dst), 'clone {}: other leaves'.format(tree))
        for key, value in src.items():
            block = tuple(slice(0, n) for n in value.shape)
            check(np.array_equal(dst[key][block], value), 'clone {}: {} differs'.format(tree, key))
            if dst[key].shape != value.shape:
                rest = dst[key].copy()
                rest[block] = 0.
                check(not rest.any(), 'clone {}: {} widened with non-zero rows'.format(tree, key))
                widened.append(key)
    check(sorted(widened) == ['decoder/attention/memory/kernel', 'decoder/attention_rnn/kernel',
                              'decoder/decoder_rnn/cell_0/kernel', 'decoder/gate_layer/kernel',
                              'decoder/linear_projection/kernel'], 'widened: {}'.format(widened))
    out['widened_leaves'] = widened
    section('transfer')

    # each row's speaker embedding from the clone's speaker encoder
    start = time.perf_counter()
    embeddings = clone.embed_audio([r['filename'] for r in rows])
    out['embed_rows_ms'] = 1e3 * (time.perf_counter() - start)
    rows = [dict(r, embedding = e.astype(np.float32)) for r, e in zip(rows, embeddings)]

    # the clone decodes on K3 as its source: the zero rows hide the speaker
    tokens = teacher.encode_text(TRAIN_TEXT)
    probe = dict(max_length = 64, deterministic = True, early_stopping = False,
                 use_fused_decoder = True)
    reset_launches()
    ref = teacher.compiled_infer(tokens, ** probe).mel.float()
    decodes = [clone.compiled_infer(tokens, embeddings = rows[i]['embedding'], ** probe)
               .mel.float() for i in (0, 15)]
    launches = read_launches()
    scale = float(ref.abs().max())
    errs = [float((d - ref).abs().max()) for d in decodes]
    out['decode_as_source'] = {'max_abs_err': errs, 'scale': scale, 'tolerance': 1e-5 * scale,
                               'launches': launches}
    check(launches['decoder_steps'] == 3 and max(errs) <= 1e-5 * scale,
          'clone K3 decode against its source: {}'.format(out['decode_as_source']))
    del teacher
    section('embed_and_decode_as_source')

    # 4. fine-tune: the speaker held out as validation data, the training rows
    #    through a disk cache; every WAV row decoded on the native pool
    train, valid = train_test_split(rows, split_column = 'speaker', valid_size = 0.5)
    check(len(train) == len(valid) == 8, 'split: {} / {}'.format(len(train), len(valid)))
    mapped = []

    def prepare(row):
        mapped.append(row['id'])
        return clone.prepare_data(row)

    cache_dir = os.path.join(root, 'mel_cache')
    train_ds = FileCacheDataset(train, cache_dir, map_fn = prepare, filter_fn = clone.filter_data,
                                collate_fn = clone.collate, batch_size = 4, shuffle = True,
                                cache = False, length_bucket_fn = _item_length,
                                native_audio_rate = clone.rate)
    decoded = []
    load_audio_batch = data_loader.load_audio_batch

    def timed_decode(paths, ** kw):
        start = time.perf_counter()
        batch = load_audio_batch(paths, ** kw)
        decoded.append({'rows': len(batch), 'native_rows': batch.native_rows,
                        'ms': 1e3 * (time.perf_counter() - start)})
        return batch

    start = time.perf_counter()
    check(data_loader.available(), 'the native loader did not build')       # g++, once
    out['native_build_ms'] = 1e3 * (time.perf_counter() - start)
    data_loader.load_audio_batch = timed_decode
    try:
        start = time.perf_counter()
        first = list(train_ds)                    # decode, mels, cache files
        out['first_epoch_ms'] = 1e3 * (time.perf_counter() - start)
        start = time.perf_counter()
        list(train_ds)                            # the cache files
        out['cached_epoch_ms'] = 1e3 * (time.perf_counter() - start)
        start = time.perf_counter()
        clone.ckpt_manager.max_to_keep = 2                  # the 3 epochs rotate
        history = clone.fit(train_ds, valid_data = valid, epochs = 3, batch_size = 4,
                            native_audio = True, optimizer = 'lion', lr = 1e-4,
                            device = 'cuda', ** fit_kw)
        out['fit_s'] = time.perf_counter() - start
    finally:
        data_loader.load_audio_batch = load_audio_batch
    out['native_decodes'] = decoded
    out['native_decode_rows_per_s'] = sum(d['rows'] for d in decoded) / (
        1e-3 * sum(d['ms'] for d in decoded))
    check(sorted((d['rows'], d['native_rows']) for d in decoded) == [(8, 8), (8, 8)]
          and train_ds.native_rows == 8,
          'native pool: {} (train {})'.format(decoded, train_ds.native_rows))
    n_files = len(os.listdir(cache_dir))
    check(len(mapped) == len(train) and n_files == len(train) and len(first) == 2,
          'disk cache: {} maps, {} files, {} batches'.format(len(mapped), n_files, len(first)))
    logs = history.epoch_logs[-3:]
    out['epoch_losses'] = [log['metrics']['loss'] for log in logs]
    out['epoch_val_losses'] = [log['metrics']['val_loss'] for log in logs]
    out['epoch_s'] = [log['time'] for log in logs]
    check(len(logs) == 3 and all(np.isfinite(out['epoch_losses'] + out['epoch_val_losses'])),
          'clone fit: {}'.format(logs))
    # history counts epochs from 0, the checkpoints from 1 (the JAX numbering)
    best_value, best_epoch = history.get_best('val_loss')
    manager = clone.ckpt_manager
    kept = [c['epoch'] for c in manager.checkpoints]
    check(manager.best_epoch == best_epoch + 1 and manager.best_epoch in kept
          and len(kept) == 2 and kept[-1] == 3,
          'best checkpoint: {} of {} (history epoch {})'.format(
              manager.best_epoch, kept, best_epoch))
    # three more epochs, worse than the best, rotate out the epochs after it
    # and never the best: the last two are kept beside it
    last = manager.load(trees = ('params', 'state'))
    for epoch in (4, 5, 6):
        manager.save(last, epoch, metric = best_value + 1.)
    after = [c['epoch'] for c in manager.checkpoints]
    out['best'] = {'checkpoint_epoch': manager.best_epoch, 'history_epoch': best_epoch,
                   'val_loss': best_value, 'kept_after_fit': kept, 'kept_after_6': after}
    check(manager.best_epoch == best_epoch + 1
          and after == sorted({manager.best_epoch, 5, 6})
          and any(e > manager.best_epoch and e not in after for e in range(1, 7)),
          'best checkpoint under rotation: {}'.format(out['best']))
    section('fine_tune')

    # the fine-tune step (Lion, B = 4), and one Adafactor step card vs CPU
    items = [clone.prepare_data(r) for r in train[:4]]
    steps = _train_steps(clone, batch_of(clone, items), n = 2, optimizer = 'lion')
    out['step_ms'] = statistics.median(steps['step_ms'][1:])
    out['step_B4'] = steps
    no_drop = dict(encoder_drop_rate = 0., prenet_drop_rate = 0., postnet_drop_rate = 0.)
    section('step_B4')
    out['adafactor_card_vs_cpu_B1'] = _card_vs_cpu(
        lambda device: _rebuild(clone, device, root, ** no_drop), batch_of(clone, items[:1]),
        optimizer = 'adafactor', n = 2)
    section('adafactor_card_vs_cpu')

    # 5. the best epoch speaks with the held-out speaker
    best = manager.load(best = True, trees = ('params', 'state'))
    clone.set_weights(* tacotron2_from_jax(best['params'], best['state']))
    held_out = np.mean([r['embedding'] for r in valid], axis = 0).astype(np.float32)
    kw = dict(model = clone, vocoder = vocoder, embeddings = held_out, max_length = 320,
              min_fpt_ratio = 0., max_fpt_ratio = 1e9, save = False, display = False)
    tts(TRAIN_TEXT, ** kw)                                                  # warm-up
    # the mel each vocoder call of the counted run gets: K1's (B, T) there
    vocoded, device_vocoder_fn = [], vocoder.device_vocoder_fn

    def recording_vocoder_fn(** config):
        fn, params, tag = device_vocoder_fn(** config)

        def recorded(params, mel, generator = None):
            vocoded.append(tuple(mel.shape))
            return fn(params, mel, generator)
        return recorded, params, tag
    vocoder.device_vocoder_fn = recording_vocoder_fn
    try:
        torch.cuda.synchronize()
        reset_launches()
        start = time.perf_counter()
        spoken = tts(TRAIN_TEXT, ** kw)[0]
        total_s = time.perf_counter() - start
        launches = read_launches()
    finally:
        del vocoder.device_vocoder_fn                   # the class's method again
    check(len(vocoded) == 1, 'clone tts(): vocoder calls {}'.format(vocoded))
    wn_shape = (vocoded[0][0], vocoded[0][1] * vocoder.upsample_rate // vocoder.arch.hp.n_group)
    check(launches['decoder_steps'] >= 1 and launches['wn_block'] == n_flows
          and launches['wn_layer'] == 0 and launches['wn_block_int8'] == 0,
          'clone tts(): launches {}'.format(launches))
    check(bool(np.isfinite(spoken['audio']).all()) and spoken['audio'].shape
          == (spoken['mel'][0].shape[0] * vocoder.upsample_rate,), 'clone tts(): output')
    runs['clone_one_sentence'] = {
        'frames': spoken['mel'][0].shape[0], 'vocoded_mel': vocoded[0],
        'wn_block_shape': wn_shape, 'total_ms': 1e3 * total_s,
        'decode_ms': 1e3 * clone.last_timings['decode_s'],
        'vocode_ms': 1e3 * clone.last_timings['vocode_s'], 'launches': launches}
    section('speak')
    speaker = torch.from_numpy(held_out).cuda()
    cases = decoder_steps_phase(clone, speaker = lambda B: speaker.expand(B, -1),
                                shapes = ((1, 64, False),), name = 'decoder_steps_clone')
    section('k3_against_plain')

    # the teacher-forced mels of the held-out rows against their ground truth
    v_items = [clone.prepare_data(r) for r in valid[::4]]
    inputs, _ = batch_of(clone, v_items)
    with torch.no_grad():
        (_, mel_post, _), _ = model_forward(clone, clone.params, clone.state,
                                            _to_device(inputs, 'cuda'), train = False)
    quality = {'mcd_db': [], 'mel_snr_db': []}
    for i, (_, (mel_out, gate)) in enumerate(v_items):
        n = int(len(gate) - 1)                   # the frames before the gated one
        truth, pred = mel_out[:n], mel_post[i, :n].float().cpu().numpy()
        quality['mcd_db'].append(get_metric('mcd')(truth, pred))
        quality['mel_snr_db'].append(get_metric('mel_snr')(truth, pred))
    check(all(np.isfinite(quality['mcd_db'] + quality['mel_snr_db'])), 'quality: {}'.format(
        quality))
    out['teacher_forced_quality'] = quality
    del clone
    torch.cuda.empty_cache()
    section('quality')
    emit({'phase': 'transfer', ** out, 'runs': runs, 'section_s': sections,
          'phase_s': time.perf_counter() - phase_start})
    return cases, runs, wn_shape


# the VITS rows' texts, drawn for each WAV by a seeded generator (the WAVs
# say TRAIN_TEXT; the GAN step does not read the match)
GAN_TEXTS = SENTENCES + [TRAIN_TEXT]


def _gan_state(gen, disc, device, lr = 2e-4):
    """A train state of copies of the `gen` and `disc` trees on `device`,
    with `fit_gan`'s optimizers (Adam, b1 0.8, b2 0.99)."""
    from text_to_speech_tpu_torch.train import gan
    from text_to_speech_tpu_torch.train.optimizers import get_optimizer
    from text_to_speech_tpu_torch.weights import tree_to

    tx_g, tx_d = (get_optimizer('adam', lr = lr, b1 = 0.8, b2 = 0.99) for _ in range(2))
    state = {'gen': gan._trainable(_clone(tree_to(gen, device))),
             'disc': gan._trainable(_clone(tree_to(disc, device)))}
    state['gen_opt'], state['disc_opt'] = tx_g.init(state['gen']), tx_d.init(state['disc'])
    return state, tx_g, tx_d


def _gan_steps(run, state, warmup = 2, timed = 3):
    """`warmup` + `timed` steps ``run(state) → (state, metrics)``, each
    synchronised: the median ms of the timed ones, every step's losses, the
    peak memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    ms, logs = [], []
    for _ in range(warmup + timed):
        start = time.perf_counter()
        state, metrics = run(state)
        logs.append({k: float(v) for k, v in metrics.items()})
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - start))
    check(all(np.isfinite(list(m.values())).all() for m in logs),
          'GAN step: non-finite metrics {}'.format(logs))
    return state, {'step_ms': statistics.median(ms[warmup:]), 'step_ms_each': ms,
                   'disc_loss': [m['disc_loss'] for m in logs],
                   'gen_loss': [m['gen_loss'] for m in logs], 'last': logs[-1],
                   'peak_bytes': torch.cuda.max_memory_allocated(),
                   'peak_above_start_bytes': torch.cuda.max_memory_allocated() - before}


def _gan_card_vs_cpu(make_step, gen, disc, batches):
    """One step from the same trees and batch on the card and on the CPU:
    every loss within 1e-4 and both gradient norms within 1e-3, relative."""
    metrics = {}
    for device in ('cuda', 'cpu'):
        state, tx_g, tx_d = _gan_state(gen, disc, device)
        _, m = make_step(tx_g, tx_d)(state, batches[device])
        metrics[device] = {k: float(v) for k, v in m.items()}
    card, cpu = metrics['cuda'], metrics['cpu']
    rel = {k: abs(card[k] - v) / max(abs(v), 1e-30) for k, v in cpu.items()}
    losses = max(v for k, v in rel.items() if not k.endswith('grad_norm'))
    norms = max(v for k, v in rel.items() if k.endswith('grad_norm'))
    check(losses <= 1e-4 and norms <= 1e-3, 'GAN step card vs CPU: {} vs {}'.format(card, cpu))
    return {'card': card, 'cpu': cpu, 'loss_rel': losses, 'grad_norm_rel': norms,
            'tolerance_rel': {'loss': 1e-4, 'grad_norm': 1e-3}}


def _gan_fit(model, rows, ** kw):
    """`fit` for 1 epoch, then 1 resumed from the checkpoint and
    ``gan_state.npz``: epochs, seconds, the last epoch's metrics."""
    out = {}
    for name, epochs in (('first', 1), ('resumed', 1)):
        torch.cuda.synchronize()
        start = time.perf_counter()
        history = model.fit(rows, epochs = epochs, device = 'cuda', verbose = False, ** kw)
        out[name] = {'epochs': model.epochs, 's': time.perf_counter() - start,
                     'metrics': history.epoch_logs[-1]['metrics']}
    gan_state = os.path.join(model.folder, 'saving', 'gan_state.npz')
    check(model.epochs == 2 and os.path.exists(gan_state) and len(model.history.trainings) == 2
          and all(np.isfinite(v) for v in out['resumed']['metrics'].values()),
          '{} fit: {}'.format(type(model).__name__, out))
    out['gan_state_bytes'] = os.path.getsize(gan_state)
    return out


def gan_phase(root):
    """Adversarial training at the published widths, seeded weights, in
    `root`: HiFi-GAN V1 and Vocos on a batch of 16 × 8,192 samples of the
    in-repo WAVs (the L1 mel term on `TacotronSTFT`), VITS (use_sdp, the
    LJSpeech widths) and SV2TTS-VITS (a 256-wide embedding) on 16 of their
    utterances with seeded texts, 32-frame windows; step ms and peak memory
    in float32 and mixed_bfloat16; VITS's step in parts and the share of the
    monotonic alignment; the card against the CPU; `fit` with a resume.
    No kernel of the port runs here (none of these modules has a Pallas
    kernel in the JAX package)."""
    import glob
    from text_to_speech_tpu_torch.models.tts import HiFiGAN, SV2TTSVITS, VITS, Vocos
    from text_to_speech_tpu_torch.models.tts.tacotron2 import _Clock
    from text_to_speech_tpu_torch.models.vits_arch import maximum_path, neg_cross_entropy
    from text_to_speech_tpu_torch.ops.audio_io import load_audio
    from text_to_speech_tpu_torch.train import gan
    from text_to_speech_tpu_torch.utils.sequence_utils import pad_to_multiple

    phase_start = time.perf_counter()
    out, sections = {}, {}
    section = section_clock(sections)

    wavs = sorted(glob.glob(WAVS))
    check(len(wavs) == 4, 'in-repo WAVs: {}'.format(wavs))
    waves = [np.asarray(load_audio(w, 22050), np.float32) for w in wavs]
    # config_v1.json's batch: 16 segments of 8,192 samples (32 frames)
    audio = torch.from_numpy(np.stack([w[i * 8192: (i + 1) * 8192] for w in waves
                                       for i in range(4)])).cuda()

    hifigan = HiFiGAN.create(name = 'gan_hifigan', root = root, device = 'cuda', seed = 31)
    hp = hifigan.arch.hp
    check(hp.upsample_initial_channel == 512 and tuple(hp.upsample_rates) == (8, 8, 2, 2)
          and tuple(hp.mpd_periods) == (2, 3, 5, 7, 11) and hp.msd_scales == 3,
          'HiFi-GAN V1: {}'.format(hp))
    with torch.no_grad():
        mel = hifigan.mel_fn(audio)[:, :32]
    disc = {'mpd': hifigan.arch.init_mpd(32), 'msd': hifigan.arch.init_msd(33)}
    mel_fn = gan.mel_fn_from_stft(hifigan.mel_fn)
    section('setup')

    def vocoder_steps(name, model):
        rec = {}
        for precision in (None, 'mixed_bfloat16'):
            state, tx_g, tx_d = _gan_state(model.params, disc, 'cuda')
            step = gan.make_hifigan_train_step(model.arch, tx_g, tx_d, mel_fn,
                                               precision = precision)
            _, rec[precision or 'float32'] = _gan_steps(lambda s: step(s, mel, audio), state)
            del state
        losses = rec['float32']['disc_loss']
        check(losses[-1] < losses[0], '{}: the disc loss does not fall on a fixed batch: {}'
              .format(name, losses))
        make = lambda tx_g, tx_d: lambda state, batch: gan.make_hifigan_train_step(
            model.arch, tx_g, tx_d, mel_fn)(state, * batch)
        # one row of 16 frames: the CPU's step at full width takes seconds
        rec['card_vs_cpu_B1'] = _gan_card_vs_cpu(
            make, model.params, disc, {'cuda': (mel[:1, :16], audio[:1, :4096]),
                                       'cpu': (mel[:1, :16].cpu(), audio[:1, :4096].cpu())})
        rec['batch'] = list(audio.shape)
        out[name] = rec
        section(name)

    vocoder_steps('hifigan_v1', hifigan)
    vocos = Vocos.create(name = 'gan_vocos', root = root, device = 'cuda', seed = 34)
    check(vocos.arch.hp.dim == 512 and vocos.arch.hp.intermediate_dim == 1536
          and vocos.arch.hp.n_layers == 8, 'Vocos: {}'.format(vocos.arch.hp))
    vocoder_steps('vocos', vocos)
    del vocos

    # VITS: 16 rows of the WAVs' utterances, the frames and samples padded
    # to multiples of 32 frames as `fit_gan` pads them
    vits = VITS.create('en', name = 'gan_vits', root = root, device = 'cuda', seed = 35,
                       use_sdp = True)
    check(vits.arch.hp.hidden_channels == 192 and vits.upsample_rate == 256
          and vits.arch.hp.segment_frames == 32, 'VITS: {}'.format(vits.arch.hp))
    rng = np.random.default_rng(37)
    rows = [{'text': GAN_TEXTS[rng.integers(len(GAN_TEXTS))], 'audio': w, 'rate': 22050}
            for w in waves for _ in range(4)]
    speakers = rng.standard_normal((16, 256)).astype(np.float32)
    speakers /= np.linalg.norm(speakers, axis = 1, keepdims = True)

    def vits_batch(model, rows):
        """Collated, the tokens padded to a multiple of 16, the frames of 32
        (SV2TTS-VITS: the embeddings in the speaker slot)."""
        tokens, spec, lengths, wave, * speaker = model.collate(
            [model.prepare_data(r) for r in rows])
        batch = [pad_to_multiple(tokens, 16, axis = 1, constant_values = model.blank_token_idx),
                 pad_to_multiple(spec, 32, axis = 1), lengths,
                 pad_to_multiple(wave, 32 * 256, axis = 1)] + speaker
        return [torch.as_tensor(b.astype(np.int64 if b.dtype.kind in 'iu' else np.float32))
                for b in map(np.asarray, batch)]

    batch = [t.cuda() for t in vits_batch(vits, rows)]
    section('vits_setup')
    rec = {'batch': {'rows': 16, 'tokens': int(batch[0].shape[1]),
                     'frames': int(batch[1].shape[1]), 'samples': int(batch[3].shape[1])}}
    generator = torch.Generator(device = 'cuda').manual_seed(0)
    for precision in (None, 'mixed_bfloat16'):
        state, tx_g, tx_d = _gan_state(vits.params, disc, 'cuda')
        step = gan.make_vits_train_step(vits.arch, tx_g, tx_d, gan.mel_fn_from_stft(vits.mel_fn),
                                        precision = precision)
        # a step of ~0.7 s: 3 timed after 1
        state, rec[precision or 'float32'] = _gan_steps(
            lambda s: step(s, batch, generator), state, warmup = 1, timed = 3)
        if precision is None:
            # the step in parts (CUDA events: the training forward with the
            # alignment in it, the discriminators' update, the generator's)
            parts = []
            for _ in range(2):
                clock = _Clock(torch.device('cuda'))
                step(state, batch, generator, clock = clock)
                torch.cuda.synchronize()
                parts.append(clock.seconds())
            rec['parts_ms'] = {name: 1e3 * statistics.median(p[i] for p in parts)
                               for i, name in enumerate(('train_forward', 'discriminators',
                                                         'generator'))}
        del state
    # the monotonic alignment alone on this batch's prior and latent
    arch, params = vits.arch, vits.params
    with torch.no_grad():
        tokens, spec, lengths = batch[:3]
        _, m_p, logs_p, tmask = arch.encode_text(params, tokens)
        fmask = torch.arange(spec.shape[1], device = 'cuda')[None] < lengths[:, None]
        z, _, _ = arch.posterior(params, spec, fmask, eps = 0.)
        nc = neg_cross_entropy(arch.flow(params, z, fmask), m_p, logs_p, tmask)
        mas = []
        for _ in range(3):
            torch.cuda.synchronize()
            start = time.perf_counter()
            maximum_path(nc, fmask, tmask)
            torch.cuda.synchronize()
            mas.append(1e3 * (time.perf_counter() - start))
    rec['mas_ms'] = statistics.median(mas)
    rec['mas_share_of_step'] = rec['mas_ms'] / rec['float32']['step_ms']
    section('vits_steps')

    # the card against the CPU at B = 2, dropout off, the same draws
    short = [{'text': 'the birch canoe slid on the smooth planks.', 'audio': w[:22016],
              'rate': 22050} for w in waves[:2]]
    cfg = dict(vits.arch.get_config(), drop_rate = 0., duration_drop_rate = 0., sdp_drop_rate = 0.)
    trees = vits.jax_trees()['params']
    models = {d: VITS.from_jax(trees, device = d, tokenizer = vits.tokenizer,
                               mel_fn = vits.mel_fn, ** cfg) for d in ('cuda', 'cpu')}
    cpu_batch = vits_batch(models['cpu'], short)
    B, T, L = 2, cpu_batch[1].shape[1], cpu_batch[0].shape[1]
    draw = np.random.default_rng(38)
    draws = {'eps': torch.from_numpy(draw.standard_normal((B, T, 192)).astype(np.float32)),
             'e_q': torch.from_numpy(draw.standard_normal((B, L, 2)).astype(np.float32)),
             'starts': torch.from_numpy(draw.integers(0, 8, B))}
    on = lambda device: ([t.to(device) for t in cpu_batch],
                         {k: v.to(device) for k, v in draws.items()})
    make = lambda tx_g, tx_d: lambda state, args: gan.make_vits_train_step(
        models['cuda'].arch, tx_g, tx_d, gan.mel_fn_from_stft(vits.mel_fn))(
        state, args[0], draws = args[1])
    rec['card_vs_cpu_B2'] = _gan_card_vs_cpu(make, models['cpu'].params, disc,
                                             {d: on(d) for d in ('cuda', 'cpu')})
    paths = {}
    for d, model in models.items():
        b, dr = on(d)
        with torch.no_grad():
            paths[d] = model.arch.train_forward(model.params, * b, ** dr)['path'].cpu()
    check(torch.equal(paths['cuda'], paths['cpu']), 'VITS card vs CPU: the alignment differs')
    rec['card_vs_cpu_B2']['mas_path_equal'] = True
    del models
    out['vits'] = rec
    section('vits_card_vs_cpu')

    clone = SV2TTSVITS.create('en', name = 'gan_sv2tts_vits', root = root, device = 'cuda',
                              seed = 36, embedding_dim = 256, use_sdp = True)
    clone_batch = [t.cuda() for t in vits_batch(
        clone, [dict(r, embedding = e) for r, e in zip(rows, speakers)])]
    check(clone_batch[4].shape == (16, 256), 'SV2TTS-VITS batch: {}'.format(
        [t.shape for t in clone_batch]))
    state, tx_g, tx_d = _gan_state(clone.params, disc, 'cuda')
    step = gan.make_vits_train_step(clone.arch, tx_g, tx_d, gan.mel_fn_from_stft(clone.mel_fn))
    # VITS's step with a speaker projection: 3 timed steps after 1 suffice
    _, out['sv2tts_vits'] = _gan_steps(lambda s: step(s, clone_batch, generator), state,
                                       warmup = 1, timed = 3)
    del state, clone
    section('sv2tts_vits_steps')

    # fit with a resume on the four WAVs (batch 4)
    out['hifigan_fit'] = _gan_fit(hifigan, [{'filename': w} for w in wavs], batch_size = 4)
    section('hifigan_fit')
    out['vits_fit'] = _gan_fit(vits, [{'text': TRAIN_TEXT, 'filename': w} for w in wavs],
                               batch_size = 4)
    section('vits_fit')
    del hifigan, vits
    torch.cuda.empty_cache()
    emit({'phase': 'gan', ** out, 'section_s': sections,
          'phase_s': time.perf_counter() - phase_start})


LLM_TIE = 1e-4              # a top-two (or kept / dropped) margin below this is a tie


def _tie_rule(card, cpu, margins, start, tie = None):
    """Rows of generated tokens (B, T) on the card against the CPU's, from
    column `start`: equal, or apart only after a step whose margin on the
    CPU (`margins`: one (B,) tensor a step, and for a beam search a last one
    for the choice of beam) fell below `tie` (`LLM_TIE` by default).
    Returns (rows equal, rows apart after a tie)."""
    tie = LLM_TIE if tie is None else tie
    card, cpu = card.cpu(), cpu.cpu()
    margins = torch.stack([m.float().cpu() for m in margins], dim = 1)   # (B, steps)
    equal = tied = 0
    for b in range(card.shape[0]):
        apart = (card[b, start:] != cpu[b, start:]).nonzero()
        if len(apart) == 0:
            equal += 1
            continue
        first = int(apart[0])
        near = margins[b] if margins.shape[1] > card.shape[1] - start \
            else margins[b, : first + 1]
        check(float(near.min()) < tie,
              'row {}: card and CPU apart at step {} with no tie (margins {})'.format(
                  b, first, margins[b].tolist()))
        tied += 1
    return equal, tied


def _llm_families(rng):
    """The narrow families on the card against the CPU, each from its
    seeded HF-layout state dict through the converters: Mistral (4 heads, 2
    KV heads, RoPE, SwiGLU, RMS), Mixtral (4 experts, top 2, with the
    load-balancing loss), BERT with its MLM head, T5, BART and Whisper
    (encode / encode_audio and an 8-token greedy decode)."""
    from text_to_speech_tpu_torch import init
    from text_to_speech_tpu_torch.models.transformers import (
        generate, mlm_logits, moe_load_balancing_loss, Transformer)
    from text_to_speech_tpu_torch.models.transformers import families
    from text_to_speech_tpu_torch.models.transformers.heads import convert_bert_mlm_state_dict
    from text_to_speech_tpu_torch.weights import transformer_from_jax, tree_to

    out = {}
    narrow = dict(vocab_size = 1000, hidden_size = 256, intermediate_size = 512,
                  num_hidden_layers = 2, num_attention_heads = 4, num_key_value_heads = 2)
    tokens = torch.from_numpy(rng.integers(1, 1000, (2, 16)))
    on = lambda params: {'cuda': tree_to(params, 'cuda'), 'cpu': params}
    for name, experts in (('mistral', 0), ('mixtral', 4)):
        sd = init.mistral_state_dict(51 + experts, num_local_experts = experts, ** narrow)
        config = families.mistral_config(vocab_size = 1000, dim = 256, n_layers = 2, n_heads = 4,
                                         n_kv_heads = 2, ffn_dim = 512)
        if experts:
            config = families.mixtral_config(n_experts = experts, n_experts_per_token = 2,
                                             ** config)
        model = Transformer(** config)
        convert = families.convert_mixtral_state_dict if experts \
            else families.convert_mistral_state_dict
        params = on(transformer_from_jax(convert(sd, n_heads = 4, n_kv_heads = 2)))
        logits, aux, greedy, margins = {}, {}, {}, []
        for device, p in params.items():
            aux[device] = []
            logits[device] = model.decode(p, tokens.to(device), aux = aux[device])[0]
            greedy[device] = generate(model, p, tokens, max_new_tokens = 8, device = device,
                                      trace = margins if device == 'cpu' else None).tokens
        entry = {'logits_rel_err': _card_vs_cpu_rel(logits['cuda'], logits['cpu'])}
        entry['greedy_rows_equal'], entry['greedy_rows_tied'] = _tie_rule(
            greedy['cuda'], greedy['cpu'], margins, 16)
        if experts:
            loss = {d: float(moe_load_balancing_loss(a, experts, 2)) for d, a in aux.items()}
            entry['load_balancing_loss'] = loss
            check(abs(loss['cuda'] - loss['cpu']) <= 1e-4 * abs(loss['cpu'])
                  and loss['cpu'] >= 1. - 1e-4, '{} load balancing: {}'.format(name, loss))
        check(entry['logits_rel_err'] <= 1e-4, '{}: {}'.format(name, entry))
        out[name] = entry

    # BERT with its MLM head
    sd = init.bert_mlm_state_dict(53, vocab_size = 1000, hidden_size = 256, num_hidden_layers = 2,
                                  intermediate_size = 512, max_position_embeddings = 64)
    model = Transformer(** families.bert_config(vocab_size = 1000, dim = 256, n_layers = 2,
                                                n_heads = 4, ffn_dim = 512, max_position = 64))
    params, head = (on(transformer_from_jax(t)) for t in convert_bert_mlm_state_dict(sd))
    padded = tokens.clone()
    padded[1, 12:] = 0
    mlm = {}
    for device in ('cuda', 'cpu'):
        hidden, _ = model.encode(params[device], padded.to(device))
        mlm[device] = (hidden, mlm_logits(params[device], head[device], hidden))
    out['bert_mlm'] = {'encode_rel_err': _card_vs_cpu_rel(mlm['cuda'][0], mlm['cpu'][0]),
                       'mlm_logits_rel_err': _card_vs_cpu_rel(mlm['cuda'][1], mlm['cpu'][1])}
    check(max(out['bert_mlm'].values()) <= 1e-4, 'BERT MLM: {}'.format(out['bert_mlm']))

    # the encoder-decoders: encode (audio for Whisper), then 8 greedy tokens
    narrow = dict(vocab_size = 1000, dim = 256, n_layers = 2, n_heads = 4, ffn_dim = 512)
    mel = torch.from_numpy(rng.standard_normal((2, 100, 80)).astype(np.float32))
    for name, build, sd, source in (
            ('t5', families.build_t5(rel_buckets = 32, ** narrow), init.t5_state_dict(
                54, vocab_size = 1000, d_model = 256, d_kv = 64, d_ff = 512, num_layers = 2,
                num_heads = 4), padded),
            ('bart', families.build_bart(** narrow), init.bart_state_dict(
                55, vocab_size = 1000, d_model = 256, encoder_layers = 2, decoder_layers = 2,
                ffn_dim = 512, max_position_embeddings = 64), padded),
            ('whisper', families.build_whisper(** narrow), init.whisper_state_dict(
                56, vocab_size = 1000, d_model = 256, encoder_layers = 2, decoder_layers = 2,
                ffn_dim = 512, num_mel_bins = 80, max_source_positions = 50,
                max_target_positions = 64), mel)):
        params = on(transformer_from_jax(families._FAMILIES[name][1](sd)))
        encoded, greedy, margins = {}, {}, []
        start = torch.ones((2, 1), dtype = torch.long)
        for device, p in params.items():
            enc, mask = build.encode(p, source.to(device))
            encoded[device] = enc
            greedy[device] = generate(build, p, start, max_new_tokens = 8, device = device,
                                      encoder_output = enc, encoder_mask = mask,
                                      trace = margins if device == 'cpu' else None).tokens
        entry = {'encode_rel_err': _card_vs_cpu_rel(encoded['cuda'], encoded['cpu']),
                 'encoded_shape': list(encoded['cuda'].shape)}
        entry['greedy_rows_equal'], entry['greedy_rows_tied'] = _tie_rule(
            greedy['cuda'], greedy['cpu'], margins, 1)
        check(entry['encode_rel_err'] <= 1e-4, '{}: {}'.format(name, entry))
        out[name] = entry
    check(out['whisper']['encoded_shape'] == [2, 50, 256], 'Whisper: {}'.format(out['whisper']))
    return out


#: the mesh phase: 8 requests over two ranks on the one card
MESH_TEXTS = SERVING_TEXTS[:8]
#: the WaveGlow batch (rows, frames) of the data-parallel steps and their
#: SGD rate, the pipeline's batch (its stages keep every activation: no
#: remat), Mixtral-8x7B's widths at 2 layers, and the frames a served
#: request runs
MESH_CASE = {'dp_batch': (8, 256), 'dp_precision': 'mixed_bfloat16', 'dp_lr': 1e-4,
             'pp_batch': (2, 64), 'mixtral': {'num_hidden_layers': 2}, 'max_steps': 256}
#: the trees of (e) to (i) beside the Tacotron-2 and WaveGlow ones
TENSOR_TREES = ('fastspeech2', 'fastspeech2_state', 'vits')
#: (b)'s bound on the reduced gradients' distance from one process's on the
#: whole batch, relative, in the L2 norm over every leaf
DP_GRAD_TOLERANCE = 1e-2


def _sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()


def _mesh_models(case, weights, device):
    """Tacotron-2 and WaveGlow (sigma 0 for serving) from the phase's
    weights, as every rank and the references build them."""
    from text_to_speech_tpu_torch.models.tts import Tacotron2, WaveGlow
    from text_to_speech_tpu_torch.text import default_english_tokenizer
    model = Tacotron2(weights['tacotron2_params'], weights['tacotron2_state'],
                      tokenizer = default_english_tokenizer(), device = device,
                      ** case['tacotron2'])
    vocoder = WaveGlow(weights['waveglow'], device = device, ** case['waveglow'])
    vocoder.arch.hp.sigma = 0.
    # remat='acts': the faster of the two remat modes (PERF.md §5)
    vocoder.train_remat = 'acts'
    return model, vocoder


def _mesh_serving_kw(vocoder, case):
    return dict(vocoder = vocoder, stream_audio = True, max_steps = case['max_steps'],
                deterministic = True, stream_context = 192)


def _mesh_drive(stepper):
    """`MESH_TEXTS` through an engine on `stepper` → (results, streamed parts)."""
    from text_to_speech_tpu_torch.runtimes.serving import ContinuousServingEngine
    parts = [[] for _ in MESH_TEXTS]
    with ContinuousServingEngine(* stepper, max_batch_size = 8) as engine:
        requests = [engine.submit(t, on_audio = parts[i].append)
                    for i, t in enumerate(MESH_TEXTS)]
        return [r.result.get(timeout = 300) for r in requests], parts


def _dp_batch(case, vocoder, device):
    """(b)'s WaveGlow batch, seeded: mel (B, F, n_mel) and audio."""
    rng = np.random.default_rng(51)
    B, F = case['dp_batch']
    mel = rng.standard_normal((B, F, vocoder.arch.hp.n_mel_channels)) - 5.
    audio = 0.3 * rng.standard_normal((B, F * vocoder.upsample_rate))
    return (torch.from_numpy(mel.astype(np.float32)).to(device),
            torch.from_numpy(audio.astype(np.float32)).to(device))


def _dp_steps(vocoder, case, mesh, mel, audio, local = None):
    """Two SGD WaveGlow steps from the vocoder's weights → (params, losses,
    each step's gradients by leaf: on a `mesh` those reduced over the data
    group).  `local`, a dict, receives the first step's gradients of this
    rank's own rows, before the reduce."""
    from text_to_speech_tpu_torch.parallel import collectives
    from text_to_speech_tpu_torch.train import trainer
    from text_to_speech_tpu_torch.train.losses import WaveGlowLoss
    from text_to_speech_tpu_torch.train.optimizers import get_optimizer
    from text_to_speech_tpu_torch.weights import flatten_tree, unflatten_tree
    tree = unflatten_tree(trainer._trainable({k: v.clone() for k, v in
                                              flatten_tree(vocoder.params).items()}))
    tx = get_optimizer('sgd', lr = case['dp_lr'])
    opt = tx.init(tree)
    step = trainer.make_train_step(vocoder, WaveGlowLoss(sigma = 1.), tx, mesh = mesh,
                                   precision = case['dp_precision'])
    reduce = collectives.average_gradients

    def recording(tensors, * args, ** kwargs):
        if local is not None and not local:
            local.update({id(t): t.grad.clone() for t in tensors})
        return reduce(tensors, * args, ** kwargs)
    collectives.average_gradients = recording
    losses, grads = [], []
    try:
        for _ in range(2):
            tree, _, opt, metrics = step(tree, None, opt, None, (mel, audio), None)
            losses.append(float(metrics['loss']))
            grads.append({k: v.grad.clone() for k, v in flatten_tree(tree).items()})
    finally:
        collectives.average_gradients = reduce
    if local:
        by_id = {id(v): k for k, v in flatten_tree(tree).items()}
        named = {by_id[i]: g for i, g in local.items()}
        local.clear()
        local.update(named)
    _sync(mel.device)
    return tree, losses, grads


def _grad_rel(grads, ref):
    """(‖grads − ref‖ / ‖ref‖ over every leaf together, its largest value
    over the leaves one by one whose reference is not 0), in float64."""
    num = {k: float((grads[k].double() - ref[k].double()).pow(2).sum()) for k in ref}
    den = {k: float(ref[k].double().pow(2).sum()) for k in ref}
    return ((sum(num.values()) / sum(den.values())) ** 0.5,
            max((num[k] / den[k]) ** 0.5 for k in ref if den[k] > 0))


def _mesh_references(case, weights):
    """The one-process references of (a), (b) and (e) to (i), in this
    process while the ranks start: the one-rank stepper's 8 requests, two
    SGD steps on the whole batch with their gradients, and
    `_tensor_references`.  Written to ``case['refs']`` and, (e) to (i)'s,
    to ``case['refs'] + '.tensor'``."""
    from text_to_speech_tpu_torch.runtimes.serving import make_tacotron_stepper
    from text_to_speech_tpu_torch.weights import tree_to
    sections = {}
    clock = section_clock(sections)
    device = case.get('device', 'cuda')
    model, vocoder = _mesh_models(case, weights, device)
    results, _ = _mesh_drive(make_tacotron_stepper(model, ** _mesh_serving_kw(vocoder, case)))
    _sync(device)
    clock('serving_one_rank')
    mel, audio = _dp_batch(case, vocoder, device)
    tree, losses, grads = _dp_steps(vocoder, case, None, mel, audio)
    clock('dp_one_process')
    refs = {'serving': [{k: torch.from_numpy(np.asarray(r[k])) for k in ('mel', 'audio')}
                        for r in results],
            'dp_losses': losses, 'dp_grads': grads}
    del tree, grads
    _save_refs(refs, case['refs'])
    clock('save')
    # (e) to (i)'s, in a file of their own: the ranks read it after (c)
    refs = _tensor_references(
        case, {k: tree_to(weights[k], device) for k in TENSOR_TREES}, model, vocoder, device)
    clock('tensor_one_process')
    _save_refs(refs, case['refs'] + '.tensor')
    clock('save_tensor')
    return sections


def _save_refs(refs, path):
    torch.save(refs, path + '.part')
    os.replace(path + '.part', path)


def _await_refs(case, suffix = '', timeout = 300.):
    """The references (``case['refs'] + suffix``) once this process's parent
    has written them."""
    start = time.perf_counter()
    path = case['refs'] + suffix
    while not os.path.exists(path):
        if os.path.exists(case['refs'] + '.failed'):
            raise RuntimeError('the mesh references failed in the parent')
        if time.perf_counter() - start > timeout:
            raise TimeoutError('no mesh references after {} s'.format(timeout))
        time.sleep(0.1)
    return torch.load(path, map_location = case.get('device', 'cuda'))


def _mesh_worker(case):
    """One rank of the mesh phase (two gloo ranks on the one card): its
    records of parts (a) to (d), numbers only, and its checks' failures
    raised (the parent's `parallel.spawn` raises them)."""
    import torch.distributed as dist
    from text_to_speech_tpu_torch import parallel
    from text_to_speech_tpu_torch.init import mixtral_state_dict
    from text_to_speech_tpu_torch.models import tacotron2_arch
    from text_to_speech_tpu_torch.models.transformers import Transformer, families, generate
    from text_to_speech_tpu_torch.parallel.pipeline import WaveGlowPipeline
    from text_to_speech_tpu_torch.runtimes.serving import make_tacotron_stepper
    from text_to_speech_tpu_torch.train import trainer
    from text_to_speech_tpu_torch.train.optimizers import get_optimizer
    from text_to_speech_tpu_torch.weights import flatten_tree, unflatten_tree

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # 'cpu' with small sizes in `case`: the CPU rehearsal of the phase
    on_card = case.get('device', 'cuda') == 'cuda'
    rank = dist.get_rank()
    mesh = parallel.create_mesh({'dp': 2})
    out, sections = {'rank': rank, 'device': str(mesh.device)}, {}
    # gloo's send / recv abort on a CUDA tensor (``--probe-gloo-p2p``): the
    # port's stage it through host memory; the other collectives take it
    out['send_recv_staged_through_host'] = parallel.collectives.stages_through_host(
        torch.ones(1, device = mesh.device), mesh.group('dp'))
    clock = section_clock(sections)

    def section(name):
        clock(name)
        print('mesh rank {}: {} {:.1f} s'.format(rank, name, sections[name]), file = sys.stderr,
              flush = True)

    # the first rank loads the weights, every rank receives them
    weights = torch.load(case['weights'], map_location = mesh.device) if rank == 0 else None
    weights = parallel.shard_params(weights, mesh)
    model, vocoder = _mesh_models(case, weights, mesh.device)
    tensor_trees = {k: weights[k] for k in TENSOR_TREES}
    del weights
    section('weights')

    # (a) serving over {'dp': 2}; the emission windows and K3's row groups
    # recorded
    vocoded, k3_shapes = [], []
    device_vocoder_fn = vocoder.device_vocoder_fn

    def recording_vocoder_fn(** config):
        fn, params, tag = device_vocoder_fn(** config)

        def recorded(params, mel, generator = None):
            vocoded.append(tuple(mel.shape[:2]))
            return fn(params, mel, generator)
        return recorded, params, tag

    real_k3 = tacotron2_arch.decoder_steps

    def recording_k3(weights, mem, * args, ** kwargs):
        k3_shapes.append(tuple(mem.shape[:2]))
        return real_k3(weights, mem, * args, ** kwargs)

    stepper = make_tacotron_stepper(model, mesh = mesh, ** _mesh_serving_kw(vocoder, case))
    check(stepper[1].fused or not on_card, 'mesh serving: the stepper is not on K3')
    _sync(mesh.device)
    reset_launches()
    vocoder.device_vocoder_fn = recording_vocoder_fn
    tacotron2_arch.decoder_steps = recording_k3
    start = time.perf_counter()
    try:
        if stepper[1].controller:
            results, parts = _mesh_drive(stepper)
        else:
            stepper[1].follow()
        _sync(mesh.device)
    finally:
        tacotron2_arch.decoder_steps = real_k3
        del vocoder.device_vocoder_fn
    serving = {'wall_s': time.perf_counter() - start, 'launches': read_launches(),
               'stepper': dict(stepper[1].stats), 'k3_shapes': sorted(set(k3_shapes)),
               'k3_calls': len(k3_shapes), 'vocoder_calls': len(vocoded),
               'emission_shapes': sorted(set(vocoded))}
    check(not on_card or serving['launches']['decoder_steps'] == sum(-(-B // 8) for B, _ in k3_shapes) > 0
          and serving['launches']['wn_block'] == vocoder.arch.hp.n_flows * len(vocoded) > 0,
          'mesh serving rank {}: launches {} for K3 calls {} and {} vocoder calls'.format(
              rank, serving['launches'], k3_shapes, len(vocoded)))
    del stepper
    section('serving_mesh')
    refs = _await_refs(case)
    section('await_references')
    if rank == 0:
        mel_err = audio_err = 0.
        for res, ref_res, streamed in zip(results, refs['serving'], parts):
            ref_res = {k: v.cpu().numpy() for k, v in ref_res.items()}
            check(res['mel'].shape == ref_res['mel'].shape
                  == (case['max_steps'], model.arch.hp.n_mel_channels)
                  and res['steps'] == case['max_steps'],
                  'mesh serving: mel {}'.format(res['mel'].shape))
            check(np.array_equal(np.concatenate(streamed), res['audio']),
                  'mesh serving: the streamed parts are not the audio')
            mel_err = max(mel_err, float(np.abs(res['mel'] - ref_res['mel']).max())
                          / float(np.abs(ref_res['mel']).max()))
            audio_err = max(audio_err, float(np.abs(res['audio'] - ref_res['audio']).max())
                            / float(np.abs(ref_res['audio']).max()))
        check(mel_err <= 1e-4 and audio_err <= 2e-2,
              'mesh serving against one rank: mel {} audio {}'.format(mel_err, audio_err))
        serving.update(requests = len(MESH_TEXTS), mel_rel_err = mel_err,
                       mel_tolerance_rel = 1e-4, audio_rel_err = audio_err,
                       audio_tolerance_rel = 2e-2)
    out['serving'] = serving

    # (b) two SGD steps on the ranks, 4 rows each: the reduced gradients
    # against one process's on the whole batch; the second rank's own rows'
    # gradient (a step without the reduce) and the reduce summed, not
    # averaged, must miss the same bound
    mel, audio = _dp_batch(case, vocoder, mesh.device)
    B, F = case['dp_batch']
    rows = slice(rank * B // 2, (rank + 1) * B // 2)
    local = {}
    start = time.perf_counter()
    tree, losses, grads = _dp_steps(vocoder, case, mesh, mel[rows], audio[rows], local)
    dp = {'batch': [B, F], 'rows_a_rank': B // 2, 'steps': 2, 'optimizer': 'sgd',
          'lr': case['dp_lr'], 'precision': case['dp_precision'],
          'wall_s': time.perf_counter() - start, 'losses': losses}
    flat = flatten_tree(tree)
    digest = float(sum(float(v.detach().double().sum()) for v in flat.values()))
    digests = parallel.collectives.all_gather_objects(digest, mesh.group('dp'))
    check(digests[0] == digests[1], "dp: the ranks' parameters differ: {}".format(digests))
    ref_losses, ref_grads = refs['dp_losses'], refs['dp_grads']
    tol = DP_GRAD_TOLERANCE
    # held leaf by leaf: the whole tree's norm is led by the flows' log-det
    # gradients, which no row's data moves
    errs = [_grad_rel(g, r) for g, r in zip(grads, ref_grads)]
    controls = {'own_rows_unreduced': _grad_rel(local, ref_grads[0]),
                'reduce_summed': _grad_rel({k: 2 * v for k, v in grads[0].items()},
                                           ref_grads[0])}
    loss_errs = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    dp.update(ref_losses = ref_losses, grad_rel_err_all_leaves = [e[0] for e in errs],
              grad_rel_err_worst_leaf = [e[1] for e in errs], grad_tolerance_rel = tol,
              controls_grad_rel_err = controls, loss_rel_err = loss_errs,
              loss_tolerance_rel = [1e-5, 1e-4])
    check(max(e[1] for e in errs) <= tol and loss_errs[0] <= 1e-5 and loss_errs[1] <= 1e-4,
          'dp steps against one process: {}'.format(dp))
    check(min(c[1] for c in controls.values()) > tol,
          'dp: a control meets the bound: {}'.format(dp))
    out['dp_training'] = dp
    del tree, flat, grads, local, refs, ref_grads
    section('dp_mesh')

    # (c) two GPipe steps over {'pp': 2} against arch.loss on one process
    # (sigma 1: the stream above ran the vocoder at sigma 0)
    B, F = case['pp_batch']
    mel, audio = mel[:B, :F].contiguous(), audio[:B, :F * vocoder.upsample_rate].contiguous()
    pp_mesh = parallel.create_mesh({'pp': 2})
    pipe = WaveGlowPipeline(vocoder.arch, pp_mesh, n_micro = 2)
    tree = unflatten_tree(trainer._trainable({k: v.clone() for k, v in
                                              flatten_tree(vocoder.params).items()}))
    sgd = get_optimizer('sgd', lr = 1e-4).init(tree)
    pp = {'batch': [B, F], 'n_micro': 2, 'stages': 2, 'bounds': pipe.bounds, 'steps': []}
    for _ in range(2):
        sgd.zero_grad()
        start = time.perf_counter()
        loss = pipe.value_and_grad(tree, mel, audio, 1.)
        _sync(mesh.device)
        record = {'loss': float(loss), 'wall_s': time.perf_counter() - start}
        grads = {k: v.grad.clone() for k, v in flatten_tree(tree).items()}
        if rank == 0:
            ref_leaves = {k: v.detach().clone().requires_grad_(True)
                          for k, v in flatten_tree(tree).items()}
            ref_loss = vocoder.arch.loss(unflatten_tree(ref_leaves), mel, audio, 1., remat = True)
            ref_loss.backward()
            grad_err = max(float((grads[k] - ref_leaves[k].grad).abs().max())
                           / max(float(ref_leaves[k].grad.abs().max()), 1e-30) for k in grads)
            loss_err = abs(record['loss'] - float(ref_loss)) / abs(float(ref_loss))
            check(loss_err <= 1e-5 and grad_err <= 1e-4,
                  'pp step against arch.loss: loss {} grads {}'.format(loss_err, grad_err))
            record.update(ref_loss = float(ref_loss), loss_rel_err = loss_err,
                          grad_rel_err = grad_err, tolerance = {'loss_rel': 1e-5,
                                                                'grad_rel': 1e-4})
            del ref_leaves, ref_loss
        pp['steps'].append(record)
        sgd.step()
        dist.barrier()
    out['pipeline'] = pp
    del tree, grads, sgd
    section('pipeline')

    # (e) to (i): the tensor and sequence axes
    tensor_refs = _await_refs(case, '.tensor')
    section('await_tensor_references')
    out['tensor'] = _tensor_cases(case, tensor_trees, model, vocoder, tensor_refs, rank,
                                  mesh.device, section)
    del model, vocoder, tensor_trees, tensor_refs
    if on_card:
        torch.cuda.empty_cache()

    # (d) Mixtral-8x7B's widths at 2 layers in bfloat16 over {'ep': 2}
    widths = case['mixtral']
    config = families.mixtral_config(
        vocab_size = widths.get('vocab_size', 32000), dim = widths.get('hidden_size', 4096),
        ffn_dim = widths.get('intermediate_size', 14336), n_layers = widths['num_hidden_layers'],
        n_heads = widths.get('num_attention_heads', 32),
        n_kv_heads = widths.get('num_key_value_heads', 8))
    ep_mesh = parallel.create_mesh({'ep': 2})
    tokens = torch.from_numpy(np.random.default_rng(52).integers(
        1, config['vocab_size'], (2, 16))).to(mesh.device)
    moe = {'config': {k: config[k] for k in ('dim', 'n_heads', 'n_kv_heads', 'n_experts',
                                             'n_experts_per_token', 'ffn_dim', 'n_layers')}}
    params = None
    if rank == 0:
        sd = mixtral_state_dict(7, device = mesh.device, dtype = torch.bfloat16, ** widths)
        params = families.mixtral_from_state_dict(sd, config['n_heads'], config['n_kv_heads'])
        del sd
        one = Transformer(** config)
        margins = []
        with torch.no_grad():
            ref_logits = one.decode(params, tokens)[0].float()
            ref_tokens = generate(one, params, tokens, max_new_tokens = 8,
                                  device = mesh.device, trace = margins).tokens
        _sync(mesh.device)
    section('mixtral_build')
    start = time.perf_counter()
    local = parallel.shard_params(params, ep_mesh, parallel.moe_param_specs)
    _sync(mesh.device)
    moe['shard_s'] = time.perf_counter() - start
    del params
    moe['local_experts'] = int(local['layer_0']['ffn']['experts']['gate']['weight'].shape[0])
    model = Transformer(mesh = ep_mesh, ** config)
    with torch.no_grad():
        start = time.perf_counter()
        logits = model.decode(local, tokens)[0].float()
        _sync(mesh.device)
        moe['logits_s'] = time.perf_counter() - start
        start = time.perf_counter()
        greedy = generate(model, local, tokens, max_new_tokens = 8, device = mesh.device)
        _sync(mesh.device)
        moe['greedy_s'] = time.perf_counter() - start
    if rank == 0:
        err = float((logits - ref_logits).abs().max())
        rel = err / float(ref_logits.abs().max())
        # a token may flip where two logits lie within the two runs' difference
        tie = max(LLM_TIE, 2 * err)
        equal, tied = _tie_rule(greedy.tokens, ref_tokens, margins, tokens.shape[1], tie = tie)
        check(rel <= 2e-2, 'ep logits against one rank: {}'.format(rel))
        moe.update(logits_rel_err = rel, logits_tolerance_rel = 2e-2, tie_margin = tie,
                   rows_equal = equal, rows_apart_after_a_tie = tied)
    out['mixtral_ep'] = moe
    section('mixtral_ep')
    out['section_s'] = sections
    return out


#: the tensor and sequence axes, (e) to (i): WaveGlow's vocode (frames) and
#: SGD step (rows, frames, rate) over tp, its vocode over sp on K1 (frames,
#: the noise's sigma), FastSpeech-2's and VITS's token rows, and
#: Tacotron-2's teacher-forced batch (rows, frames) over tp
TENSOR_CASE = {'tp_vocode_frames': 32, 'tp_step': (2, 16), 'tp_lr': 1e-4, 'sp_frames': 256,
               'sp_sigma': 0.6, 'fs2_tokens': (2, 32), 'fs2_min_duration': 8,
               'fs2_max_frames': 384, 'vits_tokens': (2, 40), 'taco_batch': (2, 64),
               'taco_tokens': 48}


def _tensor_inputs(case, device):
    """(e) to (i)'s inputs, seeded: every rank and the references make the
    same."""
    rng = np.random.default_rng(61)
    mel = lambda frames: torch.from_numpy(
        (rng.standard_normal((1, frames, 80)) - 5.).astype(np.float32)).to(device)
    B, S = case['taco_batch'][0], case['taco_tokens']
    tokens = rng.integers(1, 140, (B, S))
    tokens[1:, S - 8:] = 0
    T = case['taco_batch'][1]
    gate = np.zeros((B, T), np.float32)
    gate[0, -1] = 1.
    gate[1:, T - 12:] = 1.
    taco = (tokens, (rng.standard_normal((B, T, 80)) - 5.).astype(np.float32),
            np.array([T] + [T - 11] * (B - 1), np.int64),
            (rng.standard_normal((B, T, 80)) - 5.).astype(np.float32), gate)
    return {'tp_mel': mel(case['tp_vocode_frames']), 'sp_mel': mel(case['sp_frames']),
            'fs2_tokens': torch.from_numpy(rng.integers(1, 140, case['fs2_tokens'])).to(device),
            'vits_tokens': torch.from_numpy(rng.integers(1, 140, case['vits_tokens'])).to(device),
            'taco': [torch.from_numpy(t).to(device) for t in taco]}


def _wg_sgd_step(arch, tree, mel, audio, lr, mesh = None):
    """One SGD step of `arch.loss` from `tree` (on `mesh`'s tp axis when
    given) → (loss, the new tree, the gradients)."""
    from text_to_speech_tpu_torch.parallel import collectives
    from text_to_speech_tpu_torch.weights import flatten_tree, unflatten_tree
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in flatten_tree(tree).items()}
    with collectives.tensor_shard(mesh) if mesh is not None else contextlib.nullcontext():
        loss = arch.loss(unflatten_tree(leaves), mel, audio, 1.)
    loss.backward()
    with torch.no_grad():
        new = {k: v - lr * v.grad for k, v in leaves.items()}
    return (float(loss.detach()), unflatten_tree(new),
            unflatten_tree({k: v.grad for k, v in leaves.items()}))


def _durations_ties(got, ref, pre, boundary):
    """Durations against the reference's: equal, or one apart where the
    reference's value before rounding lies within 1e-5 of a `boundary`
    (0.5: round half to even; 0: ceil) → (rows where all agree, moved)."""
    moved = got != ref
    if bool(moved.any()):
        off = pre[moved] - boundary
        ties = float((off - torch.round(off)).abs().max())
        check(ties <= 1e-5 and int((got - ref).abs().max()) <= 1,
              'durations differ off a tie: {}'.format(ties))
    return ~moved.any(dim = 1), int(moved.sum())


def _fs2_pre_rounding(arch, params, state, tokens):
    hidden, _, pad = arch.encode(params, tokens)
    log_d = arch._variance_predictor(params['duration_predictor'], hidden, pad_mask = pad)
    return torch.exp(log_d.float()) - 1.


def _vits_pre_ceil(arch, params, tokens, d_control):
    h, _, _, valid = arch.encode_text(params, tokens)
    logw = arch.sdp_sample(params, h, valid, noise_scale_w = 0.) if arch.hp.use_sdp \
        else arch.predict_log_durations(params, h, valid.float())
    return torch.exp(logw.float()) * valid * d_control


def _tensor_archs(case):
    from text_to_speech_tpu_torch.models.fastspeech2_arch import FastSpeech2
    from text_to_speech_tpu_torch.models.vits_arch import VITS
    return FastSpeech2(** case['fastspeech2_config']), VITS(** case['vits_config'])


def _tensor_references(case, weights, model, vocoder, device):
    """The one-process references of (e) to (i), on the card."""
    from text_to_speech_tpu_torch.train.losses import TacotronLoss
    x = _tensor_inputs(case, device)
    arch, params = vocoder.arch, vocoder.params
    refs = {}
    with torch.no_grad():
        refs['tp_vocode'] = arch.infer(params, x['tp_mel'], deterministic = True)
        f32 = arch.pack_kernel_params(params, dtype = torch.float32)
        for key, p, kernel in (('sp_k1', params, True), ('sp_chain', params, False),
                               ('sp_k1_f32', f32, True)):
            refs[key] = arch.infer(p, x['sp_mel'], sigma = case['sp_sigma'],
                                   generator = torch.Generator(device).manual_seed(62),
                                   use_kernel = kernel)
        # the K1 route's own spread: the same row alone and beside another
        # (other shapes of the matmuls around the kernel)
        z = torch.randn((1, x['sp_mel'].shape[1] * 32, 8), generator =
                        torch.Generator(device).manual_seed(64), device = device)
        one = arch.infer(params, x['sp_mel'], sigma = case['sp_sigma'], z = z, use_kernel = True)
        two = arch.infer(params, torch.cat([x['sp_mel'], x['sp_mel'].flip(1)]),
                         sigma = case['sp_sigma'], z = torch.cat([z, z.flip(1)]),
                         use_kernel = True)[:1]
        refs['sp_k1_batch_spread'] = _rel_scale(two, one)
    B, F = case['tp_step']
    mel, audio = _dp_batch(case, vocoder, device)
    # the loss and the gradients: the ranks take the new tree from these
    loss, _, grads = _wg_sgd_step(arch, params, mel[:B, :F],
                                  audio[:B, :F * vocoder.upsample_rate], case['tp_lr'])
    refs['tp_step'] = loss, grads
    fs_arch, v_arch = _tensor_archs(case)
    fs_kw = dict(max_frames = case['fs2_max_frames'], min_duration = case['fs2_min_duration'])
    v_params = weights['vits']
    with torch.no_grad():
        out = fs_arch.infer(weights['fastspeech2'], weights['fastspeech2_state'],
                            x['fs2_tokens'], ** fs_kw)
        refs['fs2'] = {'mel': out.mel, 'durations': out.durations, 'pre': _fs2_pre_rounding(
            fs_arch, weights['fastspeech2'], weights['fastspeech2_state'], x['fs2_tokens'])}
        quiet = dict(noise_scale = 0., noise_scale_w = 0., max_frames = 384)
        base = v_arch.infer(v_params, {}, x['vits_tokens'], ** quiet).lengths
        d_control = 256. / max(int(base.min()), 1)
        out = v_arch.infer(v_params, {}, x['vits_tokens'], d_control = d_control, ** quiet)
        refs['vits'] = {'audio': out.audio, 'lengths': out.lengths, 'durations': out.durations,
                        'd_control': d_control,
                        'pre': _vits_pre_ceil(v_arch, v_params, x['vits_tokens'], d_control)}
        tokens, mel_in, lengths, mel_out, gate = x['taco']
        preds, _ = model.arch(model.params, model.state, tokens, mel_in, mel_lengths = lengths,
                              train = True, generator = torch.Generator(device).manual_seed(63))
        refs['taco_loss'] = float(torch.mean(TacotronLoss()((mel_out, gate), preds)['loss']))
    return refs


def _rel_scale(out, ref):
    return float((out.float() - ref.float()).abs().max()) / max(float(ref.float().abs().max()),
                                                                1e-30)


def _tensor_cases(case, weights, model, vocoder, refs, rank, device, clock):
    """(e) to (i) on this rank: WaveGlow over {'tp': 2} (vocode, SGD step),
    over {'sp': 2} on K1, FastSpeech-2, VITS and Tacotron-2's teacher-forced
    loss over {'tp': 2}, each against one process."""
    import hashlib
    from text_to_speech_tpu_torch import parallel
    from text_to_speech_tpu_torch.nn import layers as nn_layers
    from text_to_speech_tpu_torch.parallel import collectives
    from text_to_speech_tpu_torch.train.losses import TacotronLoss
    from text_to_speech_tpu_torch.weights import flatten_tree
    out = {}
    x = _tensor_inputs(case, device)
    arch = vocoder.arch
    tp = parallel.create_mesh({'tp': 2})

    # (e) WaveGlow over tp: a deterministic vocode, then one SGD step
    start = time.perf_counter()
    wg_specs = parallel.waveglow_param_specs
    local = parallel.shard_params(vocoder.params if rank == 0 else None, tp, wg_specs)
    e = {'frames': case['tp_vocode_frames'], 'send_s': time.perf_counter() - start,
         'in_conv_shape': list(local['flow_0']['block']['in_conv_0']['weight'].shape)}
    with torch.no_grad(), collectives.tensor_shard(tp):
        t0 = time.perf_counter()
        audio = arch.infer(local, x['tp_mel'], deterministic = True)
        _sync(device)
        e['vocode_s'] = time.perf_counter() - t0
        try:
            arch.infer(local, x['tp_mel'][:, :8], deterministic = True, use_kernel = True)
            e['use_kernel_refused'] = False
        except ValueError:
            e['use_kernel_refused'] = True
    e['vocode_rel_err'] = _rel_scale(audio, refs['tp_vocode'])
    check(e['use_kernel_refused'] and e['vocode_rel_err'] <= 1e-4,
          'tp vocode against one process: {}'.format(e))
    B, F = case['tp_step']
    mel, audio = _dp_batch(case, vocoder, device)
    step = lambda: _wg_sgd_step(arch, local, mel[:B, :F], audio[:B, :F * vocoder.upsample_rate],
                                case['tp_lr'], mesh = tp)
    # the replicated leaves bit-equal on both ranks: no cuDNN algorithm
    # that sums in another order from call to call
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        t0 = time.perf_counter()
        loss, tree, grads = step()
        _sync(device)
        e['step_s'] = time.perf_counter() - t0
        # the control: the exits through `all_reduce_sum`, whose backward
        # all-reduces the gradient, must give the sharded leaves tp times it
        exit_op = nn_layers.tp_exit
        nn_layers.tp_exit = lambda t, axis: t if axis is None \
            else collectives.all_reduce_sum(t, axis.group)
        try:
            control = step()[2]
        finally:
            nn_layers.tp_exit = exit_op
    finally:
        torch.backends.cudnn.deterministic = deterministic
    ref_loss, ref_grads = refs['tp_step']
    ref_grads = flatten_tree(ref_grads)
    whole = flatten_tree(parallel.gather_params(tree, tp, wg_specs))
    # one process's step, from its gradients as `_wg_sgd_step` takes it
    start_tree = flatten_tree(vocoder.params)
    ref_tree = {k: start_tree[k] - case['tp_lr'] * g for k, g in ref_grads.items()}
    specs = flatten_tree(wg_specs(tree))
    replicated = hashlib.sha1(b''.join(
        whole[k].cpu().numpy().tobytes() for k in sorted(whole)
        if not any(a is not None for a in specs[k]))).hexdigest()
    digests = collectives.all_gather_objects(replicated, tp.group('tp'))
    # each rank's gradients against its slices of one process's, leaf by leaf
    grad_err = lambda tree: max(_rel_scale(tree[k], ref_grads[k][parallel._slices(
        specs[k], ref_grads[k].shape, tp, tp.coords)]) for k in ref_grads)
    grads, control = flatten_tree(grads), flatten_tree(control)
    e.update(step_batch = [B, F], lr = case['tp_lr'], loss = loss, ref_loss = ref_loss,
             loss_rel_err = abs(loss - ref_loss) / abs(ref_loss),
             grad_rel_err = grad_err(grads), control_grad_rel_err = grad_err(control),
             leaf_rel_err = max(_rel_scale(whole[k], ref_tree[k]) for k in ref_tree),
             sharded_leaves = sum(any(a is not None for a in s) for s in specs.values()),
             replicated_equal_on_ranks = len(set(digests)) == 1, tolerance_grad = 1e-4)
    check(e['loss_rel_err'] <= 1e-5 and e['grad_rel_err'] <= 1e-4 and e['leaf_rel_err'] <= 1e-4
          and e['control_grad_rel_err'] > 1e-4 and e['replicated_equal_on_ranks'],
          'tp SGD step against one process: {}'.format(e))
    e['wall_s'] = time.perf_counter() - start
    out['e_waveglow_tp'] = e
    del local, tree, grads, control, whole, ref_tree, start_tree
    clock('e_waveglow_tp')

    # (f) WaveGlow over sp on K1: each rank its frames and the halos.  The
    # counted run is the bf16 route.  K1 itself gives a row the same bits
    # whatever the length or batch it is computed in (`k1_halo_rows`, each
    # shard and halo against the whole utterance, held at 1e-5 of scale:
    # 0.0 read).  The route around it does not: `_end_conv`'s float32
    # product sums in an order that depends on its rows (a last-bit change
    # between a shard and the whole), and where that moves a value across
    # a bf16 rounding of the next flow's K1 input, the inverse flows carry
    # a bf16 step on (`k1_batch_spread`: the same row alone and beside
    # another, 1.28e-3 of scale; `--probe-k1-rows` reads each op).  So the
    # bf16 audio is held at twice that spread (2.5e-3) against the
    # one-device K1 route, and at K1's bound (1e-2) against the chain; the
    # halos of the whole route at 1e-5: the float32 chain and K1's float32
    # instantiation over sp against their one-device routes.
    start = time.perf_counter()
    sp = parallel.create_mesh({'sp': 2})
    mel = parallel.shard_sequence(x['sp_mel'], sp)
    groups = mel.shape[1] * vocoder.upsample_rate // arch.hp.n_group
    sp_kw = dict(sigma = case['sp_sigma'])
    _sync(device)
    reset_launches()
    with torch.no_grad(), collectives.tensor_shard(sp):
        audio = arch.infer(vocoder.params, mel, use_kernel = True, ** sp_kw,
                           generator = torch.Generator(device).manual_seed(62))
    _sync(device)
    f = {'frames': case['sp_frames'], 'launches': read_launches(), 'halo_groups':
         arch.halo_groups, 'k1_shape': [1, groups + arch.halo_groups],
         'wall_s': time.perf_counter() - start}
    f.update(k1_rel_err = _rel_scale(audio, refs['sp_k1']),
             chain_rel_err = _rel_scale(audio, refs['sp_chain']),
             k1_batch_spread = refs['sp_k1_batch_spread'], tolerance_bf16_k1 = 2.5e-3,
             tolerance_bf16_chain = 1e-2)
    with torch.no_grad(), collectives.tensor_shard(sp):
        f32 = arch.pack_kernel_params(vocoder.params, dtype = torch.float32)
        for key, p, kernel in (('chain', vocoder.params, False), ('k1_f32', f32, True)):
            out_sp = arch.infer(p, mel, use_kernel = kernel, ** sp_kw,
                                generator = torch.Generator(device).manual_seed(62))
            f['{}_sp_rel_err'.format(key)] = _rel_scale(out_sp, refs['sp_' + key])
    with torch.no_grad():
        rows = _k1_halo_rows(arch, vocoder.params, x['sp_mel'], torch.bfloat16,
                             torch.Generator(device).manual_seed(65))[0]
    f['k1_halo_rows'] = rows
    f['tolerance_halo'] = 1e-5
    on_card = torch.device(device).type == 'cuda'          # the CPU rehearsal: plain K1
    check((f['launches']['wn_block'] == arch.hp.n_flows or not on_card)
          and f['k1_rel_err'] <= 2.5e-3 and f['chain_rel_err'] <= 1e-2
          and max(f['chain_sp_rel_err'], f['k1_f32_sp_rel_err'],
                  max(rows['shard_0'], rows['shard_1'], rows['batch']) / rows['scale']) <= 1e-5,
          'sp vocode on K1: {}'.format(f))
    out['f_waveglow_sp'] = f
    del f32
    clock('f_waveglow_sp')

    # (g) FastSpeech-2 and (h) VITS over tp, deterministic
    fs_arch, v_arch = _tensor_archs(case)
    start = time.perf_counter()
    fs_local = parallel.shard_params(weights['fastspeech2'] if rank == 0 else None, tp,
                                     parallel.fastspeech2_param_specs)
    with torch.no_grad(), collectives.tensor_shard(tp):
        res = fs_arch.infer(fs_local, weights['fastspeech2_state'], x['fs2_tokens'],
                            max_frames = case['fs2_max_frames'],
                            min_duration = case['fs2_min_duration'])
    ref = refs['fs2']
    rows, moved = _durations_ties(res.durations, ref['durations'], ref['pre'], 0.5)
    g = {'frames': [int(v) for v in res.lengths], 'rows_equal': int(rows.sum()),
         'durations_moved': moved,
         'mel_rel_err': _rel_scale(res.mel[rows], ref['mel'][rows]) if bool(rows.any())
         else None, 'tolerance': 1e-4}
    check(g['mel_rel_err'] is not None and g['mel_rel_err'] <= 1e-4,
          'FastSpeech-2 over tp: {}'.format(g))
    g['wall_s'] = time.perf_counter() - start
    out['g_fastspeech2_tp'] = g
    del fs_local
    clock('g_fastspeech2_tp')
    start = time.perf_counter()
    v_local = parallel.shard_params(weights['vits'] if rank == 0 else None, tp,
                                    parallel.vits_param_specs)
    ref = refs['vits']
    with torch.no_grad(), collectives.tensor_shard(tp):
        res = v_arch.infer(v_local, {}, x['vits_tokens'], noise_scale = 0., noise_scale_w = 0.,
                           max_frames = 384, d_control = ref['d_control'])
    rows, moved = _durations_ties(res.durations, ref['durations'], ref['pre'], 0.)
    h = {'frames': [int(v) for v in res.lengths], 'rows_equal': int(rows.sum()),
         'durations_moved': moved,
         'audio_rel_err': _rel_scale(res.audio[rows], ref['audio'][rows]) if bool(rows.any())
         else None, 'tolerance': 1e-4}
    check(h['audio_rel_err'] is not None and h['audio_rel_err'] <= 1e-4
          and torch.equal(res.lengths[rows], ref['lengths'][rows]), 'VITS over tp: {}'.format(h))
    h['wall_s'] = time.perf_counter() - start
    out['h_vits_tp'] = h
    del v_local
    clock('h_vits_tp')

    # (i) Tacotron-2's teacher-forced loss over tp
    start = time.perf_counter()
    t_local = parallel.shard_params(model.params if rank == 0 else None, tp,
                                    parallel.tacotron2_param_specs)
    tokens, mel_in, lengths, mel_out, gate = x['taco']
    with torch.no_grad(), collectives.tensor_shard(tp):
        preds, _ = model.arch(t_local, model.state, tokens, mel_in, mel_lengths = lengths,
                              train = True, generator = torch.Generator(device).manual_seed(63))
        loss = float(torch.mean(TacotronLoss()((mel_out, gate), preds)['loss']))
        try:
            model.arch.infer(t_local, model.state, tokens[:1], max_length = 4)
            refused = False
        except ValueError:
            refused = True
    i = {'batch': list(case['taco_batch']), 'loss': loss, 'ref_loss': refs['taco_loss'],
         'loss_rel_err': abs(loss - refs['taco_loss']) / abs(refs['taco_loss']),
         'tolerance_rel': 1e-5, 'infer_refused': refused,
         'wall_s': time.perf_counter() - start}
    check(i['loss_rel_err'] <= 1e-5 and refused, 'Tacotron-2 over tp: {}'.format(i))
    out['i_tacotron2_tp'] = i
    clock('i_tacotron2_tp')
    return out


def _nccl_one_rank():
    """One NCCL rank in this process: the NCCL path initialised and its
    collectives called on the card."""
    import torch.distributed as dist
    from text_to_speech_tpu_torch import parallel
    from text_to_speech_tpu_torch.parallel import collectives
    start = time.perf_counter()
    store = tempfile.mkdtemp(prefix = 'nccl_')
    dist.init_process_group('nccl', init_method = 'file://' + os.path.join(store, 'store'),
                            world_size = 1, rank = 0)
    try:
        mesh = parallel.create_mesh({'dp': 1}, platform = 'gpu')
        group = mesh.group('dp')
        t = torch.arange(4., device = 'cuda')
        collectives.all_reduce_(t, group)
        collectives.broadcast_(t, 0, group)
        gathered = collectives.all_gather(t, group)
        obj = collectives.broadcast_object({'x': 1}, 0, group)
        objs = collectives.all_gather_objects(3, group)
        params = parallel.shard_params({'w': torch.ones(3, device = 'cuda')}, mesh)
        torch.cuda.synchronize()
        out = {'backend': dist.get_backend(), 'device': str(mesh.device),
               'ok': bool(torch.equal(gathered[0], torch.arange(4., device = 'cuda'))
                          and obj == {'x': 1} and objs == [3]
                          and float(params['w'].sum()) == 3.)}
    finally:
        dist.destroy_process_group()
    out['s'] = time.perf_counter() - start
    check(out['ok'] and out['backend'] == 'nccl', 'NCCL one-rank mesh: {}'.format(out))
    return out


def mesh_phase(model, vocoder, root, ** overrides):
    """The parallel axes on torch.distributed: two ranks spawned on the one
    card (`parallel.spawn`, gloo: NCCL takes one rank a card) run (a)
    Tacotron-2 + WaveGlow at NVIDIA width serving 8 requests of 256 frames
    over {'dp': 2} with streamed audio, K3 and K1 on each rank, against the
    one-rank stepper; (b) two data-parallel SGD WaveGlow steps (8 × 256
    frames, 4 rows a rank), their reduced gradients against one process's;
    (c) two GPipe steps over {'pp': 2} against `arch.loss`; (e) to (i),
    the tensor and sequence axes (`_tensor_cases`): NVIDIA WaveGlow over
    {'tp': 2} (a vocode, an SGD step), over {'sp': 2} on K1, FastSpeech-2,
    VITS and Tacotron-2's teacher-forced loss over {'tp': 2}; (d) a
    Mixtral-8x7B-width transformer (2 layers, bfloat16) over {'ep': 2}
    against one rank; then one NCCL rank in this process.  The one-process
    references of (a), (b) and (e) to (i) run here while the ranks start.
    Returns the per-rank K3 row groups and K1 emission shapes, the K1 shape
    of a rank's sp vocode and the launches."""
    from text_to_speech_tpu_torch import parallel
    from text_to_speech_tpu_torch.init import init_fastspeech2, vits_state_dict
    from text_to_speech_tpu_torch.models.fastspeech2_arch import HParamsFastSpeech2
    from text_to_speech_tpu_torch.models.tts import VITS
    from text_to_speech_tpu_torch.text import default_english_tokenizer, en_symbols
    from text_to_speech_tpu_torch.weights import convert_tree, tree_to

    phase_start = time.perf_counter()
    weights = os.path.join(root, 'mesh_weights.pt')
    # (g) and (h): FastSpeech-2 at the fastspeech2 phase's widths and seed,
    # VITS as the families phase imports it
    fs_hp = HParamsFastSpeech2(vocab_size = len(en_symbols))
    fs_params, fs_state = init_fastspeech2(fs_hp, seed = 13)
    vits = VITS.from_torch_pretrained(vits_state_dict(23, vocab_size = len(en_symbols)),
                                      name = 'vits', root = root, device = 'cpu',
                                      tokenizer = default_english_tokenizer())
    trees = {'tacotron2_params': tree_to(model.params, 'cpu'),
             'tacotron2_state': tree_to(model.state, 'cpu'),
             'waveglow': tree_to(vocoder.params, 'cpu'),
             'fastspeech2': convert_tree(fs_params), 'fastspeech2_state': convert_tree(fs_state),
             'vits': vits.params}
    torch.save(trees, weights)
    case = dict(MESH_CASE, ** TENSOR_CASE, weights = weights,
                refs = os.path.join(root, 'mesh_refs.pt'),
                tacotron2 = model.arch.hp.get_config(), waveglow = vocoder.arch.hp.get_config(),
                fastspeech2_config = fs_hp.get_config(), vits_config = vits.arch.hp.get_config(),
                ** overrides)
    del vits
    box = {}

    def run():
        start = time.perf_counter()
        try:
            box['ranks'] = parallel.spawn(_mesh_worker, 2, backend = 'gloo',
                                          device = case.get('device', 'cuda'),
                                          args = (case,), timeout = 300.)
        except BaseException as e:          # raised below, after the references
            box['error'] = e
        box['spawn_s'] = time.perf_counter() - start
    thread = threading.Thread(target = run)
    thread.start()
    try:
        ref_sections = _mesh_references(case, trees)
    except BaseException:
        open(case['refs'] + '.failed', 'w').close()
        raise
    finally:
        thread.join()
    if 'error' in box:
        raise box['error']
    ranks = box['ranks']
    for path in (weights, case['refs'], case['refs'] + '.tensor'):
        os.remove(path)
    nccl = _nccl_one_rank() if case.get('device', 'cuda') == 'cuda' else None
    launches = {k: [r['serving']['launches'][k] for r in ranks]
                for k in ('decoder_steps', 'wn_block')}
    launches['wn_block_sp'] = [r['tensor']['f_waveglow_sp']['launches']['wn_block']
                               for r in ranks]
    emit({'phase': 'mesh', 'ranks': ranks, 'references_s': ref_sections,
          'nccl_one_rank': nccl, 'spawn_s': box['spawn_s'], 'launches_per_rank': launches,
          'backend': 'gloo', 'note': "both ranks share one card: its times are not two cards'",
          'phase_s': time.perf_counter() - phase_start})
    k3_shapes = sorted({tuple(s) for r in ranks for s in r['serving']['k3_shapes']})
    k1_shapes = sorted({tuple(s) for r in ranks for s in r['serving']['emission_shapes']})
    return {'k3_shapes': k3_shapes, 'k1_shapes': k1_shapes,
            'sp_k1_shape': tuple(ranks[0]['tensor']['f_waveglow_sp']['k1_shape']),
            'launches': {k: sum(v) for k, v in launches.items()}}


def _gloo_p2p_worker():
    """One of two gloo ranks: `dist.send` / `dist.recv` called on a CUDA
    tensor as it is, then through `collectives.send` / `recv`."""
    import torch.distributed as dist
    rank = dist.get_rank()
    sent = torch.arange(1024, dtype = torch.float32, device = 'cuda')
    out = {'rank': rank}
    try:
        if rank == 0:
            dist.send(sent, 1)
        else:
            got = torch.zeros_like(sent)
            dist.recv(got, 0)
            torch.cuda.synchronize()
            out['direct_equal'] = bool(torch.equal(got, sent))
        out['direct'] = 'returned'
    except Exception as e:                  # the outcome is the probe's reading
        out['direct'] = '{}: {}'.format(type(e).__name__, str(e).splitlines()[0][:200])
    return out


def _gloo_p2p_staged():
    import torch.distributed as dist
    from text_to_speech_tpu_torch.parallel import collectives
    rank = dist.get_rank()
    sent = torch.arange(1024, dtype = torch.float32, device = 'cuda')
    if rank == 0:
        collectives.send(sent, 1)
        return {'rank': rank}
    got = collectives.recv(sent.shape, sent.dtype, 'cuda', 0)
    return {'rank': rank, 'staged_equal': bool(torch.equal(got, sent))}


def _k1_halo_rows(arch, params, mel, dtype, generator):
    """K1 in `dtype` on each rank's shard and halo of a {'sp': 2} vocode of
    `mel` (1, F, n_mel), the last flow's block on a seeded stream, against
    the same rows of the whole utterance, and the whole utterance beside a
    second row: max abs differences (0.0: bit-equal), and the output's
    scale → (dict, the block's packed weights, x, spect, K1's output)."""
    from text_to_speech_tpu_torch.nn import layers as nn
    from text_to_speech_tpu_torch.ops.wn_block import fused_wn_block
    diff = lambda a, b: float((a.float() - b.float()).abs().max())
    pair = lambda t: torch.cat([t, t.flip(1)])
    spect = arch.upsample_mel(params, mel)
    lg, halo = spect.shape[1], arch.halo_groups
    half = lg // 2
    name = 'flow_{}'.format(arch.hp.n_flows - 1)
    block = arch.pack_kernel_params({name: params[name]}, dtype = dtype)[name]['block']
    w = block['packed']
    k1 = lambda xs, ss: fused_wn_block(
        xs.contiguous(), ss.contiguous(), w['w_in_cond'], w['b_in_cond'], w['w_rs'],
        w['b_rs'], w['w_rs_last'], w['b_rs_last'])
    audio_half = torch.randn((1, lg, block['start']['weight'].shape[1]), generator = generator,
                             device = mel.device)
    x = nn.conv1d(block['start'], audio_half)
    xb, sb = x.to(dtype), spect.to(dtype)
    whole = k1(xb, sb)
    rows = {'shard_0': diff(k1(xb[:, :half + halo], sb[:, :half + halo])[:, :half],
                            whole[:, :half]),
            'shard_1': diff(k1(xb[:, half - halo:], sb[:, half - halo:])[:, halo:],
                            whole[:, half:]),
            'batch': diff(k1(pair(xb), pair(sb))[:1], whole),
            'scale': float(whole.float().abs().max())}
    return rows, block, x, spect, whole


def _k1_rows(vocoder, mel):
    """Where the bf16 K1 route's audio for a row depends on the shape the
    row is computed in: K1 on each rank's shard and halo (`_k1_halo_rows`),
    in bf16 and float32; each float32 op around it (the upsample, the
    start and end convs, the 1x1 inverse) at the same pairs of shapes, as
    max abs differences (0.0: bit-equal); then the route's audio, the same
    row alone and beside another (relative to scale), in bf16 K1, K1's
    float32 instantiation and the chain."""
    from text_to_speech_tpu_torch.nn import layers as nn
    arch, params = vocoder.arch, vocoder.params
    hp, device = arch.hp, mel.device
    diff = lambda a, b: float((a.float() - b.float()).abs().max())
    pair = lambda t: torch.cat([t, t.flip(1)])
    gen = torch.Generator(device).manual_seed(65)
    out = {}
    with torch.no_grad():
        for dtype in (torch.bfloat16, torch.float32):
            rows, block, x, spect, whole = _k1_halo_rows(arch, params, mel, dtype, gen)
            out['k1_' + str(dtype).split('.')[-1]] = rows
            if dtype == torch.bfloat16:
                lg, halo = spect.shape[1], arch.halo_groups
                half, frames = lg // 2, mel.shape[1] // 2
                end = arch._end_conv(block, whole)
                out['end_conv'] = {
                    'shard': diff(arch._end_conv(block, whole[:, half - halo:])[:, halo:],
                                  end[:, half:]),
                    'batch': diff(arch._end_conv(block, pair(whole))[:1], end)}
        overlap = (hp.upsample_width - 1) // hp.upsample_stride
        shard = arch.upsample_mel(params, mel[:, frames - overlap:])
        out['upsample'] = {
            'shard': diff(shard[:, overlap * (hp.upsample_stride // hp.n_group):], spect[:, half:]),
            'batch': diff(arch.upsample_mel(params, pair(mel))[:1], spect)}
        audio_half = torch.randn((1, lg, block['start']['weight'].shape[1]), generator = gen,
                                 device = device)
        x = nn.conv1d(block['start'], audio_half)
        out['start_conv'] = {
            'shard': diff(nn.conv1d(block['start'], audio_half[:, half - halo:])[:, halo:],
                          x[:, half:]),
            'batch': diff(nn.conv1d(block['start'], pair(audio_half))[:1], x)}
        w_inv = torch.linalg.inv(params['flow_{}'.format(hp.n_flows - 1)]['convinv']['weight']
                                 .float().T)
        audio = torch.randn((1, lg, w_inv.shape[0]), generator = gen, device = device)
        out['convinv'] = {'shard': diff(audio[:, half:] @ w_inv, (audio @ w_inv)[:, half:]),
                          'batch': diff((pair(audio) @ w_inv)[:1], audio @ w_inv)}
        z = torch.randn((1, lg, hp.n_group), generator = gen, device = device)
        f32 = arch.pack_kernel_params(params, dtype = torch.float32)
        for name, p, kernel in (('bf16', params, True), ('k1_float32', f32, True),
                                ('chain', params, False)):
            one = arch.infer(p, mel, sigma = 0.6, z = z, use_kernel = kernel)
            two = arch.infer(p, pair(mel), sigma = 0.6, z = pair(z), use_kernel = kernel)
            out['route_batch_' + name] = _rel_scale(two[:1], one)
    return out


def probe_k1_rows():
    """``--probe-k1-rows``: `_k1_rows` on NVIDIA's WaveGlow (seeded) and
    the 256-frame mel of the mesh phase's (f), float32 products in true
    float32 as there."""
    import tempfile
    from text_to_speech_tpu_torch.init import nvidia_waveglow_state_dict
    from text_to_speech_tpu_torch.models.tts import WaveGlow
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory() as root:
        vocoder = WaveGlow.from_nvidia_pretrained(nvidia_waveglow_state_dict(12), root = root,
                                                  device = 'cuda')
    mel = _tensor_inputs(TENSOR_CASE, 'cuda')['sp_mel']
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output = True, text = True, check = True).stdout.strip()
    print(json.dumps({'probe': 'k1_rows', 'torch': torch.__version__, 'card': smi,
                      ** _k1_rows(vocoder, mel)}))
    return 0


def probe_gloo_p2p():
    """``--probe-gloo-p2p``: whether gloo's send / recv take a CUDA tensor
    as it is (two ranks on the card, 20 s gloo timeout; a rank that dies
    or hangs is the reading), and the port's staged send / recv."""
    from text_to_speech_tpu_torch import parallel
    out = {}
    try:
        out['direct'] = parallel.spawn(_gloo_p2p_worker, 2, backend = 'gloo', device = 'cuda',
                                       timeout = 20.)
    except Exception as e:
        out['direct'] = '{}: {}'.format(type(e).__name__, str(e).splitlines()[0][:300])
    out['staged'] = parallel.spawn(_gloo_p2p_staged, 2, backend = 'gloo', device = 'cuda',
                                   timeout = 20.)
    print(json.dumps({'probe': 'gloo_p2p', 'torch': torch.__version__, ** out}))
    return 0


def llm_phase():
    """Token-level LLM serving and the transformer zoo: GPT-2 small at its
    published widths (vocab 50,257, dim 768, 12 layers, 12 heads, FFN 3,072,
    learned positions, gelu_new), its weights a seeded state dict in HF's
    ``transformer.*`` layout through `convert_gpt2_state_dict`; the prefill
    of 4 right-padded prompts and `generate` (greedy, beam, sampling) on the
    card against the port on the CPU (the tie rule of `_tie_rule`); 64
    requests served through `make_llm_engine` at the shape of
    `benchmarks/llm_serving_load.py`'s defaults (32-token prompts, 96 new
    tokens, max_length 256, chunk 8, 32 slots), each equal to the offline
    greedy `generate`, with the card's busy share over one chunk; then the
    narrow families.  No kernel of the port runs here: none of these modules
    reaches ``pl.pallas_call`` in the JAX package."""
    from text_to_speech_tpu_torch.init import gpt2_state_dict
    from text_to_speech_tpu_torch.models.transformers import Transformer, generate
    from text_to_speech_tpu_torch.models.transformers import families
    from text_to_speech_tpu_torch.ops.matmul_rate import matmul_rate
    from text_to_speech_tpu_torch.runtimes.llm_serving import make_llm_engine
    from text_to_speech_tpu_torch.weights import flatten_tree, transformer_from_jax, tree_to

    phase_start = time.perf_counter()
    out, sections = {}, {}
    section = section_clock(sections)
    reset_launches()
    matmul_rate.launches = 0
    rng = np.random.default_rng(41)

    model = Transformer(** families.gpt2_config())
    hp = model.hp
    check((hp.vocab_size, hp.dim, hp.n_layers, hp.n_heads, hp.ffn_dim, hp.positional,
           hp.ffn_activation) == (50257, 768, 12, 12, 3072, 'learned', 'gelu_new'),
          'GPT-2 small: {}'.format(hp.get_config()))
    cpu_params = transformer_from_jax(families.convert_gpt2_state_dict(gpt2_state_dict(41)))
    params = tree_to(cpu_params, 'cuda')
    n_params = sum(t.numel() for t in flatten_tree(params).values())
    check(n_params == 124_439_808, 'GPT-2 small parameters: {}'.format(n_params))
    out['gpt2'] = {'params': n_params}
    section('gpt2_build')

    # the prefill of 4 right-padded prompts of 8-32 tokens, card vs CPU
    lengths = torch.tensor([8, 17, 25, 32])
    prompts = torch.zeros((4, 32), dtype = torch.long)
    for b, n in enumerate(lengths.tolist()):
        prompts[b, :n] = torch.from_numpy(rng.integers(1, hp.vocab_size, n))

    def prefill(p, device):
        caches = model.init_caches(4, 32, device = device)
        with torch.no_grad():
            return model.decode(p, prompts.to(device), caches = caches)[0]
    card, prefill_ms = _synced_ms(lambda: prefill(params, 'cuda'))
    cpu = prefill(cpu_params, 'cpu')
    rows = torch.arange(4)
    out['prefill'] = {'logits_rel_err': _card_vs_cpu_rel(card, cpu),
                      'next_logits_rel_err': _card_vs_cpu_rel(card[rows, lengths - 1].cpu(),
                                                              cpu[rows, lengths - 1]),
                      'ms': prefill_ms, 'tolerance_rel': 1e-4}
    check(out['prefill']['logits_rel_err'] <= 1e-4, 'GPT-2 prefill: {}'.format(out['prefill']))
    section('prefill')

    # offline generation on the card against the CPU
    with torch.no_grad():
        gp = rng.integers(1, hp.vocab_size, (4, 16))
        margins = []
        greedy_cpu = generate(model, cpu_params, gp, max_new_tokens = 32, device = 'cpu',
                              trace = margins)
        greedy, greedy_ms = _synced_ms(lambda: generate(model, params, gp, max_new_tokens = 32,
                                                        device = 'cuda'))
        equal, tied = _tie_rule(greedy.tokens, greedy_cpu.tokens, margins, 16)
        out['greedy'] = {'rows': 4, 'new_tokens': 32, 'ms': greedy_ms, 'rows_equal': equal,
                         'rows_apart_after_a_tie': tied,
                         'min_margin_cpu': float(torch.stack(margins).min())}
        beam_margins = []
        beam_cpu = generate(model, cpu_params, gp[:2], max_new_tokens = 32, method = 'beam',
                            num_beams = 4, device = 'cpu', trace = beam_margins)
        beam, beam_ms = _synced_ms(lambda: generate(model, params, gp[:2], max_new_tokens = 32,
                                                    method = 'beam', num_beams = 4,
                                                    device = 'cuda'))
        equal, tied = _tie_rule(beam.tokens, beam_cpu.tokens, beam_margins, 16)
        out['beam'] = {'rows': 2, 'beams': 4, 'new_tokens': 32, 'ms': beam_ms,
                       'rows_equal': equal, 'rows_apart_after_a_tie': tied,
                       'scores_rel_err': _card_vs_cpu_rel(beam.scores, beam_cpu.scores)}
        sample = [generate(model, params, gp, max_new_tokens = 32, method = 'sample', rng = 7,
                           device = 'cuda').tokens for _ in range(2)]
        top1 = generate(model, params, gp, max_new_tokens = 32, method = 'sample', top_k = 1,
                        rng = 8, device = 'cuda').tokens
        out['sample'] = {'repeat_equal': bool(torch.equal(sample[0], sample[1])),
                         'top_k_1_equals_greedy': bool(torch.equal(top1, greedy.tokens)),
                         'differs_from_greedy': bool(not torch.equal(sample[0], greedy.tokens))}
        check(out['sample']['repeat_equal'] and out['sample']['top_k_1_equals_greedy'],
              'sampling: {}'.format(out['sample']))
    del cpu_params
    section('generate')

    # serving: 64 requests at once, 32-token prompts, 96 new tokens each
    engine = make_llm_engine(model, params, max_batch = 32, max_length = 256, chunk = 8,
                             prompt_multiple = 32, device = 'cuda')
    requests = rng.integers(1, hp.vocab_size, (64, 32))
    warm_s = engine.warmup(requests[0], batch_sizes = (1, 32), max_new_tokens = 8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    first, done = {}, {}
    with engine:
        start = time.perf_counter()
        futures = [engine.submit(
            p, max_new_tokens = 96,
            on_token = lambda f, t, i = i: first.setdefault(i, time.perf_counter()),
            callback = lambda o, rid, i = i: done.setdefault(i, time.perf_counter()))
            for i, p in enumerate(requests)]
        served = [f.result.get(timeout = 600) for f in futures]
        wall = time.perf_counter() - start
    stats = engine.stats
    first_ms = sorted(1e3 * (first[i] - start) for i in range(64))
    latency_ms = sorted(1e3 * (done[i] - start) for i in range(64))
    n_tokens = sum(o['n_tokens'] for o in served)
    check(n_tokens == 64 * 96 and all(o['prompt_tokens'] == r.tolist()
                                      for o, r in zip(served, requests)),
          'served {} tokens'.format(n_tokens))
    out['serving'] = {
        'requests': 64, 'prompt_tokens': 32, 'new_tokens': 96, 'max_batch': 32,
        'max_length': 256, 'chunk': 8, 'warmup_s': warm_s, 'wall_s': wall,
        'tokens_per_s': n_tokens / wall, 'requests_per_s': 64 / wall,
        'first_token_ms_median': statistics.median(first_ms),
        'first_token_ms_p90': first_ms[int(0.9 * 63)],
        'latency_ms_median': statistics.median(latency_ms),
        'latency_ms_p90': latency_ms[int(0.9 * 63)],
        'engine_first_token_ms_median': 1e3 * statistics.median(
            o['first_token_s'] for o in served),
        'chunks': stats['chunks'],
        'occupancy': stats['rows_stepped'] / (stats['chunks'] * 32),
        'engine': {k: stats[k] for k in ('step_s', 'admit_s', 'finish_s', 'rows_stepped')},
        'peak_rise_gb': (torch.cuda.max_memory_allocated() - before) / 2 ** 30,
        'peak_memory_gb': torch.cuda.max_memory_allocated() / 2 ** 30}
    section('serving')

    # every served greedy row equals the offline generate of its prompt
    offline_margins = []
    with torch.no_grad():
        offline = generate(model, params, requests, max_new_tokens = 96, device = 'cuda',
                           trace = offline_margins)
    served_tokens = torch.tensor([r.tolist() + o['tokens'] for r, o in zip(requests, served)])
    equal, tied = _tie_rule(served_tokens, offline.tokens, offline_margins, 32)
    out['serving'].update(rows_equal_offline = equal, rows_apart_after_a_tie = tied)
    check(equal + tied == 64, 'served rows against offline: {} equal, {} tied'.format(
        equal, tied))
    section('offline_generate')

    # a chunk of 32 rows with the stepper alone (no engine threads): its wall
    # ms, then the card's busy share over one more under the profiler
    start_fn, step_fn = engine.start_fn, engine.step_fn
    states = start_fn.start_many(list(requests[:32]), [{'max_new_tokens': 96}] * 32)
    states, _ = step_fn(states)                  # the admission's scatter and a chunk
    chunk_states = states
    _, alone_ms = _synced_ms(lambda: step_fn(chunk_states))
    busy = _device_busy(lambda: step_fn(chunk_states))
    per_step = busy['kernel_launches'] / 8
    out['serving']['chunk_trace'] = dict(busy, rows = 32, steps = 8, chunk_ms_alone = alone_ms,
                                         launches_per_decode_step = per_step)
    del engine, states, chunk_states
    torch.cuda.empty_cache()
    section('chunk_trace')

    out['families'] = _llm_families(rng)
    section('families')
    launches = dict(read_launches(), matmul_rate = matmul_rate.launches)
    check(not any(launches.values()), 'kernel launches in the llm phase: {}'.format(launches))
    out['launches'] = launches
    del params
    torch.cuda.empty_cache()
    emit({'phase': 'llm', ** out, 'section_s': sections,
          'phase_s': time.perf_counter() - phase_start})


EXPORT_CASE = {'vocode_frames': 256, 'decode_rows': (1, 8), 'decode_tokens': 64,
               'chunk': 64, 'seeds': (1, 2), 'offsets': (0, 64)}


def _sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()


def _host_ms(fn, device, reps = 5):
    """(median host ms of a call, from the call to its return, and median
    wall ms to a synchronisation after it) over `reps` calls after one."""
    host, wall = [], []
    for i in range(reps + 1):
        _sync(device)
        start = time.perf_counter()
        fn()
        returned = time.perf_counter()
        _sync(device)
        if i:
            host.append(1e3 * (returned - start))
            wall.append(1e3 * (time.perf_counter() - start))
    return statistics.median(host), statistics.median(wall)


def _leaves_equal(a, b):
    a, b = torch.utils._pytree.tree_leaves(a), torch.utils._pytree.tree_leaves(b)
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def vocode_conv_flops(arch, params, B, F):
    """Operations of WaveGlow's `infer` outside the WN blocks, as
    `FlopCounterMode` counts them: the upsample as one product, each flow's
    start and end convs (1 tap) and its 1x1 inverse."""
    hp = arch.hp
    s, g = hp.upsample_stride, hp.n_group
    T = F * s // g
    total = 2 * B * F * (hp.upsample_width // s) * hp.n_mel_channels * s * hp.n_mel_channels
    for k in range(hp.n_flows):
        flow = params['flow_{}'.format(k)]
        C, n_half = flow['block']['start']['weight'].shape[:2]
        c = flow['convinv']['weight'].shape[0]
        total += 2 * B * T * (n_half * C + C * 2 * n_half) + 2 * B * T * c * c
    return total


def export_phase(model, vocoder, root, device = 'cuda', ** overrides):
    """The serving forwards through `torch.export` and the `Runtime`
    registry, K1, K2 and K3 in the programs as `torch.library` ops: (a)
    WaveGlow's bf16 vocode, exported, saved and loaded by
    ``build_runtime('export', path)``: 12 K1 a call, equal to the eager call
    to the bit; (b) the int8 route: 12 K2; (c) the stepper's 64-step
    `decode_chunk` on K3 at B = 1 and 8 rows: one launch a call, frames and
    state equal to eager, deterministic, and with dropout at two seeds and
    step offsets 0 and 64 from one program; (d) `AOTRuntime` of (a): its
    `flops` within 1 % of 12 x K1's count plus the convs', its memory, and
    another shape refused; (e) (a) exported on the CPU and moved onto the
    card at load: 12 K1, (a)'s audio; (f) export and load seconds and the
    host ms of a call, eager against exported.  On the CPU (a rehearsal at
    a tiny size, `device='cpu'`) the ops run their plain versions and no
    launch is counted."""
    from text_to_speech_tpu_torch.ops.wn_block import wn_block_work
    from text_to_speech_tpu_torch.runtimes import AOTRuntime, ExportRuntime, build_runtime
    from text_to_speech_tpu_torch.weights import tree_to

    case = dict(EXPORT_CASE, ** overrides)
    on_card = torch.device(device).type == 'cuda'
    phase_start = time.perf_counter()
    arch, hp = vocoder.arch, vocoder.arch.hp
    rng = np.random.default_rng(50)
    F = case['vocode_frames']
    T = F * hp.upsample_stride // hp.n_group
    mel = torch.from_numpy(rng.standard_normal((1, F, hp.n_mel_channels))
                           .astype(np.float32)).to(device)
    z = torch.from_numpy(rng.standard_normal((1, T, hp.n_group)).astype(np.float32)).to(device)

    def vocode(params, mel, z):
        return arch.infer(params, mel, z = z, use_kernel = True)

    def counted(fn):
        reset_launches()
        with torch.no_grad():
            out = fn()
        _sync(device)
        return out, read_launches()

    def exported(fn, args, name, load_device = device):
        path = os.path.join(root, name + '.pt2')
        start = time.perf_counter()
        ExportRuntime.export_function(fn, args, path)
        export_s = time.perf_counter() - start
        start = time.perf_counter()
        runtime = build_runtime('export', path, device = load_device)
        return runtime, {'export_s': export_s, 'load_s': time.perf_counter() - start,
                         'file_bytes': os.path.getsize(path)}

    record = {'phase': 'export', 'device': str(device), 'case': case}
    n_flows = hp.n_flows if on_card else 0
    for name, int8, kernel in (('vocode_bf16', False, 'wn_block'),
                               ('vocode_int8', True, 'wn_block_int8')):
        params = vocoder._serving_params(True, int8)
        eager, _ = counted(lambda: vocode(params, mel, z))
        runtime, readings = exported(vocode, (params, mel, z), name)
        out, launches = counted(lambda: runtime(params, mel, z))
        check(launches[kernel] == n_flows and sum(launches.values()) == n_flows,
              '{}: launches {}'.format(name, launches))
        check(torch.equal(out, eager), '{}: exported audio differs from eager'.format(name))
        readings.update(launches = launches, equal_to_eager = True,
                        host_ms_eager = _host_ms(lambda: vocode(params, mel, z), device),
                        host_ms_exported = _host_ms(lambda: runtime(params, mel, z), device))
        record[name] = readings
        if not int8:
            bf16_params, bf16_audio = params, eager

    # (c) the stepper's decode chunk on K3
    taco, K = model.arch, case['chunk']
    weights = model._decoder_weights(None)
    S = case['decode_tokens']
    tensor = lambda v, on = device: torch.tensor([v], dtype = torch.int64, device = on)
    decode = {}
    for B in case['decode_rows']:
        tokens = torch.from_numpy(rng.integers(1, taco.hp.vocab_size, (B, S))).to(device)
        with torch.no_grad():
            enc, mask = taco.encode(model.params, model.state, tokens)
            memory, pm = taco.process_memory(model.params['decoder'], enc, mask)
        zero = (torch.zeros((B, taco.hp.n_mel_channels), device = device),
                taco.init_cell_state(B, S, device = device))
        for deterministic in (True, False):
            def chunk(params, weights, frame, cell, memory, pm, mask, seed, step0,
                      deterministic = deterministic):
                return taco.decode_chunk(params, frame, cell, memory, pm, mask, n_steps = K,
                                         deterministic = deterministic, weights = weights,
                                         seed = seed, step_offset = step0)
            args = lambda seed, offset: (model.params, weights, * zero, memory, pm, mask,
                                         tensor(seed), tensor(offset, 'cpu'))
            key = 'B{}_{}'.format(B, 'deterministic' if deterministic else 'dropout')
            runtime, readings = exported(chunk, args(case['seeds'][0], 0), 'chunk_' + key)
            runs = [(case['seeds'][0], 0)] if deterministic else \
                [(seed, offset) for seed in case['seeds'] for offset in case['offsets']]
            outs = []
            for seed, offset in runs:
                out, launches = counted(lambda: runtime(* args(seed, offset)))
                eager, _ = counted(lambda: chunk(* args(seed, offset)))
                want = -(-B // 8) if on_card else 0
                check(launches['decoder_steps'] == want and sum(launches.values()) == want,
                      '{} seed {} offset {}: launches {}'.format(key, seed, offset, launches))
                check(_leaves_equal(out, eager), '{} seed {} offset {}: differs from eager'
                      .format(key, seed, offset))
                outs.append(out[0])
            if not deterministic:
                # the seeds and offsets reach the kernel: each run draws its own masks
                check(all(not torch.equal(a, b) for i, a in enumerate(outs) for b in outs[i + 1:]),
                      '{}: two runs drew the same dropout'.format(key))
            readings.update(runs = len(runs), launches_per_call = -(-B // 8) if on_card else 0,
                            equal_to_eager = True,
                            host_ms_eager = _host_ms(lambda: chunk(* args(1, 0)), device),
                            host_ms_exported = _host_ms(lambda: runtime(* args(1, 0)), device))
            decode[key] = readings
    record['decode_chunk'] = decode

    # (d) ahead of time: the bf16 vocode at the example shapes
    start = time.perf_counter()
    aot = AOTRuntime(vocode, (bf16_params, mel, z))
    aot_s = time.perf_counter() - start
    out, launches = counted(lambda: aot(bf16_params, mel, z))
    check(torch.equal(out, bf16_audio) and launches['wn_block'] == n_flows,
          'aot: launches {}, equal {}'.format(launches, torch.equal(out, bf16_audio)))
    block = bf16_params['flow_0']['block']['packed']
    L, C, S_ = block['w_in_cond'].shape[0], block['w_rs_last'].shape[0], \
        block['w_in_cond'].shape[1] - 3 * block['w_rs_last'].shape[0]
    k1_flops = hp.n_flows * wn_block_work(1, T, C, S_, L, 1)[0]
    expected = k1_flops + vocode_conv_flops(arch, bf16_params, 1, F)
    flops = aot.flops
    check(abs(flops - expected) <= 0.01 * expected,
          'aot flops {} against {} counted'.format(flops, expected))
    try:
        aot(bf16_params, mel[:, :F // 2], z[:, :T // 2])
        refused = False
    except ValueError:
        refused = True
    check(refused, 'aot: another shape was not refused')
    memory = aot.memory_analysis
    record['aot'] = {'build_s': aot_s, 'flops': flops, 'expected_flops': expected,
                     'k1_flops': k1_flops, 'flops_rel_err': abs(flops - expected) / expected,
                     'launches': launches, 'other_shape_refused': refused,
                     'memory': vars(memory)}

    # (e) exported on the CPU, moved onto the card at load
    cpu_params = tree_to(bf16_params, 'cpu')
    runtime, readings = exported(vocode, (cpu_params, mel.cpu(), z.cpu()), 'vocode_bf16_cpu')
    out, launches = counted(lambda: runtime(bf16_params, mel, z))
    check(launches['wn_block'] == n_flows and torch.equal(out, bf16_audio),
          'CPU artifact on {}: launches {}'.format(device, launches))
    del cpu_params
    record['cpu_artifact'] = dict(readings, launches = launches, equal_to_bf16_eager = True)
    record['phase_s'] = time.perf_counter() - phase_start
    emit(record)
    return record


def main():
    if not torch.cuda.is_available():
        print('chip_smoke.py needs a CUDA device', file = sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from text_to_speech_tpu_torch.init import random_tts_models
    from text_to_speech_tpu_torch.ops import _build

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'],
                         capture_output = True, text = True, check = True).stdout.strip()
    start = time.perf_counter()
    # one nvcc per source, all started together
    _build.build_all(['wn_block', 'decoder_steps', 'wn_block_int8', 'wn_layer',
                      'matmul_rate'])
    build_s = time.perf_counter() - start
    ptxas = {name: [line.strip() for line in log.splitlines()
                    if 'registers' in line or 'spill' in line]
             for name, log in _build.build_logs.items()}
    emit({'phase': 'device', 'nvidia_smi': smi, 'build_s': build_s,
          'torch': torch.__version__, 'cuda': torch.version.cuda, 'ptxas': ptxas,
          'sass': sass_check()})

    start = time.perf_counter()
    # random weights at NVIDIA sizes (the `HParamsTacotron2` and
    # `HParamsWaveGlow` defaults), the stop gate biased off
    model, vocoder = random_tts_models('cuda', seed = 1)
    setup_s = time.perf_counter() - start
    wn_cases = wn_block_phase()
    wn8_cases = wn_block_int8_phase()
    layer_cases = wn_layer_phase()
    rate_cases, probe_launches = matmul_rate_phase()
    dec_cases = decoder_steps_phase(model)
    runs, int8_lstm = e2e_phase(model, vocoder, setup_s)
    runs.update(windowed_phase(model, vocoder))
    runs.update(surface_phase(model, vocoder))
    # the checkpoints and predictions of these phases go when they end
    with tempfile.TemporaryDirectory(prefix = 'chip_smoke_') as scratch:
        root = lambda name: tempfile.mkdtemp(prefix = name + '_', dir = scratch)
        family_runs, vits, d_control = families_phase(model, root('families'))
        serving_k3, serving_shapes, serving = serving_phase(model, vocoder, vits, d_control)
        del vits
        sv2tts_cases, sv2tts_runs = sv2tts_phase(vocoder, root('sv2tts'))
        nvidia_cases, nvidia_runs, nvidia_vocoder = nvidia_import_phase(root('nvidia'))
        fs2_runs, fs2_shapes = fastspeech2_phase(nvidia_vocoder, root('fastspeech2'))
        del nvidia_vocoder
        training_root = root('training')
        teacher_cases, train_runs, student_shape = synthesizer_training_phase(
            vocoder, training_root)
        with tempfile.TemporaryDirectory(prefix = 'transfer_', dir = scratch) as transfer_root:
            clone_cases, transfer_runs, clone_shape = transfer_phase(
                vocoder, transfer_root, training_root)
        gan_phase(root('gan'))
        # the parallel axes: two ranks on the card, then one NCCL rank here
        torch.cuda.empty_cache()
        mesh = mesh_phase(model, vocoder, root('mesh'))
    llm_phase()
    # K1 and K2 at the (B, T) of FastSpeech-2's whole decode buffer: one
    # sentence on the one-launch route and the batch of four
    fs2_shapes = [fs2_shapes['one_sentence'], fs2_shapes['batch_of_4']]
    fs2_wn = wn_block_phase([(torch.bfloat16, B, T) for B, T in fs2_shapes],
                            label = 'fused_wn_block_fastspeech2')
    fs2_wn8 = wn_block_int8_phase(fs2_shapes, label = 'fused_wn_block_int8_fastspeech2')
    fs2_case = lambda cases, i: cases['bfloat16_B{}_T{}'.format(* fs2_shapes[i])]
    # K1 at the trained student's buffer: FastSpeech-2's default widths give
    # the same (B, T) as the fastspeech2 phase's one sentence, held there
    student_key = 'bfloat16_B{}_T{}'.format(* student_shape)
    student_wn = fs2_wn if student_key in fs2_wn else wn_block_phase(
        [(torch.bfloat16, * student_shape)], label = 'fused_wn_block_student')
    # K1 at the voice clone's vocoder buffer (its decode padded to the
    # vocoder's multiple of frames)
    clone_key = 'bfloat16_B{}_T{}'.format(* clone_shape)
    clone_wn = next((cases for cases in (fs2_wn, student_wn) if clone_key in cases), None) \
        or wn_block_phase([(torch.bfloat16, * clone_shape)], label = 'fused_wn_block_clone')
    # K1 at the (B, T) of each vocoder call of the served requests' emissions
    hop = vocoder.upsample_rate // vocoder.arch.hp.n_group
    serving_k1 = sorted({(B, F * hop) for B, F, _ in serving_shapes})
    serving_wn = wn_block_phase([(torch.bfloat16, B, T) for B, T in serving_k1],
                                label = 'fused_wn_block_serving', clocks = False)
    # K3 at each rank's row groups of the mesh serving run, K1 at its
    # emission shapes (those the serving phase timed are not run again)
    mesh_k3 = {'B{}_S{}'.format(B, S): _k3_serving_case(model, B, S)
               for B, S in mesh['k3_shapes']}
    emit({'phase': 'kernels', 'decoder_steps_mesh': mesh_k3})
    mesh_k1 = sorted({(B, F * hop) for B, F in mesh['k1_shapes']})
    mesh_wn = dict(serving_wn, ** wn_block_phase(
        [(torch.bfloat16, B, T) for B, T in mesh_k1 if (B, T) not in serving_k1],
        label = 'fused_wn_block_mesh', clocks = False)) \
        if set(mesh_k1) - set(serving_k1) else serving_wn
    # K1 at a rank's shard and halo of the sp vocode (e.g. B=1 × 4096 + 255)
    sp_wn = wn_block_phase([(torch.bfloat16, * mesh['sp_k1_shape'])],
                           label = 'fused_wn_block_sp', clocks = False)
    steps, eval_full = train_phase()
    with tempfile.TemporaryDirectory(prefix = 'chip_smoke_export_') as export_root:
        export_phase(model, vocoder, export_root)

    # K1's, K2's and K4's rates against K5's of the same type, from this run
    shares = {}
    for key, case, rate_key in (
            ('fused_wn_block_bf16_B1', wn_cases['bfloat16_B1_T8192'], 'bfloat16_M512_reps64'),
            ('fused_wn_block_bf16_B4', wn_cases['bfloat16_B4_T8192'], 'bfloat16_M512_reps64'),
            ('fused_wn_block_bf16_B8', wn_cases['bfloat16_B8_T8192'], 'bfloat16_M512_reps64'),
            ('fused_wn_block_bf16_B32_T4096', wn_cases['bfloat16_B32_T4096'],
             'bfloat16_M512_reps64'),
            ('fused_wn_block_int8_B1', wn8_cases['bfloat16_B1_T8192'], 'int8_M512_reps64'),
            ('fused_wn_block_int8_B4', wn8_cases['bfloat16_B4_T8192'], 'int8_M512_reps64'),
            ('fused_wn_block_int8_B32_T4096', wn8_cases['bfloat16_B32_T4096'],
             'int8_M512_reps64'),
            ('fused_wn_layer_bf16_B8', layer_cases['bfloat16_B8_T8192_d1_residual'],
             'bfloat16_M512_reps64'),
            ('fused_wn_layer_bf16_B1', layer_cases['bfloat16_B1_T8192_d1_residual'],
             'bfloat16_M512_reps64')):
        work = case.get('flops', case.get('ops'))
        rate = work / (case['kernel_ms'] * 1e-3)
        peak = PEAK_INT8_OPS if 'int8' in rate_key else PEAK_BF16_FLOPS
        shares[key] = {'ms': case['kernel_ms'], 'bound_ms': case['bound_ms'], 'rate': rate,
                       'share_of_k5_rate': rate / rate_cases[rate_key]['rate'],
                       'share_of_peak': rate / peak, 'l2_bytes': case['l2_bytes'],
                       'l2_bytes_per_s': case['l2_bytes_per_s'], 'waves': case['waves'],
                       'sm_clock_mhz': case['clocks']['during']['sm_clock_mhz'],
                       'power_w': case['clocks']['during']['power_w']}
    emit({'phase': 'kernels', 'wn_shares_of_k5': shares})

    launches = lambda kernel: sum(r['launches'][kernel] for r in runs.values())
    summary = lambda case, ** entry: dict(
        entry, max_abs_err = case['max_abs_err'], ms = case['kernel_ms'],
        plain_ms = case['plain_ms'], bound_ms = case['bound_ms'],
        bound_by = case['bound_by'], library_ms = None)
    print(json.dumps({'kernels': [
        summary(wn_cases['bfloat16_B1_T8192'], name = 'fused_wn_block', route = 'cuda',
                source = 'text_to_speech_tpu_torch/csrc/wn_block.cu',
                replaces = 'text_to_speech_tpu/ops/pallas_kernels.py:277',
                launches = launches('wn_block')),
        # `tts(text)` decodes in float32 with dropout on
        summary(dec_cases['float32_B1_S64_dropout'], name = 'decoder_steps', route = 'cuda',
                source = 'text_to_speech_tpu_torch/csrc/decoder_steps.cu',
                replaces = 'text_to_speech_tpu/ops/decoder_kernel.py:313',
                launches = launches('decoder_steps')),
        # SV2TTS: D = 768 and a non-zero prenet addend; launches of one
        # sentence cloned from reference audio
        # Tacotron-2 + HiFi-GAN V1: K3 at the same widths and shape; launches
        # of one sentence through `tts()` (the one-launch route, no WN kernel)
        summary(dec_cases['float32_B1_S64_dropout'], name = 'decoder_steps (Tacotron-2 + HiFi-GAN)',
                route = 'cuda', source = 'text_to_speech_tpu_torch/csrc/decoder_steps.cu',
                replaces = 'text_to_speech_tpu/ops/decoder_kernel.py:313',
                launches = family_runs['hifigan_one_sentence']['launches']['decoder_steps']),
        summary(sv2tts_cases['float32_B1_S64_dropout'], name = 'decoder_steps (SV2TTS, D=768)',
                route = 'cuda', source = 'text_to_speech_tpu_torch/csrc/decoder_steps.cu',
                replaces = 'text_to_speech_tpu/ops/decoder_kernel.py:313',
                launches = sv2tts_runs['sv2tts_one_sentence_audio']['launches']['decoder_steps']),
        summary(dec_cases['int8_lstm_B1_S64_dropout'], name = 'decoder_steps (int8 LSTM)',
                route = 'cuda', source = 'text_to_speech_tpu_torch/csrc/decoder_steps.cu',
                replaces = 'text_to_speech_tpu/ops/decoder_kernel.py:313',
                launches = int8_lstm['launches']),
        summary(wn8_cases['bfloat16_B1_T8192'], name = 'fused_wn_block_int8', route = 'cuda',
                source = 'text_to_speech_tpu_torch/csrc/wn_block_int8.cu',
                replaces = 'text_to_speech_tpu/ops/pallas_kernels.py:646',
                launches = launches('wn_block_int8')),
        # the long text's window batch (B=32, T=4096): launches in its run of each mode
        summary(wn_cases['bfloat16_B32_T4096'], name = 'fused_wn_block (window batch)',
                route = 'cuda', source = 'text_to_speech_tpu_torch/csrc/wn_block.cu',
                replaces = 'text_to_speech_tpu/ops/pallas_kernels.py:277',
                launches = runs['long_text_windowed']['launches']['wn_block']),
        summary(wn8_cases['bfloat16_B32_T4096'], name = 'fused_wn_block_int8 (window batch)',
                route = 'cuda', source = 'text_to_speech_tpu_torch/csrc/wn_block_int8.cu',
                replaces = 'text_to_speech_tpu/ops/pallas_kernels.py:646',
                launches = runs['long_text_windowed_int8']['launches']['wn_block_int8']),
        # the use_pallas eval forward under mixed_bfloat16, at the train step's shape
        summary(layer_cases['bfloat16_B8_T8192_d1_residual'], name = 'fused_wn_layer',
                route = 'cuda', source = 'text_to_speech_tpu_torch/csrc/wn_layer.cu',
                replaces = 'text_to_speech_tpu/ops/pallas_kernels.py:91',
                launches = eval_full['use_pallas']['wn_layer_launches']),
        # wn_train_fused: launches per train step (forward and remat recompute)
        summary(wn_cases['bfloat16_B8_T8192'], name = 'fused_wn_block (wn_train_fused training)',
                route = 'cuda', source = 'text_to_speech_tpu_torch/csrc/wn_block.cu',
                replaces = 'text_to_speech_tpu/ops/pallas_kernels.py:277',
                launches = int(steps['wn_train_fused_mixed_bfloat16']['wn_block_launches_per_step'])),
        # the NVIDIA import: K3 at the imported widths (its own cases), K1 and
        # K2 at the shapes of the kernels phase (the imported WaveGlow has
        # the same C, L, S and one sentence the same T); launches of one
        # sentence through `tts()` in each serving mode
        summary(nvidia_cases['float32_B1_S64_dropout'], name = 'decoder_steps (NVIDIA import)',
                route = 'cuda', source = 'text_to_speech_tpu_torch/csrc/decoder_steps.cu',
                replaces = 'text_to_speech_tpu/ops/decoder_kernel.py:313',
                launches = nvidia_runs['nvidia_one_sentence']['launches']['decoder_steps']),
        summary(wn_cases['bfloat16_B1_T8192'], name = 'fused_wn_block (NVIDIA import)',
                route = 'cuda', source = 'text_to_speech_tpu_torch/csrc/wn_block.cu',
                replaces = 'text_to_speech_tpu/ops/pallas_kernels.py:277',
                launches = nvidia_runs['nvidia_one_sentence']['launches']['wn_block']),
        summary(wn8_cases['bfloat16_B1_T8192'], name = 'fused_wn_block_int8 (NVIDIA import)',
                route = 'cuda', source = 'text_to_speech_tpu_torch/csrc/wn_block_int8.cu',
                replaces = 'text_to_speech_tpu/ops/pallas_kernels.py:646',
                launches = nvidia_runs['nvidia_one_sentence_int8']['launches']['wn_block_int8']),
        # FastSpeech-2: no decoder kernel; its vocoder at the whole decode
        # buffer's shape, launches of one sentence (each serving mode) and
        # of the batch of four
        summary(fs2_case(fs2_wn, 0), name = 'fused_wn_block (FastSpeech-2)',
                route = 'cuda', source = 'text_to_speech_tpu_torch/csrc/wn_block.cu',
                replaces = 'text_to_speech_tpu/ops/pallas_kernels.py:277',
                launches = fs2_runs['fastspeech2_one_sentence']['launches']['wn_block']),
        summary(fs2_case(fs2_wn, 1), name = 'fused_wn_block (FastSpeech-2 batch of 4)',
                route = 'cuda', source = 'text_to_speech_tpu_torch/csrc/wn_block.cu',
                replaces = 'text_to_speech_tpu/ops/pallas_kernels.py:277',
                launches = fs2_runs['fastspeech2_batch_of_4']['launches']['wn_block']),
        summary(fs2_case(fs2_wn8, 0), name = 'fused_wn_block_int8 (FastSpeech-2)',
                route = 'cuda', source = 'text_to_speech_tpu_torch/csrc/wn_block_int8.cu',
                replaces = 'text_to_speech_tpu/ops/pallas_kernels.py:646',
                launches = fs2_runs['fastspeech2_one_sentence_int8']['launches']['wn_block_int8']),
        # the trained synthesizers: K3 on the fitted Tacotron-2 teacher's
        # weights, launches of its `tts()`; K1 at the distilled FastSpeech-2
        # student's buffer, launches of its `tts()`
        summary(teacher_cases['float32_B1_S64_dropout'],
                name = 'decoder_steps (trained Tacotron-2 teacher)', route = 'cuda',
                source = 'text_to_speech_tpu_torch/csrc/decoder_steps.cu',
                replaces = 'text_to_speech_tpu/ops/decoder_kernel.py:313',
                launches = train_runs['teacher_one_sentence']['launches']['decoder_steps']),
        summary(student_wn[student_key], name = 'fused_wn_block (distilled FastSpeech-2 student)',
                route = 'cuda', source = 'text_to_speech_tpu_torch/csrc/wn_block.cu',
                replaces = 'text_to_speech_tpu/ops/pallas_kernels.py:277',
                launches = train_runs['student_one_sentence']['launches']['wn_block']),
        # the voice clone: K3 at D = 768 on the best epoch's weights, launches
        # of its `tts()` with the held-out speaker; K1 at the shape it
        # vocodes at there
        summary(clone_cases['float32_B1_S64_dropout'],
                name = 'decoder_steps (voice clone, D=768)', route = 'cuda',
                source = 'text_to_speech_tpu_torch/csrc/decoder_steps.cu',
                replaces = 'text_to_speech_tpu/ops/decoder_kernel.py:313',
                launches = transfer_runs['clone_one_sentence']['launches']['decoder_steps']),
        summary(clone_wn[clone_key], name = 'fused_wn_block (voice clone)',
                route = 'cuda', source = 'text_to_speech_tpu_torch/csrc/wn_block.cu',
                replaces = 'text_to_speech_tpu/ops/pallas_kernels.py:277',
                launches = transfer_runs['clone_one_sentence']['launches']['wn_block']),
        # serving over HTTP (16 requests, continuous batching): K3 at a row
        # group of the decode chunks (B = 8), K1 at the largest emission
        # batch; launches of the 16 requests
        summary(serving_k3, name = 'decoder_steps (serving, row group of 8)', route = 'cuda',
                source = 'text_to_speech_tpu_torch/csrc/decoder_steps.cu',
                replaces = 'text_to_speech_tpu/ops/decoder_kernel.py:313',
                launches = serving['tacotron2_waveglow']['launches']['decoder_steps']),
        summary(serving_wn['bfloat16_B{}_T{}'.format(* serving_k1[-1])],
                name = 'fused_wn_block (serving emissions)', route = 'cuda',
                source = 'text_to_speech_tpu_torch/csrc/wn_block.cu',
                replaces = 'text_to_speech_tpu/ops/pallas_kernels.py:277',
                launches = serving['tacotron2_waveglow']['launches']['wn_block']),
        # mesh serving over {'dp': 2} (two ranks on the card): K3 at the
        # largest row group of a rank, K1 at the largest emission batch of a
        # rank; launches summed over the ranks (each rank's in the mesh record)
        summary(mesh_k3['B{}_S{}'.format(* mesh['k3_shapes'][-1])],
                name = 'decoder_steps (mesh serving, each rank)', route = 'cuda',
                source = 'text_to_speech_tpu_torch/csrc/decoder_steps.cu',
                replaces = 'text_to_speech_tpu/ops/decoder_kernel.py:313',
                launches = mesh['launches']['decoder_steps']),
        summary(mesh_wn['bfloat16_B{}_T{}'.format(* mesh_k1[-1])],
                name = 'fused_wn_block (mesh serving emissions, each rank)', route = 'cuda',
                source = 'text_to_speech_tpu_torch/csrc/wn_block.cu',
                replaces = 'text_to_speech_tpu/ops/pallas_kernels.py:277',
                launches = mesh['launches']['wn_block']),
        # the vocode with the time axis over {'sp': 2} (two ranks on the
        # card): K1 at a rank's shard and halo; launches summed over the ranks
        summary(sp_wn['bfloat16_B{}_T{}'.format(* mesh['sp_k1_shape'])],
                name = 'fused_wn_block (sp vocode, each rank)', route = 'cuda',
                source = 'text_to_speech_tpu_torch/csrc/wn_block.cu',
                replaces = 'text_to_speech_tpu/ops/pallas_kernels.py:277',
                launches = mesh['launches']['wn_block_sp']),
        # the rate probe: launches in its int8 and its bf16 line
        dict(summary(rate_cases['int8_M512_reps64'], name = 'matmul_rate', route = 'cuda',
                     source = 'text_to_speech_tpu_torch/csrc/matmul_rate.cu',
                     replaces = 'benchmarks/matmul_rate.py:42',
                     launches = probe_launches['int8']),
             library_ms = rate_cases['int8_M512_reps64']['library_ms']),
        dict(summary(rate_cases['bfloat16_M512_reps64'], name = 'matmul_rate (bf16)',
                     route = 'cuda', source = 'text_to_speech_tpu_torch/csrc/matmul_rate.cu',
                     replaces = 'benchmarks/matmul_rate.py:42',
                     launches = probe_launches['bf16']),
             library_ms = rate_cases['bfloat16_M512_reps64']['library_ms']),
    ]}), flush = True)
    print(smi, flush = True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush = True)
    return 0


if __name__ == '__main__':
    if sys.argv[1:] == ['--probe-gloo-p2p']:
        sys.exit(probe_gloo_p2p() if torch.cuda.is_available() else 1)
    if sys.argv[1:] == ['--probe-k1-rows']:
        sys.exit(probe_k1_rows() if torch.cuda.is_available() else 1)
    sys.exit(main())
