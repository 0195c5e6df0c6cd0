// Host-side audio DSP for the data pipeline and post-processing.
//
// The port's copy of the JAX package's native library: the per-utterance
// operations that run per dataset row or per synthesized chunk -- PCM
// conversion, windowed-sinc polyphase resampling, RMS silence scanning and
// overlap-trim stitching of windowed vocoder output.  Plain C ABI, loaded
// with ctypes (`text_to_speech_tpu_torch/native/__init__.py`).  The
// arithmetic is the JAX package's line for line, so both libraries built
// with the same flags give the same bits.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------------------
// PCM conversion
// ---------------------------------------------------------------------------

void pcm16_to_f32(const int16_t* in, float* out, int64_t n) {
    const float scale = 1.0f / 32768.0f;
    for (int64_t i = 0; i < n; ++i) out[i] = in[i] * scale;
}

void f32_to_pcm16(const float* in, int16_t* out, int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
        float v = in[i] * 32767.0f;
        v = std::max(-32768.0f, std::min(32767.0f, v));
        out[i] = (int16_t) std::lrintf(v);
    }
}

// remove DC offset and scale peak to max_val
void normalize_audio(float* data, int64_t n, float max_val) {
    if (n == 0) return;
    double mean = 0.0;
    for (int64_t i = 0; i < n; ++i) mean += data[i];
    mean /= (double) n;
    float peak = 0.0f;
    for (int64_t i = 0; i < n; ++i) {
        data[i] -= (float) mean;
        peak = std::max(peak, std::fabs(data[i]));
    }
    if (peak <= 1e-9f) return;
    const float scale = max_val / peak;
    for (int64_t i = 0; i < n; ++i) data[i] *= scale;
}

// ---------------------------------------------------------------------------
// Windowed-sinc polyphase resampling (Kaiser-windowed, zero-phase)
// ---------------------------------------------------------------------------

static double bessel_i0(double x) {
    double sum = 1.0, term = 1.0;
    for (int k = 1; k < 32; ++k) {
        term *= (x / (2.0 * k)) * (x / (2.0 * k));
        sum += term;
        if (term < 1e-12 * sum) break;
    }
    return sum;
}

static int64_t gcd64(int64_t a, int64_t b) {
    while (b) { int64_t t = a % b; a = b; b = t; }
    return a;
}

// Polyphase resampler: coefficients precomputed per output phase (classic
// rational up/down design), inner loop is a plain dot product.
// out must have capacity ceil(n * out_rate / in_rate) + 8.
int64_t resample_sinc(const float* in, int64_t n, float* out,
                      int32_t in_rate, int32_t out_rate,
                      int32_t half_taps /* e.g. 32 */) {
    if (in_rate == out_rate) {
        std::memcpy(out, in, sizeof(float) * n);
        return n;
    }
    const int64_t g = gcd64(in_rate, out_rate);
    const int64_t up = out_rate / g, down = in_rate / g;
    const int64_t out_n = (int64_t)((double) n * out_rate / in_rate);

    const double cutoff = (out_rate < in_rate) ? (double) out_rate / in_rate : 1.0;
    const double beta = 8.6;  // Kaiser beta ~ 90 dB stopband
    const double i0b = bessel_i0(beta);
    const int32_t taps = 2 * half_taps;

    // filter bank: up phases x taps; phase p covers fractional offset p/up
    // (designed in double, stored float32 so the inner dot product
    // auto-vectorizes — the double-accumulate scalar loop was the data
    // loader's bottleneck vs scipy's FFT resample)
    static thread_local std::vector<float> bank;
    static thread_local int64_t bank_up = -1, bank_down = -1;
    static thread_local int32_t bank_taps = -1;
    if (bank_up != up || bank_down != down || bank_taps != taps) {
        bank.assign((size_t)(up * taps), 0.0f);
        std::vector<double> phase_w((size_t) taps);
        for (int64_t p = 0; p < up; ++p) {
            const double frac = (double) p * down / up - std::floor((double) p * down / up);
            double wsum = 0.0;
            for (int32_t k = 0; k < taps; ++k) {
                const double x = (double)(k - half_taps) - frac + 0.0;
                const double t = x / half_taps;
                double w = 0.0;
                if (std::fabs(t) <= 1.0) {
                    const double sx = x * cutoff;
                    const double sinc = (std::fabs(sx) < 1e-12)
                        ? 1.0 : std::sin(M_PI * sx) / (M_PI * sx);
                    w = sinc * bessel_i0(beta * std::sqrt(1.0 - t * t)) / i0b * cutoff;
                }
                phase_w[(size_t) k] = w;
                wsum += w;
            }
            // unity DC gain per phase
            const double norm = (wsum > 1e-12) ? 1.0 / wsum : 1.0;
            for (int32_t k = 0; k < taps; ++k)
                bank[(size_t)(p * taps + k)] = (float)(phase_w[(size_t) k] * norm);
        }
        bank_up = up; bank_down = down; bank_taps = taps;
    }

    for (int64_t j = 0; j < out_n; ++j) {
        const int64_t num = j * down;
        const int64_t base = num / up;             // integer input position
        const int64_t phase = num % up;            // fractional part = phase/up
        const float* __restrict coef = bank.data() + (size_t)(phase * taps);
        const int64_t lo = base - half_taps;
        int32_t k0 = 0;
        int64_t i = lo;
        if (i < 0) { k0 = (int32_t)(-i); i = 0; }
        const int64_t hi = std::min(n, lo + taps);
        const float* __restrict src = in + i;
        const int32_t len = (int32_t)(hi - i);
        float acc = 0.0f;
        for (int32_t k = 0; k < len; ++k)          // SIMD-friendly flat dot
            acc += src[k] * coef[k0 + k];
        out[j] = acc;
    }
    return out_n;
}

// ---------------------------------------------------------------------------
// Frame-RMS silence scan
// ---------------------------------------------------------------------------

// writes per-frame RMS into rms (capacity n_frames); returns n_frames
int64_t frame_rms(const float* in, int64_t n, float* rms,
                  int32_t frame_length, int32_t hop_length) {
    if (n <= 0 || frame_length <= 0 || hop_length <= 0) return 0;
    int64_t n_frames = std::max((int64_t) 1, 1 + (n - frame_length) / hop_length);
    for (int64_t f = 0; f < n_frames; ++f) {
        double acc = 0.0;
        const int64_t start = f * hop_length;
        for (int64_t i = 0; i < frame_length; ++i) {
            const int64_t idx = std::min(start + i, n - 1);
            acc += (double) in[idx] * in[idx];
        }
        rms[f] = (float) std::sqrt(acc / frame_length);
    }
    return n_frames;
}

// returns [start, end) of the non-silent region (threshold relative to max RMS)
void trim_bounds(const float* in, int64_t n, int32_t frame_length,
                 int32_t hop_length, float threshold,
                 int64_t* start_out, int64_t* end_out) {
    std::vector<float> rms(std::max((int64_t) 1, 1 + (n - frame_length) / hop_length));
    int64_t n_frames = frame_rms(in, n, rms.data(), frame_length, hop_length);
    float max_rms = 0.0f;
    for (int64_t f = 0; f < n_frames; ++f) max_rms = std::max(max_rms, rms[f]);
    if (max_rms <= 1e-9f) { *start_out = 0; *end_out = 0; return; }
    const float thr = threshold * max_rms;
    int64_t first = -1, last = -1;
    for (int64_t f = 0; f < n_frames; ++f) {
        if (rms[f] >= thr) { if (first < 0) first = f; last = f; }
    }
    if (first < 0) { *start_out = 0; *end_out = 0; return; }
    *start_out = first * hop_length;
    *end_out = std::min(n, last * hop_length + frame_length);
}

// ---------------------------------------------------------------------------
// Overlap-trim stitching of windowed vocoder parts
// ---------------------------------------------------------------------------

// parts: flattened (n_parts, part_len); overlaps: per-junction overlap in
// samples (n_parts - 1).  Trims half the overlap from each side of a
// junction and concatenates.  Returns output length.
int64_t overlap_stitch(const float* parts, int32_t n_parts, int64_t part_len,
                       const int64_t* overlaps, float* out) {
    int64_t pos = 0;
    for (int32_t p = 0; p < n_parts; ++p) {
        int64_t lo = (p == 0) ? 0 : overlaps[p - 1] / 2;
        int64_t hi = (p == n_parts - 1) ? part_len : part_len - (overlaps[p] - overlaps[p] / 2) + (overlaps[p] - overlaps[p] / 2) - overlaps[p] / 2;
        // hi simplifies to part_len - overlaps[p]/2 (integer-safe)
        hi = (p == n_parts - 1) ? part_len : part_len - overlaps[p] / 2;
        const float* src = parts + (int64_t) p * part_len;
        const int64_t len = hi - lo;
        std::memcpy(out + pos, src + lo, sizeof(float) * len);
        pos += len;
    }
    return pos;
}

int32_t native_abi_version() { return 1; }

}  // extern "C"
