// Multi-threaded audio data loader: a C++ worker pool that decodes WAV
// files below Python's interpreter lock.
//
// The port's copy of the JAX package's loader.  Workers decode WAV files
// (PCM 16/24/32-bit and IEEE float32, mono), optionally resample them (the
// Kaiser-windowed polyphase of `audio_native.cpp`) and peak-normalize, all
// in C++; results go back to Python as malloc'd float32 buffers keyed by the
// caller's tickets.  Containers and layouts it does not handle return a
// status code, and the caller reads those rows with its Python readers.
// Plain C ABI, loaded with ctypes (`native/data_loader.py`).

#include "audio_native.cpp"

#include <cstdio>
#include <cstdlib>
#include <condition_variable>
#include <deque>
#include <mutex>
#include <string>
#include <thread>

namespace {

enum Status {
    LOAD_OK = 0,
    ERR_OPEN = -1,      // missing/unreadable file
    ERR_FORMAT = -2,    // not a mono PCM/float WAV this decoder handles
    ERR_DATA = -3,      // truncated / malformed payload
};

struct Task {
    int64_t ticket;
    std::string path;
    int32_t target_rate;    // 0 = keep the file rate
    int32_t normalize;      // 1 = DC-remove + peak-normalize to 1.0
};

struct Result {
    int64_t ticket = 0;
    float* data = nullptr;  // malloc'd, freed by loader_free()
    int64_t n = 0;
    int32_t rate = 0;
    int32_t status = LOAD_OK;
};

static uint32_t rd_u32(const unsigned char* p) {
    return (uint32_t) p[0] | ((uint32_t) p[1] << 8)
         | ((uint32_t) p[2] << 16) | ((uint32_t) p[3] << 24);
}
static uint16_t rd_u16(const unsigned char* p) {
    return (uint16_t)((uint32_t) p[0] | ((uint32_t) p[1] << 8));
}

// RIFF/WAVE parse → scaled float32 samples (int dividing by the type max,
// matching `audio_processing.convert_audio_dtype`'s float conversion).
static int decode_wav(const std::string& path, std::vector<float>& out,
                      int32_t* rate) {
    FILE* f = std::fopen(path.c_str(), "rb");
    if (!f) return ERR_OPEN;
    struct Closer { FILE* f; ~Closer() { std::fclose(f); } } closer{f};

    unsigned char hdr[12];
    if (std::fread(hdr, 1, 12, f) != 12 || std::memcmp(hdr, "RIFF", 4)
        || std::memcmp(hdr + 8, "WAVE", 4))
        return ERR_FORMAT;

    uint16_t fmt = 0, channels = 0, bits = 0;
    uint32_t sample_rate = 0;
    bool have_fmt = false;

    unsigned char ch[8];
    while (std::fread(ch, 1, 8, f) == 8) {
        const uint32_t size = rd_u32(ch + 4);
        if (!std::memcmp(ch, "fmt ", 4)) {
            unsigned char buf[40];
            const uint32_t take = size < sizeof(buf) ? size : sizeof(buf);
            if (std::fread(buf, 1, take, f) != take) return ERR_DATA;
            if (take < 16) return ERR_FORMAT;
            fmt = rd_u16(buf);
            channels = rd_u16(buf + 2);
            sample_rate = rd_u32(buf + 4);
            bits = rd_u16(buf + 14);
            if (fmt == 0xFFFE && take >= 26)    // WAVE_FORMAT_EXTENSIBLE
                fmt = rd_u16(buf + 24);         // first 2 bytes of SubFormat
            if (size > take && std::fseek(f, (long)(size - take), SEEK_CUR))
                return ERR_DATA;
            have_fmt = true;
        } else if (!std::memcmp(ch, "data", 4)) {
            if (!have_fmt) return ERR_FORMAT;
            if (channels != 1) return ERR_FORMAT;   // python handles stereo
            const bool pcm = fmt == 1, ieee = fmt == 3;
            if (!((pcm && (bits == 16 || bits == 24 || bits == 32))
                  || (ieee && bits == 32)))
                return ERR_FORMAT;
            std::vector<unsigned char> raw(size);
            if (std::fread(raw.data(), 1, size, f) != size) return ERR_DATA;
            const int64_t n = (int64_t) size / (bits / 8);
            out.resize((size_t) n);
            const unsigned char* p = raw.data();
            if (ieee) {
                std::memcpy(out.data(), p, (size_t) n * 4);
            } else if (bits == 16) {
                const double s = 1.0 / 32767.0;     // np.iinfo(int16).max
                for (int64_t i = 0; i < n; ++i)
                    out[(size_t) i] = (float)((int16_t) rd_u16(p + 2 * i) * s);
            } else if (bits == 24) {
                const double s = 1.0 / 8388607.0;
                for (int64_t i = 0; i < n; ++i) {
                    int32_t v = (int32_t)(((uint32_t) p[3 * i])
                        | ((uint32_t) p[3 * i + 1] << 8)
                        | ((uint32_t) p[3 * i + 2] << 16));
                    if (v & 0x800000) v |= (int32_t) 0xFF000000;
                    out[(size_t) i] = (float)(v * s);
                }
            } else {                                // PCM 32
                const double s = 1.0 / 2147483647.0;
                for (int64_t i = 0; i < n; ++i)
                    out[(size_t) i] = (float)((int32_t) rd_u32(p + 4 * i) * s);
            }
            *rate = (int32_t) sample_rate;
            return LOAD_OK;
        } else {
            // skip unknown chunk (word-aligned)
            if (std::fseek(f, (long)(size + (size & 1)), SEEK_CUR))
                return ERR_DATA;
        }
    }
    return ERR_FORMAT;      // no data chunk
}

struct Loader {
    std::mutex mu;
    std::condition_variable task_cv, result_cv;
    std::deque<Task> tasks;
    std::deque<Result> results;
    std::vector<std::thread> workers;
    size_t capacity;        // bound on decoded-but-unconsumed results
    bool stopping = false;

    Loader(int32_t n_workers, int32_t cap)
        : capacity((size_t) (cap > 0 ? cap : 8)) {
        for (int32_t i = 0; i < (n_workers > 0 ? n_workers : 1); ++i)
            workers.emplace_back([this] { run(); });
    }

    ~Loader() {
        {
            std::unique_lock<std::mutex> lk(mu);
            stopping = true;
        }
        task_cv.notify_all();
        result_cv.notify_all();
        for (auto& t : workers) t.join();
        for (auto& r : results) std::free(r.data);
    }

    void run() {
        for (;;) {
            Task task;
            {
                std::unique_lock<std::mutex> lk(mu);
                task_cv.wait(lk, [this] {
                    return stopping
                        || (!tasks.empty() && results.size() < capacity);
                });
                if (stopping) return;
                task = std::move(tasks.front());
                tasks.pop_front();
            }

            Result res;
            res.ticket = task.ticket;
            std::vector<float> samples;
            int32_t rate = 0;
            res.status = decode_wav(task.path, samples, &rate);
            if (res.status == LOAD_OK) {
                if (task.target_rate > 0 && task.target_rate != rate) {
                    std::vector<float> resampled(
                        (size_t)((double) samples.size() * task.target_rate
                                 / rate) + 8);
                    const int64_t m = resample_sinc(
                        samples.data(), (int64_t) samples.size(),
                        resampled.data(), rate, task.target_rate, 32);
                    resampled.resize((size_t) m);
                    samples.swap(resampled);
                    rate = task.target_rate;
                }
                if (task.normalize)
                    normalize_audio(samples.data(),
                                    (int64_t) samples.size(), 1.0f);
                res.n = (int64_t) samples.size();
                res.rate = rate;
                res.data = (float*) std::malloc(sizeof(float) * (res.n ? res.n : 1));
                if (res.data) {
                    std::memcpy(res.data, samples.data(),
                                sizeof(float) * res.n);
                } else {
                    res.status = ERR_DATA;
                    res.n = 0;
                }
            }

            {
                std::unique_lock<std::mutex> lk(mu);
                results.push_back(res);
            }
            result_cv.notify_one();
        }
    }
};

}  // namespace

extern "C" {

void* loader_create(int32_t n_workers, int32_t capacity) {
    return new Loader(n_workers, capacity);
}

void loader_destroy(void* h) {
    delete (Loader*) h;
}

void loader_submit(void* h, int64_t ticket, const char* path,
                   int32_t target_rate, int32_t normalize) {
    Loader* L = (Loader*) h;
    {
        std::unique_lock<std::mutex> lk(L->mu);
        L->tasks.push_back(Task{ticket, std::string(path), target_rate,
                                normalize});
    }
    L->task_cv.notify_one();
}

// Blocking pop of one finished result.  Returns the ticket; fills
// (*data, *n, *rate, *status).  *data must be released via loader_free.
int64_t loader_next(void* h, float** data, int64_t* n, int32_t* rate,
                    int32_t* status) {
    Loader* L = (Loader*) h;
    Result res;
    {
        std::unique_lock<std::mutex> lk(L->mu);
        L->result_cv.wait(lk, [L] { return L->stopping || !L->results.empty(); });
        if (L->results.empty()) {       // stopping
            *data = nullptr; *n = 0; *rate = 0; *status = ERR_DATA;
            return -1;
        }
        res = L->results.front();
        L->results.pop_front();
    }
    L->task_cv.notify_one();    // capacity freed: wake a parked worker
    *data = res.data;
    *n = res.n;
    *rate = res.rate;
    *status = res.status;
    return res.ticket;
}

void loader_free(float* data) {
    std::free(data);
}

}  // extern "C"
