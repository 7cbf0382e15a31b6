// Native frame loader: PGM/PPM decode + background prefetch ring buffer.
//
// The equivalent of the reference's native IO path (the C++ demos
// read image sequences synchronously through OpenCV,
// demo-davison-mono-slam.cpp:1699-1729). Here decode runs on a worker thread
// ahead of the tracker so host IO overlaps device compute; Python binds via
// ctypes (no pybind11 in this image).
//
// C ABI:
//   fl_open(dir, prefetch_depth) -> handle (0 on error)
//   fl_frame_count(h), fl_width(h), fl_height(h)
//   fl_next(h, out_buf, buf_len) -> frame index (>=0) or -1 when exhausted,
//       -2 on decode error; out_buf receives H*W grayscale bytes
//   fl_close(h)

#include <atomic>
#include <algorithm>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <filesystem>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace fs = std::filesystem;

namespace {

struct Frame {
    int index = -1;
    int width = 0;
    int height = 0;
    bool ok = false;
    std::vector<uint8_t> gray;
};

bool DecodePnmGray(const std::string& path, Frame* out) {
    FILE* f = std::fopen(path.c_str(), "rb");
    if (!f) return false;
    char magic[3] = {0, 0, 0};
    if (std::fscanf(f, "%2s", magic) != 1) { std::fclose(f); return false; }

    auto skip_ws_comments = [&]() {
        int c;
        for (;;) {
            c = std::fgetc(f);
            if (c == '#') {
                while (c != '\n' && c != EOF) c = std::fgetc(f);
            } else if (!std::isspace(c)) {
                if (c != EOF) std::ungetc(c, f);
                return;
            }
        }
    };
    auto read_int = [&]() -> long {
        skip_ws_comments();
        long v = -1;
        if (std::fscanf(f, "%ld", &v) != 1) return -1;
        return v;
    };

    long w = read_int(), h = read_int(), maxv = read_int();
    if (w <= 0 || h <= 0 || maxv <= 0 || maxv > 255) { std::fclose(f); return false; }
    std::fgetc(f);  // single whitespace after header

    out->width = static_cast<int>(w);
    out->height = static_cast<int>(h);
    const size_t n = static_cast<size_t>(w) * h;
    if (std::strcmp(magic, "P5") == 0) {
        out->gray.resize(n);
        if (std::fread(out->gray.data(), 1, n, f) != n) { std::fclose(f); return false; }
    } else if (std::strcmp(magic, "P6") == 0) {
        std::vector<uint8_t> rgb(n * 3);
        if (std::fread(rgb.data(), 1, n * 3, f) != n * 3) { std::fclose(f); return false; }
        out->gray.resize(n);
        for (size_t i = 0; i < n; ++i) {
            // BT.601 luma, integer arithmetic
            const uint32_t r = rgb[3 * i], g = rgb[3 * i + 1], b = rgb[3 * i + 2];
            out->gray[i] = static_cast<uint8_t>((299 * r + 587 * g + 114 * b) / 1000);
        }
    } else if (std::strcmp(magic, "P2") == 0) {
        // ASCII PGM; same maxval scaling as the python reader
        // (vision/picture.py: vals * 255 // maxval)
        out->gray.resize(n);
        for (size_t i = 0; i < n; ++i) {
            const long v = read_int();
            if (v < 0 || v > maxv) { std::fclose(f); return false; }
            out->gray[i] = static_cast<uint8_t>(v * 255 / maxv);
        }
    } else {
        std::fclose(f);
        return false;
    }
    std::fclose(f);
    out->ok = true;
    return true;
}

struct Loader {
    std::vector<std::string> paths;
    int width = 0;
    int height = 0;
    size_t next_to_decode = 0;
    size_t in_flight = 0;   // claimed by the worker but not yet in `ready`
    size_t prefetch_depth = 4;

    std::deque<Frame> ready;
    std::mutex mu;
    std::condition_variable cv_ready;
    std::condition_variable cv_space;
    std::atomic<bool> stop{false};
    std::thread worker;

    void Run() {
        for (;;) {
            size_t idx;
            {
                std::unique_lock<std::mutex> lk(mu);
                cv_space.wait(lk, [&] {
                    return stop.load() || ready.size() < prefetch_depth;
                });
                if (stop.load()) return;
                if (next_to_decode >= paths.size()) return;
                idx = next_to_decode++;
                in_flight++;
            }
            Frame fr;
            fr.index = static_cast<int>(idx);
            DecodePnmGray(paths[idx], &fr);
            {
                std::lock_guard<std::mutex> lk(mu);
                ready.push_back(std::move(fr));
                in_flight--;
            }
            cv_ready.notify_one();
        }
    }
};

bool HasImageExt(const fs::path& p) {
    std::string e = p.extension().string();
    std::transform(e.begin(), e.end(), e.begin(), ::tolower);
    return e == ".pgm" || e == ".ppm" || e == ".pnm";
}

}  // namespace

extern "C" {

void* fl_open(const char* dir, int prefetch_depth) {
    auto* L = new Loader();
    std::error_code ec;
    for (const auto& entry : fs::directory_iterator(dir, ec)) {
        if (entry.is_regular_file() && HasImageExt(entry.path()))
            L->paths.push_back(entry.path().string());
    }
    if (ec || L->paths.empty()) { delete L; return nullptr; }
    std::sort(L->paths.begin(), L->paths.end());
    // probe dimensions from the first frame
    Frame probe;
    if (!DecodePnmGray(L->paths[0], &probe)) { delete L; return nullptr; }
    L->width = probe.width;
    L->height = probe.height;
    L->prefetch_depth = prefetch_depth > 0 ? prefetch_depth : 4;
    L->worker = std::thread(&Loader::Run, L);
    return L;
}

int fl_frame_count(void* h) { return static_cast<Loader*>(h)->paths.size(); }
int fl_width(void* h) { return static_cast<Loader*>(h)->width; }
int fl_height(void* h) { return static_cast<Loader*>(h)->height; }

int fl_next(void* h, uint8_t* out, int64_t out_len) {
    auto* L = static_cast<Loader*>(h);
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_ready.wait(lk, [&] {
        return !L->ready.empty() ||
               (L->next_to_decode >= L->paths.size() && L->in_flight == 0);
    });
    if (L->ready.empty()) return -1;  // exhausted
    Frame fr = std::move(L->ready.front());
    L->ready.pop_front();
    lk.unlock();
    L->cv_space.notify_one();
    if (!fr.ok) return -2;
    const int64_t n = static_cast<int64_t>(fr.gray.size());
    if (n > out_len) return -2;
    std::memcpy(out, fr.gray.data(), n);
    return fr.index;
}

void fl_close(void* h) {
    auto* L = static_cast<Loader*>(h);
    L->stop.store(true);
    L->cv_space.notify_all();
    L->cv_ready.notify_all();
    if (L->worker.joinable()) L->worker.join();
    delete L;
}

}  // extern "C"
