// Native runtime support for eradiate_tpu.
//
// The reference's number-crunching core is C++ (Mitsuba, SURVEY §2.1); in
// the TPU build the compute path is JAX/XLA, and the native layer covers
// the *runtime around it*: binary dataset IO (Mitsuba-compatible .vol
// grids, mirror of `src/eradiate/kernel/gridvolume.py:15-60`) and
// threaded host-side table preparation (absorption-coefficient
// interpolation feeding the spectral driver; leaf-cloud generation for
// large canopies).
//
// Exposed as a C ABI consumed via ctypes (pybind11 is unavailable here).

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Mitsuba .vol format: "VOL" magic, version 3, int32 dtype tag (1 = f32),
// int32 shape (nx, ny, nz, channels), 6 x f32 bbox, payload.
// ---------------------------------------------------------------------------

struct VolHeader {
    int32_t nx, ny, nz, channels;
    float bbox[6];
};

int vol_read_header(const char* path, VolHeader* out) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    char magic[3];
    if (std::fread(magic, 1, 3, f) != 3 || std::memcmp(magic, "VOL", 3) != 0) {
        std::fclose(f);
        return -2;
    }
    uint8_t version;
    int32_t dtype;
    if (std::fread(&version, 1, 1, f) != 1 || version != 3) {
        std::fclose(f);
        return -3;
    }
    if (std::fread(&dtype, 4, 1, f) != 1 || dtype != 1) {
        std::fclose(f);
        return -4;
    }
    if (std::fread(&out->nx, 4, 1, f) != 1 || std::fread(&out->ny, 4, 1, f) != 1 ||
        std::fread(&out->nz, 4, 1, f) != 1 || std::fread(&out->channels, 4, 1, f) != 1 ||
        std::fread(out->bbox, 4, 6, f) != 6) {
        std::fclose(f);
        return -5;
    }
    std::fclose(f);
    return 0;
}

int vol_read_data(const char* path, float* out, int64_t n) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    // header: 3 + 1 + 4 + 16 + 24 = 48 bytes
    if (std::fseek(f, 48, SEEK_SET) != 0) {
        std::fclose(f);
        return -2;
    }
    int64_t got = (int64_t)std::fread(out, 4, (size_t)n, f);
    std::fclose(f);
    return got == n ? 0 : -3;
}

int vol_write(const char* path, const float* data, int32_t nx, int32_t ny,
              int32_t nz, int32_t channels, const float* bbox) {
    FILE* f = std::fopen(path, "wb");
    if (!f) return -1;
    std::fwrite("VOL", 1, 3, f);
    uint8_t version = 3;
    int32_t dtype = 1;
    std::fwrite(&version, 1, 1, f);
    std::fwrite(&dtype, 4, 1, f);
    std::fwrite(&nx, 4, 1, f);
    std::fwrite(&ny, 4, 1, f);
    std::fwrite(&nz, 4, 1, f);
    std::fwrite(&channels, 4, 1, f);
    std::fwrite(bbox, 4, 6, f);
    int64_t n = (int64_t)nx * ny * nz * channels;
    std::fwrite(data, 4, (size_t)n, f);
    std::fclose(f);
    return 0;
}

// ---------------------------------------------------------------------------
// Threaded bilinear (p, T) interpolation of absorption tables:
// table [W, P, T] row-major; for each of S spectral rows (already gathered
// to the W axis by the caller via iw/fw) and each of L levels, produce
// sigma[s, l]. This is the host-side hot loop when building large spectral
// batches (mono line-by-line grids).
// ---------------------------------------------------------------------------

static void interp_rows(const float* table, int64_t W, int64_t P, int64_t T,
                        const int32_t* iw, const float* fw, int64_t S,
                        const int32_t* ip, const float* fp, const int32_t* it,
                        const float* ft, int64_t L, float* out, int64_t s0,
                        int64_t s1) {
    for (int64_t s = s0; s < s1; ++s) {
        const float* t_lo = table + (int64_t)iw[s] * P * T;
        const float* t_hi = table + ((int64_t)iw[s] + 1 < W ? (int64_t)iw[s] + 1
                                                            : (int64_t)iw[s]) *
                                        P * T;
        float fws = fw[s];
        for (int64_t l = 0; l < L; ++l) {
            int64_t p0 = ip[l], t0 = it[l];
            float a = fp[l], b = ft[l];
            float w00 = (1 - a) * (1 - b), w01 = (1 - a) * b;
            float w10 = a * (1 - b), w11 = a * b;
            const float* r;
            float lo, hi;
            r = t_lo;
            lo = w00 * r[p0 * T + t0] + w01 * r[p0 * T + t0 + 1] +
                 w10 * r[(p0 + 1) * T + t0] + w11 * r[(p0 + 1) * T + t0 + 1];
            r = t_hi;
            hi = w00 * r[p0 * T + t0] + w01 * r[p0 * T + t0 + 1] +
                 w10 * r[(p0 + 1) * T + t0] + w11 * r[(p0 + 1) * T + t0 + 1];
            out[s * L + l] = (1 - fws) * lo + fws * hi;
        }
    }
}

void absorption_interp(const float* table, int64_t W, int64_t P, int64_t T,
                       const int32_t* iw, const float* fw, int64_t S,
                       const int32_t* ip, const float* fp, const int32_t* it,
                       const float* ft, int64_t L, float* out,
                       int32_t n_threads) {
    if (n_threads <= 1 || S < 64) {
        interp_rows(table, W, P, T, iw, fw, S, ip, fp, it, ft, L, out, 0, S);
        return;
    }
    std::vector<std::thread> threads;
    int64_t chunk = (S + n_threads - 1) / n_threads;
    for (int32_t k = 0; k < n_threads; ++k) {
        int64_t s0 = k * chunk;
        int64_t s1 = s0 + chunk < S ? s0 + chunk : S;
        if (s0 >= s1) break;
        threads.emplace_back(interp_rows, table, W, P, T, iw, fw, S, ip, fp,
                             it, ft, L, out, s0, s1);
    }
    for (auto& th : threads) th.join();
}

// ---------------------------------------------------------------------------
// Leaf cloud generation: uniform positions in a box + Goel-Strebel-like
// inclination sampling, xorshift RNG — fast path for multi-million-leaf
// canopies.
// ---------------------------------------------------------------------------

static inline uint64_t xorshift64(uint64_t* s) {
    uint64_t x = *s;
    x ^= x << 13;
    x ^= x >> 7;
    x ^= x << 17;
    *s = x;
    return x;
}

static inline double uniform01(uint64_t* s) {
    return (double)(xorshift64(s) >> 11) * (1.0 / 9007199254740992.0);
}

void generate_leaf_cloud(int64_t n, double lh, double lv, double mu, double nu,
                         uint64_t seed, float* positions, float* normals) {
    uint64_t s = seed ? seed : 0x9E3779B97F4A7C15ull;
    for (int64_t i = 0; i < n; ++i) {
        positions[i * 3 + 0] = (float)((uniform01(&s) - 0.5) * lh);
        positions[i * 3 + 1] = (float)((uniform01(&s) - 0.5) * lh);
        positions[i * 3 + 2] = (float)(uniform01(&s) * lv);
        // Beta(mu, nu) via Johnk's algorithm (mu, nu ~ 1 regime)
        double x, y;
        do {
            x = std::pow(uniform01(&s), 1.0 / mu);
            y = std::pow(uniform01(&s), 1.0 / nu);
        } while (x + y > 1.0);
        double theta = (x / (x + y)) * (M_PI / 2.0);
        double phi = uniform01(&s) * 2.0 * M_PI;
        normals[i * 3 + 0] = (float)(std::sin(theta) * std::cos(phi));
        normals[i * 3 + 1] = (float)(std::sin(theta) * std::sin(phi));
        normals[i * 3 + 2] = (float)std::cos(theta);
    }
}

}  // extern "C"
