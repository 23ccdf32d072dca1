// Host-side data-path primitives of the streaming data tier
// (dl4ds_tpu_torch/dataloader.py HostStreamer): the sample/window gather and
// the batched patch crop, the two memory-bound host steps of a batch that is
// assembled on the host, at memcpy speed over OpenMP threads. They write
// straight into the caller's output buffer (a pinned slot). Built by
// native/__init__.py with g++ -O3 -march=native -fopenmp into build/host/;
// the inputs are bounds-checked there, since these loops check nothing.

#include <cstring>
#include <cstdint>

extern "C" {

// Gather b sample windows from src[n][sample_elems]:
// out[i] = src[idx[i] .. idx[i]+tw-1], flattened.
void gather_windows_f32(const float* src, const int64_t* idx,
                        int64_t b, int64_t tw, int64_t sample_elems,
                        float* out) {
    const int64_t window_elems = tw * sample_elems;
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < b; ++i) {
        std::memcpy(out + i * window_elems,
                    src + idx[i] * sample_elems,
                    sizeof(float) * window_elems);
    }
}

// Batched square crops: src[b][t][h][w][c] -> out[b][t][p][p][c] with
// per-sample origins (ys[i], xs[i]). t may be 1 for spatial samples.
void crop_batch_f32(const float* src, int64_t b, int64_t t, int64_t h,
                    int64_t w, int64_t c, const int64_t* ys,
                    const int64_t* xs, int64_t p, float* out) {
    const int64_t src_row = w * c;
    const int64_t src_plane = h * src_row;
    const int64_t dst_row = p * c;
    const int64_t dst_plane = p * dst_row;
#pragma omp parallel for collapse(2) schedule(static)
    for (int64_t i = 0; i < b; ++i) {
        for (int64_t k = 0; k < t; ++k) {
            const float* sp = src + (i * t + k) * src_plane
                              + ys[i] * src_row + xs[i] * c;
            float* dp = out + (i * t + k) * dst_plane;
            for (int64_t r = 0; r < p; ++r) {
                std::memcpy(dp + r * dst_row, sp + r * src_row,
                            sizeof(float) * dst_row);
            }
        }
    }
}

// Fused gather + crop: pick b windows of tw timesteps from src[n][h][w][c]
// and crop each at (ys[i], xs[i]) with size p in one pass (no intermediate
// window buffer).
void gather_crop_f32(const float* src, const int64_t* idx, int64_t b,
                     int64_t tw, int64_t h, int64_t w, int64_t c,
                     const int64_t* ys, const int64_t* xs, int64_t p,
                     float* out) {
    const int64_t src_row = w * c;
    const int64_t src_plane = h * src_row;
    const int64_t dst_row = p * c;
    const int64_t dst_plane = p * dst_row;
#pragma omp parallel for collapse(2) schedule(static)
    for (int64_t i = 0; i < b; ++i) {
        for (int64_t k = 0; k < tw; ++k) {
            const float* sp = src + (idx[i] + k) * src_plane
                              + ys[i] * src_row + xs[i] * c;
            float* dp = out + (i * tw + k) * dst_plane;
            for (int64_t r = 0; r < p; ++r) {
                std::memcpy(dp + r * dst_row, sp + r * src_row,
                            sizeof(float) * dst_row);
            }
        }
    }
}

}  // extern "C"
