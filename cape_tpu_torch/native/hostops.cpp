// Native host-side data-pipeline kernel of the PyTorch port: a copy of
// `cape_tpu/native/hostops.cpp`, kept byte-for-byte in its arithmetic so
// both packages' colour jitter gives the same bytes.
//
// The fused brightness/contrast/saturation jitter of the train-time
// augmentation (`cape_tpu_torch/data/augment.py::_color_jitter`) in one
// pass over a uint8 RGB image. It is compiled with g++ at first use by
// `cape_tpu_torch/native/__init__.py` and called through ctypes, which
// releases the GIL, so the loader threads overlap. The linear transform:
//
//   m    = b * mean(x)                (x = image as float32)
//   gray = mean over channels
//   out  = clip(A*x + G*gray + M, 0, 255) truncated to uint8
//   with A = s*c*b, G = (1-s)*c*b, M = m*(1-c)
//
// The mean is an exact integer sum here; numpy's float32 pairwise mean
// (the plain version) can differ from it by one level in the output.
//
// Build: g++ -O3 -march=native -fPIC -shared hostops.cpp -o hostops.so
// (no -ffast-math: IEEE semantics keep the numpy-equivalence test tight).

#include <cstdint>
#include <cstddef>

extern "C" {

// Fused brightness/contrast/saturation color jitter on uint8 RGB.
//   img:  H*W*3 contiguous uint8 (any channel-last layout; "RGB" is
//         conventional — the math is channel-symmetric)
//   n:    number of pixels (H*W)
//   b, c, s: brightness / contrast / saturation factors
//   out:  H*W*3 uint8 output buffer (may NOT alias img)
void cape_fused_bcs(const uint8_t* img, int64_t n,
                    float b, float c, float s, uint8_t* out) {
    // pass 1: global mean over all bytes. Bytes are integers, so an
    // integer reduction is EXACT (numpy's pairwise-f32 mean is the
    // approximation). Four independent accumulators let the compiler
    // vectorize the reduction; uint64 cannot overflow below ~7e16 bytes.
    const int64_t total = n * 3;
    uint64_t s0 = 0, s1 = 0, s2 = 0, s3 = 0;
    int64_t i = 0;
    for (; i + 4 <= total; i += 4) {
        s0 += img[i];
        s1 += img[i + 1];
        s2 += img[i + 2];
        s3 += img[i + 3];
    }
    for (; i < total; ++i) s0 += img[i];
    const float mean = (float)((double)(s0 + s1 + s2 + s3) / (double)total);

    const float A = s * c * b;
    const float G = (1.0f - s) * c * b;
    const float M = (b * mean) * (1.0f - c);
    const float third = 1.0f / 3.0f;

    // pass 2: per-pixel transform; auto-vectorizes under -O3
    for (int64_t p = 0; p < n; ++p) {
        const uint8_t* px = img + p * 3;
        const float r = (float)px[0];
        const float g = (float)px[1];
        const float bl = (float)px[2];
        // numpy computes mean(axis=-1) as f32 (r+g+b)/3 — keep the order
        const float gray = (r + g + bl) * third;
        const float base = G * gray + M;
        float v0 = A * r + base;
        float v1 = A * g + base;
        float v2 = A * bl + base;
        // clip then truncate, matching np.clip(...).astype(np.uint8)
        v0 = v0 < 0.0f ? 0.0f : (v0 > 255.0f ? 255.0f : v0);
        v1 = v1 < 0.0f ? 0.0f : (v1 > 255.0f ? 255.0f : v1);
        v2 = v2 < 0.0f ? 0.0f : (v2 > 255.0f ? 255.0f : v2);
        uint8_t* q = out + p * 3;
        q[0] = (uint8_t)v0;
        q[1] = (uint8_t)v1;
        q[2] = (uint8_t)v2;
    }
}

// ABI/version probe so the Python loader can reject stale cached builds.
int cape_hostops_version(void) { return 1; }

}  // extern "C"
