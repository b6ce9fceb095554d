// NPVP-TPU native data pipeline.
//
// C++ implementations of the host-side hot loops of the data layer
// (the reference delegates these to PIL/torchvision inside DataLoader worker
// processes — utils/dataset.py:780-900; here they are SIMD-friendly loops
// threaded with std::thread, callable from the Python loader via ctypes):
//
//  - fused clip transform: center-crop → bilinear resize → flips → normalize
//  - stochastic moving-sprites clip synthesis (SM-MNIST equivalent,
//    utils/dataset.py:672-778 dynamics) with a deterministic per-index RNG
//
// Built at first use by npvp_tpu_torch/data/native_bindings.py (g++).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// bilinear resize of one (H, W, C) float frame — cv2 INTER_LINEAR sampling
// convention: src_x = (dst_x + 0.5) * scale - 0.5
// ---------------------------------------------------------------------------
static void resize_frame(const float* src, int sh, int sw, int c, float* dst,
                         int dh, int dw) {
  const float sy = static_cast<float>(sh) / dh;
  const float sx = static_cast<float>(sw) / dw;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = static_cast<int>(std::floor(fy));
    float wy = fy - y0;
    int y1 = std::min(y0 + 1, sh - 1);
    y0 = std::max(y0, 0);
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = static_cast<int>(std::floor(fx));
      float wx = fx - x0;
      int x1 = std::min(x0 + 1, sw - 1);
      x0 = std::max(x0, 0);
      const float* p00 = src + (y0 * sw + x0) * c;
      const float* p01 = src + (y0 * sw + x1) * c;
      const float* p10 = src + (y1 * sw + x0) * c;
      const float* p11 = src + (y1 * sw + x1) * c;
      float* out = dst + (y * dw + x) * c;
      for (int ch = 0; ch < c; ++ch) {
        float top = p00[ch] * (1.f - wx) + p01[ch] * wx;
        float bot = p10[ch] * (1.f - wx) + p11[ch] * wx;
        out[ch] = top * (1.f - wy) + bot * wy;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fused per-clip transform.
//   src: (T, H, W, C) float32 in [0,1]
//   dst: (T, outH, outW, C)
//   crop: center-crop to (cropH, cropW) first when > 0
//   hflip/vflip: mirror the whole clip
//   mean/std: per-channel normalization (length C)
// ---------------------------------------------------------------------------
void transform_clip(const float* src, int T, int H, int W, int C, float* dst,
                    int cropH, int cropW, int outH, int outW, int hflip,
                    int vflip, const float* mean, const float* stdv) {
  int ch0 = 0, cw0 = 0, curH = H, curW = W;
  if (cropH > 0 && cropW > 0) {
    ch0 = (H - cropH) / 2;
    cw0 = (W - cropW) / 2;
    curH = cropH;
    curW = cropW;
  }
  std::vector<float> cropped(static_cast<size_t>(curH) * curW * C);
  std::vector<float> resized(static_cast<size_t>(outH) * outW * C);

  for (int t = 0; t < T; ++t) {
    const float* frame = src + static_cast<size_t>(t) * H * W * C;
    const float* work = frame;
    if (curH != H || curW != W) {
      for (int y = 0; y < curH; ++y)
        std::memcpy(cropped.data() + static_cast<size_t>(y) * curW * C,
                    frame + (static_cast<size_t>(y + ch0) * W + cw0) * C,
                    sizeof(float) * curW * C);
      work = cropped.data();
    }
    const float* final_src = work;
    if (curH != outH || curW != outW) {
      resize_frame(work, curH, curW, C, resized.data(), outH, outW);
      final_src = resized.data();
    }
    float* out = dst + static_cast<size_t>(t) * outH * outW * C;
    for (int y = 0; y < outH; ++y) {
      int yy = vflip ? (outH - 1 - y) : y;
      for (int x = 0; x < outW; ++x) {
        int xx = hflip ? (outW - 1 - x) : x;
        const float* p = final_src + (static_cast<size_t>(yy) * outW + xx) * C;
        float* q = out + (static_cast<size_t>(y) * outW + x) * C;
        for (int ch = 0; ch < C; ++ch)
          q[ch] = (p[ch] - mean[ch]) / stdv[ch];
      }
    }
  }
}

// threaded batch variant: N clips laid out contiguously
void transform_batch(const float* src, int N, int T, int H, int W, int C,
                     float* dst, int cropH, int cropW, int outH, int outW,
                     const int* hflips, const int* vflips, const float* mean,
                     const float* stdv, int num_threads) {
  const size_t in_stride = static_cast<size_t>(T) * H * W * C;
  const size_t out_stride = static_cast<size_t>(T) * outH * outW * C;
  num_threads = std::max(1, std::min(num_threads, N));
  std::vector<std::thread> threads;
  for (int w = 0; w < num_threads; ++w) {
    threads.emplace_back([&, w]() {
      for (int n = w; n < N; n += num_threads)
        transform_clip(src + n * in_stride, T, H, W, C, dst + n * out_stride,
                       cropH, cropW, outH, outW, hflips[n], vflips[n], mean,
                       stdv);
    });
  }
  for (auto& t : threads) t.join();
}

// ---------------------------------------------------------------------------
// deterministic RNG (splitmix64) for the sprite synthesizer
// ---------------------------------------------------------------------------
struct Rng {
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed + 0x9e3779b97f4a7c15ULL) {}
  uint64_t next() {
    uint64_t z = (s += 0x9e3779b97f4a7c15ULL);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
    return z ^ (z >> 31);
  }
  // uniform int in [lo, hi)
  int randint(int lo, int hi) {
    return lo + static_cast<int>(next() % static_cast<uint64_t>(hi - lo));
  }
};

// ---------------------------------------------------------------------------
// bouncing-sprite clip synthesis (reference SM-MNIST dynamics,
// utils/dataset.py:742-771): dx, dy ∈ [-4, 4]; on wall hit the normal
// velocity resamples away from the wall (stochastic) or reflects
// (deterministic).
//   sprites: (num_sprites, D, D) float32 bank
//   out: (seq_len, S, S, 1), values clipped to [0, 1]
// ---------------------------------------------------------------------------
void synth_moving_sprites(const float* sprites, int num_sprites, int D,
                          float* out, int seq_len, int S, int num_digits,
                          int deterministic, uint64_t seed) {
  std::memset(out, 0, sizeof(float) * seq_len * S * S);
  const int lim = S - D;
  Rng rng(seed);
  for (int d = 0; d < num_digits; ++d) {
    const float* sprite = sprites +
        static_cast<size_t>(rng.randint(0, num_sprites)) * D * D;
    int sx = rng.randint(0, lim);
    int sy = rng.randint(0, lim);
    int dx = rng.randint(-4, 5);
    int dy = rng.randint(-4, 5);
    for (int t = 0; t < seq_len; ++t) {
      if (sy < 0) {
        sy = 0;
        if (deterministic) dy = -dy;
        else { dy = rng.randint(1, 5); dx = rng.randint(-4, 5); }
      } else if (sy >= lim) {
        sy = lim - 1;
        if (deterministic) dy = -dy;
        else { dy = rng.randint(-4, 0); dx = rng.randint(-4, 5); }
      }
      if (sx < 0) {
        sx = 0;
        if (deterministic) dx = -dx;
        else { dx = rng.randint(1, 5); dy = rng.randint(-4, 5); }
      } else if (sx >= lim) {
        sx = lim - 1;
        if (deterministic) dx = -dx;
        else { dx = rng.randint(-4, 0); dy = rng.randint(-4, 5); }
      }
      float* frame = out + static_cast<size_t>(t) * S * S;
      for (int y = 0; y < D; ++y)
        for (int x = 0; x < D; ++x)
          frame[(sy + y) * S + (sx + x)] += sprite[y * D + x];
      sy += dy;
      sx += dx;
    }
  }
  const size_t n = static_cast<size_t>(seq_len) * S * S;
  for (size_t i = 0; i < n; ++i) out[i] = std::min(out[i], 1.0f);
}

void synth_moving_sprites_batch(const float* sprites, int num_sprites, int D,
                                float* out, int N, int seq_len, int S,
                                int num_digits, int deterministic,
                                const uint64_t* seeds, int num_threads) {
  const size_t stride = static_cast<size_t>(seq_len) * S * S;
  num_threads = std::max(1, std::min(num_threads, N));
  std::vector<std::thread> threads;
  for (int w = 0; w < num_threads; ++w) {
    threads.emplace_back([&, w]() {
      for (int n = w; n < N; n += num_threads)
        synth_moving_sprites(sprites, num_sprites, D, out + n * stride,
                             seq_len, S, num_digits, deterministic, seeds[n]);
    });
  }
  for (auto& t : threads) t.join();
}

}  // extern "C"
