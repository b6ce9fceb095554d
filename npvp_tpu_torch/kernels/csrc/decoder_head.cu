// The AE decoder's tail (nn/resnet_ae.py ResnetDecoder), for Hopper (sm_90a):
// the last upsampling's BatchNorm (eval affine) and ReLU, the reflect padding
// by 3, the 7x7 output head with its bias, and the Tanh or Sigmoid, in one
// pass over the last transposed convolution's raw output.
//
// Replaces no TPU kernel: XLA fused the head and its neighbours on the TPU.
// Eagerly, PyTorch passes over the tail's input, the largest tensor of the
// AE (1280 x 128 x 128 x 32 bf16 a Cityscapes window, 1.34 GB), about six
// times (BatchNorm's multiply and add, the ReLU, the padded copy), then runs
// the head in cuDNN, whose tiles of 64 output channels do ~21x the work for 3.
//
// Function. y (N, H, W, CIN) bf16 NHWC; the BatchNorm's (a, b) per channel and
// the head's weight (COUT, CIN, 7, 7) and bias (COUT), all bf16 as the eager
// code casts them; out (N, H, W, COUT) bf16, in the eager code's roundings:
//   x   = relu(bf16(bf16(y a) + b))              bit-equal to the eager ops
//   x'  = x reflect-padded by 3 (read as reflected coordinates, never written)
//   c   = bf16(sum over (kh, kw, ci) of x' w)    fp32 accumulate, one rounding
//   out = bf16(act(bf16(c + bias)))               act in fp32: tanhf, or
//                                                 1 / (1 + expf(-v))
// The sum is taken in another order than cuDNN's; nothing else differs.
//
// What bounds it. A Cityscapes window reads 1.34 GB and writes 0.13 GB (0.44
// ms at 3.35 TB/s); its useful FLOPs (0.197 T) take 0.2 ms at the bf16 peak.
// So every byte of y is read from device memory once, and the tensor-core
// work is laid out so that little of it is padding:
// - a block of 8 warps owns an output tile of 8 rows x TW columns of one
//   frame (TW 64 at CIN 32, 32 at CIN 64); it loads the tile's
//   (8 + 6) x (TW + 6) halo once into shared memory, applying the BatchNorm
//   and ReLU on the way (16-byte loads, bf16x2 arithmetic) and reflecting the
//   coordinates at the frame's border; 16-byte chunks are XOR-swizzled so
//   that ldmatrix reads of any 8 consecutive pixels hit 32 distinct banks;
// - the product puts the 7 kw taps x COUT channels in the mma's N (21 of 24
//   columns used at COUT 3, 7 of 8 at COUT 1; a direct implicit GEMM would
//   pad 3 channels to 8): for each halo pixel q and tap row kh,
//   z_kh[q, (kw, co)] = sum_ci x'[q, ci] w[co, ci, kh, kw], on mma.sync
//   m16n8k16 (bf16 in, fp32 accumulate), M = 16 consecutive halo pixels of a
//   row; a warp accumulates over kh in registers, reading A as
//   the rows below (q + kh * (TW + 6)), so out[p, co] = sum_kw acc[p + kw,
//   (kw, co)] is left: a diagonal sum over 7 neighbouring pixels;
// - that sum goes through a ring of 32 staged fp32 rows a warp in shared
//   memory, 16 pixels at a time, then the bias, the activation and the store;
// - B, the head's weights in mma fragment order, is packed once a call by a
//   pre-pass (npvp_decoder_head_pack) into a scratch of 10.5 KB at
//   CIN 32 (so that no block gathers 2-byte weights at L2 latency), copied
//   into each block's shared memory with 16-byte loads, and read once a tap
//   row and k step for all the row's m tiles.
// Two blocks an SM (100 KB of shared memory each at CIN 32), so that one
// block's halo load overlaps the other's products. Two launches a call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kRows = 8;               // output rows of a tile: a warp each
constexpr int kThreads = 32 * kRows;
constexpr int kPad = 3;                // the head's reflect padding
constexpr int kTaps = 7;               // the head's kernel side
constexpr int kRing = 32;              // staged accumulator rows of a warp

template <int CIN, int COUT>
struct Tile {
  static constexpr int kCh = CIN / 8;              // 16-byte chunks a pixel
  static constexpr int kKs = CIN / 16;             // k16 steps a tap
  static constexpr int kCols = kTaps * COUT;       // (kw, co) columns
  static constexpr int kNt = (kCols + 7) / 8;      // n8 tiles
  static constexpr int kTw = CIN == 32 ? 64 : 32;  // output columns a tile
  static constexpr int kWh = kTw + 2 * kPad;       // halo columns
  static constexpr int kMt = (kWh + 15) / 16;      // m16 tiles a halo row
  // halo pixels, and one m tile beyond: the last warp's last tile reads
  // past the halo's end into rows it never uses
  static constexpr int kHaloPos = (kRows + 2 * kPad) * kWh + 16;
  static constexpr int kStride = kNt * 8 + 1;      // floats a staged row
  static constexpr size_t kHaloBytes = size_t(kHaloPos) * CIN * 2;
  static constexpr int kFrag = kTaps * kKs * kNt * 64;  // B words
  static constexpr size_t kBBytes = size_t(kFrag) * 4;
  static constexpr size_t kRingBytes = size_t(kRows) * kRing * kStride * 4;
  static constexpr size_t kSmem = kHaloBytes + kBBytes + kRingBytes;
  static constexpr int kLoads = (kRows + 2 * kPad) * kWh * kCh;
  static_assert(kThreads % kCh == 0, "a thread keeps one chunk's channels");
  static_assert(kTw + kTaps - 1 <= 16 * kMt, "a row's taps within its tiles");
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4],
                                            unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// D += A (16x16, row) B (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma16(float (&d)[4], const unsigned (&a)[4],
                                      unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// chunk c of halo pixel pos, in 16-byte units: any 8 consecutive pixels'
// chunk c lie in 8 distinct groups of 4 banks
template <int CH>
__device__ __forceinline__ int chunk_at(int pos, int c) {
  return pos * CH + (c ^ ((pos / (8 / CH)) & (CH - 1)));
}

// reflect-pad coordinate i of a side of n (n > 3); beyond a ragged tile's
// edge any pixel of the frame (its products are never stored)
__device__ __forceinline__ int reflect(int i, int n) {
  i = i < 0 ? -i : i;
  i = i >= n ? 2 * n - 2 - i : i;
  return min(max(i, 0), n - 1);
}

// relu(bf16(bf16(x a) + b)) on a bf16 pair; the _rn forms keep the compiler
// from contracting the two roundings into one fma
__device__ __forceinline__ unsigned bn_relu(unsigned x, unsigned a,
                                            unsigned b) {
  const __nv_bfloat162 zero = __float2bfloat162_rn(0.0f);
  __nv_bfloat162 v = __hmul2_rn(*reinterpret_cast<__nv_bfloat162*>(&x),
                                *reinterpret_cast<__nv_bfloat162*>(&a));
  v = __hmax2(__hadd2_rn(v, *reinterpret_cast<__nv_bfloat162*>(&b)), zero);
  return *reinterpret_cast<unsigned*>(&v);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// the head's weights as mma B fragments: [kh][ks][nt][lane][2], lane
// (g, q) holding B[k = 2q (+8), 2q + 1 (+8)][n = g], n = kw * COUT + co
template <int CIN, int COUT>
__global__ void npvp_decoder_head_pack(const __nv_bfloat16* __restrict__ w,
                                       unsigned* __restrict__ frag) {
  using T = Tile<CIN, COUT>;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= T::kFrag) return;
  const int reg = i & 1, ln = (i >> 1) & 31;
  int rest = i >> 6;
  const int nt = rest % T::kNt;
  rest /= T::kNt;
  const int ks = rest % T::kKs, kh = rest / T::kKs;
  const int col = nt * 8 + (ln >> 2);
  const int ci = ks * 16 + (ln & 3) * 2 + reg * 8;
  unsigned v = 0;
  if (col < T::kCols) {
    const int kw = col / COUT, co = col % COUT;
    const __nv_bfloat16* p = w + ((co * CIN + ci) * kTaps + kh) * kTaps + kw;
    v = static_cast<unsigned>(__bfloat16_as_ushort(p[0])) |
        (static_cast<unsigned>(__bfloat16_as_ushort(p[kTaps * kTaps])) << 16);
  }
  frag[i] = v;
}

template <int CIN, int COUT>
__global__ void __launch_bounds__(kThreads, 2)
    npvp_decoder_head(const __nv_bfloat16* __restrict__ y,
                      const __nv_bfloat16* __restrict__ bn_a,
                      const __nv_bfloat16* __restrict__ bn_b,
                      const unsigned* __restrict__ frag,
                      const __nv_bfloat16* __restrict__ bias,
                      __nv_bfloat16* __restrict__ out, int H, int W,
                      int row_tiles, int col_tiles, int sigmoid) {
  using T = Tile<CIN, COUT>;
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* halo = reinterpret_cast<uint4*>(smem);
  unsigned* bfrag = reinterpret_cast<unsigned*>(smem + T::kHaloBytes);
  float* ring =
      reinterpret_cast<float*>(smem + T::kHaloBytes + T::kBBytes);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int t = blockIdx.x;
  const int col_tile = t % col_tiles;
  t /= col_tiles;
  const int r0 = (t % row_tiles) * kRows, c0 = col_tile * T::kTw;
  const size_t img = static_cast<size_t>(t / row_tiles) * H * W;

  // the packed B fragments, all 16-byte loads in flight at once
  {
    constexpr int kVec = T::kFrag / 4, kPer = (kVec + kThreads - 1) / kThreads;
    uint4 v[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      if (tid + k * kThreads < kVec)
        v[k] = __ldg(reinterpret_cast<const uint4*>(frag) + tid + k * kThreads);
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      if (tid + k * kThreads < kVec)
        reinterpret_cast<uint4*>(bfrag)[tid + k * kThreads] = v[k];
  }

  // the halo, BatchNorm and ReLU applied: thread tid loads chunk
  // tid % kCh of its pixels (channels 8c .. 8c + 7), 8 loads in flight
  {
    const int c = tid % T::kCh;
    const uint4 a4 = *reinterpret_cast<const uint4*>(bn_a + 8 * c);
    const uint4 b4 = *reinterpret_cast<const uint4*>(bn_b + 8 * c);
    constexpr int kPer = (T::kLoads + kThreads - 1) / kThreads;
    constexpr int kInFlight = 8;
#pragma unroll 1
    for (int base = 0; base < kPer; base += kInFlight) {
      uint4 v[kInFlight];
      int dst[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int i = tid + (base + u) * kThreads;
        dst[u] = -1;
        if (i < T::kLoads) {
          const int pos = i / T::kCh;
          const int hr = pos / T::kWh, hc = pos - hr * T::kWh;
          const int fr = reflect(r0 - kPad + hr, H);
          const int fc = reflect(c0 - kPad + hc, W);
          v[u] = __ldg(reinterpret_cast<const uint4*>(
              y + ((img + static_cast<size_t>(fr) * W + fc) * CIN + 8 * c)));
          dst[u] = chunk_at<T::kCh>(pos, c);
        }
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        if (dst[u] >= 0) {
          uint4 x = v[u];
          x.x = bn_relu(x.x, a4.x, b4.x);
          x.y = bn_relu(x.y, a4.y, b4.y);
          x.z = bn_relu(x.z, a4.z, b4.z);
          x.w = bn_relu(x.w, a4.w, b4.w);
          halo[dst[u]] = x;
        }
      }
    }
  }
  __syncthreads();

  // warp r: output row r0 + r; m tile j covers halo pixels r*kWh + 16j ..
  // + 15, tap row kh reads them kh halo rows below
  float acc[T::kMt][T::kNt][4];
#pragma unroll
  for (int j = 0; j < T::kMt; ++j)
#pragma unroll
    for (int nt = 0; nt < T::kNt; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][nt][e] = 0.0f;
  const unsigned halo_s = smem_addr(halo);
  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8, ahalf = lane >> 4;
#pragma unroll 1
  for (int kh = 0; kh < kTaps; ++kh) {
    const int first = (warp + kh) * T::kWh + arow;
#pragma unroll
    for (int ks = 0; ks < T::kKs; ++ks) {
      unsigned bf[T::kNt][2];
#pragma unroll
      for (int nt = 0; nt < T::kNt; ++nt) {
        const uint2 b2 = *reinterpret_cast<const uint2*>(
            bfrag + ((kh * T::kKs + ks) * T::kNt + nt) * 64 + lane * 2);
        bf[nt][0] = b2.x;
        bf[nt][1] = b2.y;
      }
#pragma unroll
      for (int j = 0; j < T::kMt; ++j) {
        unsigned a[4];
        ldmatrix_x4(a, halo_s + 16u * chunk_at<T::kCh>(first + 16 * j,
                                                      ks * 2 + ahalf));
#pragma unroll
        for (int nt = 0; nt < T::kNt; ++nt)
          mma16(acc[j][nt], a, bf[nt][0], bf[nt][1]);
      }
    }
  }

  // out[p, co] = sum_kw acc[p + kw][kw * COUT + co]: stage m tile j in the
  // warp's ring (pixel q in row q % 32), then finish the pixels whose seven
  // taps have all been staged, a (channel, pixel) pair a lane
  float* mine = ring + warp * kRing * T::kStride;
  const int g = lane >> 2, q2 = (lane & 3) * 2;
  const int fr = r0 + warp;
  constexpr int kPairs = (16 * COUT + 31) / 32;  // pairs a lane
  float bias_f[kPairs];
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    const int co = (lane + 32 * k) >> 4;
    bias_f[k] = co < COUT ? __bfloat162float(bias[co]) : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < T::kMt; ++j) {
#pragma unroll
    for (int nt = 0; nt < T::kNt; ++nt) {
      float* lo = mine + ((16 * j + g) & (kRing - 1)) * T::kStride + nt * 8 + q2;
      float* hi =
          mine + ((16 * j + g + 8) & (kRing - 1)) * T::kStride + nt * 8 + q2;
      lo[0] = acc[j][nt][0];
      lo[1] = acc[j][nt][1];
      hi[0] = acc[j][nt][2];
      hi[1] = acc[j][nt][3];
    }
    __syncwarp();
    const int first = j == 0 ? 0 : 16 * j - (kTaps - 1);
    const int last = j == T::kMt - 1 ? T::kTw : 16 * j + 16 - (kTaps - 1);
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const int co = (lane + 32 * k) >> 4, p = first + (lane & 15);
      const int fc = c0 + p;
      if (co < COUT && p < last && fr < H && fc < W) {
        float s = 0.0f;
#pragma unroll
        for (int kw = 0; kw < kTaps; ++kw)
          s += mine[((p + kw) & (kRing - 1)) * T::kStride + kw * COUT + co];
        float v = round_bf16(round_bf16(s) + bias_f[k]);
        v = sigmoid ? 1.0f / (1.0f + expf(-v)) : tanhf(v);
        out[(img + static_cast<size_t>(fr) * W + fc) * COUT + co] =
            __float2bfloat16_rn(v);
      }
    }
    __syncwarp();
  }
}

template <int CIN, int COUT>
int launch(const void* y, const void* a, const void* b, const void* w,
           const void* bias, void* frag, void* out, int n_img, int H, int W,
           int sigmoid, cudaStream_t stream) {
  using T = Tile<CIN, COUT>;
  npvp_decoder_head_pack<CIN, COUT><<<(T::kFrag + 255) / 256, 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(w), static_cast<unsigned*>(frag));
  const cudaError_t packed = cudaGetLastError();
  if (packed != cudaSuccess) return static_cast<int>(packed);
  static bool raised = false;  // the shared-memory limit, once an instance
  if (!raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        npvp_decoder_head<CIN, COUT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(T::kSmem));
    if (e != cudaSuccess) return static_cast<int>(e);
    raised = true;
  }
  const int row_tiles = (H + kRows - 1) / kRows;
  const int col_tiles = (W + T::kTw - 1) / T::kTw;
  const long long blocks =
      static_cast<long long>(n_img) * row_tiles * col_tiles;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  npvp_decoder_head<CIN, COUT>
      <<<static_cast<unsigned>(blocks), kThreads, T::kSmem, stream>>>(
          static_cast<const __nv_bfloat16*>(y),
          static_cast<const __nv_bfloat16*>(a),
          static_cast<const __nv_bfloat16*>(b),
          static_cast<const unsigned*>(frag),
          static_cast<const __nv_bfloat16*>(bias),
          static_cast<__nv_bfloat16*>(out), H, W, row_tiles, col_tiles,
          sigmoid);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y (n_img, H, W, cin) -> out (n_img, H, W, cout), bf16; a, b (cin), w
// (cout, cin, 7, 7), bias (cout); frag, a scratch of
// 7 * (cin / 16) * ceil(7 * cout / 8) * 64 words for the packed weights. cin
// in {32, 64}, cout in {1, 3}, H, W > 3; sigmoid 0 for Tanh, 1 for Sigmoid
// (the wrapper checks shapes, contiguity and alignment). Returns the first
// launch's CUDA error, 0 on success.
extern "C" int npvp_decoder_head_launch(const void* y, const void* a,
                                        const void* b, const void* w,
                                        const void* bias, void* frag,
                                        void* out, int n_img, int H, int W,
                                        int cin, int cout, int sigmoid,
                                        void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cin == 32 && cout == 3)
    return launch<32, 3>(y, a, b, w, bias, frag, out, n_img, H, W, sigmoid, s);
  if (cin == 32 && cout == 1)
    return launch<32, 1>(y, a, b, w, bias, frag, out, n_img, H, W, sigmoid, s);
  if (cin == 64 && cout == 3)
    return launch<64, 3>(y, a, b, w, bias, frag, out, n_img, H, W, sigmoid, s);
  if (cin == 64 && cout == 1)
    return launch<64, 1>(y, a, b, w, bias, frag, out, n_img, H, W, sigmoid, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
