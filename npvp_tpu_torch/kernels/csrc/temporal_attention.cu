// Per-site attention with the output projection fused, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of npvp_tpu/kernels/temporal_attention.py:
// _kernel_oproj (attention + output projection, the serving path) and _kernel
// (attention only). Each site (an (h, w) position over time, or an attention
// window) holds q (Tq, H*D) and k, v (Tk, H*D), Tq, Tk <= 64. Per head: fp32
// logits q_h k_h^T / sqrt(hd) + bias (a shared (Tq, Tk) fp32 mask of 0 or
// -FLT_MAX), a max-subtracted fp32 softmax divided by its sum, the weights
// rounded to the compute type, ctx_h = w v_h accumulated in fp32 and rounded
// to the compute type; then either ctx (attention only) or
// sum_h ctx_h wo_h^T + bo accumulated in fp32 (fused), stored in the compute
// type. wo is (C, H*D), nn.Linear's weight as it stands.
//
// bf16 (serving) runs the Hopper kernel below; fp32 runs the CUDA-core kernel
// of the first port, kept for fp32 parity only (no TF32 anywhere). The
// softmax divides once per row and multiplies the row by the reciprocal:
// within an fp32 ulp of dividing each weight, far below the bf16 rounding
// that follows.
//
// What bounds the bf16 kernel at the flagship shapes (H*D = C = 512, 8 heads
// of 64, windows of 16 tokens or sites of T = 10, 2560-4096 sites a call):
// (1) HBM bytes: q, k, v and the output are read and written once, about
// 168 MB a call, 0.050 ms at 3.35 TB/s; the products (23 GFLOP) take half
// of that on the tensor cores. (2) L2 traffic of wo: every tile of 64 token
// rows multiplies by all of wo (512 KB), 335-358 MB a call through L2.
//
// Design. A tile is S = 64 / max(Tq, Tk) whole sites, packed into the 64 rows
// of one wgmma (4 windows of 16, or 6 sites of 10 in 60 rows). Per head the
// 64 x 64 logits of the whole tile come from one tensor-core product; the
// entries between different sites are masked with -inf (exactly zero weight)
// and each site's own (Tq, Tk) bias is added on the diagonal blocks, so a
// query row whose keys are all masked is uniform over its own keys. This is
// the TPU kernel's site packing (_packed_bias) in the form the tensor cores
// want. The softmax runs in registers, in the accumulator layout (row max and
// sum by quad shuffles), and the bf16 weights feed the P.V product as the
// register A operand, V read from shared memory MN-major.
// A block of three warpgroups stays on each SM and walks over the work:
// warpgroup 0 produces (one thread per consumer issues TMA loads: 2-D maps
// over (rows, H*D), 128-byte swizzle = one 64-wide bf16 head row, zero fill
// past the last site), warpgroups 1 and 2 consume. Each consumer has a ring
// of 8 KB pages with an mbarrier pair each, filled in exactly the order it
// consumes them, so every load is issued as soon as a page frees up, whether
// it holds q, k, v or a piece of wo: the wo pieces of a tile stream in
// during its attention, and the next tile's q, k, v during its projection.
// Against (1): the rings keep the loads of 3 heads (fused) or 4 (attention
// only) in flight per consumer, and the outputs leave as 16-byte stores, 64
// contiguous bytes of a row per quad of threads (4-byte stores straight from
// the accumulator layout cost the fused variant more than all its
// products). Against (2): wo is read
// from L2 once per 64-row tile in 8 KB pages of 128 columns x 32 of a
// head's 64, through the same rings, so its loads overlap the attention; a
// 128-row tile or a wo page shared by two blocks would halve the traffic,
// but two context tiles do not fit beside the rings in 227 KB.
// Fused: the two consumers take every other head of a tile and put each
// head's context into a 64 x H*D bf16 tile in shared memory (swizzled, as
// TMA would write it); then they split the output columns in passes of
// 128: accumulators start at bo, each head's context comes back as register
// A fragments (ldmatrix) and is multiplied by its wo pages on wgmma. Attention
// only: the work is (tile, head) units, dealt out to the consumers, so the
// last wave is a head, not a tile.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is reached at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxRows = 64;  // token rows of a tile

__host__ __device__ constexpr size_t round_up(size_t x, size_t to) {
  return (x + to - 1) / to * to;
}

// ---------------------------------------------------------------------------
// fp32: CUDA-core kernel, one block per tile
// ---------------------------------------------------------------------------

// The fused variant holds a 64-row fp32 context tile, so one block fills an
// SM; it runs 1024 threads.
template <bool FUSE>
__host__ __device__ constexpr int f32_threads() { return FUSE ? 1024 : 256; }
constexpr int kF32Warps = f32_threads<true>() / 32;  // 32

// Projection on the CUDA cores: each thread holds a 2 x 8 block of the output
// (rows ty + 32i, columns tx + 32j of a 256-column chunk); wo (C, HD) streams
// through `wsm` in pieces of 256 columns x 32 k, stored k-major in padded
// rows so that both the load and the product are free of bank conflicts.
constexpr int kF32KC = 32, kF32NC = 256, kF32Rows = kMaxRows / kF32Warps,
              kF32Cols = kF32NC / 32, kF32Ld = kF32NC + 1;
constexpr size_t kF32RegionBytes = sizeof(float) * kF32KC * kF32Ld;

__device__ void f32_project(const float* ctx, int ldc, float* wsm,
                            const float* __restrict__ wo,
                            const float* __restrict__ bo,
                            float* __restrict__ out, int Rq, int HD, int C) {
  constexpr int kThreads = f32_threads<true>();
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int c0 = 0; c0 < C; c0 += kF32NC) {
    float acc[kF32Rows][kF32Cols];
#pragma unroll
    for (int i = 0; i < kF32Rows; ++i)
#pragma unroll
      for (int j = 0; j < kF32Cols; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < HD; k0 += kF32KC) {
      for (int i = threadIdx.x; i < kF32KC * kF32NC; i += kThreads) {
        const int cc = i / kF32KC, kk = i - cc * kF32KC;
        const int gk = k0 + kk, gc = c0 + cc;
        wsm[kk * kF32Ld + cc] =
            (gk < HD && gc < C) ? wo[static_cast<size_t>(gc) * HD + gk] : 0.f;
      }
      __syncthreads();
      const int kmax = min(kF32KC, HD - k0);
      for (int kk = 0; kk < kmax; ++kk) {
        float a[kF32Rows], b[kF32Cols];
#pragma unroll
        for (int i = 0; i < kF32Rows; ++i)
          a[i] = ctx[(ty + kF32Warps * i) * ldc + k0 + kk];
#pragma unroll
        for (int j = 0; j < kF32Cols; ++j) b[j] = wsm[kk * kF32Ld + tx + 32 * j];
#pragma unroll
        for (int i = 0; i < kF32Rows; ++i)
#pragma unroll
          for (int j = 0; j < kF32Cols; ++j)
            acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < kF32Rows; ++i) {
      const int r = ty + kF32Warps * i;
      if (r >= Rq) continue;
#pragma unroll
      for (int j = 0; j < kF32Cols; ++j) {
        const int c = c0 + tx + 32 * j;
        if (c < C) out[static_cast<size_t>(r) * C + c] = acc[i][j] + bo[c];
      }
    }
  }
}

// bytes of a block's q, k, v of one head (rows padded by one word, so that
// consecutive rows start in consecutive banks) and of its fp32 logits
__host__ __device__ size_t f32_logits_offset(int S, int Tq, int Tk, int ld) {
  return round_up(sizeof(float) * (static_cast<size_t>(S) * Tq +
                                   2 * static_cast<size_t>(S) * Tk) * ld, 16);
}
__host__ __device__ size_t f32_heads_bytes(int S, int Tq, int Tk, int ld) {
  return round_up(f32_logits_offset(S, Tq, Tk, ld) +
                      sizeof(float) * static_cast<size_t>(S) * Tq * Tk,
                  128);
}

template <bool FUSE>
__global__ void __launch_bounds__(f32_threads<FUSE>())
temporal_attention_f32(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ bias,
           const float* __restrict__ wo, const float* __restrict__ bo,
           float* __restrict__ out, int B, int Tq, int Tk, int HD,
           int num_heads, int C, int S, int ctx_bytes) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kThreads = f32_threads<FUSE>();
  const int hd = HD / num_heads;
  const int ld = hd + 1;
  const int site0 = blockIdx.x * S;
  const int nsites = min(S, B - site0);
  const int Rq = nsites * Tq;
  const int Rk = nsites * Tk;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));

  // [ctx: kMaxRows x HD, fused only][q, k, v of a head, then its logits; the
  //  projection's wo pieces reuse this region]
  float* ctx = reinterpret_cast<float*>(smem);
  unsigned char* region = smem + (FUSE ? ctx_bytes : 0);
  float* qs = reinterpret_cast<float*>(region);
  float* ks = qs + S * Tq * ld;
  float* vs = ks + S * Tk * ld;
  float* ps =
      reinterpret_cast<float*>(region + f32_logits_offset(S, Tq, Tk, ld));

  const float* qg = q + static_cast<size_t>(site0) * Tq * HD;
  const float* kg = k + static_cast<size_t>(site0) * Tk * HD;
  const float* vg = v + static_cast<size_t>(site0) * Tk * HD;
  float* og = out + static_cast<size_t>(site0) * Tq * C;

  for (int h = 0; h < num_heads; ++h) {
    const int col = h * hd;
    for (int i = threadIdx.x; i < Rq * hd; i += kThreads) {
      const int r = i / hd, d = i - r * hd;
      qs[r * ld + d] = qg[static_cast<size_t>(r) * HD + col + d];
    }
    for (int i = threadIdx.x; i < Rk * hd; i += kThreads) {
      const int r = i / hd, d = i - r * hd;
      const size_t g = static_cast<size_t>(r) * HD + col + d;
      ks[r * ld + d] = kg[g];
      vs[r * ld + d] = vg[g];
    }
    __syncthreads();

    // logits (site, query, key)
    const int TT = Tq * Tk;
    for (int i = threadIdx.x; i < nsites * TT; i += kThreads) {
      const int s = i / TT, rem = i - s * TT;
      const int a = rem / Tk, b = rem - a * Tk;
      const float* qr = qs + (s * Tq + a) * ld;
      const float* kr = ks + (s * Tk + b) * ld;
      float acc = 0.f;
      for (int d = 0; d < hd; ++d) acc = fmaf(qr[d], kr[d], acc);
      float l = acc * scale;
      if (bias != nullptr) l += bias[rem];
      ps[i] = l;
    }
    __syncthreads();

    // softmax over keys, one row per thread
    for (int r = threadIdx.x; r < Rq; r += kThreads) {
      float* p = ps + r * Tk;
      float m = p[0];
      for (int b = 1; b < Tk; ++b) m = fmaxf(m, p[b]);
      float sum = 0.f;
      for (int b = 0; b < Tk; ++b) {
        const float e = expf(p[b] - m);
        p[b] = e;
        sum += e;
      }
      for (int b = 0; b < Tk; ++b) p[b] /= sum;
    }
    __syncthreads();

    // ctx_h = w . v_h
    for (int i = threadIdx.x; i < Rq * hd; i += kThreads) {
      const int r = i / hd, d = i - r * hd;
      const float* p = ps + r * Tk;
      const float* vr = vs + (r / Tq) * Tk * ld + d;
      float acc = 0.f;
      for (int b = 0; b < Tk; ++b) acc = fmaf(p[b], vr[b * ld], acc);
      if (FUSE) {
        ctx[r * HD + col + d] = acc;
      } else {
        og[static_cast<size_t>(r) * HD + col + d] = acc;
      }
    }
    __syncthreads();
  }
  if (!FUSE) return;
  // Rows of ctx beyond Rq hold stale values; their sums are never stored.
  f32_project(ctx, HD, reinterpret_cast<float*>(region), wo, bo, og, Rq, HD,
              C);
}

size_t f32_smem_bytes(bool fuse, int Tq, int Tk, int HD, int num_heads) {
  const int S = kMaxRows / std::max(Tq, Tk);
  const size_t heads = f32_heads_bytes(S, Tq, Tk, HD / num_heads + 1);
  if (!fuse) return heads;
  return round_up(sizeof(float) * kMaxRows * HD, 128) +
         std::max(heads, kF32RegionBytes);
}

template <bool FUSE>
cudaError_t f32_launch(const void* q, const void* k, const void* v,
                       const void* bias, const void* wo, const void* bo,
                       void* out, int B, int Tq, int Tk, int HD,
                       int num_heads, int C, cudaStream_t stream) {
  const int S = kMaxRows / std::max(Tq, Tk);
  const size_t bytes = f32_smem_bytes(FUSE, Tq, Tk, HD, num_heads);
  const size_t ctx_bytes =
      FUSE ? round_up(sizeof(float) * kMaxRows * HD, 128) : 0;
  auto kern = temporal_attention_f32<FUSE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((B + S - 1) / S);
  kern<<<grid, f32_threads<FUSE>(), bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(bias),
      static_cast<const float*>(wo), static_cast<const float*>(bo),
      static_cast<float*>(out), B, Tq, Tk, HD, num_heads, C, S,
      static_cast<int>(ctx_bytes));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: the Hopper kernel
// ---------------------------------------------------------------------------

constexpr int kHd = 64;  // head width: one 128-byte row, the 128B swizzle
constexpr uint32_t kPageBytes = kMaxRows * kHd * 2;  // 8 KB: 64 rows x 1 head
constexpr int kMaxFusedHeads = 8;  // the context tile beside the rings
constexpr int kConsumers = 2;      // consumer warpgroups
constexpr int kHopperThreads = 128 * (1 + kConsumers);
constexpr float kScale = 0.125f;   // 1 / sqrt(64), exact

// The projection runs in passes of kPassN output columns; a wo page holds
// kPassN columns x kPageK of one head's 64 (64-byte rows, 64B swizzle).
constexpr int kPassN = 128, kPageK = 32;


// Pages of each consumer's ring: 227 KB of shared memory holds 28 pages, of
// which the fused variant's context tile takes 8.
template <bool FUSE>
__host__ __device__ constexpr int ring_pages() { return FUSE ? 10 : 12; }

struct HopperParams {
  int B, Tq, Tk, nh, C, S, ntiles;
  const float* bias;  // (Tq, Tk) or null
  const float* bo;    // (C), fused only
  __nv_bfloat16* out;
};

// Shared memory, from a 1024-byte aligned base: [the consumers' rings of
// pages][context tile, fused: head blocks of 64 x 64][mbarriers: per ring,
// its pages' full barriers, then their empty ones]
template <bool FUSE>
size_t hopper_smem_bytes(int nh) {
  return kConsumers * ring_pages<FUSE>() * (kPageBytes + 16) +
         (FUSE ? nh * kPageBytes : 0) + 1024;  // room to align the base
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            int col, int row, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// wgmma descriptor of a 128B-swizzled bf16 tile (rows of 128 bytes, 8-row
// groups 1024 bytes apart, 1024-byte aligned): K-major, a k16 step adds 32
// bytes; MN-major (V), a k16 step adds 16 rows, 2048 bytes. Both byte
// offsets are 1024 (the leading one is unused at these widths).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// the same for a wo page: K-major, 64B-swizzled rows of 64 bytes, 8-row
// groups 512 bytes apart
__device__ __forceinline__ uint64_t wo_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) |
         (static_cast<uint64_t>(2) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// returns once at most N committed groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads and writes across the
// asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 64, fp32) += A (64 x 16, smem) * B (64 x 16, smem), both
// K-major bf16
__device__ __forceinline__ void wgmma_m64n64_ss(float (&d)[32], uint64_t a,
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// D (64 x 64, fp32) += A (64 x 16, bf16 registers) * B (16 x 64, smem,
// MN-major bf16)
__device__ __forceinline__ void wgmma_m64n64_rs_tb(float (&d)[32], uint32_t a0,
                                                   uint32_t a1, uint32_t a2,
                                                   uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// D (64 x 128, fp32) += A (64 x 16, bf16 registers) * B (16 x 128, smem,
// K-major bf16)
__device__ __forceinline__ void wgmma_m64n128_rs(float (&d)[64], uint32_t a0,
                                                   uint32_t a1, uint32_t a2,
                                                   uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& r0,
                                            uint32_t& r1, uint32_t& r2,
                                            uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One ring of pages, as its producer or its consumer walks it. Every page
// has a full barrier (one arrival plus the TMA bytes) and an empty one (the
// consumer warpgroup's 128 threads). Ring `first` starts at page `first`.
struct Ring {
  uint32_t pages, bars;
  int n, i;
  uint32_t ph;
  __device__ Ring(uint32_t page0, uint32_t bars0, int first, int count)
      : pages(page0 + first * kPageBytes),
        bars(bars0 + 16 * first),
        n(count),
        i(0),
        ph(0) {}
  __device__ uint32_t full() const { return bars + 8 * i; }
  __device__ uint32_t empty() const { return bars + 8 * (n + i); }
  __device__ void next() {
    if (++i == n) {
      i = 0;
      ph ^= 1;
    }
  }
  // producer: wait for the page to be free, then load a box into it
  __device__ void load(const CUtensorMap* map, int col, int row,
                       uint32_t bytes) {
    mbar_wait(empty(), ph ^ 1);
    mbar_expect_tx(full(), bytes);
    tma_load_2d(pages + i * kPageBytes, map, col, row, full());
    next();
  }
};

// a page the consumer holds: its address and the barrier that frees it
struct Page {
  uint32_t addr, empty;
};

__device__ __forceinline__ Page take(Ring& r) {
  mbar_wait(r.full(), r.ph);
  const Page pg{r.pages + r.i * kPageBytes, r.empty()};
  r.next();
  return pg;
}

// The work of a block: items blockIdx.x, + gridDim.x, ... (tiles, fused;
// (tile, head) units, attention only).
__device__ __forceinline__ int nth_item(int j) {
  return blockIdx.x + j * gridDim.x;
}

// The producer of consumer c fills its ring in exactly the order the
// consumer takes the pages: attention only, q, k, v of units j = c, c + 2,
// ... of the block; fused, per tile, q, k, v of its heads c, c + 2, ...,
// then for each of its column passes c, c + 2, ... and each head the wo
// pages. So the wo pages of a tile stream in during its attention and the
// next tile's q, k, v during its projection, as far as the ring reaches.
template <bool FUSE>
__device__ void produce(const CUtensorMap* tq, const CUtensorMap* tk,
                        const CUtensorMap* tv, const CUtensorMap* tw,
                        const HopperParams& p, Ring r, int c) {
  const int rq = p.S * p.Tq, rk = p.S * p.Tk;
  const uint32_t bq = rq * kHd * 2, bk = rk * kHd * 2;
  auto head = [&](int tile, int h) {
    r.load(tq, h * kHd, tile * rq, bq);
    r.load(tk, h * kHd, tile * rk, bk);
    r.load(tv, h * kHd, tile * rk, bk);
  };
  if (!FUSE) {
    for (int j = c; nth_item(j) < p.ntiles * p.nh; j += kConsumers) {
      const int u = nth_item(j);
      head(u / p.nh, u % p.nh);
    }
    return;
  }
  const int passes = (p.C + kPassN - 1) / kPassN;
  for (int j = 0; nth_item(j) < p.ntiles; ++j) {
    for (int h = c; h < p.nh; h += kConsumers) head(nth_item(j), h);
    for (int n = c; n < passes; n += kConsumers)
      for (int h = 0; h < p.nh; ++h)
        for (int pg = 0; pg < kHd / kPageK; ++pg)
          r.load(tw, h * kHd + pg * kPageK, n * kPassN, kPageBytes);
  }
}

// Thread t of a consumer warpgroup holds rows r0 = 16 (t / 32) + (t % 32) / 4
// and r1 = r0 + 8 of the accumulators and, in each 8-column block j,
// columns 8j + 2 (t % 4) and the next: element i of an m64nN accumulator is
// row (i & 2 ? r1 : r0), column 8 (i / 4) + 2 (t % 4) + (i & 1). The A
// fragment of k-step kk of a product is elements 8kk .. 8kk + 7 of such an
// accumulator, in pairs, rounded to bf16.
//
// The tile's logit bias, the same for every tile, in that layout: a site's
// own bias on its diagonal block, -inf between sites and past the last
// packed key, 0 on the rows past the last packed query (finite values that
// are never stored).
__device__ __forceinline__ void tile_bias(const HopperParams& p,
                                          float (&mb)[32]) {
  const int t = threadIdx.x & 127, lane = t & 31;
  const int r0 = (t >> 5) * 16 + (lane >> 2), cq = lane & 3;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int row = r0 + ((i & 2) ? 8 : 0);
    const int col = 8 * (i >> 2) + 2 * cq + (i & 1);
    float v = 0.f;
    if (row < p.S * p.Tq) {
      const int sq = row / p.Tq, sk = col / p.Tk;
      v = sq != sk ? -INFINITY
          : p.bias == nullptr
              ? 0.f
              : p.bias[(row - sq * p.Tq) * p.Tk + col - sk * p.Tk];
    }
    mb[i] = v;
  }
}

// One head of one tile: takes its q, k and v pages, leaves ctx_h (64 x 64,
// fp32) in o and frees the pages.
__device__ __forceinline__ void attend(Ring& r, const float (&mb)[32],
                                       float (&o)[32]) {
  const Page q = take(r), k = take(r);

  // logits of the whole tile: q_h k_h^T, 64 x 64
  float sc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
  fence_operands(sc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kHd / 16; ++kk)
    wgmma_m64n64_ss(sc, sw128_desc(q.addr + 32 * kk),
                    sw128_desc(k.addr + 32 * kk));
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(sc);
  mbar_arrive(q.empty);
  mbar_arrive(k.empty);

  // softmax over the row's keys, fp32; the weights rounded to bf16
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    sc[i] = fmaf(sc[i], kScale, mb[i]);
    if (i & 2) {
      m1 = fmaxf(m1, sc[i]);
    } else {
      m0 = fmaxf(m0, sc[i]);
    }
  }
  m0 = quad_max(m0);
  m1 = quad_max(m1);
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    sc[i] = __expf(sc[i] - ((i & 2) ? m1 : m0));
    if (i & 2) {
      s1 += sc[i];
    } else {
      s0 += sc[i];
    }
  }
  // one division per row, then products: within an fp32 ulp of dividing
  // each weight, far below the bf16 rounding that follows
  const float inv0 = 1.f / quad_sum(s0), inv1 = 1.f / quad_sum(s1);
  uint32_t pa[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float inv = (i & 1) ? inv1 : inv0;
    pa[i] = pack_bf16(sc[2 * i] * inv, sc[2 * i + 1] * inv);
  }

  // ctx_h = w v_h, fp32 accumulators
  const Page v = take(r);
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  fence_operands(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kMaxRows / 16; ++kk)
    wgmma_m64n64_rs_tb(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                       pa[4 * kk + 3], sw128_desc(v.addr + 2048 * kk));
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(o);
  mbar_arrive(v.empty);
}

// rows r0 and r0 + 8 of a 64 x 64 fp32 accumulator, rounded to bf16, to rows `grow` + r of a row-major array with row stride
// ld, from column col0. The four threads of a quad hold 8 consecutive
// columns of a row between them; a 4 x 4 transpose by shuffles gives each
// 16 bytes of its own 8-column block, so that a warp writes 64 contiguous
// bytes of each of 8 rows. Columns from `cols` on (a multiple of 8) and
// rows from `rows` on are not stored.
__device__ __forceinline__ void store_rows(const float (&a)[32],
                                           __nv_bfloat16* out, size_t grow,
                                           int ld, int col0, int cols,
                                           int rows) {
  const int t = threadIdx.x & 127, lane = t & 31;
  const int r0 = (t >> 5) * 16 + (lane >> 2), cq = lane & 3;
  const bool odd = cq & 1, hi = cq & 2;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + 8 * half;
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      uint32_t v[4];  // this thread's 2 columns of blocks 4g .. 4g + 3
#pragma unroll
      for (int m = 0; m < 4; ++m)
        v[m] = pack_bf16(a[16 * g + 4 * m + 2 * half],
                         a[16 * g + 4 * m + 2 * half + 1]);
      const uint32_t x0 = __shfl_xor_sync(0xffffffffu, odd ? v[0] : v[1], 1);
      const uint32_t x1 = __shfl_xor_sync(0xffffffffu, odd ? v[2] : v[3], 1);
      const uint32_t n0 = odd ? x0 : v[0], n1 = odd ? v[1] : x0;
      const uint32_t n2 = odd ? x1 : v[2], n3 = odd ? v[3] : x1;
      const uint32_t y0 = __shfl_xor_sync(0xffffffffu, hi ? n0 : n2, 2);
      const uint32_t y1 = __shfl_xor_sync(0xffffffffu, hi ? n1 : n3, 2);
      const int col = col0 + 8 * (4 * g + cq);
      if (row < rows && col < cols)
        *reinterpret_cast<uint4*>(out + (grow + row) * ld + col) =
            hi ? make_uint4(y0, y1, n2, n3) : make_uint4(n0, n1, y0, y1);
    }
  }
}

// Attention only: units j = c, c + 2, ... of the block, each context
// stored straight from the accumulators.
__device__ void consume_attn(const HopperParams& p, Ring r, int c) {
  const int HD = p.nh * kHd, rows_q = p.S * p.Tq;
  float mb[32];
  tile_bias(p, mb);
  for (int j = c; nth_item(j) < p.ntiles * p.nh; j += kConsumers) {
    const int u = nth_item(j), tile = u / p.nh, h = u % p.nh;
    float o[32];
    attend(r, mb, o);
    store_rows(o, p.out, static_cast<size_t>(tile) * rows_q, HD, h * kHd, HD,
               min(p.S, p.B - tile * p.S) * p.Tq);
  }
}

// Fused: the tiles of the block. Consumer c attends heads c, c + 2, ... and
// puts each context into the context tile `ctx`, swizzled as TMA would
// write it; then, once both have, it projects the tile for its column
// passes c, c + 2, ... on wgmma, one head's products in flight while the
// next head's wo pages are waited for.
__device__ void consume_fused(const HopperParams& p, Ring r, uint32_t ctx,
                              int c) {
  constexpr int kPages = kHd / kPageK;  // wo pages of a head in a pass
  const int t = threadIdx.x & 127, lane = t & 31;
  const int r0 = (t >> 5) * 16 + (lane >> 2), cq = lane & 3;
  const int rows_q = p.S * p.Tq;
  const int passes = (p.C + kPassN - 1) / kPassN;
  float mb[32];
  tile_bias(p, mb);
  for (int j = 0; nth_item(j) < p.ntiles; ++j) {
    const int tile = nth_item(j);
    const int rows = min(p.S, p.B - tile * p.S) * p.Tq;  // rows stored
    const size_t grow = static_cast<size_t>(tile) * rows_q;
    for (int h = c; h < p.nh; h += kConsumers) {
      float o[32];
      attend(r, mb, o);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = r0 + 8 * half;
          st_shared_u32(ctx + h * kPageBytes + row * 128 +
                            ((jj ^ (row & 7)) << 4) + 4 * cq,
                        pack_bf16(o[4 * jj + 2 * half],
                                  o[4 * jj + 2 * half + 1]));
        }
      }
    }
    named_bar_sync(1, 128 * kConsumers);  // every head's context is in

    for (int n = c; n < passes; n += kConsumers) {
      // the accumulators start at bo, as in the TPU kernel
      float acc[kPassN / 2];
#pragma unroll
      for (int j = 0; j < kPassN / 8; ++j) {
        const int col = n * kPassN + 8 * j + 2 * cq;
        const float2 b = col < p.C ? *reinterpret_cast<const float2*>(p.bo + col)
                                   : make_float2(0.f, 0.f);
        acc[4 * j] = acc[4 * j + 2] = b.x;
        acc[4 * j + 1] = acc[4 * j + 3] = b.y;
      }
      // one head's products in flight while the next head's A fragments
      // and wo pages are fetched: two fragment buffers, heads in pairs
      const int lr = (t >> 5) * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
      Page prev[kPages];
      auto step = [&](int h, uint32_t (&af)[16]) {
        const uint32_t a = ctx + h * kPageBytes;
#pragma unroll
        for (int kk = 0; kk < kHd / 16; ++kk) {
          const int chunk = 2 * kk + (lane >> 4);
          ldmatrix_x4(a + lr * 128 + ((chunk ^ (lr & 7)) << 4), af[4 * kk],
                      af[4 * kk + 1], af[4 * kk + 2], af[4 * kk + 3]);
        }
        fence_operands(acc);
        wgmma_fence();
        Page w[kPages];
#pragma unroll
        for (int pg = 0; pg < kPages; ++pg) {
          w[pg] = take(r);
#pragma unroll
          for (int ks = 0; ks < kPageK / 16; ++ks) {
            const int kk = pg * (kPageK / 16) + ks;
            wgmma_m64n128_rs(acc, af[4 * kk], af[4 * kk + 1], af[4 * kk + 2],
                             af[4 * kk + 3], wo_desc(w[pg].addr + 32 * ks));
          }
        }
        wgmma_commit();
        wgmma_wait<1>();
#pragma unroll
        for (int pg = 0; pg < kPages; ++pg) {
          if (h > 0) mbar_arrive(prev[pg].empty);
          prev[pg] = w[pg];
        }
      };
      uint32_t af0[16], af1[16];
      for (int h = 0; h < p.nh; h += 2) {
        step(h, af0);
        if (h + 1 < p.nh) step(h + 1, af1);
      }
      wgmma_wait<0>();
      fence_operands(acc);
#pragma unroll
      for (int pg = 0; pg < kPages; ++pg) mbar_arrive(prev[pg].empty);
#pragma unroll
      for (int q = 0; q < kPassN / 64; ++q)
        store_rows(reinterpret_cast<float(&)[32]>(acc[32 * q]), p.out, grow,
                   p.C, n * kPassN + 64 * q, p.C, rows);
    }
    named_bar_sync(1, 128 * kConsumers);  // done reading the context tile
  }
}

template <bool FUSE>
__global__ void __launch_bounds__(kHopperThreads, 1)
temporal_attention_hopper(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tw,
                          const HopperParams p) {
  extern __shared__ __align__(1024) unsigned char hopper_smem[];
  const uint32_t raw = smem_u32(hopper_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  constexpr int kPages = ring_pages<FUSE>();
  const uint32_t ctx = base + kConsumers * kPages * kPageBytes;
  const uint32_t bars0 = ctx + (FUSE ? p.nh * kPageBytes : 0);

  // A TMA box covers S * T <= 64 rows; the rows it leaves must read as
  // zeros (never stale NaN), so the pages are zeroed once.
  for (uint32_t a = base + threadIdx.x * 16; a < ctx; a += kHopperThreads * 16)
    asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};" ::"r"(a), "r"(0)
                 : "memory");
  if (threadIdx.x == 0) {
    for (int i = 0; i < kConsumers * kPages; ++i) {
      const int c = i / kPages, pg = i % kPages;
      const uint32_t full = bars0 + 16 * kPages * c + 8 * pg;
      mbar_init(full, 1);
      mbar_init(full + 8 * kPages, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  fence_proxy_async();
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    const int warp = threadIdx.x / 32;
    if ((threadIdx.x & 31) == 0 && warp < kConsumers)
      produce<FUSE>(&tq, &tk, &tv, &tw, p,
                    Ring(base, bars0, warp * kPages, kPages), warp);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int c = wg - 1;
    const Ring r(base, bars0, c * kPages, kPages);
    if (FUSE) {
      consume_fused(p, r, ctx, c);
    } else {
      consume_attn(p, r, c);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime,
// so the library links against no libcuda
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// a 2-D map over a row-major bf16 (rows, cols) array, boxes of box_rows x 64
// columns, 128B swizzle; rows past the end read as zeros
bool encode_map(CUtensorMap* map, const void* ptr, int rows, int cols,
                int box_rows, int box_cols = kHd,
                CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool hopper_supports(int HD, int num_heads, int C, bool fuse) {
  return HD == num_heads * kHd &&
         (!fuse || (num_heads <= kMaxFusedHeads && C % 8 == 0));
}

template <bool FUSE>
cudaError_t hopper_launch(const void* q, const void* k, const void* v,
                          const void* bias, const void* wo, const void* bo,
                          void* out, int B, int Tq, int Tk, int HD,
                          int num_heads, int C, cudaStream_t stream) {
  const int S = kMaxRows / std::max(Tq, Tk);
  const HopperParams p{B,
                       Tq,
                       Tk,
                       num_heads,
                       C,
                       S,
                       (B + S - 1) / S,
                       static_cast<const float*>(bias),
                       static_cast<const float*>(bo),
                       static_cast<__nv_bfloat16*>(out)};
  CUtensorMap mq, mk, mv, mw;
  if (!encode_map(&mq, q, B * Tq, HD, S * Tq) ||
      !encode_map(&mk, k, B * Tk, HD, S * Tk) ||
      !encode_map(&mv, v, B * Tk, HD, S * Tk) ||
      !encode_map(&mw, FUSE ? wo : q, FUSE ? C : B * Tq, HD,
                  FUSE ? kPassN : S * Tq, FUSE ? kPageK : kHd,
                  FUSE ? CU_TENSOR_MAP_SWIZZLE_64B
                       : CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  const size_t bytes = hopper_smem_bytes<FUSE>(num_heads);
  auto kern = temporal_attention_hopper<FUSE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  // whole tiles (fused) or (tile, head) units, two a block
  const int work = FUSE ? p.ntiles : (p.ntiles * num_heads + 1) / 2;
  const unsigned grid = static_cast<unsigned>(std::min(work, sms));
  kern<<<grid, kHopperThreads, bytes, stream>>>(mq, mk, mv, mw, p);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Plain C entry points, loaded with ctypes. dtype: 0 float, 1 bfloat16.
// fuse: 1 with the output projection (wo (C, HD) in the compute type, bo (C)
// float), 0 without (C == HD). bfloat16 needs heads of 64 (HD == 64 *
// num_heads), 16-byte aligned q, k, v, wo and, fused, at most 8 heads and
// C % 8 == 0. bias may be null. Returns a cudaError_t.
extern "C" int temporal_attention_launch(const void* q, const void* k,
                                         const void* v, const void* bias,
                                         const void* wo, const void* bo,
                                         void* out, int B, int Tq, int Tk,
                                         int HD, int num_heads, int C,
                                         int dtype, int fuse, void* stream) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || num_heads <= 0 || HD % num_heads != 0 ||
      std::max(Tq, Tk) > kMaxRows || C <= 0 || (dtype != 0 && dtype != 1) ||
      (fuse && (wo == nullptr || bo == nullptr)) ||
      (dtype == 1 && (!hopper_supports(HD, num_heads, C, fuse) ||
                      !aligned16(q) || !aligned16(k) || !aligned16(v) ||
                      (fuse && !aligned16(wo)))))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) {
    err = fuse ? hopper_launch<true>(q, k, v, bias, wo, bo, out, B, Tq, Tk,
                                     HD, num_heads, C, st)
               : hopper_launch<false>(q, k, v, bias, wo, bo, out, B, Tq, Tk,
                                      HD, num_heads, C, st);
  } else {
    err = fuse ? f32_launch<true>(q, k, v, bias, wo, bo, out, B, Tq, Tk, HD,
                                  num_heads, C, st)
               : f32_launch<false>(q, k, v, bias, wo, bo, out, B, Tq, Tk, HD,
                                   num_heads, C, st);
  }
  return static_cast<int>(err);
}

// Dynamic shared memory of one block, in bytes, for the same arguments.
extern "C" int temporal_attention_smem_bytes(int Tq, int Tk, int HD,
                                             int num_heads, int dtype,
                                             int fuse) {
  if (dtype == 1)
    return static_cast<int>(fuse ? hopper_smem_bytes<true>(num_heads)
                                 : hopper_smem_bytes<false>(num_heads));
  return static_cast<int>(f32_smem_bytes(fuse, Tq, Tk, HD, num_heads));
}
