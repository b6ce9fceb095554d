// Row-wise LayerNorm with an optional GELU epilogue, for Hopper (sm_90a).
//
// Replaces no TPU kernel. On the TPU, XLA fused the predictor's two norms
// (nn/layers.py TokenLayerNorm over C, LayerNormHWC over (H, W, C)) and the
// GELU after each LayerNormHWC into its neighbours; the JAX package's own
// fused MlpDWBN kernel was deleted. Eagerly, PyTorch runs each norm as ~17
// passes over the row (an fp32 copy, its square, two means, the affine
// broadcast into full-size fp32 tensors and their casts), ~66 bytes of
// traffic per bf16 element. This kernel is the same function in one pass.
//
// Function. Each of `rows` contiguous rows of length L (L = C for the token
// norm, H*W*C for the HWC norm) with an fp32 affine (w, b) of length L:
//   mean = sum(x) / L, var = max(sum(x^2) / L - mean^2, 0), inv = rsqrt(var+eps)
//   (fp32 statistics in the form every norm of the port and of the JAX
//   package shares), a = inv * w, c = b - mean * inv * w, y = act(x * a + c)
//   in fp32, act none, GELU (tanh form) or GELU (erf form), then ONE rounding
//   to the output type. Input and output are fp32 or bf16 each.
//
// What bounds it: bytes. It reads the row once and writes it once, 4 bytes a
// bf16 element (a flagship forward: ~20.6 GB, ~6.2 ms at 3.35 TB/s). The
// affine is 8 bytes an element but shared by every row, so a block reads it
// once into shared memory (laid out so that lanes read it without bank
// conflicts) and keeps it there while it walks over rows, or it would triple
// the traffic through L2. x is loaded and y stored with the streaming cache
// hint (each is touched once here). The arithmetic (two sums, an FMA, the
// GELU as one exp and one division) stays below the card's rate.
//
// Design: the row stays on chip between its statistics and its output, so x
// leaves DRAM once; rows are walked by persistent warps or clusters whose
// loads run ahead of their arithmetic. The launch shape follows L and the row
// count:
// - short rows (L <= 1024): a warp a row. Each lane keeps its <= 32 elements
//   in registers as 16-byte vectors; the next row's loads are in flight while
//   the warp reduces (shuffles) and writes the current one.
// - long rows (up to 16 blocks of 256 x 32 = 8192 elements: L <= 131072): a
//   thread-block cluster a row, each block a slice of it in registers, two
//   blocks an SM (two clusters' rows in flight on each). A block reduces its
//   slice's (sum, sum of squares) by shuffles and shared memory; every warp
//   of the cluster adds the blocks' partials read through distributed shared
//   memory (in one order, so every block gets the same statistics). The
//   cluster barrier that publishes a row's partials is split (arrive, then
//   wait) and software-pipelined over three rows: while the barrier of row
//   i+1 is in flight the block writes row i, and the loads of row i+2 were
//   started before. The partials alternate between two slots, so a row's
//   writes never meet the reads of the row two before it.
//
// Measured at the flagship's shapes (H100 SXM, bf16): the token norms at
// ~1.3x their byte bound, the (H, W, C) norms at ~1.5x without the GELU and
// ~1.65x with it; the cluster's barrier a row, the pipeline's fill and the
// GELU's two special-function operations an element hold them there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kWarpBlock = 256;     // threads a block of the warp kernel
constexpr int kWarpElems = 32;      // elements a lane keeps at most: L <= 1024
constexpr int kClusterBlock = 256;  // threads a block of the cluster kernel
constexpr int kClusterElems = 32;   // elements a thread keeps of a row
constexpr int kMaxCluster = 16;     // non-portable above 8 (Hopper allows 16)

enum Act { kNone = 0, kGeluTanh = 1, kGeluErf = 2 };

// A 16-byte vector of the input: 8 bf16 or 4 fp32 elements, loaded and
// stored whole, unpacked to fp32 in registers.
template <typename T>
struct Lanes;
template <>
struct Lanes<float> {
  static constexpr int n = 4;
};
template <>
struct Lanes<__nv_bfloat16> {
  static constexpr int n = 8;
};

__device__ __forceinline__ void unpack(const uint4& r, float (&f)[4]) {
  f[0] = __uint_as_float(r.x), f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z), f[3] = __uint_as_float(r.w);
}

__device__ __forceinline__ void unpack(const uint4& r, float (&f)[8]) {
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // element 2i is the word's low half
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ unsigned bf16_pair(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // one cvt
  return *reinterpret_cast<const unsigned*>(&h);
}

template <int VEC>
__device__ __forceinline__ void store(float* p, const float (&f)[VEC]) {
#pragma unroll
  for (int q = 0; q < VEC / 4; ++q)
    __stcs(reinterpret_cast<float4*>(p) + q,
           make_float4(f[4 * q], f[4 * q + 1], f[4 * q + 2], f[4 * q + 3]));
}

template <int VEC>
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&f)[VEC]) {
  if constexpr (VEC == 8) {
    __stcs(reinterpret_cast<uint4*>(p),
           make_uint4(bf16_pair(f[0], f[1]), bf16_pair(f[2], f[3]),
                      bf16_pair(f[4], f[5]), bf16_pair(f[6], f[7])));
  } else {
    __stcs(reinterpret_cast<uint2*>(p),
           make_uint2(bf16_pair(f[0], f[1]), bf16_pair(f[2], f[3])));
  }
}

// The GELU after the norm, in fp32. The erf form as PyTorch's CUDA GELU
// computes it (erff). The tanh form, 0.5 v (1 + tanh(u)) with
// u = sqrt(2/pi) (v + 0.044715 v^3), as v / (1 + exp(-2u)), the same function
// (0.5 (1 + tanh(u)) is the logistic of 2u): one exp and one division on the
// special-function unit in place of tanhf's polynomial, within ~1e-6 of it,
// far inside the bf16 rounding that follows; exp(-2u) overflowing to inf
// gives the -0 that GELU tends to.
__device__ __forceinline__ float activate(float v, int act) {
  if (act == kGeluTanh) {
    // exp(-2u) as 2^(-2u log2 e), the constants folded into one
    const float k = -2.0f * 0.7978845608028654f * 1.4426950408889634f;
    float e;
    asm("ex2.approx.ftz.f32 %0, %1;"
        : "=f"(e) : "f"(k * v * fmaf(0.044715f, v * v, 1.0f)));
    return __fdividef(v, 1.0f + e);
  }
  if (act == kGeluErf) return v * 0.5f * (1.0f + erff(v * 0.7071067811865476f));
  return v;
}

__device__ __forceinline__ float2 warp_sum(float2 p) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    p.x += __shfl_xor_sync(0xffffffffu, p.x, o);
    p.y += __shfl_xor_sync(0xffffffffu, p.y, o);
  }
  return p;
}

// NV vectors of a row, vector `first + k * stride` in slot k; zeros (0.0 in
// either type) past `nvec`
template <int NV>
__device__ __forceinline__ void load_row(uint4 (&dst)[NV],
                                         const void* __restrict__ src,
                                         int first, int stride, int nvec) {
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int v = first + k * stride;
    dst[k] = v < nvec ? __ldcs(reinterpret_cast<const uint4*>(src) + v)
                      : make_uint4(0u, 0u, 0u, 0u);
  }
}

template <int VEC, int NV>
__device__ __forceinline__ float2 row_sums(const uint4 (&xv)[NV]) {
  float2 p = make_float2(0.0f, 0.0f);
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    float f[VEC];
    unpack(xv[k], f);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      p.x += f[j];
      p.y = fmaf(f[j], f[j], p.y);
    }
  }
  return p;
}

// (mean, inv) from the row's (sum, sum of squares)
__device__ __forceinline__ float2 moments(float2 p, float inv_n, float eps) {
  const float mean = p.x * inv_n;
  const float var = fmaxf(p.y * inv_n - mean * mean, 0.0f);
  return make_float2(mean, rsqrtf(var + eps));
}

// The affine of a block's slice of `slice` vectors in shared memory: float4
// q of vector v at [q * slice + v], so that consecutive lanes read
// consecutive float4s (no bank conflicts).
template <int VEC>
struct SharedAffine {
  const float4* w4;
  const float4* b4;
  int slice;
  __device__ __forceinline__ int at(int v, int q) const {
    return q * slice + v;
  }
};

// Normalise the NV vectors of a row held in registers, vector
// `first + k * stride` of the row, and store those before `nvec`.
template <typename Tout, int VEC, int NV>
__device__ __forceinline__ void normalise_row(const uint4 (&xv)[NV],
                                              const SharedAffine<VEC>& aff,
                                              float2 mi, int act,
                                              Tout* __restrict__ dst,
                                              int first, int stride,
                                              int nvec) {
  const float mean_inv = mi.x * mi.y;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int v = first + k * stride;
    if (v >= nvec) continue;
    float f[VEC];
    unpack(xv[k], f);
#pragma unroll
    for (int q = 0; q < VEC / 4; ++q) {
      const float4 wq = aff.w4[aff.at(v, q)], bq = aff.b4[aff.at(v, q)];
      const float wv[4] = {wq.x, wq.y, wq.z, wq.w};
      const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float a = mi.y * wv[j];
        const float c = bv[j] - mean_inv * wv[j];
        f[4 * q + j] = activate(fmaf(f[4 * q + j], a, c), act);
      }
    }
    store<VEC>(dst + static_cast<size_t>(v) * VEC, f);
  }
}

// a slice of `here` vectors of w and of b (VEC floats each, 16-byte
// aligned) into shared memory, by the whole block
template <int VEC>
__device__ __forceinline__ SharedAffine<VEC> load_affine(
    float4* smem, const float* __restrict__ w, const float* __restrict__ b,
    int here, int slice) {
  float4* w4 = smem;
  float4* b4 = smem + slice * (VEC / 4);
  const SharedAffine<VEC> aff{w4, b4, slice};
  for (int i = threadIdx.x; i < here * (VEC / 4); i += blockDim.x) {
    const int v = i / (VEC / 4), q = i % (VEC / 4);
    w4[aff.at(v, q)] = __ldg(reinterpret_cast<const float4*>(w) + i);
    b4[aff.at(v, q)] = __ldg(reinterpret_cast<const float4*>(b) + i);
  }
  __syncthreads();
  return aff;
}

// ---------------------------------------------------------------------------
// short rows: a warp a row

template <typename Tin, typename Tout, int NV>
__device__ __forceinline__ void warp_step(
    const uint4 (&cur)[NV], uint4 (&nxt)[NV], const Tin* __restrict__ x,
    Tout* __restrict__ y, const SharedAffine<Lanes<Tin>::n>& aff, int row,
    int warps, int rows, int L, float inv_n, float eps, int act) {
  constexpr int VEC = Lanes<Tin>::n;
  const int lane = threadIdx.x & 31, nvec = L / VEC;
  if (row + warps < rows)  // the next row's loads fly during this one
    load_row<NV>(nxt, x + static_cast<size_t>(row + warps) * L, lane, 32,
                 nvec);
  const float2 mi = moments(warp_sum(row_sums<VEC, NV>(cur)), inv_n, eps);
  normalise_row<Tout, VEC, NV>(cur, aff, mi, act,
                               y + static_cast<size_t>(row) * L, lane, 32,
                               nvec);
}

template <typename Tin, typename Tout, int NV>
__global__ void __launch_bounds__(kWarpBlock)
    npvp_layer_norm_warp_rows(const Tin* __restrict__ x,
                              const float* __restrict__ w,
                              const float* __restrict__ b,
                              Tout* __restrict__ y, int rows, int L,
                              float eps, int act) {
  constexpr int VEC = Lanes<Tin>::n;
  const int lane = threadIdx.x & 31, nvec = L / VEC;
  extern __shared__ float4 smem[];  // the affine, w then b
  const SharedAffine<VEC> aff = load_affine<VEC>(smem, w, b, nvec, nvec);
  const float inv_n = 1.0f / static_cast<float>(L);
  const int warps = gridDim.x * (kWarpBlock / 32);
  int row = blockIdx.x * (kWarpBlock / 32) + (threadIdx.x >> 5);
  uint4 r0[NV], r1[NV];
  if (row < rows)
    load_row<NV>(r0, x + static_cast<size_t>(row) * L, lane, 32, nvec);
  // two steps a turn, so the buffers swap by name and no copy waits on a load
  while (row < rows) {
    warp_step<Tin, Tout, NV>(r0, r1, x, y, aff, row, warps, rows, L, inv_n,
                             eps, act);
    row += warps;
    if (row >= rows) break;
    warp_step<Tin, Tout, NV>(r1, r0, x, y, aff, row, warps, rows, L, inv_n,
                             eps, act);
    row += warps;
  }
}

// ---------------------------------------------------------------------------
// long rows: a cluster a row, each block a slice

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_size() {
  unsigned n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}

// a float2 of block `rank`'s shared memory at the address of `local`
__device__ __forceinline__ float2 read_peer(const float2* local,
                                            unsigned rank) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(local));
  unsigned peer;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(peer) : "r"(addr), "r"(rank));
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y) : "r"(peer) : "memory");
  return v;
}

struct ClusterShared {
  float2 warp_part[kClusterBlock / 32];
  float2 block_part[2];  // by row parity, read by the whole cluster
};

// This block's (sum, sum of squares) of the row in `xv`, into its slot for
// the row's parity, then the cluster barrier's arrive.
template <int VEC, int NV>
__device__ __forceinline__ void publish(const uint4 (&xv)[NV],
                                       ClusterShared& sh, int parity) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float2 p = warp_sum(row_sums<VEC, NV>(xv));
  if (lane == 0) sh.warp_part[warp] = p;
  __syncthreads();
  if (warp == 0) {
    p = warp_sum(lane < kClusterBlock / 32 ? sh.warp_part[lane]
                                           : make_float2(0.0f, 0.0f));
    if (lane == 0) sh.block_part[parity] = p;
  }
  cluster_arrive();
}

// Row i of this cluster's rows, with A = row i, B = row i + 1, C free: start
// the loads of row i + 2 into C, wait for row i's barrier and read its
// statistics, publish row i + 1's partials (or only arrive, after the last
// row), then normalise and store row i.
template <typename Tin, typename Tout, int NV>
__device__ __forceinline__ void cluster_step(
    const uint4 (&A)[NV], const uint4 (&B)[NV], uint4 (&C)[NV],
    const Tin* __restrict__ x, Tout* __restrict__ y,
    const SharedAffine<Lanes<Tin>::n>& aff, ClusterShared& sh, int i,
    int count, int first,
    int nclusters, int L, size_t off, int here, unsigned cs, float inv_n,
    float eps, int act) {
  constexpr int VEC = Lanes<Tin>::n;
  const size_t row = first + static_cast<size_t>(i) * nclusters;
  if (i + 2 < count)
    load_row<NV>(C, x + (row + 2 * static_cast<size_t>(nclusters)) * L + off,
                 threadIdx.x, kClusterBlock, here);
  cluster_wait();  // every block's partials of row i are written
  const int lane = threadIdx.x & 31;
  float2 t = make_float2(0.0f, 0.0f);
  if (lane < static_cast<int>(cs)) t = read_peer(&sh.block_part[i & 1], lane);
  const float2 mi = moments(warp_sum(t), inv_n, eps);
  if (i + 1 < count) {
    publish<VEC, NV>(B, sh, (i + 1) & 1);
  } else {
    cluster_arrive();  // the last phase: no block leaves while one reads
  }
  normalise_row<Tout, VEC, NV>(A, aff, mi, act, y + row * L + off,
                               threadIdx.x, kClusterBlock, here);
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kClusterBlock, 2)
    npvp_layer_norm_cluster_rows(const Tin* __restrict__ x,
                                 const float* __restrict__ w,
                                 const float* __restrict__ b,
                                 Tout* __restrict__ y, int rows, int L,
                                 int slice_vecs, float eps, int act) {
  constexpr int VEC = Lanes<Tin>::n;
  constexpr int NV = kClusterElems / VEC;
  extern __shared__ float4 smem[];  // this slice's w, then its b
  __shared__ ClusterShared sh;
  const unsigned cs = cluster_size();
  const int rank = static_cast<int>(cluster_rank());
  const int nclusters = gridDim.x / cs;
  const int first = blockIdx.x / cs;
  const int count = first < rows ? (rows - 1 - first) / nclusters + 1 : 0;
  const int nvec = L / VEC;
  const int v0 = rank * slice_vecs;
  const int here = max(0, min(slice_vecs, nvec - v0));  // vectors here
  const size_t off = static_cast<size_t>(v0) * VEC;
  const SharedAffine<VEC> aff =
      load_affine<VEC>(smem, w + off, b + off, here, slice_vecs);
  if (count == 0) return;  // the whole cluster alike
  const float inv_n = 1.0f / static_cast<float>(L);
  const size_t stride = static_cast<size_t>(nclusters) * L;
  uint4 r0[NV], r1[NV], r2[NV];
  load_row<NV>(r0, x + first * static_cast<size_t>(L) + off, threadIdx.x,
               kClusterBlock, here);
  if (count > 1)
    load_row<NV>(r1, x + first * static_cast<size_t>(L) + stride + off,
                 threadIdx.x, kClusterBlock, here);
  publish<VEC, NV>(r0, sh, 0);
  // three steps a turn, so the buffers rotate by name and no copy waits on a
  // load
  for (int i = 0; i < count; i += 3) {
    cluster_step<Tin, Tout, NV>(r0, r1, r2, x, y, aff, sh, i, count,
                                first, nclusters, L, off, here, cs, inv_n,
                                eps, act);
    if (i + 1 >= count) break;
    cluster_step<Tin, Tout, NV>(r1, r2, r0, x, y, aff, sh, i + 1, count,
                                first, nclusters, L, off, here, cs, inv_n,
                                eps, act);
    if (i + 2 >= count) break;
    cluster_step<Tin, Tout, NV>(r2, r0, r1, x, y, aff, sh, i + 2, count,
                                first, nclusters, L, off, here, cs, inv_n,
                                eps, act);
  }
  cluster_wait();
}

// ---------------------------------------------------------------------------
// host side

int g_sms = 0;

int sm_count() {
  if (g_sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return g_sms;
}

// the plan of a launch: which kernel, its cluster size, its slices
struct Plan {
  int cluster;     // 0: the warp kernel; else the cluster size
  int nv;          // warp kernel: vectors a lane
  int slice_vecs;  // cluster kernel: vectors a block
};

bool make_plan(int L, int vec, Plan* p) {
  if (L <= 0 || L % vec != 0) return false;
  const int nvec = L / vec;
  if (L <= 32 * kWarpElems) {
    int nv = 1;
    while (32 * nv < nvec) nv *= 2;
    *p = Plan{0, nv, 0};
    return true;
  }
  const int per_block = kClusterBlock * kClusterElems / vec;
  const int cs = (nvec + per_block - 1) / per_block;
  if (cs > kMaxCluster) return false;
  *p = Plan{cs, 0, (nvec + cs - 1) / cs};
  return true;
}

template <typename Tin, typename Tout, int NV>
int launch_warp(const void* x, const void* w, const void* b, void* y,
                int rows, int L, float eps, int act, cudaStream_t stream) {
  auto kernel = npvp_layer_norm_warp_rows<Tin, Tout, NV>;
  const int smem = static_cast<int>(sizeof(float)) * 2 * L;
  // blocks an SM, at the largest affine (32 * kWarpElems floats each)
  static int per_sm = 0;
  if (per_sm == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kWarpBlock, sizeof(float) * 2 * 32 * kWarpElems);
    if (per_sm <= 0) per_sm = 1;
  }
  const int wanted = (rows + kWarpBlock / 32 - 1) / (kWarpBlock / 32);
  const int grid = wanted < per_sm * sm_count() ? wanted : per_sm * sm_count();
  kernel<<<grid, kWarpBlock, smem, stream>>>(
      static_cast<const Tin*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<Tout*>(y), rows, L, eps, act);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tin, typename Tout>
int launch_cluster(const void* x, const void* w, const void* b, void* y,
                   int rows, int L, const Plan& plan, float eps, int act,
                   cudaStream_t stream) {
  auto kernel = npvp_layer_norm_cluster_rows<Tin, Tout>;
  // every launch asks for the largest slice's shared memory (two blocks an
  // SM), so the clusters that fit depend on the cluster size alone
  constexpr int kSmem =
      static_cast<int>(sizeof(float)) * 2 * kClusterBlock * kClusterElems;
  static bool ready = false;
  static int max_clusters[kMaxCluster + 1] = {0};
  if (!ready) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kSmem);
    cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
                         1);
    ready = true;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = plan.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(kClusterBlock, 1, 1);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int& fit = max_clusters[plan.cluster];
  if (fit == 0) {
    cfg.gridDim = dim3(plan.cluster * sm_count(), 1, 1);
    if (cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg) != cudaSuccess ||
        fit <= 0) {
      cudaGetLastError();
      fit = sm_count() / plan.cluster > 0 ? sm_count() / plan.cluster : 1;
    }
  }
  const int clusters = rows < fit ? rows : fit;
  cfg.gridDim = dim3(clusters * plan.cluster, 1, 1);
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const Tin*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<Tout*>(y), rows, L,
      plan.slice_vecs, eps, act);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tin, typename Tout>
int launch_typed(const void* x, const void* w, const void* b, void* y,
                 int rows, int L, float eps, int act, cudaStream_t stream) {
  constexpr int VEC = Lanes<Tin>::n;
  Plan plan;
  if (!make_plan(L, VEC, &plan)) return static_cast<int>(cudaErrorInvalidValue);
  if (plan.cluster > 0)
    return launch_cluster<Tin, Tout>(x, w, b, y, rows, L, plan, eps, act,
                                     stream);
  switch (plan.nv) {
    case 1:
      return launch_warp<Tin, Tout, 1>(x, w, b, y, rows, L, eps, act, stream);
    case 2:
      return launch_warp<Tin, Tout, 2>(x, w, b, y, rows, L, eps, act, stream);
    case 4:
      return launch_warp<Tin, Tout, 4>(x, w, b, y, rows, L, eps, act, stream);
    default:
      if constexpr (VEC * 8 <= kWarpElems)
        return launch_warp<Tin, Tout, 8>(x, w, b, y, rows, L, eps, act,
                                         stream);
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// x (rows, L) fp32 or bf16 (in_bf16), w and b (L,) fp32, y (rows, L) fp32 or
// bf16 (out_bf16), all contiguous and 16-byte aligned; act 0 none, 1 GELU
// (tanh form), 2 GELU (erf form). Launches on `stream`; returns the CUDA
// error of the launch (0 on success).
extern "C" int npvp_layer_norm_launch(const void* x, const void* w,
                                      const void* b, void* y, int rows, int L,
                                      int in_bf16, int out_bf16, float eps,
                                      int act, void* stream) {
  if (rows <= 0 || act < kNone || act > kGeluErf || !aligned16(x) ||
      !aligned16(w) || !aligned16(b) || !aligned16(y))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_bf16) {
    if (out_bf16)
      return launch_typed<__nv_bfloat16, __nv_bfloat16>(x, w, b, y, rows, L,
                                                         eps, act, st);
    return launch_typed<__nv_bfloat16, float>(x, w, b, y, rows, L, eps, act,
                                              st);
  }
  if (out_bf16)
    return launch_typed<float, __nv_bfloat16>(x, w, b, y, rows, L, eps, act,
                                              st);
  return launch_typed<float, float>(x, w, b, y, rows, L, eps, act, st);
}
