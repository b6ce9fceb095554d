// The AE's non-local attention (nn/resnet_ae.py NonLocalAttention2D) after
// its fused q|k|v projection, for Hopper (sm_90a): 2x2 max-pooled keys and
// values, unscaled (SAGAN) logits, a softmax over every key of the image and
// the weighted sum of the values.
//
// Replaces no TPU kernel. On the TPU, XLA fused the module's einsums and
// softmax into a few passes (the JAX module's comment,
// npvp_tpu/nn/resnet_ae.py, measured 13.5 ms in the module at 32x32).
// Eagerly, PyTorch writes the (H*W) x (H*W/4) logits to device memory in fp32
// and passes over them about ten times (cast, max, subtract, cast, exp, sum,
// divide, cast, the P.V einsum): ~50 bytes a logit, ~54 GB a Cityscapes
// window at 64x64 for a result of 67 MB. Here the logits never leave the SM.
//
// Function. qkv (N, H, W, 2a + dv) bf16, as the fused projection writes it:
// q = qkv[..., :a], k = qkv[..., a:2a], v = qkv[..., 2a:]; k and v are
// max-pooled 2x2 (stride 2, odd edges dropped) to keys = (H/2)(W/2). For each
// of the H*W query rows, in the eager code's roundings:
//   s_j = bf16(sum_c q_c k_jc)          fp32 accumulate, one rounding
//   m   = max_j s_j
//   d_j = bf16(s_j - m)                 one rounding
//   e_j = exp(d_j), l = sum_j e_j       fp32
//   out = bf16(sum_j bf16(e_j) v_j / l) fp32 accumulate
// with one reordering: the eager code rounds e_j / l to bf16 and sums, the
// kernel rounds e_j and divides the fp32 sum by l. An online softmax (a
// running max that rescales) would round other values, so the keys are
// walked twice: once for m, once for e, l and the sum. Logits are unscaled,
// so one bf16 ulp at |s| ~ 50 moves a weight by ~10 %: the roundings are the
// contract, and the logits stay in bf16 as in the JAX module.
//
// What bounds it. At Cityscapes' first level (256 images of 64x64, a = 8,
// dv = 32; 1.07 G logits a call) the bytes (qkv read once, out written once,
// 168 MB: 0.05 ms at 3.35 TB/s) and the tensor-core work (86 GFLOP: 0.09 ms)
// are small beside the exponentials: 1.07 G ex2 on the special-function unit
// (16 a clock an SM: ~0.27 ms at 1.98 GHz) and the ~6 ALU instructions a
// logit around each (rounding, subtracting and unpacking bf16 pairs, the
// sum). So the design keeps every logit in registers and spends as few
// instructions on it as it can:
// - a pre-pass (npvp_nonlocal_pool_kv) pools k and v once per image into a
//   scratch (k as (keys, a), v transposed to (dv, keys), keys padded to a
//   multiple of 16 with zeros; 21 MB at the first level), so that no block of
//   the main kernel pools or transposes;
// - npvp_nonlocal_attn_rows: a block of 8 warps per (image, tile of query
//   rows) copies the image's pooled K and V whole into shared memory
//   (cp.async; 82 KB at the first level, two blocks an SM; the V copy lands
//   while the first pass runs), each warp owns 16 query rows, or 32 at
//   dv = 32 (two row tiles share each K and V fragment it loads: 0.68 in
//   place of 0.80 ms at the first level, H100 SXM), and a slice of up to 64
//   of the dv output columns (at dv 128 and 256 two and four warps share the
//   rows, recomputing their cheap logits); it keeps q in registers as
//   mma.sync A fragments, and walks the keys twice: Q.K^T on tensor cores
//   (m16n8k8 at a = 8, m16n8k16 above) with a max; then Q.K^T again (the same
//   instructions, so the same values), the subtraction as one bf16x2 fma, the
//   exp as ex2 in fp32, the row sum in fp32, the weights packed in registers
//   straight into the A fragment of P.V (m16n8k16, fp32 accumulate);
// - shared-memory rows are padded so that the fragments' 32-bit loads hit 32
//   distinct banks (K: a + 8 elements a row above a = 8; V^T: keys + 8).
// Two launches a call; nothing of size (H*W) x keys is ever written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;  // 8 warps a block of the attention kernel
constexpr int kRows = 16;      // query rows of a warp: one m16 tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kNegOne = 0xBF80BF80u;  // bf16x2 (-1, -1)

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// D += A (16x16, row) B (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma16(float (&d)[4], const unsigned (&a)[4],
                                      unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D += A (16x8, row) B (8x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma8(float (&d)[4], unsigned a0, unsigned a1,
                                     unsigned b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// two fp32 values rounded to a bf16 pair, the first in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

__device__ __forceinline__ float lo_f32(unsigned w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float hi_f32(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

// a - b for bf16 pairs, rounded once (as b * -1 + a in one fma)
__device__ __forceinline__ unsigned sub_bf16x2(unsigned a, unsigned b) {
  unsigned d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(b), "r"(kNegOne),
      "r"(a));
  return d;
}

__device__ __forceinline__ unsigned max_bf16x2(unsigned a, unsigned b) {
  const __nv_bfloat162 m =
      __hmax2_nan(*reinterpret_cast<const __nv_bfloat162*>(&a),
                  *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const unsigned*>(&m);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// One thread per (image, group of 8 channels of k|v, pooled key), keys
// fastest: the 2x2 max of the group at the key's four pixels. k groups go to
// kp[n][key][:], v groups transposed to vt[n][c][key] (coalesced over the
// warp's keys); keys from (H/2)(W/2) up to keys16 are zeros.
__global__ void __launch_bounds__(256) npvp_nonlocal_pool_kv(
    const __nv_bfloat16* __restrict__ qkv, __nv_bfloat16* __restrict__ kp,
    __nv_bfloat16* __restrict__ vt, int n_img, int H, int W, int a, int dv,
    int keys16) {
  const int Wp = W / 2, keys = (H / 2) * Wp;
  const int groups = (a + dv) / 8, row = 2 * a + dv;
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(n_img) * groups * keys16) return;
  const int key = static_cast<int>(idx % keys16);
  const long long rest = idx / keys16;
  const int g = static_cast<int>(rest % groups);
  const long long n = rest / groups;
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (key < keys) {
    const int i = key / Wp, j = key - i * Wp;
    const __nv_bfloat16* p =
        qkv + ((n * H + 2 * i) * W + 2 * j) * row + a + 8 * g;
    const long long below = static_cast<long long>(W) * row;  // next pixel row
    const uint4 x00 = __ldg(reinterpret_cast<const uint4*>(p));
    const uint4 x01 = __ldg(reinterpret_cast<const uint4*>(p + row));
    const uint4 x10 = __ldg(reinterpret_cast<const uint4*>(p + below));
    const uint4 x11 = __ldg(reinterpret_cast<const uint4*>(p + below + row));
    r.x = max_bf16x2(max_bf16x2(x00.x, x01.x), max_bf16x2(x10.x, x11.x));
    r.y = max_bf16x2(max_bf16x2(x00.y, x01.y), max_bf16x2(x10.y, x11.y));
    r.z = max_bf16x2(max_bf16x2(x00.z, x01.z), max_bf16x2(x10.z, x11.z));
    r.w = max_bf16x2(max_bf16x2(x00.w, x01.w), max_bf16x2(x10.w, x11.w));
  }
  if (g < a / 8) {
    *reinterpret_cast<uint4*>(kp + (n * keys16 + key) * a + 8 * g) = r;
    return;
  }
  unsigned short* dst = reinterpret_cast<unsigned short*>(vt) +
                        (n * dv + (8 * g - a)) * keys16 + key;
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    dst[(2 * e) * keys16] = static_cast<unsigned short>(w[e] & 0xffffu);
    dst[(2 * e + 1) * keys16] = static_cast<unsigned short>(w[e] >> 16);
  }
}

// The logits of the warp's MT tiles of 16 rows against 8 keys from k0: fp32,
// in the C fragment layout (rows g and g + 8, keys k0 + 2t and k0 + 2t + 1);
// the tiles share each K fragment.
template <int A, int KS, int KC, int MT>
__device__ __forceinline__ void logits8(float (&s)[MT][4],
                                        const unsigned (&qa)[MT][KC][4],
                                        const __nv_bfloat16* ks, int k0,
                                        int g, int t) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    s[mt][0] = s[mt][1] = s[mt][2] = s[mt][3] = 0.0f;
  const __nv_bfloat16* kr = ks + (k0 + g) * KS + 2 * t;
  if constexpr (A == 8) {
    const unsigned b = ld_u32(kr);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      mma8(s[mt], qa[mt][0][0], qa[mt][0][1], b);
  } else {
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      const unsigned b0 = ld_u32(kr + 16 * kc), b1 = ld_u32(kr + 16 * kc + 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma16(s[mt], qa[mt][kc], b0, b1);
    }
  }
}

// keys at or past `keys` get -inf: no part in the max, weight exp(-inf) = 0
__device__ __forceinline__ void mask_keys(float (&s)[4], int k0, int t,
                                          int keys) {
  if (k0 + 2 * t >= keys) s[0] = s[2] = -INFINITY;
  if (k0 + 2 * t + 1 >= keys) s[1] = s[3] = -INFINITY;
}

// A pair of weights of one row: bf16(bf16(s) - m), its exp in fp32 added to
// the row's sum, and the pair rounded to bf16 for P.V.
__device__ __forceinline__ unsigned weights(float s_lo, float s_hi,
                                            unsigned m2, float& l) {
  const unsigned d = sub_bf16x2(pack_bf16(s_lo, s_hi), m2);
  const float e_lo = ex2(lo_f32(d) * kLog2e);
  const float e_hi = ex2(hi_f32(d) * kLog2e);
  l += e_lo + e_hi;
  return pack_bf16(e_lo, e_hi);
}

// A block: 8 warps over (image n, a tile of query rows). A warp owns MT
// tiles of 16 rows and DVW of the dv output columns: dv / DVW warps share
// rows, so a block holds 8 / (dv / DVW) row groups of 16 MT rows.
template <int A, int DVW, int MT>
__global__ void __launch_bounds__(kThreads, 2) npvp_nonlocal_attn_rows(
    const __nv_bfloat16* __restrict__ qkv,
    const __nv_bfloat16* __restrict__ kp,
    const __nv_bfloat16* __restrict__ vt, __nv_bfloat16* __restrict__ out,
    int hw, int keys, int keys16, int dv, int tiles) {
  constexpr int KS = A == 8 ? A : A + 8;   // K row stride in shared memory
  constexpr int KC = A == 8 ? 1 : A / 16;  // k-chunks of Q.K^T
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + keys16 * KS;
  const int vstride = keys16 + 8;
  const int splits = dv / DVW, groups = kThreads / 32 / splits;
  const int n = blockIdx.x / tiles, tile = blockIdx.x - n * tiles;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  {  // the image's pooled K, then V^T, into shared memory
    const __nv_bfloat16* src = kp + static_cast<long long>(n) * keys16 * A;
    for (int c = threadIdx.x; c < keys16 * (A / 8); c += kThreads)
      cp_async16(ks + (c / (A / 8)) * KS + (c % (A / 8)) * 8, src + 8 * c);
    cp_async_commit();
    src = vt + static_cast<long long>(n) * dv * keys16;
    const int per_row = keys16 / 8;
    for (int c = threadIdx.x; c < dv * per_row; c += kThreads)
      cp_async16(vs + (c / per_row) * vstride + (c % per_row) * 8,
                 src + 8 * c);
    cp_async_commit();
  }

  const int cc = warp % splits;
  const int row0 = (tile * groups + warp / splits) * kRows * MT;
  const bool active = warp < groups * splits && row0 < hw;
  unsigned qa[MT][KC][4];
  {
    const int row_len = 2 * A + dv;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r_lo = row0 + kRows * mt + g, r_hi = r_lo + 8;
      const __nv_bfloat16* q_lo =
          qkv + (static_cast<long long>(n) * hw + r_lo) * row_len + 2 * t;
      const __nv_bfloat16* q_hi =
          qkv + (static_cast<long long>(n) * hw + r_hi) * row_len + 2 * t;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        qa[mt][kc][0] = r_lo < hw ? ld_u32(q_lo + 16 * kc) : 0u;
        qa[mt][kc][1] = r_hi < hw ? ld_u32(q_hi + 16 * kc) : 0u;
        qa[mt][kc][2] =
            (A > 8 && r_lo < hw) ? ld_u32(q_lo + 16 * kc + 8) : 0u;
        qa[mt][kc][3] =
            (A > 8 && r_hi < hw) ? ld_u32(q_hi + 16 * kc + 8) : 0u;
      }
    }
  }

  cp_async_wait<1>();  // K has landed (V may still be in flight)
  __syncthreads();
  // pass 1: the rows' max (of fp32 logits; rounding keeps the order, so its
  // rounding is the max of the rounded logits)
  float mx_lo[MT], mx_hi[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) mx_lo[mt] = mx_hi[mt] = -INFINITY;
  if (active) {
    for (int k0 = 0; k0 < keys16; k0 += 8) {
      float s[MT][4];
      logits8<A, KS, KC, MT>(s, qa, ks, k0, g, t);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (k0 + 8 > keys) mask_keys(s[mt], k0, t, keys);
        mx_lo[mt] = fmaxf(mx_lo[mt], fmaxf(s[mt][0], s[mt][1]));
        mx_hi[mt] = fmaxf(mx_hi[mt], fmaxf(s[mt][2], s[mt][3]));
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {  // the 4 lanes of a row
        mx_lo[mt] =
            fmaxf(mx_lo[mt], __shfl_xor_sync(0xffffffffu, mx_lo[mt], o));
        mx_hi[mt] =
            fmaxf(mx_hi[mt], __shfl_xor_sync(0xffffffffu, mx_hi[mt], o));
      }
    }
  }
  cp_async_wait<0>();  // V^T has landed
  __syncthreads();
  if (!active) return;

  // pass 2: weights, their sum and P.V over the warp's DVW columns
  unsigned m_lo[MT], m_hi[MT];
  float acc[MT][DVW / 8][4], l_lo[MT], l_hi[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m_lo[mt] = pack_bf16(mx_lo[mt], mx_lo[mt]);
    m_hi[mt] = pack_bf16(mx_hi[mt], mx_hi[mt]);
    l_lo[mt] = l_hi[mt] = 0.0f;
#pragma unroll
    for (int j = 0; j < DVW / 8; ++j)
      acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.0f;
  }
  const __nv_bfloat16* vr = vs + (cc * DVW + g) * vstride + 2 * t;
  for (int kb = 0; kb < keys16; kb += 16) {
    float s0[MT][4], s1[MT][4];
    logits8<A, KS, KC, MT>(s0, qa, ks, kb, g, t);
    logits8<A, KS, KC, MT>(s1, qa, ks, kb + 8, g, t);
    // the C fragments of keys kb..kb+7 and kb+8..kb+15 are the A fragment
    // of P (16 rows x 16 keys)
    unsigned p[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (kb + 16 > keys) {
        mask_keys(s0[mt], kb, t, keys);
        mask_keys(s1[mt], kb + 8, t, keys);
      }
      p[mt][0] = weights(s0[mt][0], s0[mt][1], m_lo[mt], l_lo[mt]);
      p[mt][1] = weights(s0[mt][2], s0[mt][3], m_hi[mt], l_hi[mt]);
      p[mt][2] = weights(s1[mt][0], s1[mt][1], m_lo[mt], l_lo[mt]);
      p[mt][3] = weights(s1[mt][2], s1[mt][3], m_hi[mt], l_hi[mt]);
    }
#pragma unroll
    for (int j = 0; j < DVW / 8; ++j) {
      const __nv_bfloat16* v = vr + j * 8 * vstride + kb;
      const unsigned b0 = ld_u32(v), b1 = ld_u32(v + 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma16(acc[mt][j], p[mt], b0, b1);
    }
  }
  __nv_bfloat16* dst = out + cc * DVW + 2 * t;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      l_lo[mt] += __shfl_xor_sync(0xffffffffu, l_lo[mt], o);
      l_hi[mt] += __shfl_xor_sync(0xffffffffu, l_hi[mt], o);
    }
    const int r_lo = row0 + kRows * mt + g, r_hi = r_lo + 8;
    if (r_lo < hw) {
      __nv_bfloat16* d = dst + (static_cast<long long>(n) * hw + r_lo) * dv;
#pragma unroll
      for (int j = 0; j < DVW / 8; ++j)
        *reinterpret_cast<unsigned*>(d + 8 * j) = pack_bf16(
            acc[mt][j][0] / l_lo[mt], acc[mt][j][1] / l_lo[mt]);
    }
    if (r_hi < hw) {
      __nv_bfloat16* d = dst + (static_cast<long long>(n) * hw + r_hi) * dv;
#pragma unroll
      for (int j = 0; j < DVW / 8; ++j)
        *reinterpret_cast<unsigned*>(d + 8 * j) = pack_bf16(
            acc[mt][j][2] / l_hi[mt], acc[mt][j][3] / l_hi[mt]);
    }
  }
}

template <int A, int DVW, int MT>
int launch_rows(const __nv_bfloat16* qkv, const __nv_bfloat16* kp,
                const __nv_bfloat16* vt, __nv_bfloat16* out, int n_img,
                int hw, int keys, int keys16, int dv, cudaStream_t stream) {
  const int rows = kThreads / 32 / (dv / DVW) * kRows * MT;
  const int tiles = (hw + rows - 1) / rows;
  const size_t smem =
      (static_cast<size_t>(keys16) * (A == 8 ? A : A + 8) +
       static_cast<size_t>(dv) * (keys16 + 8)) * sizeof(__nv_bfloat16);
  static size_t allowed = 48 * 1024;  // raised once per instance as needed
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        npvp_nonlocal_attn_rows<A, DVW, MT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed = smem;
  }
  npvp_nonlocal_attn_rows<A, DVW, MT>
      <<<n_img * tiles, kThreads, smem, stream>>>(qkv, kp, vt, out, hw, keys,
                                                  keys16, dv, tiles);
  return static_cast<int>(cudaGetLastError());
}

template <int A>
int launch_a(const __nv_bfloat16* qkv, const __nv_bfloat16* kp,
             const __nv_bfloat16* vt, __nv_bfloat16* out, int n_img, int hw,
             int keys, int keys16, int dv, cudaStream_t stream) {
  if (dv == 32)  // two row tiles a warp: each V fragment serves both
    return launch_rows<A, 32, 2>(qkv, kp, vt, out, n_img, hw, keys, keys16,
                                 dv, stream);
  return launch_rows<A, 64, 1>(qkv, kp, vt, out, n_img, hw, keys, keys16, dv,
                               stream);
}

}  // namespace

// qkv (n_img, H, W, 2a + dv) bf16 -> out (n_img, H, W, dv) bf16, through
// the scratch kp (n_img, keys16, a) and vt (n_img, dv, keys16), keys16 =
// (H/2)(W/2) rounded up to 16. a in {8, 16, 32, 64}; dv in {32, 64, 128,
// 256} (the wrapper checks shapes, alignment and shared memory).
// Returns the first launch's CUDA error, 0 on success.
extern "C" int npvp_nonlocal_attention_launch(const void* qkv, void* kp,
                                              void* vt, void* out, int n_img,
                                              int H, int W, int a, int dv,
                                              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int keys = (H / 2) * (W / 2), keys16 = (keys + 15) / 16 * 16;
  const auto* x = static_cast<const __nv_bfloat16*>(qkv);
  auto* k = static_cast<__nv_bfloat16*>(kp);
  auto* v = static_cast<__nv_bfloat16*>(vt);
  auto* y = static_cast<__nv_bfloat16*>(out);
  const long long threads =
      static_cast<long long>(n_img) * ((a + dv) / 8) * keys16;
  npvp_nonlocal_pool_kv<<<static_cast<unsigned>((threads + 255) / 256), 256,
                          0, s>>>(x, k, v, n_img, H, W, a, dv, keys16);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int hw = H * W;
  switch (a) {
    case 8:
      return launch_a<8>(x, k, v, y, n_img, hw, keys, keys16, dv, s);
    case 16:
      return launch_a<16>(x, k, v, y, n_img, hw, keys, keys16, dv, s);
    case 32:
      return launch_a<32>(x, k, v, y, n_img, hw, keys, keys16, dv, s);
    case 64:
      return launch_a<64>(x, k, v, y, n_img, hw, keys, keys16, dv, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
