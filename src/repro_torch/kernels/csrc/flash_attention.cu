// K1: causal GQA flash attention (forward), CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (_flash_kernel, launched from flash_attention_bhsd).
//
// What it computes: for every (b, q-head h, query row i)
//   out[i] = sum_j softmax_j(q_i . k_j / sqrt(D)) v_j  over keys j <= i,
// with an online softmax in f32, masked scores set to -1e30, l == 0 -> 1, and
// the output in q's dtype.  KV head = h / (Hq / Hkv).
//
// What bounds it on this card: at the serve shape (S = 512, D = 256, MQA,
// bf16) the work is ~1.1 GFLOP against ~4.7 MB of traffic, so the roofline
// bound is memory (about 1.4 us).  Two paths, picked by the input dtype:
//  * bf16 (serving): mma.sync m16n8k16 on tensor cores with f32 accumulation,
//    tiles in shared memory, scores and output accumulators in registers.
//    Without cp.async/TMA double buffering or wgmma, the loads into shared
//    memory and the block count (64 at the serve shape) bound it.
//  * f32 (parity runs): plain f32 FMAs on CUDA cores out of shared memory, so
//    the f32 numbers stay within 2e-5 of the plain version (tensor cores
//    would round the products to tf32).  Bound by shared-memory bandwidth and
//    FMA issue rate.
//
// What the design does about the TPU original's choices (both paths):
//  * One block per (64-row q tile, q head, batch).  An in-block loop over
//    64-key tiles replaces the Pallas grid's sequential k dimension, and it
//    stops at the diagonal: tiles wholly above it are never loaded (the Pallas
//    grid visits and masks them).  Tiles are issued longest first.
//  * Inputs are read in the model's (B, S, H, D) layout through strides, so
//    no transpose copies are made; the ragged edge of S is masked here, so no
//    padding copies either; K/V of a head group are read from the same memory
//    (no repeated K/V).
//  * f32 at D = 256: the q/k/v tiles (+1 column of padding against bank
//    conflicts) and the P tile take 214,016 bytes of dynamic shared memory,
//    enabled with cudaFuncSetAttribute.  The 64 x D f32 accumulator lives in
//    registers: 256 threads x (4 rows x D/16 columns) = 64 floats a thread at
//    D = 256, with no spill to local memory (ptxas -v).
#include <cstdint>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kBQ = 64;   // query rows per block
constexpr int kBK = 64;   // keys per inner tile
constexpr int kNT = 256;  // threads: 16 row groups of 4 rows x 16 lanes
constexpr int kLDP = kBK + 1;

template <int D>
constexpr size_t flash_smem_bytes() {
  return sizeof(float) * (size_t(kBQ) * (D + 1) + 2 * size_t(kBK) * (D + 1) + size_t(kBQ) * kLDP);
}

template <int D>
__global__ void __launch_bounds__(kNT) flash_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, int S, int group, float scale,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh) {
  constexpr int LD = D + 1;
  constexpr int NC = D / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;             // kBQ x LD
  float* sK = sQ + kBQ * LD;    // kBK x LD
  float* sV = sK + kBK * LD;    // kBK x LD
  float* sP = sV + kBK * LD;    // kBQ x kLDP

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x;
  const int rg = tid >> 4;  // rows rg*4 .. rg*4+3
  const int ln = tid & 15;  // score columns ln + 16j, output columns ln + 16c

  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + hk * k_sh;
  const float* vb = v + b * v_sb + hk * v_sh;

  for (int i = tid; i < kBQ * D; i += kNT) {
    const int r = i / D, c = i % D, s = q0 + r;
    sQ[r * LD + c] = s < S ? qb[s * q_ss + c] : 0.f;
  }

  float acc[4][NC];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // keys at or past q0 + kBQ lie above the diagonal for every row of the tile
  const int kv_end = min(S, q0 + kBQ);
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the previous tile's readers of sK/sV/sP are done
    for (int i = tid; i < kBK * D; i += kNT) {
      const int r = i / D, c = i % D, s = k0 + r;
      const bool ok = s < S;
      sK[r * LD + c] = ok ? kb[s * k_ss + c] : 0.f;
      sV[r * LD + c] = ok ? vb[s * v_ss + c] : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(rg * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(ln + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + rg * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + ln + 16 * j;
        const float s = col <= row ? sc[i][j] * scale : kNegInf;
        sc[i][j] = s;
        mx = fmaxf(mx, s);
      }
      // the 16 lanes of a row group are one half of a warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        sP[(rg * 4 + i) * kLDP + ln + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(rg * 4 + i) * kLDP + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = sV[kk * LD + ln + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

  float* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg * 4 + i;
    if (row >= S) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < NC; ++c) ob[row * o_ss + ln + 16 * c] = acc[i][c] / denom;
  }
}

// ---------------------------------------------------------------------------
// bf16: the same algorithm on tensor cores (mma.sync m16n8k16, f32 accumulate)
// ---------------------------------------------------------------------------
//
// 4 warps, each owning 16 of the block's 64 query rows.  S = Q K^T and O += P V
// are mma.sync products on bf16 tiles in shared memory; the score and output
// accumulators stay in registers in the mma fragment layout (thread holds
// rows g and g + 8 of its warp's 16, g = lane / 4), so the online softmax runs
// on registers with 4-lane shuffles and P goes from the score accumulators
// straight into the A operand of the P V product, rounded to bf16 (the usual
// flash-attention trade: P in bf16, all sums in f32).  V is stored transposed
// so that both products read 32-bit pairs.  At D = 256: 104,448 bytes of
// shared memory (two blocks per SM) and 128 f32 output accumulators a thread.

constexpr int kMNT = 128;       // 4 warps x 16 rows
constexpr int kMBQ = 64;
constexpr int kMBK = 64;
constexpr int kVLD = kMBK + 8;  // row stride of transposed V, in bf16
constexpr int kVec = 8;         // bf16 per 16-byte global load

template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (size_t(kMBQ + kMBK) * (D + 8) + size_t(D) * kVLD);
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c += a (16x16, row-major fragment) * b (16x8, column-major fragment)
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <int D>
__global__ void __launch_bounds__(kMNT) flash_fwd_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int S, int group,
    float scale, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh) {
  constexpr int LD = D + 8;   // row stride of Q and K tiles, in bf16
  constexpr int NT = D / 8;   // output n-tiles (8 columns each) per warp
  constexpr int CH = D / kVec;  // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // kMBQ x LD
  __nv_bfloat16* sK = sQ + kMBQ * LD;                                // kMBK x LD
  __nv_bfloat16* sVt = sK + kMBK * LD;                               // D x kVLD

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest tiles first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const int q0 = qt * kMBQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + hk * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + hk * v_sh;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  for (int i = tid; i < kMBQ * CH; i += kMNT) {
    const int r = i / CH, c = (i % CH) * kVec, s = q0 + r;
    *reinterpret_cast<uint4*>(sQ + r * LD + c) =
        s < S ? *reinterpret_cast<const uint4*>(qb + s * q_ss + c) : zero;
  }

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // l: this thread's partial sums

  const int kv_end = min(S, q0 + kMBQ);  // keys past the tile's last row are masked
  for (int k0 = 0; k0 < kv_end; k0 += kMBK) {
    __syncthreads();  // the previous tile's readers of sK/sVt are done
    for (int i = tid; i < kMBK * CH; i += kMNT) {
      const int r = i / CH, c = (i % CH) * kVec, s = k0 + r;
      *reinterpret_cast<uint4*>(sK + r * LD + c) =
          s < S ? *reinterpret_cast<const uint4*>(kb + s * k_ss + c) : zero;
    }
    // V: neighbouring lanes take neighbouring keys, so the transposed
    // stores of one column land in one shared-memory row
    for (int i = tid; i < kMBK * CH; i += kMNT) {
      const int r = i % kMBK, c = (i / kMBK) * kVec, s = k0 + r;
      const uint4 val = s < S ? *reinterpret_cast<const uint4*>(vb + s * v_ss + c) : zero;
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int j = 0; j < kVec; ++j) sVt[(c + j) * kVLD + r] = e[j];
    }
    __syncthreads();

    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const __nv_bfloat16* qa = sQ + (warp * 16 + g) * LD + kk * 16 + t * 2;
      const uint32_t a0 = ld_pair(qa), a1 = ld_pair(qa + 8 * LD);
      const uint32_t a2 = ld_pair(qa + 8), a3 = ld_pair(qa + 8 * LD + 8);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const __nv_bfloat16* kp = sK + (j * 8 + g) * LD + kk * 16 + t * 2;
        mma_bf16(sc[j], a0, a1, a2, a3, ld_pair(kp), ld_pair(kp + 8));
      }
    }

    // online softmax on the fragments: sc[j][0..1] are row0, sc[j][2..3] row1,
    // columns k0 + 8j + 2t + {0, 1}; a row's 4 lanes reduce by xor 1, 2
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + j * 8 + t * 2 + e;
        sc[j][e] = col <= row0 ? sc[j][e] * scale : kNegInf;
        sc[j][2 + e] = col <= row1 ? sc[j][2 + e] * scale : kNegInf;
        mx0 = fmaxf(mx0, sc[j][e]);
        mx1 = fmaxf(mx1, sc[j][2 + e]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = expf(m0 - mn0), c1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[j][e] = expf(sc[j][e] - mn0);
        sc[j][2 + e] = expf(sc[j][2 + e] - mn1);
        ps0 += sc[j][e];
        ps1 += sc[j][2 + e];
      }
    }
    l0 = l0 * c0 + ps0;
    l1 = l1 * c1 + ps1;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= c0;
      acc[n][1] *= c0;
      acc[n][2] *= c1;
      acc[n][3] *= c1;
    }

    // O += P V: P's fragments for keys 16kk..16kk+15 are the score
    // accumulators of n-tiles 2kk and 2kk+1
#pragma unroll
    for (int kk = 0; kk < kMBK / 16; ++kk) {
      const uint32_t a0 = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
      const uint32_t a1 = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
      const uint32_t a2 = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      const uint32_t a3 = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const __nv_bfloat16* vp = sVt + (n * 8 + g) * kVLD + kk * 16 + t * 2;
        mma_bf16(acc[n], a0, a1, a2, a3, ld_pair(vp), ld_pair(vp + 8));
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float d0 = l0 == 0.f ? 1.f : l0, d1 = l1 == 0.f ? 1.f : l1;
  __nv_bfloat16* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = n * 8 + t * 2;
    if (row0 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + row0 * o_ss + col) =
          __floats2bfloat162_rn(acc[n][0] / d0, acc[n][1] / d0);
    if (row1 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + row1 * o_ss + col) =
          __floats2bfloat162_rn(acc[n][2] / d1, acc[n][3] / d1);
  }
}

template <int D>
cudaError_t launch_flash_mma(const void* q, const void* k, const void* v, void* o, int B, int S,
                             int Hq, int Hkv, const long long* st, cudaStream_t stream) {
  auto kern = flash_fwd_mma_kernel<D>;
  const size_t smem = mma_smem_bytes<D>();
  static bool smem_set[kMaxDevices] = {};  // one per instantiation
  const cudaError_t err = allow_smem(kern, smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kMBQ - 1) / kMBQ, Hq, B);
  using bf16 = __nv_bfloat16;
  kern<<<grid, kMNT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), S, Hq / Hkv, 1.0f / sqrtf(static_cast<float>(D)),
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11]);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_flash(const void* q, const void* k, const void* v, void* o, int B, int S,
                         int Hq, int Hkv, const long long* st, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<D>;
  const size_t smem = flash_smem_bytes<D>();
  static bool smem_set[kMaxDevices] = {};  // one per instantiation
  const cudaError_t err = allow_smem(kern, smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  kern<<<grid, kNT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), S, Hq / Hkv, 1.0f / sqrtf(static_cast<float>(D)),
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11]);
  return cudaGetLastError();
}

cudaError_t dispatch_flash(int dtype, const void* q, const void* k, const void* v, void* o,
                           int B, int S, int Hq, int Hkv, int D, const long long* st,
                           cudaStream_t stream) {
  if (dtype == kF32) {
    switch (D) {
      case 16: return launch_flash<16>(q, k, v, o, B, S, Hq, Hkv, st, stream);
      case 32: return launch_flash<32>(q, k, v, o, B, S, Hq, Hkv, st, stream);
      case 64: return launch_flash<64>(q, k, v, o, B, S, Hq, Hkv, st, stream);
      case 128: return launch_flash<128>(q, k, v, o, B, S, Hq, Hkv, st, stream);
      case 256: return launch_flash<256>(q, k, v, o, B, S, Hq, Hkv, st, stream);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype == kBF16) {
    switch (D) {
      case 16: return launch_flash_mma<16>(q, k, v, o, B, S, Hq, Hkv, st, stream);
      case 32: return launch_flash_mma<32>(q, k, v, o, B, S, Hq, Hkv, st, stream);
      case 64: return launch_flash_mma<64>(q, k, v, o, B, S, Hq, Hkv, st, stream);
      case 128: return launch_flash_mma<128>(q, k, v, o, B, S, Hq, Hkv, st, stream);
      case 256: return launch_flash_mma<256>(q, k, v, o, B, S, Hq, Hkv, st, stream);
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro_torch

// q: (B,S,Hq,D), k/v: (B,S,Hkv,D), o: (B,S,Hq,D), each with unit stride on D
// and the (batch, seq, head) strides given in elements.  Returns the CUDA
// error of the launch (0 on success).
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int S, int Hq, int Hkv, int D,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, int dtype, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  const long long st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                            v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  return dispatch_flash(dtype, q, k, v, o, B, S, Hq, Hkv, D, st,
                        static_cast<cudaStream_t>(stream));
}
