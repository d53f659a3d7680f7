// K2: flash decode (one query token per sequence against the KV cache),
// CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
// (_decode_kernel, launched from decode_attention_bhd).
//
// What it computes: for every (b, q-head), softmax over cache slots
// j < lengths[b] of q . k_j / sqrt(D), times v_j; the G = Hq / Hkv query heads
// of a KV head share each cache tile.  f32 accumulation, -1e30 masking,
// l == 0 -> 1, output in q's dtype.
//
// What bounds it on this card: it reads every valid K/V byte once and does
// ~4 G D FLOPs per slot, far below the card's ~295 FLOP/byte balance point in
// bf16, so it is bound by memory bandwidth.  The TPU grid gives only
// B * Hkv programs (8 for gemma, whose Hkv = 1), which would leave most of the
// 132 SMs idle, so:
//  * Flash-decoding: the grid is (B, Hkv, n_split).  Each block streams its
//    range of slots in 32-slot tiles through shared memory with an online
//    softmax and writes a partial (m, l, acc) in f32 to scratch the wrapper
//    allocates; decode_combine_kernel merges the partials.
//  * Each block reads lengths[b] itself (replaces the SMEM scalar prefetch).
//    A split wholly past lengths[b] loads nothing and writes l = 0, which the
//    combine skips.  Slots past lengths[b] are never read, so NaN left in
//    stale slots cannot reach the output (no NaN is multiplied by 0).
//  * The cache is read in place in the model's (B, M, Hkv, D) layout through
//    strides: no per-token transpose or padding copy of the cache.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kBN = 32;    // cache slots per tile (one per lane in the row pass)
constexpr int kNT = 128;   // threads per split block
constexpr int kGMax = 16;  // most query heads per KV head

size_t split_smem_bytes(int G, int D) {
  return sizeof(float) *
         (size_t(G) * D + size_t(kBN) * (D + 1) + size_t(kBN) * D + size_t(G) * kBN + 3 * size_t(G));
}

template <typename T, int D>
__global__ void __launch_bounds__(kNT) decode_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ lengths, float* __restrict__ part_m, float* __restrict__ part_l,
    float* __restrict__ part_acc, int M, int G, int split_len, float scale,
    long long q_sb, long long q_sh, long long k_sb, long long k_sm, long long k_sh,
    long long v_sb, long long v_sm, long long v_sh) {
  constexpr int LD = D + 1;
  constexpr int PAIRS = kGMax * D / kNT;  // (head, column) accumulators per thread
  extern __shared__ float smem[];
  float* sQ = smem;              // G x D
  float* sK = sQ + G * D;        // kBN x LD
  float* sV = sK + kBN * LD;     // kBN x D
  float* sS = sV + kBN * D;      // G x kBN scores, then probabilities
  float* sM = sS + G * kBN;      // running max per head
  float* sL = sM + G;            // running denominator per head
  float* sC = sL + G;            // this tile's rescale factor per head

  const int b = blockIdx.x, h = blockIdx.y, sp = blockIdx.z;
  const int Hq = gridDim.y * G, n_split = gridDim.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = min(lengths[b], M);
  const int start = sp * split_len;
  const int end = min(start + split_len, len);
  const long long part0 = (static_cast<long long>(b) * Hq + h * G) * n_split + sp;

  if (end <= start) {  // wholly past lengths[b]: load nothing
    for (int g = tid; g < G; g += kNT) {
      part_m[part0 + g * n_split] = kNegInf;
      part_l[part0 + g * n_split] = 0.f;
    }
    return;
  }

  const T* qb = q + b * q_sb + (h * G) * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  for (int i = tid; i < G * D; i += kNT) sQ[i] = to_f32(qb[(i / D) * q_sh + i % D]);
  for (int g = tid; g < G; g += kNT) {
    sM[g] = kNegInf;
    sL[g] = 0.f;
  }
  float acc[PAIRS];
#pragma unroll
  for (int pi = 0; pi < PAIRS; ++pi) acc[pi] = 0.f;

  for (int t0 = start; t0 < end; t0 += kBN) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBN * D; i += kNT) {
      const int r = i / D, c = i % D, s = t0 + r;
      const bool ok = s < end;  // slots past the split or past lengths[b] stay unread
      sK[r * LD + c] = ok ? to_f32(kb[s * k_sm + c]) : 0.f;
      sV[r * D + c] = ok ? to_f32(vb[s * v_sm + c]) : 0.f;
    }
    __syncthreads();

    for (int i = tid; i < G * kBN; i += kNT) {
      const int g = i / kBN, n = i % kBN;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(sQ[g * D + d], sK[n * LD + d], s);
      sS[i] = t0 + n < end ? s * scale : kNegInf;
    }
    __syncthreads();

    for (int g = warp; g < G; g += kNT / 32) {
      const float s = sS[g * kBN + lane];
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = sM[g];
      const float m_new = fmaxf(m_old, mx);
      const float p = expf(s - m_new);
      sS[g * kBN + lane] = p;
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        sC[g] = corr;
        sL[g] = sL[g] * corr + sum;
        sM[g] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int pi = 0; pi < PAIRS; ++pi) {
      const int i = tid + pi * kNT;
      if (i < G * D) {
        const int g = i / D, c = i % D;
        float a = acc[pi] * sC[g];
#pragma unroll 8
        for (int n = 0; n < kBN; ++n) a = fmaf(sS[g * kBN + n], sV[n * D + c], a);
        acc[pi] = a;
      }
    }
  }

#pragma unroll
  for (int pi = 0; pi < PAIRS; ++pi) {
    const int i = tid + pi * kNT;
    if (i < G * D) part_acc[(part0 + (i / D) * n_split) * D + i % D] = acc[pi];
  }
  for (int g = tid; g < G; g += kNT) {
    part_m[part0 + g * n_split] = sM[g];
    part_l[part0 + g * n_split] = sL[g];
  }
}

// One block per (b, q-head): out = sum_s w_s acc_s / sum_s w_s l_s with
// w_s = exp(m_s - max m) over the splits that saw at least one slot.
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ part_m,
                                      const float* __restrict__ part_l,
                                      const float* __restrict__ part_acc, T* __restrict__ o,
                                      int Hq, int n_split, int D, long long o_sb, long long o_sh) {
  const int bh = blockIdx.x;
  const int b = bh / Hq, hq = bh % Hq;
  const float* pm = part_m + static_cast<long long>(bh) * n_split;
  const float* pl = part_l + static_cast<long long>(bh) * n_split;
  const float* pa = part_acc + static_cast<long long>(bh) * n_split * D;
  float mx = kNegInf;
  for (int s = 0; s < n_split; ++s)
    if (pl[s] > 0.f) mx = fmaxf(mx, pm[s]);
  float den = 0.f;
  for (int s = 0; s < n_split; ++s)
    if (pl[s] > 0.f) den += expf(pm[s] - mx) * pl[s];
  if (den == 0.f) den = 1.f;
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    float num = 0.f;
    for (int s = 0; s < n_split; ++s)
      if (pl[s] > 0.f) num += expf(pm[s] - mx) * pa[static_cast<long long>(s) * D + c];
    o[b * o_sb + hq * o_sh + c] = from_f32<T>(num / den);
  }
}

template <typename T, int D>
cudaError_t launch_decode(const void* q, const void* k, const void* v, const int* lengths,
                          float* part_m, float* part_l, float* part_acc, void* o, int B, int M,
                          int Hq, int Hkv, int split_len, int n_split, const long long* st,
                          cudaStream_t stream) {
  const int G = Hq / Hkv;
  auto kern = decode_split_kernel<T, D>;
  const size_t smem = split_smem_bytes(G, D);
  static bool smem_set[kMaxDevices] = {};  // one per instantiation
  cudaError_t err = allow_smem(kern, split_smem_bytes(kGMax, D), smem_set);  // any G fits
  if (err != cudaSuccess) return err;
  kern<<<dim3(B, Hkv, n_split), kNT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lengths,
      part_m, part_l, part_acc, M, G, split_len, 1.0f / sqrtf(static_cast<float>(D)),
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int combine_threads = D < 128 ? D : 128;
  decode_combine_kernel<T><<<B * Hq, combine_threads, 0, stream>>>(
      part_m, part_l, part_acc, static_cast<T*>(o), Hq, n_split, D, st[8], st[9]);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_decode(const void* q, const void* k, const void* v, const int* lengths,
                            float* pm, float* pl, float* pa, void* o, int B, int M, int Hq,
                            int Hkv, int D, int split_len, int n_split, const long long* st,
                            cudaStream_t s) {
  switch (D) {
    case 16: return launch_decode<T, 16>(q, k, v, lengths, pm, pl, pa, o, B, M, Hq, Hkv, split_len, n_split, st, s);
    case 32: return launch_decode<T, 32>(q, k, v, lengths, pm, pl, pa, o, B, M, Hq, Hkv, split_len, n_split, st, s);
    case 64: return launch_decode<T, 64>(q, k, v, lengths, pm, pl, pa, o, B, M, Hq, Hkv, split_len, n_split, st, s);
    case 128: return launch_decode<T, 128>(q, k, v, lengths, pm, pl, pa, o, B, M, Hq, Hkv, split_len, n_split, st, s);
    case 256: return launch_decode<T, 256>(q, k, v, lengths, pm, pl, pa, o, B, M, Hq, Hkv, split_len, n_split, st, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// q: (B,1,Hq,D) through strides (q_sb, q_sh); k/v: (B,M,Hkv,D) through
// strides (sb, sm, sh); lengths: (B,) int32; o: (B,1,Hq,D) through (o_sb,
// o_sh); each with unit stride on D.  part_m/part_l: (B,Hq,n_split) f32 and
// part_acc: (B,Hq,n_split,D) f32 scratch.  Splits are split_len slots wide,
// n_split * split_len >= M.  Returns the CUDA error of the launches.
extern "C" int repro_decode_attention_fwd(
    const void* q, const void* k, const void* v, const void* lengths, void* part_m,
    void* part_l, void* part_acc, void* o, int B, int M, int Hq, int Hkv, int D, int split_len,
    int n_split, long long q_sb, long long q_sh, long long k_sb, long long k_sm, long long k_sh,
    long long v_sb, long long v_sm, long long v_sh, long long o_sb, long long o_sh, int dtype,
    void* stream) {
  using namespace repro_torch;
  if (B <= 0 || M <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kGMax || split_len <= 0 ||
      n_split <= 0 || static_cast<long long>(split_len) * n_split < M)
    return cudaErrorInvalidValue;
  const long long st[10] = {q_sb, q_sh, k_sb, k_sm, k_sh, v_sb, v_sm, v_sh, o_sb, o_sh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  if (dtype == kF32)
    return dispatch_decode<float>(q, k, v, len, pm, pl, pa, o, B, M, Hq, Hkv, D, split_len, n_split, st, s);
  if (dtype == kBF16)
    return dispatch_decode<__nv_bfloat16>(q, k, v, len, pm, pl, pa, o, B, M, Hq, Hkv, D, split_len, n_split, st, s);
  return cudaErrorInvalidValue;
}
