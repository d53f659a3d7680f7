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
// bf16, so it is bound by memory.  At the serve shapes it moves only 2-4 MB,
// which the card streams in about a microsecond: what it takes beyond that
// is latency (chains of dependent loads, barriers, launches), so the design
// aims at many independent loads in flight and few steps in series.  The TPU
// grid gives only B * Hkv programs (8 for gemma, whose Hkv = 1), which would
// leave most of the 132 SMs idle, so both paths split the slots over blocks
// (flash-decoding) and merge the partials.  Two paths, picked by dtype:
//  * bf16 (serving): decode_bf16_kernel below.  16-byte cp.async loads into
//    a ring of 3-4 stages; products on tensor cores from registers
//    (mma.sync, the G heads padded to 16 rows); P is rounded to bf16 before
//    P V (every sum stays in f32: the JAX kernel keeps P in f32); a second
//    grid merges the partials, a block per (b, q head).
//  * f32 (parity runs): the first design, whose per-tile arithmetic the
//    parity runs are held to.  Each block streams its range in 32-slot
//    tiles through an f32 staging copy in shared memory with an online
//    softmax on CUDA cores and writes a partial (m, l, acc) in f32 to
//    scratch; decode_combine_kernel, a second grid, merges them.
// Both paths:
//  * The host picks n_split from (B, Hkv, SM count) alone; each block reads
//    lengths[b] itself (replaces the SMEM scalar prefetch) and takes the
//    slots [sp * c, min((sp + 1) * c, len)), c = ceil(len / n_split), len =
//    lengths[b] clamped to [0, M] (split_range in decode_attention.py), so
//    every block of a row with len >= n_split has work whatever M is.
//    A split with no valid slot loads nothing and writes l = 0, which the
//    merge skips.  Slots past lengths[b] are never read, so NaN left in
//    stale slots cannot reach the output (no NaN is multiplied by 0).
//  * The cache is read in place in the model's (B, M, Hkv, D) layout through
//    strides: no per-token transpose or padding copy of the cache.
#include "common.cuh"
#include "hopper.cuh"

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
    float* __restrict__ part_acc, int M, int G, float scale, long long q_sb, long long q_sh,
    long long k_sb, long long k_sm, long long k_sh, long long v_sb, long long v_sm,
    long long v_sh) {
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
  const int len = max(0, min(lengths[b], M));
  const int chunk = (len + n_split - 1) / n_split;  // split_range in decode_attention.py
  const int start = min(sp * chunk, len);
  const int end = min(start + chunk, len);
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
                          int Hq, int Hkv, int n_split, const long long* st,
                          cudaStream_t stream) {
  const int G = Hq / Hkv;
  auto kern = decode_split_kernel<T, D>;
  const size_t smem = split_smem_bytes(G, D);
  static bool smem_set[kMaxDevices] = {};  // one per instantiation
  cudaError_t err = allow_smem(kern, split_smem_bytes(kGMax, D), smem_set);  // any G fits
  if (err != cudaSuccess) return err;
  kern<<<dim3(B, Hkv, n_split), kNT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lengths,
      part_m, part_l, part_acc, M, G, 1.0f / sqrtf(static_cast<float>(D)),
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int combine_threads = D < 128 ? D : 128;
  decode_combine_kernel<T><<<B * Hq, combine_threads, 0, stream>>>(
      part_m, part_l, part_acc, static_cast<T*>(o), Hq, n_split, D, st[8], st[9]);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// ---------------------------------------------------------------------------
// bf16 (serving): split by the valid length, cp.async ring, mma.sync from
// registers, a one-pass combine grid
// ---------------------------------------------------------------------------
//
// Grid (n_split, Hkv, B), 128 threads.  Block sp of (b, kv head h) takes
// its slots as above.  They stream through shared memory in 32-slot
// tiles of K and V: 16-byte cp.async per thread, zero-filled past
// the block's last slot (nothing past it is read), rows padded by 16 bytes so
// that the fragment loads below are free of bank conflicts (a row of 2D + 16
// bytes starts 4 banks further on, 20 at D = 96: the 8 rows of a fragment
// load land in 8 different 4-bank groups).  The ring has 3 stages at D = 256
// and 4 below (111 KB at D = 192), so a block's tiles (2-3 at the serve
// shapes) are all in flight at once.
//  * Scores: the G query heads are padded to the 16 rows of an mma.sync
//    m16n8k16; warp w computes the 8 slots 8w..8w+7 of the tile over all of
//    D (A = Q's fragments, loaded once into registers; B = K rows as they
//    are; two independent chains of products) into a 16 x 32 f32 score tile
//    in shared memory, scaled by log2(e) / sqrt(D).
//  * Online softmax in base 2 (ex2.approx): every warp reads the whole score
//    tile as the A fragments of P V and runs the same softmax on them
//    (identical arithmetic, so the warps agree); P is rounded to bf16.
//  * O += P V: warp w owns the 8-column n-tiles w, w + 4, ... of D; V's B
//    fragments come from the row-major tile by ldmatrix.trans.
//  * Each block writes its (m, l, acc) partial for its G heads (an empty
//    block writes l = 0 and no acc); decode_bf16_combine_kernel merges them.
//    A merge fused into this grid (the last block of each (b, kv head),
//    found by an atomic ticket) was slower at gemma's shape: one SM read
//    every split's G x D accumulator (128 KB for 16 splits).

constexpr int kDTS = 32;      // cache slots per tile: one 8-slot score n-tile per warp
constexpr int kDNT = 128;     // 4 warps
constexpr int kDRows = 16;    // query heads padded to one mma M

template <int D>
struct DecodeSmem {
  static constexpr int NST = D == 256 ? 3 : 4;  // ring stages
  static constexpr int LD = D + 8;          // bf16 row stride of Q, K and V tiles
  static constexpr int LDS = kDTS + 4;      // f32 row stride of the score tile
  static constexpr size_t kBytes =
      sizeof(__nv_bfloat16) * (size_t(kDRows) * LD + 2 * size_t(NST) * kDTS * LD) +
      sizeof(float) * size_t(kDRows) * LDS;
};

template <int D>
__global__ void __launch_bounds__(kDNT) decode_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ lengths,
    float* __restrict__ part_m, float* __restrict__ part_l, float* __restrict__ part_acc, int M,
    int G, float scale, long long q_sb, long long q_sh, long long k_sb, long long k_sm,
    long long k_sh, long long v_sb, long long v_sm, long long v_sh) {
  using Smem = DecodeSmem<D>;
  constexpr int LD = Smem::LD, LDS = Smem::LDS, NST = Smem::NST;
  constexpr int CH = D / 8;            // 16-byte chunks per row
  constexpr int NTD = D / 8;           // 8-column n-tiles over D
  constexpr int NPW = (NTD + 3) / 4;   // of them per warp
  constexpr int TILE = kDTS * LD;      // bf16 elements of one K or V tile
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);     // kDRows x LD
  bf16* sK = sQ + kDRows * LD;                        // NST stages x TILE
  bf16* sV = sK + NST * TILE;                         // NST stages x TILE
  float* sS = reinterpret_cast<float*>(sV + NST * TILE);  // kDRows x LDS

  const int sp = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x, Hkv = gridDim.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  {  // Q needs no length: its loads go out first and join tile 0's group
    const bf16* qb = q + b * q_sb + (h * G) * q_sh;
    for (int i = tid; i < kDRows * CH; i += kDNT) {
      const int r = i / CH, c = (i % CH) * 8;
      cp_async_16(sQ + r * LD + c, qb + (r < G ? r * q_sh : 0) + c, r < G ? 16 : 0);
    }
  }
  const int len = max(0, min(lengths[b], M));
  const int chunk = (len + n_split - 1) / n_split;  // split_range in decode_attention.py
  const int start = min(sp * chunk, len);
  const int end = min(start + chunk, len);
  const long long grp = static_cast<long long>(b) * Hkv + h;
  const long long row_base = (grp * n_split + sp) * G;  // this block's partial rows

  const bf16* kb = k + b * k_sb + h * k_sh;
  const bf16* vb = v + b * v_sb + h * v_sh;
  float acc[NPW][4];
#pragma unroll
  for (int jj = 0; jj < NPW; ++jj) acc[jj][0] = acc[jj][1] = acc[jj][2] = acc[jj][3] = 0.f;
  // rows g and g + 8; m in base-2 units (max score x scale x log2(e))
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  const float scale_log2 = scale * 1.4426950408889634f;
  uint32_t qf[D / 16][4];  // Q's A fragments

  // K and V rows [t0, t0 + kDTS) into stage st as one commit group; rows at
  // or past `end` are zero-filled without a read, and a tile wholly past it
  // commits an empty group (so every iteration waits for the same count)
  auto load_tile = [&](int t0, int st) {
    for (int i = tid; i < (t0 < end ? 2 * kDTS * CH : 0); i += kDNT) {
      const int which = i / (kDTS * CH), r = (i / CH) % kDTS, c = (i % CH) * 8;
      const int s = t0 + r;
      const bool ok = s < end;
      const bf16* src = which ? vb + (ok ? s * v_sm : 0) + c : kb + (ok ? s * k_sm : 0) + c;
      cp_async_16((which ? sV : sK) + st * TILE + r * LD + c, src, ok ? 16 : 0);
    }
    cp_async_commit();
  };

  if (start >= end) {
    cp_async_wait_all();  // Q's loads, not needed
  } else {
    load_tile(start, 0);  // one group: Q and the first tile
#pragma unroll
    for (int j = 1; j < NST - 1; ++j) load_tile(start + j * kDTS, j);
    const int n_tiles = (end - start + kDTS - 1) / kDTS;
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % NST, t0 = start + j * kDTS;
      cp_async_wait<NST - 2>();  // the group of tile j is in
      __syncthreads();  // tile j visible to all; every warp is done with tile j - 1
      load_tile(t0 + (NST - 1) * kDTS, (j + NST - 1) % NST);  // into tile j - 1's stage
      if (j == 0) {  // Q's A fragments, kept in registers for every tile
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const bf16* qa = sQ + g * LD + kk * 16 + t * 2;
          qf[kk][0] = ld_pair(qa);
          qf[kk][1] = ld_pair(qa + 8 * LD);
          qf[kk][2] = ld_pair(qa + 8);
          qf[kk][3] = ld_pair(qa + 8 * LD + 8);
        }
      }

      // scores of slots 8 warp .. 8 warp + 7, all 16 rows, in two
      // independent chains of products (even and odd k-steps)
      const bf16* tk = sK + st * TILE + (warp * 8 + g) * LD + t * 2;
      float c4[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_bf16(c4[kk & 1], qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3], ld_pair(tk + kk * 16),
                 ld_pair(tk + kk * 16 + 8));
      const int n = warp * 8 + t * 2;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = t0 + n + e < end;
        sS[g * LDS + n + e] = ok ? (c4[0][e] + c4[1][e]) * scale_log2 : kNegInf;
        sS[(g + 8) * LDS + n + e] = ok ? (c4[0][2 + e] + c4[1][2 + e]) * scale_log2 : kNegInf;
      }
      __syncthreads();  // the score tile is complete

      // online softmax in base 2 on P's A fragments: x[kk][0..3] row g,
      // x[kk][4..7] row g + 8, slots 16kk + {2t, 2t+1, 2t+8, 2t+9}
      float x[2][8];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = kk * 16 + hf * 8 + t * 2 + e;
            x[kk][hf * 2 + e] = sS[g * LDS + col];
            x[kk][4 + hf * 2 + e] = sS[(g + 8) * LDS + col];
          }
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          mx0 = fmaxf(mx0, x[kk][i]);
          mx1 = fmaxf(mx1, x[kk][4 + i]);
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float c0 = exp2_approx(m0 - mn0), c1 = exp2_approx(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          x[kk][i] = exp2_approx(x[kk][i] - mn0);
          x[kk][4 + i] = exp2_approx(x[kk][4 + i] - mn1);
          ps0 += x[kk][i];
          ps1 += x[kk][4 + i];
        }
      l0 = l0 * c0 + ps0;
      l1 = l1 * c1 + ps1;
#pragma unroll
      for (int jj = 0; jj < NPW; ++jj) {
        acc[jj][0] *= c0;
        acc[jj][1] *= c0;
        acc[jj][2] *= c1;
        acc[jj][3] *= c1;
      }
      const bf16* tv = sV + st * TILE;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint32_t a0 = pack_bf16(x[kk][0], x[kk][1]), a1 = pack_bf16(x[kk][4], x[kk][5]);
        const uint32_t a2 = pack_bf16(x[kk][2], x[kk][3]), a3 = pack_bf16(x[kk][6], x[kk][7]);
#pragma unroll
        for (int jj = 0; jj < NPW; ++jj) {
          const int nt = warp + 4 * jj;
          if (nt < NTD) {
            uint32_t b0, b1;
            ldmatrix_x2_trans(b0, b1, tv + (kk * 16 + (lane & 15)) * LD + nt * 8);
            mma_bf16(acc[jj], a0, a1, a2, a3, b0, b1);
          }
        }
      }
    }
  }

  // this block's partial: (m, l) from warp 0, acc from every warp's columns
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  if (warp == 0 && t == 0) {
    if (g < G) {
      part_m[row_base + g] = m0;
      part_l[row_base + g] = l0;
    }
    if (g + 8 < G) {
      part_m[row_base + g + 8] = m1;
      part_l[row_base + g + 8] = l1;
    }
  }
  if (start >= end) return;  // l = 0: the combine reads nothing else of this split
#pragma unroll
  for (int jj = 0; jj < NPW; ++jj) {
    const int nt = warp + 4 * jj;
    if (nt < NTD) {
      const int col = nt * 8 + t * 2;
      if (g < G)
        *reinterpret_cast<float2*>(part_acc + (row_base + g) * D + col) =
            make_float2(acc[jj][0], acc[jj][1]);
      if (g + 8 < G)
        *reinterpret_cast<float2*>(part_acc + (row_base + g + 8) * D + col) =
            make_float2(acc[jj][2], acc[jj][3]);
    }
  }
}

// One block per (b, q head), a thread per 4 columns of D: out = sum_s w_s
// acc_s / sum_s w_s l_s with w_s = 2^(m_s - max m) over the splits with
// l_s > 0 (a row with none gives 0), in one pass with a running max, so a
// thread's loads of every split are independent and all in flight at once.
template <int D>
__global__ void decode_bf16_combine_kernel(const float* __restrict__ part_m,
                                           const float* __restrict__ part_l,
                                           const float* __restrict__ part_acc,
                                           __nv_bfloat16* __restrict__ o, int Hq, int G,
                                           int n_split, long long o_sb, long long o_sh) {
  const int hq = blockIdx.x % Hq, b = blockIdx.x / Hq;
  const int c = threadIdx.x * 4;
  if (c >= D) return;
  const int Hkv = Hq / G, h = hq / G, gg = hq % G;
  // partial rows ((b * Hkv + h) * n_split + s) * G + gg, split s at stride G
  const long long r0 = (static_cast<long long>(b) * Hkv + h) * n_split * G + gg;
  float mx = kNegInf, den = 0.f;
  float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
  for (int s = 0; s < n_split; ++s) {
    const long long r = r0 + static_cast<long long>(s) * G;
    const float l = __ldg(part_l + r), m = __ldg(part_m + r);
    const float4 a = __ldg(reinterpret_cast<const float4*>(part_acc + r * D + c));
    if (l > 0.f) {  // a split that saw no slot wrote l = 0 and nothing else
      const float mn = fmaxf(mx, m);
      const float sc = exp2_approx(mx - mn), w = exp2_approx(m - mn);
      mx = mn;
      den = den * sc + w * l;
      num.x = num.x * sc + w * a.x;
      num.y = num.y * sc + w * a.y;
      num.z = num.z * sc + w * a.z;
      num.w = num.w * sc + w * a.w;
    }
  }
  const float inv = 1.f / (den == 0.f ? 1.f : den);
  const __nv_bfloat162 lo = __floats2bfloat162_rn(num.x * inv, num.y * inv);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(num.z * inv, num.w * inv);
  uint2 packed;
  packed.x = *reinterpret_cast<const uint32_t*>(&lo);
  packed.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(o + b * o_sb + hq * o_sh + c) = packed;
}

template <int D>
cudaError_t launch_decode_bf16(const void* q, const void* k, const void* v, const int* lengths,
                               float* part_m, float* part_l, float* part_acc, void* o, int B,
                               int M, int Hq, int Hkv, int n_split, const long long* st,
                               cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  auto kern = decode_bf16_kernel<D>;
  const size_t smem = DecodeSmem<D>::kBytes;
  static bool smem_set[kMaxDevices] = {};  // one per instantiation
  cudaError_t err = allow_smem(kern, smem, smem_set);
  if (err != cudaSuccess) return err;
  kern<<<dim3(n_split, Hkv, B), kDNT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      lengths, part_m, part_l, part_acc, M, Hq / Hkv, 1.0f / sqrtf(static_cast<float>(D)),
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int threads = D / 4 < 32 ? 32 : D / 4;
  decode_bf16_combine_kernel<D><<<B * Hq, threads, 0, stream>>>(
      part_m, part_l, part_acc, static_cast<bf16*>(o), Hq, Hq / Hkv, n_split, st[8], st[9]);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_decode(const void* q, const void* k, const void* v, const int* lengths,
                            float* pm, float* pl, float* pa, void* o, int B, int M, int Hq,
                            int Hkv, int D, int n_split, const long long* st, cudaStream_t s) {
  switch (D) {
    case 16: return launch_decode<T, 16>(q, k, v, lengths, pm, pl, pa, o, B, M, Hq, Hkv, n_split, st, s);
    case 32: return launch_decode<T, 32>(q, k, v, lengths, pm, pl, pa, o, B, M, Hq, Hkv, n_split, st, s);
    case 64: return launch_decode<T, 64>(q, k, v, lengths, pm, pl, pa, o, B, M, Hq, Hkv, n_split, st, s);
    case 96: return launch_decode<T, 96>(q, k, v, lengths, pm, pl, pa, o, B, M, Hq, Hkv, n_split, st, s);
    case 128: return launch_decode<T, 128>(q, k, v, lengths, pm, pl, pa, o, B, M, Hq, Hkv, n_split, st, s);
    case 192: return launch_decode<T, 192>(q, k, v, lengths, pm, pl, pa, o, B, M, Hq, Hkv, n_split, st, s);
    case 256: return launch_decode<T, 256>(q, k, v, lengths, pm, pl, pa, o, B, M, Hq, Hkv, n_split, st, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// q: (B,1,Hq,D) through strides (q_sb, q_sh); k/v: (B,M,Hkv,D) through
// strides (sb, sm, sh); lengths: (B,) int32; o: (B,1,Hq,D) through (o_sb,
// o_sh); each with unit stride on D.  part_m/part_l: (B,Hq,n_split) f32 and
// part_acc: (B,Hq,n_split,D) f32 scratch.  The splits are sized from
// lengths on the device.  Two grids, split and combine.  Returns the CUDA
// error of the launches.
extern "C" int repro_decode_attention_fwd(
    const void* q, const void* k, const void* v, const void* lengths, void* part_m,
    void* part_l, void* part_acc, void* o, int B, int M, int Hq, int Hkv, int D, int n_split,
    long long q_sb, long long q_sh, long long k_sb, long long k_sm, long long k_sh,
    long long v_sb, long long v_sm, long long v_sh, long long o_sb, long long o_sh, int dtype,
    void* stream) {
  using namespace repro_torch;
  if (B <= 0 || M <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kGMax || n_split <= 0 ||
      n_split > 65535)
    return cudaErrorInvalidValue;
  const long long st[10] = {q_sb, q_sh, k_sb, k_sm, k_sh, v_sb, v_sm, v_sh, o_sb, o_sh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  if (dtype == kF32)
    return dispatch_decode<float>(q, k, v, len, pm, pl, pa, o, B, M, Hq, Hkv, D, n_split, st, s);
  if (dtype == kBF16) {
    switch (D) {
      case 16: return launch_decode_bf16<16>(q, k, v, len, pm, pl, pa, o, B, M, Hq, Hkv, n_split, st, s);
      case 32: return launch_decode_bf16<32>(q, k, v, len, pm, pl, pa, o, B, M, Hq, Hkv, n_split, st, s);
      case 64: return launch_decode_bf16<64>(q, k, v, len, pm, pl, pa, o, B, M, Hq, Hkv, n_split, st, s);
      case 96: return launch_decode_bf16<96>(q, k, v, len, pm, pl, pa, o, B, M, Hq, Hkv, n_split, st, s);
      case 128: return launch_decode_bf16<128>(q, k, v, len, pm, pl, pa, o, B, M, Hq, Hkv, n_split, st, s);
      case 192: return launch_decode_bf16<192>(q, k, v, len, pm, pl, pa, o, B, M, Hq, Hkv, n_split, st, s);
      case 256: return launch_decode_bf16<256>(q, k, v, len, pm, pl, pa, o, B, M, Hq, Hkv, n_split, st, s);
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}
