// K4 (scan on pre-discretised inputs) and K3 (scan with the discretisation
// fused in): Mamba's selective scan, CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/ssm_scan.py:
//  * K4 _ssm_kernel (launched from ssm_scan_chunked):
//      h_t = dA_t * h_{t-1} + dBx_t,  y_t = <h_t, C_t>  (sum over the N states),
//    on dA, dBx (B,S,di,N) and C (B,S,N);
//  * K3 _ssm_fused_kernel (launched from ssm_scan_fused): the same recurrence
//    with the zero-order-hold discretisation done per step in registers,
//      dA_t = exp(delta_t * A),  dBx_t = delta_t * B_t * x_t,
//    from delta, x (B,S,di), B, C (B,S,N) and A (di,N).
// h starts at 0.  Everything is f32.  Outputs: y (B,S,di) and h_last (B,di,N).
//
// What bounds it on this card: K4 reads 2 B S di N floats and does ~4 FLOPs
// per element, so it is bound by memory (at hymba's serve prefill, B=1
// S=512 di=3200 N=16: ~216 MB, ~65 us at 3.35 TB/s).  K3 reads only
// O(B S (di + N)) floats (~20 MB there, ~6 us); what holds it up in this
// design is the chain of S dependent steps per channel, each with an exp.
//
// What the design does about the TPU original's choices:
//  * The TPU grid (B, n_chunks) walks the chunks in order and carries h in
//    VMEM scratch.  Here the di * N state channels are independent: one
//    thread owns one (b, d, n) channel and keeps h in a register, and a loop
//    over t replaces the sequential grid dimension.  Nothing is chunked, so
//    any S is taken as it is: no padding copies, no identity steps.
//  * The N lanes of an aligned group (N a power of two <= 32) hold one d
//    channel's states; y_t is a butterfly of warp shuffles inside the group
//    (those of T steps interleaved, as they do not depend on each other),
//    and the group's lane n = 0 stores it.
//  * Neighbouring threads read neighbouring (d, n) elements of dA/dBx, so a
//    warp's loads are coalesced (128 bytes a step).  In K3, delta_t and x_t are
//    the same address for the N lanes of a group (one broadcast load) and
//    B_t, C_t the same for every group (served from L1).
//  * The grid has B * di * N / 128 blocks (400 at the serve shape, ~3 per
//    SM), too few warps to hide memory latency one load at a time, so each
//    thread loads T steps ahead into registers before it computes them
//    (kScanT, kFusedT below).
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kNT = 128;     // threads per block: 128 / N d channels
// Timesteps loaded ahead into registers, from sweeps of 8..32 steps and of
// launch bounds at hymba's serve prefill on the card.  K4 is fastest at 8
// with 4 blocks an SM required (<= 128 registers: the grid's ~3 blocks an SM
// then run in one wave; without the bound ptxas keeps 56 registers and
// pipelines fewer loads).  K3 is fastest at 16 with no bound (243 registers):
// its exp and shuffle chains gain more from the registers than it loses to
// a second wave.
constexpr int kScanT = 8;
constexpr int kFusedT = 16;

// p[i] <- the sum of p[i] over the N lanes of this thread's aligned group, for
// T steps at once: the butterflies of the steps are independent, so they are
// interleaved.  Every lane of the warp calls it (dead lanes with p = 0), so the
// full mask holds.
template <int N, int T>
__device__ __forceinline__ void group_sums(float (&p)[T]) {
#pragma unroll
  for (int off = N / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < T; ++i) p[i] += __shfl_xor_sync(0xffffffffu, p[i], off);
  }
}

// The group's lane n = 0 stores y for the steps t0 .. t0 + T - 1 below S.
template <int T>
__device__ __forceinline__ void store_y(const float (&p)[T], float* y_p, int t0, int S, int Di,
                                        bool writer) {
  if (!writer) return;
#pragma unroll
  for (int i = 0; i < T; ++i)
    if (t0 + i < S) y_p[static_cast<long long>(t0 + i) * Di] = p[i];
}

template <int N>
__global__ void __launch_bounds__(kNT, 4) ssm_scan_kernel(
    const float* __restrict__ dA, const float* __restrict__ dBx, const float* __restrict__ C,
    float* __restrict__ y, float* __restrict__ h_last, int S, int Di, long long c_sb,
    long long c_st) {
  const int b = blockIdx.y;
  const int e = blockIdx.x * kNT + threadIdx.x;  // d * N + n
  const long long DN = static_cast<long long>(Di) * N;
  const bool live = e < DN;
  const int n = e & (N - 1), d = e / N;
  const float* a_p = dA + static_cast<long long>(b) * S * DN + e;
  const float* u_p = dBx + static_cast<long long>(b) * S * DN + e;
  const float* c_p = C + b * c_sb + n;
  float* y_p = y + static_cast<long long>(b) * S * Di + d;
  float h = 0.f;
  constexpr int T = kScanT;
  for (int t0 = 0; t0 < S; t0 += T) {
    float a[T], u[T], c[T];
#pragma unroll
    for (int i = 0; i < T; ++i) {
      const int t = t0 + i;
      const bool ok = live && t < S;  // a step past S is the identity
      a[i] = ok ? a_p[t * DN] : 1.f;
      u[i] = ok ? u_p[t * DN] : 0.f;
      c[i] = ok ? c_p[t * c_st] : 0.f;
    }
    float p[T];
#pragma unroll
    for (int i = 0; i < T; ++i) {
      h = fmaf(a[i], h, u[i]);
      p[i] = h * c[i];
    }
    group_sums<N, T>(p);
    store_y(p, y_p, t0, S, Di, live && n == 0);
  }
  if (live) h_last[b * DN + e] = h;
}

template <int N>
__global__ void __launch_bounds__(kNT) ssm_scan_fused_kernel(
    const float* __restrict__ delta, const float* __restrict__ Bm, const float* __restrict__ C,
    const float* __restrict__ x, const float* __restrict__ A, float* __restrict__ y,
    float* __restrict__ h_last, int S, int Di, long long dl_sb, long long dl_st, long long b_sb,
    long long b_st, long long c_sb, long long c_st, long long x_sb, long long x_st) {
  const int b = blockIdx.y;
  const int e = blockIdx.x * kNT + threadIdx.x;  // d * N + n
  const long long DN = static_cast<long long>(Di) * N;
  const bool live = e < DN;
  const int n = e & (N - 1), d = e / N;
  const float a_dn = live ? A[e] : 0.f;  // A is (di, N), contiguous
  const float* dl_p = delta + b * dl_sb + d;
  const float* x_p = x + b * x_sb + d;
  const float* b_p = Bm + b * b_sb + n;
  const float* c_p = C + b * c_sb + n;
  float* y_p = y + static_cast<long long>(b) * S * Di + d;
  float h = 0.f;
  constexpr int T = kFusedT;
  for (int t0 = 0; t0 < S; t0 += T) {
    float dl[T], xv[T], bv[T], cv[T];
#pragma unroll
    for (int i = 0; i < T; ++i) {
      const int t = t0 + i;
      const bool ok = live && t < S;  // delta = 0 is the identity step
      dl[i] = ok ? dl_p[t * dl_st] : 0.f;
      xv[i] = ok ? x_p[t * x_st] : 0.f;
      bv[i] = ok ? b_p[t * b_st] : 0.f;
      cv[i] = ok ? c_p[t * c_st] : 0.f;
    }
    float p[T];
#pragma unroll
    for (int i = 0; i < T; ++i) {
      // the products in the plain version's order: exp(delta * A), (delta * B) * x
      const float da = expf(dl[i] * a_dn);
      h = fmaf(da, h, dl[i] * bv[i] * xv[i]);
      p[i] = h * cv[i];
    }
    group_sums<N, T>(p);
    store_y(p, y_p, t0, S, Di, live && n == 0);
  }
  if (live) h_last[b * DN + e] = h;
}

dim3 scan_grid(int B, int Di, int N) {
  return dim3(static_cast<unsigned>((static_cast<long long>(Di) * N + kNT - 1) / kNT),
              static_cast<unsigned>(B));
}

bool bad_shape(int B, int S, int Di) {
  return B <= 0 || B > 65535 || S < 0 || Di <= 0 || static_cast<long long>(Di) * 32 > (1LL << 31) - 1;
}

template <int N>
cudaError_t launch_scan(const float* dA, const float* dBx, const float* C, float* y,
                        float* h_last, int B, int S, int Di, long long c_sb, long long c_st,
                        cudaStream_t stream) {
  ssm_scan_kernel<N><<<scan_grid(B, Di, N), kNT, 0, stream>>>(dA, dBx, C, y, h_last, S, Di,
                                                               c_sb, c_st);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_fused(const float* delta, const float* Bm, const float* C, const float* x,
                         const float* A, float* y, float* h_last, int B, int S, int Di,
                         const long long* st, cudaStream_t stream) {
  ssm_scan_fused_kernel<N><<<scan_grid(B, Di, N), kNT, 0, stream>>>(
      delta, Bm, C, x, A, y, h_last, S, Di, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7]);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// dA, dBx: (B,S,Di,N) f32, contiguous; C: (B,S,N) f32 with unit stride on N
// and (batch, seq) strides c_sb, c_st in elements; y: (B,S,Di) and h_last:
// (B,Di,N) f32, contiguous.  N is a power of two <= 32.  Returns the CUDA
// error of the launch (0 on success).
extern "C" int repro_ssm_scan_fwd(const void* dA, const void* dBx, const void* C, void* y,
                                  void* h_last, int B, int S, int Di, int N, long long c_sb,
                                  long long c_st, void* stream) {
  using namespace repro_torch;
  if (bad_shape(B, S, Di)) return cudaErrorInvalidValue;
  const auto a = static_cast<const float*>(dA);
  const auto u = static_cast<const float*>(dBx);
  const auto c = static_cast<const float*>(C);
  const auto yo = static_cast<float*>(y);
  const auto ho = static_cast<float*>(h_last);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 1: return launch_scan<1>(a, u, c, yo, ho, B, S, Di, c_sb, c_st, s);
    case 2: return launch_scan<2>(a, u, c, yo, ho, B, S, Di, c_sb, c_st, s);
    case 4: return launch_scan<4>(a, u, c, yo, ho, B, S, Di, c_sb, c_st, s);
    case 8: return launch_scan<8>(a, u, c, yo, ho, B, S, Di, c_sb, c_st, s);
    case 16: return launch_scan<16>(a, u, c, yo, ho, B, S, Di, c_sb, c_st, s);
    case 32: return launch_scan<32>(a, u, c, yo, ho, B, S, Di, c_sb, c_st, s);
    default: return cudaErrorInvalidValue;
  }
}

// delta, x: (B,S,Di) f32 with unit stride on Di; Bm, C: (B,S,N) f32 with unit
// stride on N; each with its (batch, seq) strides in elements.  A: (Di,N)
// f32, contiguous.  y: (B,S,Di) and h_last: (B,Di,N) f32, contiguous.  N is a
// power of two <= 32.  Returns the CUDA error of the launch (0 on success).
extern "C" int repro_ssm_scan_fused_fwd(
    const void* delta, const void* Bm, const void* C, const void* x, const void* A, void* y,
    void* h_last, int B, int S, int Di, int N, long long dl_sb, long long dl_st, long long b_sb,
    long long b_st, long long c_sb, long long c_st, long long x_sb, long long x_st,
    void* stream) {
  using namespace repro_torch;
  if (bad_shape(B, S, Di)) return cudaErrorInvalidValue;
  const long long st[8] = {dl_sb, dl_st, b_sb, b_st, c_sb, c_st, x_sb, x_st};
  const auto dl = static_cast<const float*>(delta);
  const auto bm = static_cast<const float*>(Bm);
  const auto c = static_cast<const float*>(C);
  const auto xv = static_cast<const float*>(x);
  const auto a = static_cast<const float*>(A);
  const auto yo = static_cast<float*>(y);
  const auto ho = static_cast<float*>(h_last);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 1: return launch_fused<1>(dl, bm, c, xv, a, yo, ho, B, S, Di, st, s);
    case 2: return launch_fused<2>(dl, bm, c, xv, a, yo, ho, B, S, Di, st, s);
    case 4: return launch_fused<4>(dl, bm, c, xv, a, yo, ho, B, S, Di, st, s);
    case 8: return launch_fused<8>(dl, bm, c, xv, a, yo, ho, B, S, Di, st, s);
    case 16: return launch_fused<16>(dl, bm, c, xv, a, yo, ho, B, S, Di, st, s);
    case 32: return launch_fused<32>(dl, bm, c, xv, a, yo, ho, B, S, Di, st, s);
    default: return cudaErrorInvalidValue;
  }
}
