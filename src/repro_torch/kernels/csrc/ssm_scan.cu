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
// What bounds it on this card:
//  * K4 reads 2 B S di N floats and does ~4 FLOPs per element, so it is
//    bound by memory (at hymba's serve prefill, B=1 S=512 di=3200 N=16:
//    ~216 MB, ~65 us at 3.35 TB/s).  One thread owns one (b, d, n) channel
//    and walks all of S with h in a register; the N lanes of an aligned
//    group (N a power of two <= 32) hold one d channel's states and sum y_t
//    by warp shuffles; the grid (B * di * N / 128 blocks, ~3 an SM) is too
//    small to hide memory latency one load at a time, so each thread loads
//    kScanT steps ahead into registers.
//  * K3 reads only O(B S (di + N)) floats (~20 MB there, ~6 us) but takes an
//    exp per (b, t, d, n): 26.2 M there, which the SFU (MUFU.EX2, 16 a clock
//    an SM) needs ~6.3 us for, with 3-4 FMA-pipe operations beside each.
//    So K3 is bound by operations, on the SFU first.
//
// K3's design, a chunked scan (the plan and its carry order are written
// once, in Python, as kernels/ssm_scan.py::scan_chunks):
//  * S is cut into chunks of kL = 32 steps counted from t = 0, whatever S
//    is.  A block holds Dt channels x W chunks (a window of W kL <= 512
//    steps) and walks S window by window; thread (w, dd, g) owns 8 of the
//    N states of channel dd in chunk w (N = 16: two adjacent lanes a
//    channel, for 25 warps an SM), h and A log2 e in registers.
//  * Pass 1 scans each chunk from h = 0 (the exp is ex2.approx of
//    delta_t (A log2 e)), loading delta and x a few steps ahead (coalesced:
//    neighbouring lanes, neighbouring d) and keeping delta and delta x in
//    shared memory; B_t and C_t, the same for every d, are staged in shared
//    memory per window by cp.async and read as broadcast float4s.  It keeps
//    each chunk's end state and sum of delta.  The carry composes the
//    chunks in order, h_in[c + 1] = exp(A sum_c delta) h_in[c] + end[c] (a
//    thread per (channel, state), carried from window to window).  Pass 2
//    re-runs each chunk from its h_in out of shared memory and writes y
//    (the two lanes of a channel add their halves by a shuffle).  h_last
//    is the carry out of the last chunk.
//  * Pass 2 repeats pass 1's exps (no room to keep them: 8 states x 32
//    steps a thread), so K3 takes 2 exps per (b, t, d, n), 12.9 us of SFU
//    time at the serve shape on 128 SMs, about half of the ~25.5 us
//    chip_smoke.py measures there on an H100 (700 W); the rest is the
//    latency of each step (shared-memory loads, the exp, the h update, the
//    y shuffle), which 25 warps an SM hide only in part, and staging B and
//    C, the first loads and the carry.
//    Variants measured slower: the whole window's delta and x staged
//    before pass 1 (they arrive about as fast as pass 1 uses them), chunks
//    of 8 with the exps kept in registers for pass 2 (a window's barriers
//    and carry cost more than the exps they save), part of the exps as a
//    polynomial on the FMA pipe (the issue slots are as busy as the SFU),
//    and two blocks an SM.
//  * Steps past S are identity steps (delta = 0: exp(0) = 1, and adding 0
//    to a sum or to h is exact), and the chunks do not move with S, so a
//    scan whose tail has delta = 0 leaves y and h_last bit for bit as the
//    shorter scan gives them.  Any S is taken with no padding copies.
//  * Dt is picked at launch from (B, di, SM count) to spread the blocks
//    evenly over the SMs (25 channels, 128 blocks of 800 threads, at the
//    serve shape on 132 SMs); W is all of S up to 16 chunks.
#include <algorithm>
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace repro_torch {
namespace {

constexpr int kNT = 128;     // K4: threads per block, 128 / N d channels
// K4: timesteps loaded ahead into registers, from sweeps of 8..32 steps and
// of launch bounds at hymba's serve prefill on the card: fastest at 8 with 4
// blocks an SM required (<= 128 registers: the grid's ~3 blocks an SM then
// run in one wave; without the bound ptxas keeps 56 registers and pipelines
// fewer loads).
constexpr int kScanT = 8;

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

// --- K3 -------------------------------------------------------------------

constexpr int kL = 32;      // steps per chunk: SCAN_CHUNK of kernels/ssm_scan.py
constexpr int kWMax = 16;   // most chunks a block holds at once (a window of 512 steps)
constexpr int kFT = 4;      // steps of delta and x loaded ahead into registers at once
constexpr int kSP = 8;      // most states a thread holds: N > 8 splits over N / 8 lanes
constexpr int kFusedMaxT = 800;  // threads a block: 25 warps of <= 80 registers an SM
constexpr float kLog2e = 1.4426950408889634f;

template <int N>
__host__ __device__ constexpr int fused_sp() {  // states per thread
  return N < kSP ? N : kSP;
}

// r <- the M floats at p (16-byte aligned when M % 4 == 0): a thread's part
// of a row of B or C in shared memory, the same address for every thread of
// a chunk with the same states (a broadcast)
template <int M>
__device__ __forceinline__ void load_row(float (&r)[M], const float* p) {
  if constexpr (M % 4 == 0) {
#pragma unroll
    for (int n = 0; n < M; n += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + n);
      r[n] = v.x;
      r[n + 1] = v.y;
      r[n + 2] = v.z;
      r[n + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int n = 0; n < M; ++n) r[n] = p[n];
  }
}

// delta and x of one channel at kFT steps from dl_q, x_q on; 0 (an
// identity step) from step n_ok on.  Pointers step by their strides: no
// 64-bit multiply per load.
__device__ __forceinline__ void load_steps(float (&dl)[kFT], float (&xv)[kFT], const float* dl_q,
                                           long long dl_st, const float* x_q, long long x_st,
                                           int n_ok) {
#pragma unroll
  for (int i = 0; i < kFT; ++i) {
    const bool ok = i < n_ok;
    dl[i] = ok ? *dl_q : 0.f;
    xv[i] = ok ? *x_q : 0.f;
    dl_q += dl_st;
    x_q += x_st;
  }
}

// Pass 1 of a chunk: one thread's SP states of a channel over the kL steps
// from h = 0; steps from n_valid on (past S, or all of them for a channel
// past di) are identity steps: delta = x = 0 (and the window's B rows past
// S are zeros).  dl, xv: the first kFT steps' delta and x, loaded by the
// caller; dl_q, x_q point at the step after them, and each further kFT's
// are loaded while the one before is computed.  sB: the thread's states of
// the chunk's first B row, rows N floats apart.  The writer (one lane of
// the channel) keeps delta and delta x in kDl, kDx (the channel's column,
// rows Dt floats apart) for pass 2.  Returns the sum of delta.
template <int N, int K>
__device__ __forceinline__ float scan_chunk(float (&h)[N / K], const float (&a2)[N / K],
                                            float (&dl)[kFT], float (&xv)[kFT],
                                            const float* dl_q, long long dl_st,
                                            const float* x_q, long long x_st, const float* sB,
                                            int n_valid, bool writer, float* kDl, float* kDx,
                                            int Dt) {
  constexpr int SP = N / K;
  float sum = 0.f;
#pragma unroll 1
  for (int i0 = 0; i0 < kL; i0 += kFT) {
    float ndl[kFT], nxv[kFT];
    load_steps(ndl, nxv, dl_q, dl_st, x_q, x_st, i0 + kFT < kL ? n_valid - i0 - kFT : 0);
    dl_q += kFT * dl_st;
    x_q += kFT * x_st;
#pragma unroll
    for (int i = 0; i < kFT; ++i) {
      const float dx = dl[i] * xv[i];
      sum += dl[i];
      if (writer) {
        kDl[(i0 + i) * Dt] = dl[i];
        kDx[(i0 + i) * Dt] = dx;
      }
      float bt[SP];
      load_row(bt, sB + (i0 + i) * N);
#pragma unroll
      for (int n = 0; n < SP; ++n) h[n] = fmaf(exp2_approx(dl[i] * a2[n]), h[n], dx * bt[n]);
    }
#pragma unroll
    for (int i = 0; i < kFT; ++i) {
      dl[i] = ndl[i];
      xv[i] = nxv[i];
    }
  }
  return sum;
}

// Pass 2 of a chunk: the steps again from h = h_in, with delta and
// delta x as pass 1 kept them in shared memory (kDl, kDx: the channel's
// column, rows Dt floats apart), writing y_t = <h_t, C_t> at y_q, y_q +
// y_st, ... for the first n_valid steps: the K lanes of a channel (adjacent
// lanes) add their parts by shuffles, and the writer stores.
template <int N, int K>
__device__ __forceinline__ void rerun_chunk(float (&h)[N / K], const float (&a2)[N / K],
                                            const float* kDl, const float* kDx, int Dt,
                                            const float* sB, const float* sC, float* y_q,
                                            long long y_st, int n_valid, bool writer,
                                            unsigned lanes) {
  constexpr int SP = N / K;
#pragma unroll 8
  for (int i = 0; i < kL; ++i) {
    const float dl = kDl[i * Dt], dx = kDx[i * Dt];
    float bt[SP], ct[SP];
    load_row(bt, sB + i * N);
    load_row(ct, sC + i * N);
#pragma unroll
    for (int n = 0; n < SP; ++n) h[n] = fmaf(exp2_approx(dl * a2[n]), h[n], dx * bt[n]);
    float part[4] = {0.f, 0.f, 0.f, 0.f};  // four short chains instead of one
#pragma unroll
    for (int n = 0; n < SP; ++n) part[n % 4] = fmaf(h[n], ct[n], part[n % 4]);
    float yv = (part[0] + part[1]) + (part[2] + part[3]);
#pragma unroll
    for (int off = 1; off < K; off <<= 1) yv += __shfl_xor_sync(lanes, yv, off);
    if (writer && i < n_valid) y_q[i * y_st] = yv;
  }
}

// Grid (ceil(Di / Dt), B), W * Dt * K threads, K = N / SP: thread
// (w, dd, g), g fastest, owns states g SP .. g SP + SP - 1 of channel
// d = blockIdx.x * Dt + dd in chunk w of each window.  Shared memory, in
// floats (fused_smem_bytes): the window's B and C rows ([W kL][N] each),
// each chunk's end state and then its h_in ([W][N][Dt]), each chunk's sum
// of delta ([W][Dt]), the carry into the window ([N][Dt]), and delta and
// delta x as pass 1 keeps them ([W kL][Dt] each).
template <int N>
__global__ void __launch_bounds__(kFusedMaxT) ssm_scan_fused_kernel(
    const float* __restrict__ delta, const float* __restrict__ Bm, const float* __restrict__ C,
    const float* __restrict__ x, const float* __restrict__ A, float* __restrict__ y,
    float* __restrict__ h_last, int S, int Di, int Dt, long long dl_sb, long long dl_st,
    long long b_sb, long long b_st, long long c_sb, long long c_st, long long x_sb,
    long long x_st) {
  constexpr int SP = fused_sp<N>(), K = N / SP;
  extern __shared__ float4 fused_smem[];
  const int W = blockDim.x / (Dt * K);
  float* sB = reinterpret_cast<float*>(fused_smem);
  float* sC = sB + W * kL * N;
  float* sH = sC + W * kL * N;
  float* sSum = sH + W * N * Dt;
  float* sCarry = sSum + W * Dt;
  float* sKDl = sCarry + N * Dt;       // [W kL][Dt]: delta, kept by pass 1
  float* sKDx = sKDl + W * kL * Dt;    // [W kL][Dt]: delta x, kept by pass 1

  const int b = blockIdx.y, tid = threadIdx.x, nt = blockDim.x;
  const int g = tid % K, dd = tid / K % Dt, w = tid / (K * Dt);
  const int d = blockIdx.x * Dt + dd;
  const bool live = d < Di;
  // the lanes of this warp that exist (blockDim need not be a multiple of 32)
  const int warp_left = nt - (tid & ~31);
  const unsigned lanes = warp_left >= 32 ? 0xffffffffu : (1u << warp_left) - 1u;
  float a2[SP];  // A log2 e: exp(delta A) = 2^(delta a2)
#pragma unroll
  for (int n = 0; n < SP; ++n)
    a2[n] = live ? A[static_cast<long long>(d) * N + g * SP + n] * kLog2e : 0.f;
  for (int i = tid; i < N * Dt; i += nt) sCarry[i] = 0.f;  // h starts at 0
  const float* dl_p = delta + b * dl_sb + d;
  const float* x_p = x + b * x_sb + d;
  const float* b_p = Bm + b * b_sb;
  const float* c_p = C + b * c_sb;
  float* y_p = y + static_cast<long long>(b) * S * Di + d;

  // B and C rows in 16-byte copies where rows and bases allow (the model's
  // B and C are views of one projection), else in 4-byte ones
  const bool vec16 = N % 4 == 0 && b_st % 4 == 0 && c_st % 4 == 0 &&
                     ((reinterpret_cast<uintptr_t>(b_p) | reinterpret_cast<uintptr_t>(c_p)) & 15) == 0;
  for (int w0 = 0; w0 < S; w0 += W * kL) {
    __syncthreads();  // the last window's readers are done; the carry is in
    // the window's B and C rows by cp.async, all in flight at once; zeros past S
    if (vec16) {
      for (int i = tid; i < W * kL * N / 4; i += nt) {
        const int t = w0 + 4 * i / N, n = 4 * i % N;
        const bool ok = t < S;
        cp_async_16(sB + 4 * i, b_p + (ok ? t * b_st + n : 0), ok ? 16 : 0);
        cp_async_16(sC + 4 * i, c_p + (ok ? t * c_st + n : 0), ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < W * kL * N; i += nt) {
        const int t = w0 + i / N, n = i % N;
        const bool ok = t < S;
        cp_async_4(sB + i, b_p + (ok ? t * b_st + n : 0), ok ? 4 : 0);
        cp_async_4(sC + i, c_p + (ok ? t * c_st + n : 0), ok ? 4 : 0);
      }
    }
    const int t0 = w0 + w * kL;
    // steps of the chunk below S; a channel past di walks identity steps
    const int n_valid = live ? S - t0 : 0;
    const float* rB = sB + w * kL * N + g * SP;
    const float* dl_q = dl_p + t0 * dl_st;
    const float* x_q = x_p + t0 * x_st;
    float dl[kFT], xv[kFT];
    load_steps(dl, xv, dl_q, dl_st, x_q, x_st, n_valid);
    cp_async_wait_all();
    __syncthreads();

    // pass 1: the chunk from h = 0, its end state and its sum of delta
    float h[SP];
#pragma unroll
    for (int n = 0; n < SP; ++n) h[n] = 0.f;
    float* kDl = sKDl + w * kL * Dt + dd;
    float* kDx = sKDx + w * kL * Dt + dd;
    const float sum = scan_chunk<N, K>(h, a2, dl, xv, dl_q + kFT * dl_st, dl_st, x_q + kFT * x_st,
                                       x_st, rB, n_valid, g == 0, kDl, kDx, Dt);
#pragma unroll
    for (int n = 0; n < SP; ++n) sH[(w * N + g * SP + n) * Dt + dd] = h[n];
    if (g == 0) sSum[w * Dt + dd] = sum;
    __syncthreads();

    // the carry, a thread per (channel, state), in chunk order:
    // h_in[c + 1] = 2^(a2 sum_c) h_in[c] + end[c]; chunks past S are the identity
    for (int i = tid; i < N * Dt; i += nt) {
      const int n = i / Dt, cd = i % Dt, dc = blockIdx.x * Dt + cd;
      const float a2c = dc < Di ? A[static_cast<long long>(dc) * N + n] * kLog2e : 0.f;
      float decay[kWMax];  // the chunks' exp(A sum delta), all in flight before the chain
#pragma unroll
      for (int c = 0; c < kWMax; ++c) decay[c] = c < W ? exp2_approx(a2c * sSum[c * Dt + cd]) : 1.f;
      float hc = sCarry[i];
#pragma unroll
      for (int c = 0; c < kWMax; ++c) {
        if (c < W) {
          float* e = sH + (c * N + n) * Dt + cd;
          const float end_c = *e;
          *e = hc;  // h_in of chunk c
          hc = fmaf(decay[c], hc, end_c);
        }
      }
      sCarry[i] = hc;
    }
    __syncthreads();

    // pass 2: the chunk again from its h_in, writing y
#pragma unroll
    for (int n = 0; n < SP; ++n) h[n] = sH[(w * N + g * SP + n) * Dt + dd];
    rerun_chunk<N, K>(h, a2, kDl, kDx, Dt, rB, sC + w * kL * N + g * SP,
                      y_p + static_cast<long long>(t0) * Di, Di, n_valid, g == 0, lanes);
  }
  // h_last = the carry out of the last chunk, stored by the threads that made it
  for (int i = tid; i < N * Dt; i += nt) {
    const int n = i / Dt, cd = i % Dt, dc = blockIdx.x * Dt + cd;
    if (dc < Di) h_last[(static_cast<long long>(b) * Di + dc) * N + n] = sCarry[i];
  }
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

int sm_count() {
  static int cached[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 1;
  if (dev < kMaxDevices && cached[dev] > 0) return cached[dev];
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n <= 0)
    n = 1;
  if (dev < kMaxDevices) cached[dev] = n;
  return n;
}

constexpr size_t kMaxSmem = 227 * 1024;  // dynamic shared memory a block can have

size_t fused_smem_bytes(int N, int W, int Dt) {
  return sizeof(float) * (2 * size_t(W) * kL * N + size_t(W) * N * Dt + size_t(W) * Dt +
                          size_t(N) * Dt + 2 * size_t(W) * kL * Dt);
}

// K3's channels per block: among the Dt whose blocks (W * Dt * K threads,
// fused_smem_bytes) all fit on the SMs at once, the one that leaves the
// fewest channels on the busiest SM when the B * ceil(Di / Dt) blocks are
// dealt out (every block has the same work), the widest among equals.
int fused_width(int B, int Di, int N, int W, int K, int sms) {
  constexpr long long kSmemPerSm = kMaxSmem, kThreadsPerSm = 2048;
  constexpr long long kRegsPerThread = 65536 / kFusedMaxT / 8 * 8;
  int best_dt = 0, widest = 1;
  long long best = -1;
  for (int dt = 1; dt * W * K <= kFusedMaxT && fused_smem_bytes(N, W, dt) <= kMaxSmem; ++dt) {
    widest = dt;
    const long long threads = static_cast<long long>(dt) * W * K;
    const long long fit = std::min({kSmemPerSm / static_cast<long long>(fused_smem_bytes(N, W, dt)),
                                    kThreadsPerSm / threads,
                                    65536 / (threads * kRegsPerThread), 32LL});
    const long long per_sm = (static_cast<long long>(B) * ((Di + dt - 1) / dt) + sms - 1) / sms;
    if (per_sm > fit) continue;  // a second wave
    const long long cost = per_sm * dt;
    if (best < 0 || cost <= best) {
      best = cost;
      best_dt = dt;
    }
  }
  return best_dt > 0 ? best_dt : widest;  // too large for one wave: the widest blocks
}

template <int N>
cudaError_t launch_fused(const float* delta, const float* Bm, const float* C, const float* x,
                         const float* A, float* y, float* h_last, int B, int S, int Di,
                         const long long* st, cudaStream_t stream) {
  constexpr int K = N / fused_sp<N>();
  const int W = std::min(kWMax, std::max(1, (S + kL - 1) / kL));
  const int Dt = fused_width(B, Di, N, W, K, sm_count());
  auto kern = ssm_scan_fused_kernel<N>;
  static bool smem_set[kMaxDevices] = {};  // one per instantiation
  const cudaError_t err = allow_smem(kern, kMaxSmem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((Di + Dt - 1) / Dt), static_cast<unsigned>(B));
  kern<<<grid, W * Dt * K, fused_smem_bytes(N, W, Dt), stream>>>(
      delta, Bm, C, x, A, y, h_last, S, Di, Dt, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
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
