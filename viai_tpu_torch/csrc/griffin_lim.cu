// Fast Griffin-Lim (librosa momentum) for Hopper, sm_90a.
//
// Replaces viai_tpu/signal/pallas_gl.py::griffin_lim_pallas, the Pallas
// TPU kernel that keeps the whole Griffin-Lim loop resident in VMEM.
//
// What bounds it: per clip and iteration the loop does four dense
// products of F x 256 x 510 multiply-adds (iDFT re/im, DFT cos/sin):
// about 0.26 GFLOP, against about 1.4 MB of inputs and outputs per
// clip for the whole call. At float32 outside the tensor cores it is
// bound by arithmetic (67 TFLOP/s on an H100 SXM), not by memory.
//
// What the design does about it: the state of one clip (phase, previous
// rebuild, frames: about 1.3 MB) does not fit one block's shared memory,
// so it lives in device memory and L2, and every iteration is two fused,
// shared-memory-tiled float32 GEMMs with register blocking:
//   gl_synth    frames = (mag'.re + obs_re | mag'.im + obs_im) @ [icosw; isinw]
//               (M = B*F, N = n_fft, K = 2*n_bins); the A tile is formed
//               while it is loaded.
//   gl_analyze  (nre, nim) = frames' @ (cosw, sinw)  (K = n_fft), whose
//               A-tile loader is the overlap-add / 1/env / trim /
//               reflect-pad / re-frame of the frames as a gather (no
//               scatter, no atomics), and whose epilogue does the
//               momentum step and the renormalization in place.
//   gl_ola_out  the same gather once more, writing the trimmed waveform.
// The Hann window is folded into the four bases on the host. The TPU
// kernel's shift matrices, reversal matmuls and 512-lane padding are
// VMEM/MXU workarounds and have no counterpart here.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;       // rows (frames) per block
constexpr int BN = 64;       // columns (samples or bins) per block
constexpr int BK = 16;       // depth per shared-memory stage
constexpr int TM = 4;        // rows per thread
constexpr int TN = 4;        // columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);
constexpr int APAD = 4;      // keeps A-tile stores at 2-way bank conflicts

struct Geometry {
  int F;       // frames per clip
  int NB;      // frequency bins
  int N;       // n_fft (frame width)
  int hop;
  int pad;     // n_fft / 2
  int total;   // hop * (F - 1) + n_fft: padded waveform length
};

// Position p of the reflect-padded re-analysis input, mapped into the
// trimmed waveform's span [pad, total - pad) of the OLA output.
__device__ __forceinline__ int reflect(int p, const Geometry& g) {
  if (p < g.pad) return 2 * g.pad - p;
  if (p >= g.total - g.pad) return 2 * (g.total - g.pad - 1) - p;
  return p;
}

// Normalized overlap-add at OLA position p of one clip. Chunk c of
// frame f covers [(f + c)*hop, (f + c + 1)*hop), so p gets frames
// f = p/hop - c for c < ceil(n_fft / hop), added in that order, the
// order of the plain version's shifted adds.
__device__ __forceinline__ float ola_at(const float* __restrict__ fr,
                                        const float* __restrict__ inv_env,
                                        int p, const Geometry& g) {
  const int q = p / g.hop;
  const int n_chunks = (g.N + g.hop - 1) / g.hop;
  float s = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    const int f = q - c;
    const int col = p - f * g.hop;
    if (f >= 0 && f < g.F && col < g.N) s += fr[f * g.N + col];
  }
  return s * inv_env[p];
}

// frames[m, n] = sum_k A[m, k] * basis[k, n], with
// A[m, k] = mag'[m, k] * re[m, k] + obs_re[m, k]            (k <  NB)
//         = mag'[m, k-NB] * im[m, k-NB] + obs_im[m, k-NB]   (k >= NB).
__global__ void __launch_bounds__(THREADS)
gl_synth(const float* __restrict__ mag, const float* __restrict__ obs_re,
         const float* __restrict__ obs_im, const float* __restrict__ re,
         const float* __restrict__ im, const float* __restrict__ basis,
         float* __restrict__ frames, int M, Geometry g) {
  __shared__ __align__(16) float As[BK][BM + APAD];
  __shared__ __align__(16) float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int K = 2 * g.NB, N = g.N;
  float acc[TM][TN] = {};

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < BM * BK / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / BK, c = idx % BK;
      const int m = m0 + r, k = k0 + c;
      float v = 0.f;
      if (m < M && k < K) {
        const bool is_re = k < g.NB;
        const size_t o = (size_t)m * g.NB + (is_re ? k : k - g.NB);
        v = mag[o] * (is_re ? re[o] : im[o]);
        if (obs_re != nullptr) v += is_re ? obs_re[o] : obs_im[o];
      }
      As[c][r] = v;
    }
#pragma unroll
    for (int i = 0; i < BK * BN / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / BN, c = idx % BN;
      const int k = k0 + r, n = n0 + c;
      Bs[r][c] = (k < K && n < N) ? basis[(size_t)k * N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * TM]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * TN]);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n < N) frames[(size_t)m * N + n] = acc[i][j];
    }
  }
}

// (nre, nim)[m, n] = sum_j X[m, j] * (cosw, sinw)[j, n], where X is the
// consistent re-framing of `frames`:
//   X[b*F + t, j] = inv_env[q] * sum_f frames[b, f, q - f*hop],
//   q = reflect(t*hop + j).
// Epilogue: are = nre - beta*pre, aim = nim - beta*pim; pre, pim <- nre,
// nim; re, im <- (are, aim) / |(are, aim)|. Each (m, n) is owned by one
// thread, so the update is in place.
__global__ void __launch_bounds__(THREADS)
gl_analyze(const float* __restrict__ frames, const float* __restrict__ inv_env,
           const float* __restrict__ cosw, const float* __restrict__ sinw,
           float* __restrict__ re, float* __restrict__ im,
           float* __restrict__ pre, float* __restrict__ pim, int M,
           Geometry g, float beta) {
  __shared__ __align__(16) float As[BK][BM + APAD];
  __shared__ __align__(16) float Bc[BK][BN];
  __shared__ __align__(16) float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int K = g.N, NB = g.NB;
  float acc_c[TM][TN] = {};
  float acc_s[TM][TN] = {};

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < BM * BK / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / BK, c = idx % BK;
      const int m = m0 + r, j = k0 + c;
      float v = 0.f;
      if (m < M && j < K) {
        const int b = m / g.F, t = m - b * g.F;
        const int q = reflect(t * g.hop + j, g);
        v = ola_at(frames + (size_t)b * g.F * g.N, inv_env, q, g);
      }
      As[c][r] = v;
    }
#pragma unroll
    for (int i = 0; i < BK * BN / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / BN, c = idx % BN;
      const int k = k0 + r, n = n0 + c;
      const bool ok = k < K && n < NB;
      const size_t o = (size_t)k * NB + n;
      Bc[r][c] = ok ? cosw[o] : 0.f;
      Bs[r][c] = ok ? sinw[o] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * TM]);
      const float4 c4 = *reinterpret_cast<const float4*>(&Bc[k][tx * TN]);
      const float4 s4 = *reinterpret_cast<const float4*>(&Bs[k][tx * TN]);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float cv[TN] = {c4.x, c4.y, c4.z, c4.w};
      const float sv[TN] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc_c[i][j] = fmaf(av[i], cv[j], acc_c[i][j]);
          acc_s[i][j] = fmaf(av[i], sv[j], acc_s[i][j]);
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n >= NB) continue;
      const size_t o = (size_t)m * NB + n;
      const float nre = acc_c[i][j], nim = acc_s[i][j];
      const float are = nre - beta * pre[o];
      const float aim = nim - beta * pim[o];
      pre[o] = nre;
      pim[o] = nim;
      const float inv = rsqrtf(are * are + aim * aim + 1e-16f);
      re[o] = are * inv;
      im[o] = aim * inv;
    }
  }
}

// out[b, s] = normalized OLA at position s + pad (the trimmed waveform).
__global__ void gl_ola_out(const float* __restrict__ frames,
                           const float* __restrict__ inv_env,
                           float* __restrict__ out, int B, int T, Geometry g) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)B * T) return;
  const int b = (int)(idx / T), s = (int)(idx % T);
  out[idx] = ola_at(frames + (size_t)b * g.F * g.N, inv_env, s + g.pad, g);
}

}  // namespace

// Runs n_iter Griffin-Lim iterations and the final synthesis on
// `stream`. re/im hold the initial phase and are updated in place;
// pre/pim must be zero; frames is (B*F, n_fft) scratch; out is (B, T)
// with T = hop*(F-1). obs_re/obs_im may both be null (no observed
// clamp). Returns the first launch error (cudaSuccess = 0 otherwise).
extern "C" int viai_griffin_lim(
    const float* mag, const float* obs_re, const float* obs_im, float* re,
    float* im, float* pre, float* pim, float* frames, const float* syn_basis,
    const float* cosw, const float* sinw, const float* inv_env, float* out,
    int B, int F, int NB, int N, int hop, int n_iter, float beta,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geometry g{F, NB, N, hop, N / 2, hop * (F - 1) + N};
  const int M = B * F;
  const int T = g.total - 2 * g.pad;
  const dim3 block(THREADS);
  const dim3 grid_synth((N + BN - 1) / BN, (M + BM - 1) / BM);
  const dim3 grid_analyze((NB + BN - 1) / BN, (M + BM - 1) / BM);
  cudaError_t err;
  for (int it = 0; it < n_iter; ++it) {
    gl_synth<<<grid_synth, block, 0, s>>>(mag, obs_re, obs_im, re, im,
                                          syn_basis, frames, M, g);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    gl_analyze<<<grid_analyze, block, 0, s>>>(frames, inv_env, cosw, sinw,
                                              re, im, pre, pim, M, g, beta);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  gl_synth<<<grid_synth, block, 0, s>>>(mag, obs_re, obs_im, re, im,
                                        syn_basis, frames, M, g);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t n_out = (size_t)B * T;
  gl_ola_out<<<(unsigned)((n_out + 255) / 256), 256, 0, s>>>(frames, inv_env,
                                                             out, B, T, g);
  return (int)cudaGetLastError();
}
