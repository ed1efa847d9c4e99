// Fast Griffin-Lim (librosa momentum) for Hopper, sm_90a.
//
// Replaces viai_tpu/signal/pallas_gl.py::griffin_lim_pallas, the Pallas
// TPU kernel that keeps the whole Griffin-Lim loop resident in VMEM.
//
// What bounds it: per clip and iteration the loop does two dense
// products of F x 512 x 512 multiply-adds once n_fft = 510 and the
// 2 x 256 interleaved (re, im) bins are padded to W = 512 (the four
// F x 256 x 510 products of the plain version). They run on the tensor
// cores as 3xTF32: a = a_hi + a_lo with both halves TF32, and
// a.b ~ a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, summed per pipeline stage on
// the tensor cores and across stages in float32, which keeps float32
// accuracy at three tensor-core products per product. The bound is
// operations: three times the float32 operations at the 495 TFLOP/s
// TF32 peak, 1.65 ms for GL x32 at B = 32 clips of 251 frames (4.07 ms
// at the 67 TFLOP/s of float32 outside the tensor cores).
//
// State at B = 32 (M = B*F = 8032 rows of W floats): A, frames, the
// previous rebuild and the observed bins 16.4 MB each, mag' 8.2 MB, the
// waveform w 4.2 MB. An iteration writes frames, w, A and prev once and
// reads each once: about 130 MB with every bin live, about 80 MB on the
// serving path, where only the hole's bins are live (counted from the
// shapes). The tiles read their operands from L2 once more per column
// or row block: about 190 MB per product at the 128 x 128 tile.
//
// Per iteration three kernels, all on the caller's stream:
//   gl_synth    frames = A @ syn        (M = B*F, K = W, N = W)
//               A[m, 2k | 2k+1] = mag'.(re | im) + obs (interleaved);
//   gl_ola      w[b, :] = reflect-pad(trim(OLA(frames) / env)), one
//               clip's re-analysis input, summed in the plain version's
//               chunk order;
//   gl_analyze  (nre, nim) = window(w) @ ana  (K = W, N = W), with the
//               cos and sin columns interleaved, so a bin's (nre, nim)
//               pair is adjacent; its epilogue does the momentum step,
//               the renormalization and writes the next A, in place;
// and at the end gl_synth once more and gl_ola with the trim (the
// output waveform).
//
// What the design does about the limits of a plain SIMT GEMM:
//   1. tensor cores: wgmma.m64nNk8 TF32, three per product, with A from
//      registers (split into hi/lo where its fragment is read from
//      shared memory) and B from shared memory (the bases, split once on
//      the host);
//   2. register tiles: a warpgroup owns a 64 x BN tile, with a second
//      set of BN / 2 accumulators per thread for a stage's partial sums
//      (see mainloop); a block of two warpgroups shares each stage;
//   3. loads overlap products: a ring of STAGES = 4 cp.async stages;
//      while the products of stage k run, stage k + 1 arrives, stage
//      k + 3 is issued and stage k + 1's A fragments are split;
//   4. synth's A operand is one dense (B*F, W) array that analyze's
//      epilogue writes (no per-element combination of five arrays);
//   5. analyze's A row t of clip b is the window w[b, t*hop : t*hop + W]
//      of a waveform gl_ola writes once per iteration: no division,
//      reflect or overlap-add in the product's loop, and no column
//      block rebuilds what another built;
//   6. the state stays in device memory and L2 (it does not fit one
//      block), each array moved once per iteration; analyze's epilogue
//      runs on the tile staged in shared memory with 16-byte accesses
//      and skips the bins where mag' = 0 (the observed ones);
//   7. every row is padded to W = 512 floats, so every copy is a
//      16-byte cp.async; the bases are K-major, as wgmma takes TF32
//      operands, and stored stage by stage in the shared-memory order,
//      so a stage's B tile is one contiguous block.
// Tiles (rows x columns) are 128 x 128, or 128 x 64 where 128 x 128
// would leave SMs without a block (B = 8); the wrapper picks. The ragged
// edge of M is masked. No atomics: every sum has a fixed order, so
// repeated calls give bit-identical results.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BK = 16;         // depth per pipeline stage
constexpr int STAGES = 4;      // cp.async ring depth
constexpr int SK = BK + 4;     // A smem row stride: conflict-free fragments
constexpr int CHUNKS = BK / 4; // 16-byte chunks per row and stage

// A block of two warpgroups computes a BM x BN tile, BM = 128: warp w
// owns rows 16w..16w+15 (wgmma's M is 64 per warpgroup), and both share
// the stage's B tile.
template <int BN>
struct Tile {
  static constexpr int THREADS = 256;
  static constexpr int BM = 128;
  static constexpr int A_COPIES = BM * CHUNKS / THREADS;  // per thread
  static constexpr int A_FLOATS = BM * SK;
  static constexpr int B_FLOATS = BN * BK;
  static constexpr int STAGE_FLOATS = A_FLOATS + 2 * B_FLOATS;
  static constexpr int SMEM_BYTES = STAGES * STAGE_FLOATS * 4;
  // analyze: the product tile, staged for its epilogue in the ring's
  // memory (rows padded by 8: conflict-free float2 writes), then mag'
  // of the tile's BN / 2 bins behind the ring.
  static constexpr int CS = BN + 8;
  static constexpr int MAG_FLOATS = BM * BN / 2;
  static constexpr int ANALYZE_SMEM_BYTES = SMEM_BYTES + MAG_FLOATS * 4;
  static_assert(BM * CS <= STAGES * STAGE_FLOATS, "C tile fits the ring");
};

struct Geometry {
  int F;       // frames per clip
  int NB;      // frequency bins
  int N;       // n_fft (frame width)
  int W;       // padded row width: n_fft and 2 * NB rounded up to 128
  int hop;
  int pad;     // n_fft / 2
  int total;   // hop * (F - 1) + n_fft: padded waveform length
  int L;       // hop * (F - 1) + W: row length of w
};

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// Shared-memory matrix descriptor of a K-major operand without swizzle:
// 8-row x 16-byte core matrices, `lbo` bytes apart along K, `sbo` bytes
// apart along N.
__device__ __forceinline__ uint64_t smem_desc(const float* p, int lbo,
                                              int sbo) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d (64 x BN, f32, this thread's BN/2 values) = d * accumulate + a
// (64 x 8, TF32, from registers) * b (8 x BN, TF32, K-major in shared
// memory).
template <int BN>
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t* a,
                                           uint64_t desc_b, int accumulate);

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float* d, const uint32_t* a,
                                              uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float* d, const uint32_t* a,
                                              uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// acc = sum_k A[row, k] * B[n, k] over k < K for the block's BM x BN
// tile, as 3xTF32 on the tensor cores. a_row[i] points at column lc of
// the block's A row lr + (THREADS / CHUNKS) i. A stage holds A
// row-major (padded rows) and the two B halves as core matrices:
// 16-byte unit u = (n / 8) * 8 * CHUNKS + c * 8 + n % 8 holds row n,
// k-chunk c. The bases are stored in that order on the host, stage by
// stage (see gl_cuda.stage_tiles): b_hi / b_lo point at the block's
// first row of stage 0, stage s lies s * BK * K floats further, and
// each stage's B tile is one contiguous block that consecutive threads
// copy in consecutive 16-byte units.
// Thread layout (g = lane / 4, t = lane % 4, warp w): A fragment rows
// 16w + g | +8, columns t | t+4; acc[4j + 2h + e] is row 16w + g + 8h,
// column 8j + 2t + e.
//
// Accuracy: the tensor cores round their sums toward zero. So the six
// products of a stage (two k8 steps, three passes each) go to `part`,
// which starts from zero, and part is added to acc in float32 (round to
// nearest): the bias stays within one stage, and the result is as
// close to the exact product as a float32 GEMM's.
// Overlap: while the products of stage k run, the threads wait for
// stage k + 1, issue the copies of stage k + 3 and split stage k + 1's
// A fragments into the other of two register sets; then they wait for
// the products and add part to acc. Stage k + 3 reuses the slot of
// stage k - 1, whose products every warpgroup waited for before the
// barrier of stage k + 1.
template <int BN>
__device__ __forceinline__ void mainloop(float* smem,
                                         const float* const* a_row,
                                         const float* b_hi,
                                         const float* b_lo, int K,
                                         float (&acc)[BN / 2]) {
  using T = Tile<BN>;
  using Frag = uint32_t[BK / 8][4];
  constexpr int THREADS = T::THREADS;
  constexpr int B_UNITS = BN * CHUNKS / THREADS;
  static_assert(B_UNITS * THREADS == BN * CHUNKS, "whole B copies");
  static_assert(T::A_COPIES * THREADS == T::BM * CHUNKS, "whole A copies");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int lr = tid / CHUNKS, lc = (tid % CHUNKS) * 4;
  const int KT = K / BK;   // even: K is a multiple of 128
  auto load = [&](int kt) {
    if (kt < KT) {
      float* as = smem + (kt % STAGES) * T::STAGE_FLOATS;
      float* bh = as + T::A_FLOATS;
      float* bl = bh + T::B_FLOATS;
      const int k0 = kt * BK;
#pragma unroll
      for (int i = 0; i < T::A_COPIES; ++i)
        cp_async16(as + (lr + i * (THREADS / CHUNKS)) * SK + lc,
                   a_row[i] + k0);
      const size_t b0 = (size_t)k0 * K;
#pragma unroll
      for (int i = 0; i < B_UNITS; ++i) {
        const int u = tid + i * THREADS;
        cp_async16(bh + 4 * u, b_hi + b0 + 4 * u);
        cp_async16(bl + 4 * u, b_lo + b0 + 4 * u);
      }
    }
    cp_async_commit();   // one group per stage, empty past the end
  };
  auto split = [&](int kt, Frag& hi, Frag& lo) {
    const float* as = smem + (kt % STAGES) * T::STAGE_FLOATS;
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = warp * 16 + g + (q & 1) * 8;
        const float v = as[r * SK + kk * 8 + t + (q >> 1) * 4];
        hi[kk][q] = to_tf32(v);
        lo[kk][q] = to_tf32(v - __uint_as_float(hi[kk][q]));
      }
  };
  float part[BN / 2] = {};
  auto stage = [&](int kt, const Frag& hi, const Frag& lo, Frag& nhi,
                   Frag& nlo) {
    const float* bh = smem + (kt % STAGES) * T::STAGE_FLOATS + T::A_FLOATS;
    const float* bl = bh + T::B_FLOATS;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      // k8 step kk: chunks 2kk, 2kk+1 (128 bytes apart), 8-row groups
      // 8 * CHUNKS units apart.
      const uint64_t dh = smem_desc(bh + kk * 64, 128, 128 * CHUNKS);
      const uint64_t dl = smem_desc(bl + kk * 64, 128, 128 * CHUNKS);
      // Small terms first; the stage's first product overwrites part.
      wgmma_tf32<BN>(part, lo[kk], dh, kk > 0);
      wgmma_tf32<BN>(part, hi[kk], dl, 1);
      wgmma_tf32<BN>(part, hi[kk], dh, 1);
    }
    wgmma_commit();
    if (kt + 1 < KT) {
      cp_async_wait<STAGES - 3>();   // stage kt + 1 has landed
      __syncthreads();
      load(kt + STAGES - 1);
      split(kt + 1, nhi, nlo);
    }
    wgmma_wait_all();
    // The products read hi and lo from registers and write part until
    // the wait: keep hi and lo live up to it, and read part after it.
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        asm volatile("" ::"r"(hi[kk][q]), "r"(lo[kk][q]));
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      asm volatile("" : "+f"(part[i])::"memory");
      acc[i] += part[i];
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load(s);
  cp_async_wait<STAGES - 2>();   // stage 0 has landed
  __syncthreads();
  Frag hi0, lo0, hi1, lo1;
  split(0, hi0, lo0);
  for (int kt = 0; kt < KT; kt += 2) {
    stage(kt, hi0, lo0, hi1, lo1);
    stage(kt + 1, hi1, lo1, hi0, lo0);
  }
  cp_async_wait<0>();
}

// frames[m, n] = sum_k A[m, k] * syn[n, k]; syn_hi / syn_lo are the
// stage tiles of the (W, W) K-major synthesis basis.
template <int BN>
__global__ void __launch_bounds__(Tile<BN>::THREADS)
gl_synth(const float* __restrict__ a, const float* __restrict__ syn_hi,
         const float* __restrict__ syn_lo, float* __restrict__ frames, int M,
         Geometry g) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int BM = Tile<BN>::BM, ROWS = Tile<BN>::THREADS / CHUNKS;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int lr = tid / CHUNKS, lc = (tid % CHUNKS) * 4;
  const int W = g.W;
  const float* a_row[Tile<BN>::A_COPIES];
#pragma unroll
  for (int i = 0; i < Tile<BN>::A_COPIES; ++i)
    a_row[i] = a + (size_t)min(m0 + lr + ROWS * i, M - 1) * W + lc;
  float acc[BN / 2] = {};
  mainloop<BN>(smem, a_row, syn_hi + (size_t)n0 * BK,
               syn_lo + (size_t)n0 * BK, W, acc);

  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + warp * 16 + gq + h * 8;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      *reinterpret_cast<float2*>(frames + (size_t)m * W + n0 + 8 * j + 2 * tq) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
}

// (nre, nim)[m, k] = sum_j X[m, j] * (cosw, sinw)[j, k] with X row
// m = b*F + t the window w[b, t*hop : t*hop + W]; ana_hi / ana_lo are
// the stage tiles of the (W, W) K-major analysis basis, whose rows 2k and
// 2k+1 are the cos and sin columns of bin k.
// Epilogue, per (m, k): are = nre - beta*pre, aim = nim - beta*pim;
// (pre, pim) <- (nre, nim); (re, im) = unit(are, aim);
// A[m, 2k | 2k+1] <- mag'[m, k] * (re | im) + obs[m, 2k | 2k+1].
// It runs on the tile staged in shared memory, each thread on 16-byte
// pieces (two bins) of consecutive columns, so every global access of a
// warp covers 512 contiguous bytes.
template <int BN>
__global__ void __launch_bounds__(Tile<BN>::THREADS)
gl_analyze(const float* __restrict__ w, const float* __restrict__ ana_hi,
           const float* __restrict__ ana_lo, const float* __restrict__ mag,
           const float* __restrict__ obs, float* __restrict__ prev,
           float* __restrict__ a, int M, Geometry g, float beta) {
  using T = Tile<BN>;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int BM = T::BM, ROWS = T::THREADS / CHUNKS;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int lr = tid / CHUNKS, lc = (tid % CHUNKS) * 4;
  const int W = g.W;
  const float* a_row[T::A_COPIES];
#pragma unroll
  for (int i = 0; i < T::A_COPIES; ++i) {
    const int m = min(m0 + lr + ROWS * i, M - 1);
    const int b = m / g.F, t = m - b * g.F;
    a_row[i] = w + (size_t)b * g.L + (size_t)t * g.hop + lc;
  }
  // mag' (M, W / 2) of the tile's bins, copied behind the ring with the
  // first stage, so that it arrives while the products run.
  float* mag_s = smem + STAGES * T::STAGE_FLOATS;
  constexpr int MAG_CHUNKS = BN / 8;   // 16-byte chunks per row
  for (int i = tid; i < BM * MAG_CHUNKS; i += T::THREADS) {
    const int r = i / MAG_CHUNKS, c = i % MAG_CHUNKS;
    cp_async16(mag_s + 4 * i,
               mag + (size_t)min(m0 + r, M - 1) * (W / 2) + n0 / 2 + 4 * c);
  }
  float acc[BN / 2] = {};
  mainloop<BN>(smem, a_row, ana_hi + (size_t)n0 * BK,
               ana_lo + (size_t)n0 * BK, W, acc);

  // Stage the product tile (acc's layout: see mainloop).
  __syncthreads();
  float* cs = smem;
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      *reinterpret_cast<float2*>(cs + (warp * 16 + gq + 8 * h) * T::CS +
                                 8 * j + 2 * tq) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  __syncthreads();

  // Where mag' = 0 (observed bins, pad bins) nothing is read or written:
  // A holds obs there from the start (A0 = mag'.u0 + obs), and the
  // previous rebuild there only ever feeds a phase that multiplies 0.
  // A piece with one such bin is updated whole: its A value is obs.
  constexpr int PIECES = BN / 4, ITEMS = BM * PIECES / T::THREADS;
  constexpr int GROUP = 4;             // pieces whose loads fly together
  static_assert(ITEMS % GROUP == 0, "whole groups");
#pragma unroll 1
  for (int i0 = 0; i0 < ITEMS; i0 += GROUP) {
    float4 pv[GROUP], ob[GROUP];
    float2 mg[GROUP];
    bool live[GROUP];
#pragma unroll
    for (int u = 0; u < GROUP; ++u) {
      const int i = tid + (i0 + u) * T::THREADS;
      const int r = i / PIECES, c = i % PIECES;
      const size_t o = (size_t)(m0 + r) * W + n0 + 4 * c;
      mg[u] = *reinterpret_cast<const float2*>(mag_s + r * (BN / 2) + 2 * c);
      live[u] = m0 + r < M && (mg[u].x != 0.f || mg[u].y != 0.f);
      pv[u] = live[u] ? *reinterpret_cast<const float4*>(prev + o)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      ob[u] = live[u] && obs != nullptr
                  ? *reinterpret_cast<const float4*>(obs + o)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < GROUP; ++u) {
      if (!live[u]) continue;
      const int i = tid + (i0 + u) * T::THREADS;
      const int r = i / PIECES, c = i % PIECES;
      const size_t o = (size_t)(m0 + r) * W + n0 + 4 * c;
      const float4 x = *reinterpret_cast<const float4*>(cs + r * T::CS + 4 * c);
      const float are0 = x.x - beta * pv[u].x, aim0 = x.y - beta * pv[u].y;
      const float are1 = x.z - beta * pv[u].z, aim1 = x.w - beta * pv[u].w;
      const float inv0 = rsqrtf(are0 * are0 + aim0 * aim0 + 1e-16f);
      const float inv1 = rsqrtf(are1 * are1 + aim1 * aim1 + 1e-16f);
      *reinterpret_cast<float4*>(prev + o) = x;
      *reinterpret_cast<float4*>(a + o) = make_float4(
          mg[u].x * (are0 * inv0) + ob[u].x, mg[u].x * (aim0 * inv0) + ob[u].y,
          mg[u].y * (are1 * inv1) + ob[u].z, mg[u].y * (aim1 * inv1) + ob[u].w);
    }
  }
}

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
    if (f >= 0 && f < g.F && col < g.N) s += fr[(size_t)f * g.W + col];
  }
  return s * inv_env[p];
}

// trim = false: dst (B, L) is the re-analysis input, the reflect-padded
// normalized OLA for p < total and 0 above (pad columns of the windows).
// trim = true: dst (B, T) is the output, the normalized OLA at p + pad.
__global__ void gl_ola(const float* __restrict__ frames,
                       const float* __restrict__ inv_env,
                       float* __restrict__ dst, int B, int len, Geometry g,
                       bool trim) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)B * len) return;
  const int b = (int)(idx / len), p = (int)(idx % len);
  const float* fr = frames + (size_t)b * g.F * g.W;
  float v = 0.f;
  if (trim)
    v = ola_at(fr, inv_env, p + g.pad, g);
  else if (p < g.total)
    v = ola_at(fr, inv_env, reflect(p, g), g);
  dst[idx] = v;
}

struct Buffers {
  const float *mag, *obs;
  float *a, *prev, *frames, *w;
  const float *syn_hi, *syn_lo, *ana_hi, *ana_lo, *inv_env;
  float* out;
};

template <int BN>
cudaError_t run(const Buffers& d, int B, const Geometry& g, int n_iter,
                float beta, cudaStream_t s) {
  using T = Tile<BN>;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(gl_synth<BN>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  T::SMEM_BYTES)) != cudaSuccess)
    return err;
  if ((err = cudaFuncSetAttribute(gl_analyze<BN>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  T::ANALYZE_SMEM_BYTES)) != cudaSuccess)
    return err;
  const int M = B * g.F;
  const int len = g.total - 2 * g.pad;
  const dim3 grid(g.W / BN, (M + T::BM - 1) / T::BM);
  const size_t n_w = (size_t)B * g.L, n_out = (size_t)B * len;
  const unsigned grid_w = (unsigned)((n_w + 255) / 256);
  const unsigned grid_out = (unsigned)((n_out + 255) / 256);
  auto synth = [&]() {
    gl_synth<BN><<<grid, T::THREADS, T::SMEM_BYTES, s>>>(
        d.a, d.syn_hi, d.syn_lo, d.frames, M, g);
    return cudaGetLastError();
  };
  for (int it = 0; it < n_iter; ++it) {
    if ((err = synth()) != cudaSuccess) return err;
    gl_ola<<<grid_w, 256, 0, s>>>(d.frames, d.inv_env, d.w, B, g.L, g, false);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    gl_analyze<BN><<<grid, T::THREADS, T::ANALYZE_SMEM_BYTES, s>>>(
        d.w, d.ana_hi, d.ana_lo, d.mag, d.obs, d.prev, d.a, M, g, beta);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if ((err = synth()) != cudaSuccess) return err;
  gl_ola<<<grid_out, 256, 0, s>>>(d.frames, d.inv_env, d.out, B, len, g, true);
  return cudaGetLastError();
}

}  // namespace

// Runs n_iter Griffin-Lim iterations and the final synthesis on
// `stream`. Layout (M = B*F rows, W columns, row-major):
//   mag (M, W / 2): mag', zero above NB; obs (M, W): interleaved
//     (obs_re, obs_im), or null;
//   a (M, W): the first synthesis operand, interleaved
//     mag'.(re0 | im0) + obs, zero in columns >= 2*NB; updated in place;
//   prev (M, W): zero; frames (M, W) and w (B, hop*(F-1) + W): scratch;
//   syn_hi/lo, ana_hi/lo: the (W, W) K-major bases as stage tiles
//   (gl_cuda.stage_tiles); inv_env (hop*(F-1) + N); out (B, hop*(F-1)).
// W must be a multiple of 128 and at least N + 2, hop a multiple of 4.
// The block tile is 128 rows x tile_n columns, tile_n 64 or 128 (the
// wrapper picks it). Returns the first launch error (0 otherwise).
extern "C" int viai_griffin_lim(
    const float* mag, const float* obs, float* a, float* prev, float* frames,
    float* w, const float* syn_hi, const float* syn_lo, const float* ana_hi,
    const float* ana_lo, const float* inv_env, float* out, int B, int F,
    int NB, int N, int W, int hop, int n_iter, float beta, int tile_n,
    void* stream) {
  if (W % 128 != 0 || W < N + 2 || hop % 4 != 0 || 2 * (NB - 1) != N ||
      B < 1 || F < 2 || n_iter < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int total = hop * (F - 1) + N;
  const Geometry g{F, NB, N, W, hop, N / 2, total, hop * (F - 1) + W};
  const Buffers d{mag, obs, a, prev, frames, w, syn_hi, syn_lo, ana_hi,
                  ana_lo, inv_env, out};
  if (tile_n == 64) return (int)run<64>(d, B, g, n_iter, beta, s);
  if (tile_n == 128) return (int)run<128>(d, B, g, n_iter, beta, s);
  return (int)cudaErrorInvalidValue;
}
