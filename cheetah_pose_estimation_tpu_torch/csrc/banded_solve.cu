// Batched block-banded SPD factor-and-solve for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of
// cheetah_pose_estimation_tpu/ops/pallas_banded.py
// (pallas_banded_solve_batched: _fwd_kernel, _bwd_kernel): every
// Levenberg-Marquardt step of the kinematic solver solves B independent
// systems H x = b with N frames of 54x54 blocks and bandwidth 3
// (diag (B, N, 54, 54), lower (B, 3, N, 54, 54) with lower[:, k-1, t] =
// H[t+k, t], rhs (B, N, 54)).
//
// Algorithm: the sequential block-banded Cholesky of the TPU kernel and of
// ops/cuda_banded.solve_reference, with each diagonal factor L[t,t] kept as
// its inverse X[t] = L[t,t]^-1. Frame t of the forward pass:
//   for j = 3..1:  M_j    = H[t,t-j] - sum_{k>j} L[t,t-k] L[t-j,t-k]^T
//                  L[t,t-j] = M_j X[t-j]^T                  (a product)
//   S      = H[t,t] - sum_j L[t,t-j] L[t,t-j]^T
//   X[t]   = chol(S)^-1                   (blocked, 18-wide panels, below)
//   y[t]   = X[t] (b[t] - sum_j L[t,t-j] y[t-j])             (a matvec)
// and the backward pass x[t] = X[t]^T (y[t] - sum_j L[t+j,t]^T x[t+j]).
// ops/cuda_banded.solve_reference_blocked is the plain twin of exactly this
// order of operations.
//
// What bounds it: latency. The frames run in sequence and one thread block
// owns one system, so B = 10 to 30 blocks use 10 to 30 of the 132 SMs; the
// solve needs ~2.0 MFLOP per frame (this kernel does ~2.6: its products
// with the triangular X are dense). A plain substitution makes every frame a chain
// of ~270 dependent steps (54 pivots, three 54-step triangular solves, two
// 54-step substitutions). This design shortens the chain:
//  * Triangular solves become products with X[t-j]: 54x54x54 register-tiled
//    FMA products over all eight warps (6x6 tiles, the m range in three
//    slices, 8-byte operand loads); the symmetric Schur update skips the
//    blocks above the diagonal.
//  * The Cholesky is blocked by 18-wide panels: one warp factors and inverts
//    each 18x18 diagonal block in registers with shuffles and no branch or
//    block barrier; warps form the panel below it (S_ip X_pp^T), the
//    trailing update and the off-diagonal blocks of X as 18x18x18 products,
//    one or two warps per product. About 16 block barriers per frame
//    instead of ~110.
//  * The next frame's four input blocks (46.7 KB) are copied with cp.async
//    into their staging buffers while the current frame factors its
//    diagonal block, so no frame waits for device memory; the backward pass
//    prefetches its four factor blocks the same way.
// Row t+1's L[t+1,t-3], M_2 and L[t+1,t-1] are formed ahead, by warps 1-7
// while warp 0 factors row t's diagonal block.
// What is left on the chain (PERF.md, phase probe): the 54 pivot steps of
// the three panels, each a shuffle, the reciprocal and two FMAs, and the
// products, which run at a few percent of the FMA rate because each phase
// is short. The next levers are a CUDA cyclic reduction (depth log N, more
// SMs than systems) or several systems per SM.
// Shared memory keeps what later frames read: the staged row t, L[t,t-1]
// and L[t,t-2] of rows t..t-2, X of rows t..t-2, a second diagonal buffer
// for the prefetch, and the products' partial sums (18 dense 54x54 blocks,
// ~212 KB of dynamic shared memory, hence cudaFuncSetAttribute). Every
// factor row (L[t,t-j] and X[t]) also goes to a global scratch buffer that
// the backward pass reads.
//
// Arithmetic is plain float32 FMA: no tensor cores, no TF32. The work is
// ~1.7 GFLOP per call at 10x64 and latency-bound, so wgmma is not the lever, and TF32
// would break the 7e-4 accuracy bar. sqrtf and one correctly rounded
// reciprocal per pivot (__frcp_rn; build without --use_fast_math): a float32
// division per element carries a slow-path check and call. The explicit
// inverse keeps the normwise backward error of a substitution (~1e-7 on the
// solver's Jacobi-scaled systems, ops/cuda_banded.py). A non-positive (or
// NaN) pivot makes that system's whole solution NaN, like the torch scan
// path (cholesky_ex + NaN), so the LM driver rejects the step and raises the
// damping; the other systems are untouched. The TPU kernel clamped the pivot
// at 1e-30 instead.
//
// Built with -DBANDED_PHASE_PROBE (ops/banded_probe.py, never the main
// path), thread 0 adds the clock64 cycles of each phase into the buffer
// that banded_probe_set() names, NPROBE counters per system.
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int D = 54;                  // block size
constexpr int P = 18;                  // panel width of the blocked Cholesky
constexpr int DD = D * D;              // floats per dense block
constexpr int BW = 3;                  // bandwidth
constexpr int THREADS = 256;
constexpr int VP = 64;                 // padded vector length
constexpr int NBLK = 18;               // dense blocks in shared memory
constexpr int TS = P * P;              // floats per 18x18 scratch block
constexpr size_t SMEM_BYTES =
    sizeof(float) * ((size_t)NBLK * DD + 3 * TS + 13 * VP);

// shared block indices
constexpr int B_HS = 0;   // 3: staged H[t,t-1..3] (M_j in place)
constexpr int B_HD = 3;   // 2: H[t,t] -> S, double-buffered by frame parity
constexpr int B_LO = 5;   // 6: L[t,t-1], L[t,t-2] of rows t%3 (ring of 3)
constexpr int B_L3 = 11;  // 1: L[t,t-3]
constexpr int B_XR = 12;  // 3: X[t] = L[t,t]^-1 of rows t%3 (ring of 3)
constexpr int B_LT = 15;  // 1: off-diagonal panels of L[t,t]
constexpr int B_R = 16;   // 2: partial sums of big_nt

#ifdef BANDED_PHASE_PROBE
constexpr int NPROBE = 8;
enum { PR_LOAD, PR_OFFDIAG, PR_TRSM, PR_SCHUR, PR_CHOL, PR_PANEL, PR_FWD,
       PR_BWD };
__device__ long long* g_probe;
#define PROBE(k)                                                   \
  do {                                                             \
    if (threadIdx.x == 0) {                                        \
      const long long c_ = clock64();                              \
      prb[k] += c_ - last;                                         \
      last = c_;                                                   \
    }                                                              \
  } while (0)
#else
#define PROBE(k) \
  do {           \
  } while (0)
#endif

__device__ __forceinline__ float qnan() { return __int_as_float(0x7fc00000); }

__device__ __forceinline__ void cp_async16(float* s, const float* g) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a),
               "l"(g));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// start copying one dense 54x54 block (11,664 bytes = 729 16-byte chunks)
__device__ __forceinline__ void copy_block_async(float* s, const float* g) {
  for (int e = threadIdx.x; e < DD / 4; e += THREADS)
    cp_async16(s + 4 * e, g + 4 * e);
}

// C = A0 B0^T (sub = false) or C -= sum_{p<n} A_p B_p^T (sub = true), all
// 54x54 dense. Every thread takes part (the function holds a block
// barrier). Threads 0..242 own a 6x6 register tile (rows it + 9r, columns
// kt + 9c) of one third of the m range (slice = tid / 81), so all eight
// warps, two on each scheduler, share the FMAs, and each tile's 12 operand
// loads feed 36 FMAs; operands are read two m at a time (8-byte loads: the
// row stride 54 is even). Each slice then owns a third of the tile's rows:
// the two other slices leave their partial sums of those rows in R (two
// blocks), and the owner adds the three in slice order and writes C, and Cg
// (global, dense) when it is not null. A tile's (r, c) entries make up the
// 9x9 block (r, c) of C; with kLower (the symmetric Schur update, whose
// upper blocks nothing reads) the blocks above the diagonal are skipped.
template <bool kLower>
__device__ void big_nt(float* C, float* Cg, bool sub, int n, const float* A0,
                       const float* B0, const float* A1, const float* B1,
                       const float* A2, const float* B2, float* R) {
  const int tid = threadIdx.x;
  const int slice = tid / 81, tile = tid % 81, it = tile / 9, kt = tile % 9;
  float acc[6][6];
#pragma unroll
  for (int r = 0; r < 6; ++r)
#pragma unroll
    for (int c = 0; c < 6; ++c) acc[r][c] = 0.f;
  if (slice < 3) {
    for (int p = 0; p < n; ++p) {
      const float* a = (p == 0 ? A0 : (p == 1 ? A1 : A2)) + it * D + 18 * slice;
      const float* b = (p == 0 ? B0 : (p == 1 ? B1 : B2)) + kt * D + 18 * slice;
#pragma unroll 1
      for (int m = 0; m < 18; m += 2) {
        float2 av[6], bv[6];
#pragma unroll
        for (int r = 0; r < 6; ++r)
          av[r] = *reinterpret_cast<const float2*>(a + r * 9 * D + m);
#pragma unroll
        for (int c = 0; c < 6; ++c)
          bv[c] = *reinterpret_cast<const float2*>(b + c * 9 * D + m);
#pragma unroll
        for (int r = 0; r < 6; ++r)
#pragma unroll
          for (int c = 0; c < 6; ++c) {
            if (kLower && c > r) continue;
            acc[r][c] = fmaf(av[r].x, bv[c].x, acc[r][c]);
            acc[r][c] = fmaf(av[r].y, bv[c].y, acc[r][c]);
          }
      }
    }
  }
  // slice s owns rows 2s, 2s+1 of each tile; the two other slices leave
  // their partial sums of those rows in R, the lower-numbered one in the
  // first block, and the owner adds the three in slice order
  if (slice < 3) {
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      const int owner = r / 2;
      if (owner == slice) continue;
      float* Rs = R + (slice - (owner < slice ? 1 : 0)) * DD;
#pragma unroll
      for (int c = 0; c < 6; ++c) Rs[(it + 9 * r) * D + kt + 9 * c] = acc[r][c];
    }
  }
  __syncthreads();
  if (slice < 3) {
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      if (r / 2 != slice) continue;
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        const int e = (it + 9 * r) * D + kt + 9 * c;
        const float p0 = R[e], p1 = R[DD + e];       // the other two slices
        const float t = slice == 0 ? (acc[r][c] + p0) + p1
                      : slice == 1 ? (p0 + acc[r][c]) + p1
                                   : (p0 + p1) + acc[r][c];
        const float v = sub ? C[e] - t : t;
        C[e] = v;
        if (Cg) Cg[e] = v;
      }
    }
  }
}

// Work ahead on row t+1 while warp 0 factors row t's diagonal block: C =
// A B^T (sub = false) or C -= A B^T (sub = true), 54x54 dense, by warps
// 1-3 and 5-7 alone, without a block barrier: 162 threads each own a 3x6
// register tile (rows it + 18r, columns kt + 9c; a warp's loads of B hit 9 distinct
// bank pairs), operands read two m at a time. The result also goes to Cg
// (global, dense) when it is not null.
__device__ void ahead_nt(float* C, float* Cg, bool sub, const float* A,
                         const float* B) {
  // warps 1-3 and 5-7: warp 4 shares warp 0's scheduler and stays idle
  const int w = threadIdx.x / 32;
  const int tid = threadIdx.x - (w < 4 ? 32 : 64);
  if (w == 0 || w == 4 || tid >= 162) return;
  const int it = tid / 9, kt = tid % 9;
  float acc[3][6];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 6; ++c) acc[r][c] = 0.f;
  const float* a = A + it * D;
  const float* b = B + kt * D;
#pragma unroll 3
  for (int m = 0; m < D; m += 2) {
    float2 av[3], bv[6];
#pragma unroll
    for (int r = 0; r < 3; ++r)
      av[r] = *reinterpret_cast<const float2*>(a + r * P * D + m);
#pragma unroll
    for (int c = 0; c < 6; ++c)
      bv[c] = *reinterpret_cast<const float2*>(b + c * 9 * D + m);
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        acc[r][c] = fmaf(av[r].x, bv[c].x, acc[r][c]);
        acc[r][c] = fmaf(av[r].y, bv[c].y, acc[r][c]);
      }
  }
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      const int e = (it + P * r) * D + kt + 9 * c;
      const float v = sub ? C[e] - acc[r][c] : acc[r][c];
      C[e] = v;
      if (Cg) Cg[e] = v;
    }
}

// One 18x18x18 product: C {=, -=, +=, = -} A op(B), op(B) = B^T (nt) or B.
// Strides in floats; Cg (global, stride D) optional.
enum { SJ_SET, SJ_SUB, SJ_ADD, SJ_NEG };
struct SmallJob {
  float* C;
  const float* A;
  const float* B;
  float* Cg;
  int ldc, lda, ldb;
  int nt, mode;
};

// One warp runs one small job (kParts = 1), or one of two warps runs half
// of it (kParts = 2, part 0 or 1): lanes 0..26 each own a 2x6 tile (rows
// ti + 9r, columns tk + 3c), or its columns c = 3 part .. 3 part + 2. A
// phase gives each warp its own job, so no warp diverges between jobs.
template <int kParts>
__device__ void small_job(const SmallJob J, int part) {
  constexpr int NC = 6 / kParts;
  const int lane = threadIdx.x & 31;
  if (lane >= 27) return;
  const int ti = lane / 3, tk = lane % 3;
  float acc[2][NC];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  const float* a = J.A + ti * J.lda;
  const int bs = J.nt ? J.ldb : 1, bm = J.nt ? 1 : J.ldb;   // B[k][m] steps
  const float* b = J.B + (tk + 3 * NC * part) * bs;
#pragma unroll 6
  for (int m = 0; m < P; ++m) {
    float av[2], bv[NC];
#pragma unroll
    for (int r = 0; r < 2; ++r) av[r] = a[9 * r * J.lda + m];
#pragma unroll
    for (int c = 0; c < NC; ++c) bv[c] = b[3 * c * bs + m * bm];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int i = ti + 9 * r, k = tk + 3 * (c + NC * part);
      float* cp = J.C + i * J.ldc + k;
      const float old = *cp, t = acc[r][c];
      const float v = J.mode == SJ_SUB ? old - t
                    : J.mode == SJ_ADD ? old + t
                    : J.mode == SJ_NEG ? -t : t;
      *cp = v;
      if (J.Cg) J.Cg[i * D + k] = v;
    }
}

// One warp: Cholesky of the 18x18 diagonal block S (stride D, lower part
// read) and its inverse. Lane r holds row r in registers. The pivot chain
// is right-looking on the unscaled columns: pivot c is broadcast by
// shuffle, its reciprocal taken once (__frcp_rn), and row r's trailing
// entries take a[r][k] -= (a[r][c] / p_c) a[k][c], with a[k][c] shuffled
// before the reciprocal is ready, so a step's dependent chain is one
// shuffle, the reciprocal and two FMAs. After the chain, lane c alone takes
// the square root 1/sqrt(p_c) = sqrt(1/p_c) and L[c][c] = p_c / sqrt(p_c),
// and shuffles the former to the lanes that scale column c (L[r][c] =
// a[r][c] / sqrt(p_c)): one square root per lane instead of eighteen
// special-function sequences in a row. L goes back into S; lane j then
// forms column j of X = L^-1 by a right-looking substitution against the
// broadcast L[m][i], and writes it to X (stride D, zeros above the
// diagonal) and Xg (global). A failed pivot sets *bad.
__device__ __noinline__ void chol_inv_panel(float* S, float* X, float* Xg,
                                            int* bad) {
  const int lane = threadIdx.x & 31;
  float a[P];
#pragma unroll
  for (int c = 0; c < P; ++c)
    a[c] = (lane < P && c <= lane) ? S[lane * D + c] : 0.f;
  bool ok = true;
  float my_piv = 0.f, my_inv = 0.f;        // lane c's pivot and 1/pivot
#pragma unroll
  for (int c = 0; c < P; ++c) {
    const float piv = __shfl_sync(0xffffffffu, a[c], c);
    float u[P];
#pragma unroll
    for (int k = c + 1; k < P; ++k) u[k] = __shfl_sync(0xffffffffu, a[c], k);
    ok = ok && piv > 0.f;
    const float inv = piv > 0.f ? __frcp_rn(piv) : qnan();
    my_piv = lane == c ? piv : my_piv;
    my_inv = lane == c ? inv : my_inv;
    // every entry right of column c takes the update: those above the
    // diagonal (k > lane) and the rows of lanes >= P are never read, and
    // updating them all keeps the loop free of predicates and branches
    const float l = a[c] * inv;
#pragma unroll
    for (int k = c + 1; k < P; ++k) a[k] = fmaf(-l, u[k], a[k]);
  }
  if (!ok && lane == 0) *bad = 1;
  const float my_rs = sqrtf(my_inv);       // 1 / L[lane][lane]
  float rinv[P];
#pragma unroll
  for (int c = 0; c < P; ++c) {
    rinv[c] = __shfl_sync(0xffffffffu, my_rs, c);
    a[c] = c == lane ? my_piv * my_rs : a[c] * rinv[c];
  }
  if (lane < P) {                          // row lane of L (and garbage
#pragma unroll                             // above the diagonal, unread)
    for (int c = 0; c < P; ++c) S[lane * D + c] = a[c];
  }
  __syncwarp();
  float x[P];
#pragma unroll
  for (int i = 0; i < P; ++i) x[i] = i == lane ? 1.f : 0.f;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    x[i] *= rinv[i];
#pragma unroll
    for (int m = i + 1; m < P; ++m) x[m] = fmaf(-S[m * D + i], x[i], x[m]);
  }
  if (lane < P) {
#pragma unroll
    for (int i = 0; i < P; ++i) {
      X[i * D + lane] = x[i];
      Xg[i * D + lane] = x[i];
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
banded_solve_kernel(const float* __restrict__ diag,
                    const float* __restrict__ lower,
                    const float* __restrict__ rhs, float* x, float* work,
                    int N) {
  extern __shared__ __align__(16) float smem[];
  float* blk = smem;                                  // NBLK dense blocks
  float* T = blk + NBLK * DD;                         // 3 18x18 scratch
  float* yring = T + 3 * TS;                          // 4 vectors
  float* xring = yring + 4 * VP;                      // 4 vectors
  float* part = xring + 4 * VP;                       // 4 partial sums
  float* sv = part + 4 * VP;                          // 1 vector
  __shared__ int bad;
#ifdef BANDED_PHASE_PROBE
  __shared__ long long prb[NPROBE];
  long long last = clock64();
  if (threadIdx.x < NPROBE) prb[threadIdx.x] = 0;
#endif
  const int tid = threadIdx.x, warp = tid / 32;
  const size_t b = blockIdx.x;
  const float* Hd = diag + b * N * DD;
  const float* Hl = lower + b * BW * N * DD;          // [k][t] blocks
  const float* rb = rhs + b * N * D;
  float* xb = x + b * N * D;
  float* Wg = work + b * N * (BW + 1) * DD;           // [t][L1, L2, L3, X]
  auto B = [&](int i) { return blk + i * DD; };
  if (tid == 0) bad = 0;
  // X's strictly upper blocks are never written: zero them once
  for (int e = tid; e < 3 * DD; e += THREADS) B(B_XR)[e] = 0.f;

  // copy frame t's staged blocks: H[t,t-2], H[t,t-3] and H[t,t] (group 0),
  // or H[t,t-1] (group 1), each one cp.async group
  auto prefetch = [&](int t, int group) {
    const int nb = t < BW ? t : BW;
    if (group == 0) {
      for (int j = 2; j <= nb; ++j)
        copy_block_async(B(B_HS + j - 1),
                         Hl + ((size_t)(j - 1) * N + (t - j)) * DD);
      copy_block_async(B(B_HD + (t & 1)), Hd + (size_t)t * DD);
    } else if (nb >= 1) {
      copy_block_async(B(B_HS), Hl + (size_t)(t - 1) * DD);
    }
    cp_async_commit();
  };
  prefetch(0, 0);
  cp_async_wait_all();
  __syncthreads();
  PROBE(PR_LOAD);

  // ---- forward: factor row t, y[t] -----------------------------------
  for (int t = 0; t < N; ++t) {
    const int nb = t < BW ? t : BW;
    float* H1 = B(B_HS);
    float* H2 = B(B_HS + 1);
    const float* H3 = B(B_HS + 2);
    float* S = B(B_HD + (t & 1));
    float* L1 = B(B_LO + 2 * (t % 3));
    float* L2 = L1 + DD;
    float* L3 = B(B_L3);
    const float* L1p = B(B_LO + 2 * ((t + 2) % 3));   // L[t-1, t-2]
    const float* L2p = L1p + DD;                      // L[t-1, t-3]
    const float* X1 = B(B_XR + (t + 2) % 3);          // X[t-1]
    const float* X2 = B(B_XR + (t + 1) % 3);          // X[t-2]
    float* Xt = B(B_XR + t % 3);                      // X[t-3], then X[t]
    float* Lt = B(B_LT);
    float* R = B(B_R);
    float* Wt = Wg + (size_t)t * (BW + 1) * DD;

    // row t's L[t,t-3] and L[t,t-2] (and M_2 in H2) were formed ahead,
    // while frame t-1 factored its diagonal block, so their staging buffers
    // and frame t-1's diagonal buffer are free: start copying frame t+1's
    if (t + 1 < N) prefetch(t + 1, 0);
    if (nb >= 2) {
      big_nt<false>(H1, nullptr, true, nb - 1, L2, L1p, L3, L2p, nullptr,
                    nullptr, R);
      __syncthreads();
      PROBE(PR_OFFDIAG);
    }
    if (nb >= 1) {
      big_nt<false>(L1, Wt, false, 1, H1, X1, nullptr, nullptr, nullptr,
                    nullptr, R);
      __syncthreads();
      PROBE(PR_TRSM);
    }
    // H[t,t-1] is consumed too
    if (t + 1 < N) prefetch(t + 1, 1);
    // s = b[t] - sum_j L[t,t-j] y[t-j]: four threads per row, each a
    // quarter of the columns, summed by two shuffles
    {
      const int r = tid / 4, q = tid % 4;
      const int m0 = q * 14, m1 = m0 + 14 < D ? m0 + 14 : D;
      float acc = 0.f;
      if (r < D) {
        const float* Ls[3] = {L1, L2, L3};
        for (int j = 1; j <= nb; ++j) {
          const float* Lr = Ls[j - 1] + r * D;
          const float* yj = yring + ((t - j) & 3) * VP;
          for (int m = m0; m < m1; ++m) acc = fmaf(Lr[m], yj[m], acc);
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (r < D && q == 0) sv[r] = rb[(size_t)t * D + r] - acc;
    }
    // S = H[t,t] - sum_j L_j L_j^T
    if (nb >= 1)
      big_nt<true>(S, nullptr, true, nb, L1, L1, L2, L2, L3, L3, R);
    PROBE(PR_SCHUR);
    // the work ahead reads H[t+1,t-2] and H[t+1,t-1]: wait for all but the
    // newest group (H[t+1,t], read in frame t+1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    PROBE(PR_LOAD);

    // ---- X[t] = chol(S)^-1 by 18-wide panels ---------------------------
    float* Xg = Wt + 3 * DD;
    float* T10 = T;
    float* T20 = T + TS;
    float* T21 = T + 2 * TS;
#define SB(M, a, c) ((M) + (a) * P * D + (c) * P)
    // while warp 0 factors, warps 1-7 form row t+1's L[t+1,t-2] (needs
    // X[t-2]), M_2 = H[t+1,t-1] - L[t+1,t-2] L[t-1,t-2]^T and
    // L[t+1,t-1] = M_2 X[t-1]^T, one per panel
    const int nb1 = t + 1 < N ? (t + 1 < BW ? t + 1 : BW) : 0;
    float* L2n = B(B_LO + 2 * ((t + 1) % 3)) + DD;    // row t+1's L2
    float* Wn = Wt + (BW + 1) * DD;                   // row t+1's blocks
    if (warp == 0) chol_inv_panel(SB(S, 0, 0), SB(Xt, 0, 0), SB(Xg, 0, 0), &bad);
    else if (nb1 == 3) ahead_nt(L3, Wn + 2 * DD, false, H3, X2);
    __syncthreads();
    PROBE(PR_CHOL);
    if (warp < 4)
      small_job<2>(warp < 2
          ? SmallJob{SB(Lt, 1, 0), SB(S, 1, 0), SB(Xt, 0, 0), nullptr, D, D, D, 1, SJ_SET}
          : SmallJob{SB(Lt, 2, 0), SB(S, 2, 0), SB(Xt, 0, 0), nullptr, D, D, D, 1, SJ_SET},
          warp & 1);
    __syncthreads();
    if (warp < 5) {
      SmallJob J;
      switch (warp) {
        case 0: J = {SB(S, 1, 1), SB(Lt, 1, 0), SB(Lt, 1, 0), nullptr, D, D, D, 1, SJ_SUB}; break;
        case 1: J = {SB(S, 2, 1), SB(Lt, 2, 0), SB(Lt, 1, 0), nullptr, D, D, D, 1, SJ_SUB}; break;
        case 2: J = {SB(S, 2, 2), SB(Lt, 2, 0), SB(Lt, 2, 0), nullptr, D, D, D, 1, SJ_SUB}; break;
        case 3: J = {T10, SB(Lt, 1, 0), SB(Xt, 0, 0), nullptr, P, D, D, 0, SJ_SET}; break;
        default: J = {T20, SB(Lt, 2, 0), SB(Xt, 0, 0), nullptr, P, D, D, 0, SJ_SET};
      }
      small_job<1>(J, 0);
    }
    __syncthreads();
    PROBE(PR_PANEL);
    if (warp == 0) chol_inv_panel(SB(S, 1, 1), SB(Xt, 1, 1), SB(Xg, 1, 1), &bad);
    else if (nb1 == 3) ahead_nt(H2, nullptr, true, L3, L1p);
    __syncthreads();
    PROBE(PR_CHOL);
    if (warp < 4)
      small_job<2>(warp < 2
          ? SmallJob{SB(Lt, 2, 1), SB(S, 2, 1), SB(Xt, 1, 1), nullptr, D, D, D, 1, SJ_SET}
          : SmallJob{SB(Xt, 1, 0), SB(Xt, 1, 1), T10, SB(Xg, 1, 0), D, D, P, 0, SJ_NEG},
          warp & 1);
    __syncthreads();
    if (warp < 6) {
      SmallJob J;
      switch (warp / 2) {
        case 0: J = {SB(S, 2, 2), SB(Lt, 2, 1), SB(Lt, 2, 1), nullptr, D, D, D, 1, SJ_SUB}; break;
        case 1: J = {T20, SB(Lt, 2, 1), SB(Xt, 1, 0), nullptr, P, D, D, 0, SJ_ADD}; break;
        default: J = {T21, SB(Lt, 2, 1), SB(Xt, 1, 1), nullptr, P, D, D, 0, SJ_SET};
      }
      small_job<2>(J, warp & 1);
    }
    __syncthreads();
    PROBE(PR_PANEL);
    if (warp == 0) chol_inv_panel(SB(S, 2, 2), SB(Xt, 2, 2), SB(Xg, 2, 2), &bad);
    else if (nb1 >= 2) ahead_nt(L2n, Wn + DD, false, H2, X1);
    __syncthreads();
    PROBE(PR_CHOL);
    if (warp < 4)
      small_job<2>(warp < 2
          ? SmallJob{SB(Xt, 2, 1), SB(Xt, 2, 2), T21, SB(Xg, 2, 1), D, D, P, 0, SJ_NEG}
          : SmallJob{SB(Xt, 2, 0), SB(Xt, 2, 2), T20, SB(Xg, 2, 0), D, D, P, 0, SJ_NEG},
          warp & 1);
#undef SB
    __syncthreads();
    PROBE(PR_PANEL);
    // y[t] = X[t] s (lower-triangular matvec, one thread per row)
    if (tid < D) {
      const float* Xr = Xt + tid * D;
      float a0 = 0.f, a1 = 0.f;
      int m = 0;
      for (; m + 1 <= tid; m += 2) {
        a0 = fmaf(Xr[m], sv[m], a0);
        a1 = fmaf(Xr[m + 1], sv[m + 1], a1);
      }
      if (m <= tid) a0 = fmaf(Xr[m], sv[m], a0);
      const float y = a0 + a1;
      yring[(t & 3) * VP + tid] = y;
      xb[(size_t)t * D + tid] = y;
    }
    cp_async_wait_all();
    __syncthreads();
    PROBE(PR_FWD);
  }

  // ---- backward: x[t] = X[t]^T (y[t] - sum_j L[t+j,t]^T x[t+j]) --------
  // the factor rows written above are read back through L2 (cp.async.cg)
  __threadfence();
  __syncthreads();
  // buffers: X[t] in block buf, L[t+j,t] in blocks 2 + 3 buf + j - 1
  auto prefetch_bwd = [&](int t, int buf) {
    copy_block_async(B(buf), Wg + ((size_t)t * (BW + 1) + BW) * DD);
    for (int j = 1; j <= BW && t + j < N; ++j)
      copy_block_async(B(2 + 3 * buf + j - 1),
                       Wg + ((size_t)(t + j) * (BW + 1) + j - 1) * DD);
    cp_async_commit();
  };
  prefetch_bwd(N - 1, 0);
  const int r = tid % D, q = tid / D;               // q < 4: a quarter of i
  const int i0 = q * 14, i1 = i0 + 14 < D ? i0 + 14 : D;
  for (int t = N - 1; t >= 0; --t) {
    const int buf = (N - 1 - t) & 1;
    cp_async_wait_all();
    __syncthreads();
    PROBE(PR_LOAD);
    if (t > 0) prefetch_bwd(t - 1, buf ^ 1);
    const float yv = tid < D ? xb[(size_t)t * D + tid] : 0.f;
    if (q < 4) {
      float acc = 0.f;
      for (int j = 1; j <= BW && t + j < N; ++j) {
        const float* Lj = B(2 + 3 * buf + j - 1);
        const float* xj = xring + ((t + j) & 3) * VP;
        for (int i = i0; i < i1; ++i) acc = fmaf(Lj[i * D + r], xj[i], acc);
      }
      part[q * VP + r] = acc;
    }
    __syncthreads();
    if (tid < D)
      sv[tid] = yv - ((part[tid] + part[VP + tid]) +
                      (part[2 * VP + tid] + part[3 * VP + tid]));
    __syncthreads();
    if (q < 4) {
      const float* X = B(buf);
      float acc = 0.f;
      for (int i = i0 > r ? i0 : r; i < i1; ++i)
        acc = fmaf(X[i * D + r], sv[i], acc);
      part[q * VP + r] = acc;
    }
    __syncthreads();
    if (tid < D) {
      const float v = (part[tid] + part[VP + tid]) +
                      (part[2 * VP + tid] + part[3 * VP + tid]);
      xring[(t & 3) * VP + tid] = v;
      xb[(size_t)t * D + tid] = v;
    }
    PROBE(PR_BWD);
  }
  __syncthreads();
  if (bad) {
    for (int e = tid; e < N * D; e += THREADS) xb[e] = qnan();
  }
#ifdef BANDED_PHASE_PROBE
  if (tid < NPROBE) g_probe[b * NPROBE + tid] = prb[tid];
#endif
}

}  // namespace

extern "C" {

// Once per process, before the first launch: allow the kernel its ~212 KB
// of dynamic shared memory on the current device. Returns the CUDA error
// (0 = ok).
int banded_solve_init() {
  return (int)cudaFuncSetAttribute(banded_solve_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)SMEM_BYTES);
}

// Solve B systems; work holds B*N*4*54*54 floats of factor rows. All
// pointers 16-byte aligned. Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
int banded_solve_f32(const float* diag, const float* lower, const float* rhs,
                     float* x, float* work, int B, int N, void* stream) {
  banded_solve_kernel<<<B, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      diag, lower, rhs, x, work, N);
  return (int)cudaGetLastError();
}

#ifdef BANDED_PHASE_PROBE
// The phase probe's buffer: B*NPROBE counters, written by every launch.
int banded_probe_set(long long* probe) {
  return (int)cudaMemcpyToSymbol(g_probe, &probe, sizeof(probe));
}
#endif

}  // extern "C"
