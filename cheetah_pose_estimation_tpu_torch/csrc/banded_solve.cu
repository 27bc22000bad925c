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
// Design. One thread block per system; a loop over frames inside the block
// takes the place of the TPU's sequential grid. Frame t of the forward pass:
//   for j = 3..1:  L[t,t-j] = (H[t,t-j] - sum_{k>j} L[t,t-k] L[t-j,t-k]^T)
//                             L[t-j,t-j]^-T
//   L[t,t] = chol(H[t,t] - sum_j L[t,t-j] L[t,t-j]^T)
//   y[t]   = L[t,t]^-1 (b[t] - sum_j L[t,t-j] y[t-j])
// and the backward pass x[t] = L[t,t]^-T (y[t] - sum_j L[t+j,t]^T x[t+j]).
// Blocks stay 54 wide (the TPU kernel's 64-lane pad was a tiling need). The
// last four factor rows (the current one and the 3-deep window it reads)
// live in dynamic shared memory, 16 blocks with an odd row stride of 55
// floats so that column walks are free of bank conflicts (~190 KB, above
// the 48 KB static limit, hence cudaFuncSetAttribute). Every factor row also
// goes to a global scratch buffer that the backward pass reads.
//
// Arithmetic is plain float32 FMA: no tensor cores, no TF32, sqrtf, and
// each pivot's reciprocal once with the correctly rounded __frcp_rn (build
// without --use_fast_math). Dividing by the pivot per element instead was
// measured 2.5x slower on the H100: every float32 division carries a
// slow-path check and call. A non-positive (or NaN) pivot
// makes that system's whole solution NaN, like the torch scan path
// (cholesky_ex + NaN), so the LM driver rejects the step and raises the
// damping. The TPU kernel clamped the pivot at 1e-30 instead.
//
// What bounds it: latency. Each frame has 54 dependent pivot steps in the
// Cholesky plus three 54-step triangular solves, the frames run in sequence,
// and the only parallelism across the card is one block per system (B = 10
// to 30 on 132 SMs). Making it fast is later work: several systems per SM,
// wgmma for the block products, and a parallel-in-time cyclic-reduction
// variant.
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int D = 54;                  // block size
constexpr int LD = 55;                 // shared-memory row stride
constexpr int BLK = D * LD;            // floats per shared block
constexpr int BW = 3;                  // bandwidth
constexpr int RING = 4;                // rows t, t-1, t-2, t-3
constexpr int VPAD = 64;               // padded vector length
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RPW = (D + WARPS - 1) / WARPS;   // rows per warp in a TRSM
constexpr size_t DD = (size_t)D * D;
constexpr size_t SMEM_BYTES =
    sizeof(float) * ((size_t)RING * (BW + 1) * BLK + RING * VPAD);

// shared block `which` (0..2 = L[t, t-1-which], 3 = L[t, t]) of row t
__device__ __forceinline__ float* row_block(float* ring, int t, int which) {
  return ring + ((t & (RING - 1)) * (BW + 1) + which) * BLK;
}

__device__ void load_block(float* s, const float* g) {
  for (int e = threadIdx.x; e < D * D; e += THREADS)
    s[(e / D) * LD + e % D] = g[e];
}

__device__ void store_block(float* g, const float* s) {
  for (int e = threadIdx.x; e < D * D; e += THREADS)
    g[e] = s[(e / D) * LD + e % D];
}

// C -= sum_p A_p B_p^T over n terms; 2x3 register tiles (27 x 18 of them)
__device__ void gemm_nt_sub(float* C, const float* A0, const float* B0,
                            const float* A1, const float* B1,
                            const float* A2, const float* B2, int n) {
  for (int tile = threadIdx.x; tile < 27 * 18; tile += THREADS) {
    const int i0 = (tile / 18) * 2, k0 = (tile % 18) * 3;
    float acc[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
    for (int p = 0; p < n; ++p) {
      const float* a = p == 0 ? A0 : (p == 1 ? A1 : A2);
      const float* b = p == 0 ? B0 : (p == 1 ? B1 : B2);
      for (int m = 0; m < D; ++m) {
        const float a0 = a[i0 * LD + m], a1 = a[(i0 + 1) * LD + m];
        const float b0 = b[k0 * LD + m], b1 = b[(k0 + 1) * LD + m],
                    b2 = b[(k0 + 2) * LD + m];
        acc[0][0] = fmaf(a0, b0, acc[0][0]);
        acc[0][1] = fmaf(a0, b1, acc[0][1]);
        acc[0][2] = fmaf(a0, b2, acc[0][2]);
        acc[1][0] = fmaf(a1, b0, acc[1][0]);
        acc[1][1] = fmaf(a1, b1, acc[1][1]);
        acc[1][2] = fmaf(a1, b2, acc[1][2]);
      }
    }
    for (int r = 0; r < 2; ++r)
      for (int c = 0; c < 3; ++c) C[(i0 + r) * LD + k0 + c] -= acc[r][c];
  }
}

// In-place lower Cholesky of the shared block S, right-looking on the
// unscaled column with one block barrier per pivot: warp w updates rows
// c+1+w, c+9+w, ..., its lanes the columns of each row. Then all threads
// scale the columns and zero the strict upper triangle. A failed pivot sets
// *bad and propagates NaN.
__device__ void chol_inplace(float* S, int* bad) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int c = 0; c < D; ++c) {
    const float p = S[c * LD + c];
    const float inv = p > 0.f ? __frcp_rn(p) : __int_as_float(0x7fc00000);
    if (threadIdx.x == 0 && !(p > 0.f)) *bad = 1;
    for (int r = c + 1 + warp; r < D; r += WARPS) {
      const float a = S[r * LD + c] * inv;
      for (int k = c + 1 + lane; k <= r; k += 32)
        S[r * LD + k] = fmaf(-a, S[k * LD + c], S[r * LD + k]);
    }
    __syncthreads();
  }
  // scale: L[r][c] = S[r][c] / sqrt(S[c][c]); zero the strict upper part
  for (int e = threadIdx.x; e < D * D; e += THREADS) {
    const int r = e / D, c = e % D;
    if (c > r) S[r * LD + c] = 0.f;
    else if (c < r) S[r * LD + c] *= __frcp_rn(sqrtf(S[c * LD + c]));
  }
  __syncthreads();
  for (int c = threadIdx.x; c < D; c += THREADS) S[c * LD + c] = sqrtf(S[c * LD + c]);
  __syncthreads();
}

// X <- X L^-T for the nrows rows of X (row stride ldx), L lower-triangular
// in shared memory: each row is a forward substitution L x = row^T, one warp
// per row, lanes holding columns lane and lane + 32, the solved entry
// broadcast by shuffle.
__device__ void trsm_rows(float* X, int ldx, int nrows, const float* L) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= nrows) return;
  float v0[RPW], v1[RPW];
#pragma unroll
  for (int q = 0; q < RPW; ++q) {
    const int r = warp + q * WARPS;
    const bool ok = r < nrows;
    v0[q] = ok ? X[r * ldx + lane] : 0.f;
    v1[q] = (ok && lane + 32 < D) ? X[r * ldx + lane + 32] : 0.f;
  }
  for (int c = 0; c < D; ++c) {
    const float rinv = __frcp_rn(L[c * LD + c]);
    const float l0 = lane > c ? L[lane * LD + c] : 0.f;
    const float l1 = (lane + 32 > c && lane + 32 < D) ? L[(lane + 32) * LD + c]
                                                      : 0.f;
#pragma unroll
    for (int q = 0; q < RPW; ++q) {
      const float own = c < 32 ? v0[q] : v1[q];
      const float xc = __shfl_sync(0xffffffffu, own, c & 31) * rinv;
      if (lane == (c & 31)) {
        if (c < 32) v0[q] = xc; else v1[q] = xc;
      }
      v0[q] = fmaf(-xc, l0, v0[q]);
      v1[q] = fmaf(-xc, l1, v1[q]);
    }
  }
#pragma unroll
  for (int q = 0; q < RPW; ++q) {
    const int r = warp + q * WARPS;
    if (r < nrows) {
      X[r * ldx + lane] = v0[q];
      if (lane + 32 < D) X[r * ldx + lane + 32] = v1[q];
    }
  }
}

// v <- L^-T v (backward substitution with the transpose), one warp
__device__ void trsv_t(float* v, const float* L) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  float v0 = v[lane], v1 = lane + 32 < D ? v[lane + 32] : 0.f;
  for (int c = D - 1; c >= 0; --c) {
    const float own = c < 32 ? v0 : v1;
    const float xc = __shfl_sync(0xffffffffu, own, c & 31) *
                     __frcp_rn(L[c * LD + c]);
    if (lane == (c & 31)) {
      if (c < 32) v0 = xc; else v1 = xc;
    }
    const float l0 = lane < c ? L[c * LD + lane] : 0.f;
    const float l1 = lane + 32 < c ? L[c * LD + lane + 32] : 0.f;
    v0 = fmaf(-xc, l0, v0);
    v1 = fmaf(-xc, l1, v1);
  }
  v[lane] = v0;
  if (lane + 32 < D) v[lane + 32] = v1;
}

__global__ void __launch_bounds__(THREADS, 1)
banded_solve_kernel(const float* __restrict__ diag,
                    const float* __restrict__ lower,
                    const float* __restrict__ rhs, float* x, float* work,
                    int N) {
  extern __shared__ float smem[];
  float* ring = smem;                                 // RING*(BW+1) blocks
  float* vring = ring + RING * (BW + 1) * BLK;        // RING vectors
  __shared__ int bad;
  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;
  const float* Hd = diag + b * N * DD;
  const float* Hl = lower + b * BW * N * DD;          // [k][t] blocks
  const float* rb = rhs + b * N * D;
  float* xb = x + b * N * D;
  float* Lg = work + b * N * (BW + 1) * DD;           // [t][which] blocks
  if (tid == 0) bad = 0;

  // ---- forward: factor row t, y[t] -----------------------------------
  for (int t = 0; t < N; ++t) {
    const int nb = t < BW ? t : BW;
    for (int j = 1; j <= nb; ++j)
      load_block(row_block(ring, t, j - 1), Hl + ((size_t)(j - 1) * N + (t - j)) * DD);
    load_block(row_block(ring, t, BW), Hd + (size_t)t * DD);
    __syncthreads();
    for (int j = nb; j >= 1; --j) {
      float* M = row_block(ring, t, j - 1);
      const int n = nb - j;                           // terms k = j+1..nb
      if (n > 0) {
        // M -= L[t, t-k] L[t-j, t-k]^T; L[t-j, t-k] is row t-j, block k-j-1
        gemm_nt_sub(M, row_block(ring, t, j), row_block(ring, t - j, 0),
                    n > 1 ? row_block(ring, t, j + 1) : nullptr,
                    n > 1 ? row_block(ring, t - j, 1) : nullptr,
                    nullptr, nullptr, n);
        __syncthreads();
      }
      trsm_rows(M, LD, D, row_block(ring, t - j, BW));
      __syncthreads();
    }
    float* S = row_block(ring, t, BW);
    if (nb > 0) {
      const float* L1 = row_block(ring, t, 0);
      const float* L2 = nb > 1 ? row_block(ring, t, 1) : nullptr;
      const float* L3 = nb > 2 ? row_block(ring, t, 2) : nullptr;
      gemm_nt_sub(S, L1, L1, L2, L2, L3, L3, nb);
      __syncthreads();
    }
    chol_inplace(S, &bad);
    float* y = vring + (t & (RING - 1)) * VPAD;
    if (tid < D) {
      float s = rb[(size_t)t * D + tid];
      for (int j = 1; j <= nb; ++j) {
        const float* Lj = row_block(ring, t, j - 1);
        const float* yj = vring + ((t - j) & (RING - 1)) * VPAD;
        for (int m = 0; m < D; ++m) s = fmaf(-Lj[tid * LD + m], yj[m], s);
      }
      y[tid] = s;
    }
    __syncthreads();
    trsm_rows(y, VPAD, 1, S);
    __syncthreads();
    if (tid < D) xb[(size_t)t * D + tid] = y[tid];
    for (int j = 1; j <= nb; ++j)
      store_block(Lg + ((size_t)t * (BW + 1) + j - 1) * DD, row_block(ring, t, j - 1));
    store_block(Lg + ((size_t)t * (BW + 1) + BW) * DD, S);
    __syncthreads();
  }

  // ---- backward: x[t] = L[t,t]^-T (y[t] - sum_j L[t+j,t]^T x[t+j]) -----
  float* Ld = ring;
  for (int t = N - 1; t >= 0; --t) {
    load_block(Ld, Lg + ((size_t)t * (BW + 1) + BW) * DD);
    float* v = vring + (t & (RING - 1)) * VPAD;
    if (tid < D) {
      float s = xb[(size_t)t * D + tid];              // y[t]
      for (int j = 1; j <= BW && t + j < N; ++j) {
        const float* Lj = Lg + ((size_t)(t + j) * (BW + 1) + j - 1) * DD;
        const float* xj = vring + ((t + j) & (RING - 1)) * VPAD;
        for (int r = 0; r < D; ++r) s = fmaf(-Lj[r * D + tid], xj[r], s);
      }
      v[tid] = s;
    }
    __syncthreads();
    trsv_t(v, Ld);
    __syncthreads();
    if (tid < D) xb[(size_t)t * D + tid] = v[tid];
  }
  __syncthreads();
  if (bad) {
    for (int e = tid; e < N * D; e += THREADS) xb[e] = __int_as_float(0x7fc00000);
  }
}

}  // namespace

extern "C" {

// Solve B systems; work holds B*N*4*54*54 floats of factor rows. Launches on
// `stream` and returns cudaGetLastError() (0 = launched).
int banded_solve_f32(const float* diag, const float* lower, const float* rhs,
                     float* x, float* work, int B, int N, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      banded_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  banded_solve_kernel<<<B, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      diag, lower, rhs, x, work, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
