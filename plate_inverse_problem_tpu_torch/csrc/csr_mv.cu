// Stacked CSR sparse matvec for Hopper (sm_90a): S operators on one sparsity
// pattern applied to L lanes, each output element summed in one fixed order.
//
// Replaces the flat-pattern operator of the JAX package's mixed sweep:
// plate_inverse_problem_tpu/ops/mixed.py _fused_mv (l.651; no Pallas kernel,
// XLA's segmented scatter) and ops/scatter.py spmv_flat (l.22), dispatched in
// the port by ops/csr_kernel.py csr_mv.  It is the exact f64 operator of the
// dense tier (every FGMRES step, every true residual, the Rayleigh-Ritz
// panels), the f32 refinement product of the preconditioner, the row sums of
// the exact band panels and the residual map of the adjoint Jacobian and the
// loss gradient at every tier.
//
// What it computes.  data (S, nnz) holds the values of S operators on one
// pattern in CSR order (rowptr (n+1,), col (nnz,), both int32); xt (n, L) is
// the lanes' input transposed, lanes fastest; y (S, L, n):
//     y[s, l, i] = sum_{k = rowptr[i]}^{rowptr[i+1]-1} data[s, k] * xt[col[k], l]
// with k ascending and one FMA per term.  No atomics: two launches on the
// same inputs give the same bits (the index_add_ scatter it replaces summed
// with atomics in no fixed order, and FGMRES carried that last-bit noise up
// to its tolerance).
//
// What bounds it.  The least work reads the S x nnz values with a 4-byte
// index each, x once and y once; at the bench plate (n = 1466, nnz = 34,220,
// S = 2, L = 1024, f64) that is 36.7 MB, 11 us at 3.35 TB/s, against
// 2 S nnz L = 140 MFLOP, 2 us at the f64 rate: memory bounds it.  What this
// kernel moves instead is the gather: every nonzero pulls 32 lanes of x
// (256 bytes in f64) from L1/L2, nnz * L * 8 = 280 MB at the bench shapes,
// which the L1 serves in part where neighbouring rows share columns.
//
// The design (a simple, right first cut).
//  * One block per (32-row tile, 32-lane tile, group of up to 4 operators);
//    warp w owns rows w, w+8, w+16, w+24 of the tile, lane-in-warp g owns
//    lane l = 32 * blockIdx.y + g.  A warp walks one row at a time: the
//    row's column index and the SG values are warp-uniform broadcasts, the
//    x reads of the 32 lanes are one coalesced 256-byte (f64) or 128-byte
//    (f32) load.  SG accumulators sit in registers.
//  * x comes transposed to (n, L) so those reads coalesce; the wrapper makes
//    the transposed copy (one read and one write of x).  y is written in the
//    callers' (S, L, n) layout through a (SG, 32, 33) tile in shared memory,
//    so the stores run along i: 32 contiguous elements per lane.
//  * More than 4 operators (the vmap-folded tangents of the adjoint
//    Jacobian, the row sums of the panels) go in groups of 4, one launch
//    each.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 32;        // lanes per block
constexpr int ROWS = 32;         // rows per block
constexpr int WARPS = 8;
constexpr int NT = 32 * WARPS;   // 256 threads
constexpr int SG_MAX = 4;        // operators per launch

template <typename T, int SG>
__global__ void __launch_bounds__(NT)
csr_mv_kernel(const T* __restrict__ data, const int* __restrict__ rowptr,
              const int* __restrict__ col, const T* __restrict__ xt,
              T* __restrict__ y, int n, int L, long long nnz)
{
    __shared__ T tile[SG][LANES][ROWS + 1];
    const int g = threadIdx.x & 31;
    const int w = threadIdx.x >> 5;
    const int l = blockIdx.y * LANES + g;
    const int i0 = blockIdx.x * ROWS;
    const bool lane_ok = l < L;

    for (int r = w; r < ROWS; r += WARPS) {
        const int i = i0 + r;
        T acc[SG];
#pragma unroll
        for (int s = 0; s < SG; ++s) acc[s] = T(0);
        if (i < n) {
            const int k1 = rowptr[i + 1];
            for (int k = rowptr[i]; k < k1; ++k) {
                const int c = __ldg(col + k);
                const T xv = lane_ok ? xt[(size_t)c * L + l] : T(0);
#pragma unroll
                for (int s = 0; s < SG; ++s)
                    acc[s] = fma(__ldg(data + s * nnz + k), xv, acc[s]);
            }
        }
#pragma unroll
        for (int s = 0; s < SG; ++s) tile[s][g][r] = acc[s];
    }
    __syncthreads();

    // y[s, l, i0 + r]: consecutive threads take consecutive rows
    const int l0 = blockIdx.y * LANES;
#pragma unroll
    for (int s = 0; s < SG; ++s) {
        for (int t = threadIdx.x; t < LANES * ROWS; t += NT) {
            const int r = t % ROWS;
            const int lt = t / ROWS;
            const int i = i0 + r;
            if (i < n && l0 + lt < L)
                y[((size_t)s * L + l0 + lt) * n + i] = tile[s][lt][r];
        }
    }
}

template <typename T, int SG>
void launch(const T* data, const int* rowptr, const int* col, const T* xt,
            T* y, int n, int L, long long nnz, cudaStream_t st)
{
    const dim3 grid((n + ROWS - 1) / ROWS, (L + LANES - 1) / LANES);
    csr_mv_kernel<T, SG><<<grid, NT, 0, st>>>(data, rowptr, col, xt, y, n,
                                              L, nnz);
}

template <typename T>
int launch_all(const T* data, const int* rowptr, const int* col,
               const T* xt, T* y, int S, int L, int n, long long nnz,
               void* stream)
{
    if (S <= 0 || L <= 0 || n <= 0) return 0;
    if (nnz < 0 || (L + LANES - 1) / LANES > 65535)
        return -static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    int launched = 0;
    for (int s0 = 0; s0 < S; s0 += SG_MAX) {
        const T* d = data + (size_t)s0 * nnz;
        T* ys = y + (size_t)s0 * L * n;
        switch (S - s0 < SG_MAX ? S - s0 : SG_MAX) {
        case 1: launch<T, 1>(d, rowptr, col, xt, ys, n, L, nnz, st); break;
        case 2: launch<T, 2>(d, rowptr, col, xt, ys, n, L, nnz, st); break;
        case 3: launch<T, 3>(d, rowptr, col, xt, ys, n, L, nnz, st); break;
        default: launch<T, 4>(d, rowptr, col, xt, ys, n, L, nnz, st); break;
        }
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return -static_cast<int>(err);
        ++launched;
    }
    return launched;
}

}  // namespace

// data (S, nnz) in CSR order, rowptr (n+1,) and col (nnz,) int32, xt (n, L),
// y (S, L, n); all contiguous on the current device.  Launches on `stream`
// one kernel per group of up to 4 operators and returns the number of
// kernels launched, or minus the cudaError of a launch that failed.
extern "C" int csr_mv_f64_launch(const double* data, const int* rowptr,
                                 const int* col, const double* xt, double* y,
                                 int S, int L, int n, long long nnz,
                                 void* stream)
{
    return launch_all<double>(data, rowptr, col, xt, y, S, L, n, nnz, stream);
}

extern "C" int csr_mv_f32_launch(const float* data, const int* rowptr,
                                 const int* col, const float* xt, float* y,
                                 int S, int L, int n, long long nnz,
                                 void* stream)
{
    return launch_all<float>(data, rowptr, col, xt, y, S, L, n, nnz, stream);
}
