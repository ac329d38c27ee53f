// f32 block-tridiagonal band matvec for Hopper (sm_90a): y = A x.
//
// Replaces the Pallas TPU kernel plate_inverse_problem_tpu/ops/pallas_band.py
// (_kernel l.35, _band_mv_pallas l.46, band_mv_pallas l.99), dispatched there
// through ops/band.py band_mv_f32.  It is the f32 operator of the two-grid
// preconditioner: every Chebyshev smoothing step, the two-grid residual and
// the refinement residual of the mixed sweep.
//
// Layout.  The RCM-reordered operator is stored as band (nb, b, 3b): block
// row q holds [A_{q,q-1} | A_{q,q} | A_{q,q+1}].  For every lane B and block
// row q,  y[B, q*b + i] = sum_{c < 3b} band[q, i, c] * x[B, (q-1)*b + c].
// x and y are (B, n) row-major; n <= nb*b.
//
// What bounds it.  At the 21k-DOF slice (nb = 82, b = 256, B = 128) the dense
// product is 2*B*nb*b*3b = 4.1 GFLOP over 64.5 MB of band, ~64 FLOP/byte,
// which would make a dense kernel compute-bound.  But the band of a plate
// operator is ~2-3 % dense, and only ~24 % of its 32-row x 16-column tiles
// hold a nonzero at 21k.  A block therefore skips the x load and the FMAs
// of every all-zero tile, and what is left is bounded by reading the band
// once (19 us at 3.35 TB/s) and by the latency of the few dependent loads
// per block.  The design:
//  * one block per (block row q, 32-row tile, 128-lane tile): for B <= 128
//    the band is read from device memory exactly once per apply;
//  * the band is staged through shared memory in super-chunks of 128
//    columns, 16 independent loads in flight per thread, and each 16-column
//    tile's "holds a nonzero" flag is OR-ed into a shared mask on the way;
//  * for each flagged tile the x window (128 lanes x 16 columns, mostly from
//    L2) is staged and multiplied: IEEE f32 FMA on the CUDA cores, 4 x 4
//    outputs per thread (the JAX side runs f32 at HIGHEST precision, so no
//    TF32).  Skipped products are exact zeros unless x holds an inf or NaN
//    there.
// wgmma / 3xTF32 and a sparse-row formulation are left to later work.
//
// Masking.  A window column (q-1)*b + c outside [0, n) reads zero: that
// covers the missing neighbours of the first and last block rows and the
// padded tail of the last block.  The Pallas kernel clamps those windows and
// relies on the band storing zeros there; masking does not.  Rows
// q*b + i >= n are not written.  Any b and any B are covered (ragged tiles
// are masked), including b that the 32-row tile does not divide.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TI = 32;    // band rows (outputs) per block
constexpr int TB = 128;   // lanes per block
constexpr int TK = 16;    // columns per tile: the unit of zero skipping
constexpr int SC = 8;     // tiles per staged super-chunk (128 columns)
constexpr int RI = 4;     // rows per thread
constexpr int RB = 4;     // lanes per thread
constexpr int NT = (TI / RI) * (TB / RB);   // 256 threads
constexpr int PAD = 4;    // keeps rows 16-byte aligned for float4 reads
constexpr int A_PER_T = TI * SC * TK / NT;  // band loads per thread (16)
constexpr int X_PER_T = TB * TK / NT;       // x loads per thread (8)

__global__ void __launch_bounds__(NT)
band_mv_f32_kernel(const float* __restrict__ band, const float* __restrict__ x,
                   float* __restrict__ y, int B, int n, int b)
{
    __shared__ __align__(16) float As[SC * TK][TI + PAD];  // As[col][row]
    __shared__ __align__(16) float Xs[TK][TB + PAD];       // Xs[col][lane]
    __shared__ int mask[2];                                // nonzero tiles

    const int q = blockIdx.x;
    const int i0 = blockIdx.y * TI;
    const int l0 = blockIdx.z * TB;
    const int tid = threadIdx.x;
    const int tx = tid % (TI / RI);   // rows i0 + tx*RI + r
    const int ty = tid / (TI / RI);   // lanes l0 + ty*RB + s
    const int b3 = 3 * b;
    const long long col0 = (long long)(q - 1) * b;
    const float* bandq = band + (size_t)q * b * b3;

    float acc[RI][RB];
#pragma unroll
    for (int r = 0; r < RI; ++r)
#pragma unroll
        for (int s = 0; s < RB; ++s) acc[r][s] = 0.0f;

    if (tid < 2) mask[tid] = 0;
    __syncthreads();

    int par = 0;
    for (int s0 = 0; s0 < b3; s0 += SC * TK) {
        // ---- stage the band super-chunk, flag its nonzero tiles ---------
        int bits = 0;
        float v[A_PER_T];
#pragma unroll
        for (int j = 0; j < A_PER_T; ++j) {
            const int e = tid + j * NT;
            const int r = e / (SC * TK), k = e % (SC * TK);
            const int i = i0 + r, c = s0 + k;
            v[j] = (i < b && c < b3) ? bandq[(size_t)i * b3 + c] : 0.0f;
        }
#pragma unroll
        for (int j = 0; j < A_PER_T; ++j) {
            const int e = tid + j * NT;
            const int r = e / (SC * TK), k = e % (SC * TK);
            As[k][r] = v[j];
            if (v[j] != 0.0f) bits |= 1 << (k / TK);
        }
        if (bits) atomicOr(&mask[par], bits);
        __syncthreads();
        const int m = mask[par];
        if (tid == 0) mask[par ^ 1] = 0;

        // ---- multiply the flagged tiles ---------------------------------
        for (int t = 0; t < SC; ++t) {
            if (!((m >> t) & 1)) continue;   // uniform across the block
            const int k0 = s0 + t * TK;
#pragma unroll
            for (int j = 0; j < X_PER_T; ++j) {
                const int e = tid + j * NT;
                const int s = e / TK, k = e % TK;
                const int lane = l0 + s;
                const long long col = col0 + k0 + k;
                Xs[k][s] = (lane < B && k0 + k < b3 && col >= 0 && col < n)
                               ? x[(size_t)lane * n + col] : 0.0f;
            }
            __syncthreads();
#pragma unroll
            for (int k = 0; k < TK; ++k) {
                const float4 a =
                    *reinterpret_cast<const float4*>(&As[t * TK + k][tx * RI]);
                const float4 w =
                    *reinterpret_cast<const float4*>(&Xs[k][ty * RB]);
                const float av[RI] = {a.x, a.y, a.z, a.w};
                const float xv[RB] = {w.x, w.y, w.z, w.w};
#pragma unroll
                for (int r = 0; r < RI; ++r)
#pragma unroll
                    for (int s = 0; s < RB; ++s)
                        acc[r][s] = fmaf(av[r], xv[s], acc[r][s]);
            }
            __syncthreads();
        }
        // the next super-chunk overwrites As and ORs into the reset mask
        __syncthreads();
        par ^= 1;
    }

#pragma unroll
    for (int s = 0; s < RB; ++s) {
        const int lane = l0 + ty * RB + s;
        if (lane >= B) continue;
#pragma unroll
        for (int r = 0; r < RI; ++r) {
            const int i = i0 + tx * RI + r;
            const long long row = (long long)q * b + i;
            if (i < b && row < n) y[(size_t)lane * n + row] = acc[r][s];
        }
    }
}

}  // namespace

// band (nb, b, 3b), x (B, n), y (B, n): all f32, contiguous, on the current
// device.  Launches on `stream` and returns cudaGetLastError().
extern "C" int band_mv_f32_launch(const float* band, const float* x, float* y,
                                  int B, int n, int nb, int b, void* stream)
{
    if (B <= 0 || n <= 0 || nb <= 0 || b <= 0) return 0;
    const dim3 grid(nb, (b + TI - 1) / TI, (B + TB - 1) / TB);
    band_mv_f32_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
        band, x, y, B, n, b);
    return static_cast<int>(cudaGetLastError());
}
