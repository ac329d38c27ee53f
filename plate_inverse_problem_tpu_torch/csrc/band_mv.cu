// f32 block-tridiagonal band matvec for Hopper (sm_90a): y = A x, read from
// a packed list of the band's nonzero 16 x 8 tiles.
//
// Replaces the Pallas TPU kernel plate_inverse_problem_tpu/ops/pallas_band.py
// (_kernel l.35, _band_mv_pallas l.46 with pl.pallas_call l.75,
// band_mv_pallas l.99), dispatched there through ops/band.py band_mv_f32.
// It is the f32 operator of the two-grid preconditioner: every Chebyshev
// smoothing step, the two-grid residual and the refinement residual of the
// mixed sweep (17 launches per preconditioner apply).
//
// What it computes.  The RCM-reordered operator is a band (nb, b, 3b): block
// row q holds [A_{q,q-1} | A_{q,q} | A_{q,q+1}], and for every lane B
//     y[B, q*b + i] = sum_c band[q, i, c] * x[B, (q-1)*b + c].
// The band never changes during a sweep, so ops/band_kernel.py packs it once
// per geometry (pack_band_tiles): the values of every TM x TK tile that holds
// a nonzero, contiguous as (n_tiles, TM, TK); each tile's global first column
// (q-1)*b + c0 (int32); a CSR pointer over row tiles (int32), the tiles of a
// row tile in column order.  Window slots outside [0, n) and rows >= n never
// reach the pack.  x is (B, nx) and y (B, ny) row-major: nx = ny = n for the
// whole band.  A rank of a dof group that owns block rows [q0, q1) launches
// it on its own window (band_kernel.window_pack): the row tiles of its rows
// [q0 b, min(n, q1 b)), ny of them, and an x window of nx columns from
// max(0, (q0 - 1) b) to min(n, (q1 + 1) b), its neighbours' boundary block
// rows included, every first column counted from the window's first.  A row
// walks the same tiles in the same order as in the whole pack, so a window's
// rows carry the whole apply's bits.
//
// Tile shape (a count of the 21k-DOF slice's f32 K_ref band on the host,
// nb = 82, b = 256, n = 20916, by `.probes/torch_sweep_profile.py
// --tile-count`: 252,722 numeric nonzeros, 12.1 a row): 32 x 16 tiles keep
// 7,561 tiles = 15.5 MB, 16 x 8 keep 17,793 = 9.1 MB with 583 MFLOP at
// B = 128, 32 x 8 keep 13,221 = 13.5 MB with 866 MFLOP.  Each tile pulls TK
// columns x B lanes of x from L2: 72.9 MB at 16 x 8 and 54.2 MB at 32 x 8
// (B = 128).  TK = 8 is the narrowest slice that is one whole 32-byte
// sector per lane; TM = 16 takes 1.5x fewer FMAs and bytes of band than 32
// for 1.3x more x from L2, and gives 1308 blocks at the slice.  (A 32-row
// version measured slower on an H100: its FMAs cost more than the x it
// saved.)
//
// What bounds it.  The least work is the nonzeros with a 4-byte index each
// (2.0 MB), x read once and y written once (10.7 MB each at B = 128):
// 23.4 MB, 7.0 us at 3.35 TB/s; the 2 x 252,722 x 128 = 64.7 MFLOP take
// ~1 us at 67 TFLOP/s, so memory bounds it.  The packed form moves 9.1 MB of
// tiles plus x and y (30.5 MB, 9.1 us) and does 583 MFLOP (8.7 us on the
// CUDA cores): both about 10x below the dense (nb, b, 3b) box that the
// earlier dense-walk kernel read.  What sets this kernel's time instead is
// the x slices it pulls from L2 for every tile (72.9 MB at B = 128, and a
// lane's 32 bytes straddle two sectors wherever n * 4 is not a multiple of
// 32): on an H100 SXM the copies alone take ~90 % of the kernel's time at
// B = 128, and removing half of the x copies removes ~35 % of it.
//
// The design.
//  * One block per (16-row tile, lane tile of 32*S lanes), S = 1, 2 or 4 by
//    B; it walks its row tile's list with no discovery phase.  It reads the
//    list's first columns into shared memory once, in parallel, so no copy
//    waits on a load of its index.  Rows of a row tile with an empty list
//    are written as 0.
//  * Every tile and its x slice (TK = 8 columns: 32 contiguous bytes per
//    lane) are streamed into a ring of shared memory with cp.async (16-byte
//    copies where nx and ny are multiples of 4, 4-byte copies else);
//    STAGES - 1 tiles are in flight while the FMAs run on the oldest, one
//    barrier per tile.  The copies hold no registers.  Columns >= nx are
//    zero-filled by the copy, so the tail of x never leaks into a row.
//  * Warp w owns rows 4w..4w+3 of the tile, lane-in-warp g owns lanes
//    g + 32 s: a 4 x S accumulator in registers.  Tile values are read as
//    warp-uniform float4 broadcasts.  A lane's x slice is two 16-byte chunks,
//    swapped for lanes l with l & 4, so the float4 reads of eight
//    neighbouring lanes hit 32 distinct banks without padding.
//  * Narrow lane tiles (small B) are latency-bound: they get a deeper ring
//    (8 stages at S = 1 and 2, 5 at S = 4) and at S = 1 more resident
//    blocks (12 an SM at <= 40 registers, else 8 at <= 64); none spills.
//  * IEEE f32 FMA on the CUDA cores, no tensor cores and no TF32: the JAX
//    side runs this product in f32 at HIGHEST precision and the FGMRES
//    iteration counts were tuned with it; 3xTF32 would triple the MMA work;
//    and the packed work (583 MFLOP at 16 x 8) is already at the memory time.
//
// An inf or NaN in x reaches exactly the rows whose packed tiles cover its
// column, in its own lane only, as in the plain version of the same pack.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 16;          // rows of a tile
constexpr int TK = 8;           // columns of a tile
constexpr int RPT = 4;          // rows a thread accumulates
constexpr int NT = 32 * TM / RPT;   // 128 threads: one warp per 4 rows

// ring depth, and resident blocks an SM (so registers), for S lanes a thread
__host__ __device__ constexpr int stages_for(int S) { return S == 4 ? 5 : 8; }

__host__ __device__ constexpr int blocks_for(int S) { return S == 1 ? 12 : 8; }

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes)
{
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes)
{
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(s), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit()
{
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait()
{
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// float offset of 4-column chunk j of lane l's x slice in a ring stage
__device__ __forceinline__ int xs_at(int l, int j)
{
    return l * TK + 4 * (j ^ ((l >> 2) & 1));
}

template <int S, bool VEC>
__global__ void __launch_bounds__(NT, blocks_for(S))
band_mv_f32_kernel(const float* __restrict__ vals,
                   const int* __restrict__ col0,
                   const int* __restrict__ row_ptr,
                   const float* __restrict__ x, float* __restrict__ y,
                   int B, int nx, int ny)
{
    constexpr int LB = 32 * S;                       // lanes of the block
    constexpr int STAGES = stages_for(S);
    __shared__ __align__(16) float Ts[STAGES][TM * TK];
    __shared__ __align__(16) float Xs[STAGES][LB * TK];
    extern __shared__ int first_col[];               // the list's col0

    const int tid = threadIdx.x;
    const int w = tid / 32;                          // rows 4w .. 4w+3
    const int g = tid % 32;                          // lanes g + 32 s
    const int l0 = blockIdx.y * LB;
    const int nl = min(LB, B - l0);                  // lanes present
    const int beg = row_ptr[blockIdx.x];
    const int cnt = row_ptr[blockIdx.x + 1] - beg;
    for (int i = tid; i < cnt; i += NT) first_col[i] = col0[beg + i];
    __syncthreads();

    // copy tile `t` of the list and its x slice into ring stage `st`
    auto issue = [&](int t, int st) {
        if (tid < TM * TK / 4)
            cp_async16(&Ts[st][4 * tid],
                       vals + (size_t)(beg + t) * (TM * TK) + 4 * tid, 16);
        const int c0 = first_col[t];
        const float* xl = x + (size_t)l0 * nx + c0;
        if (VEC) {   // nx % 4 == 0: a 4-column chunk is wholly in or out
            for (int e = tid; e < nl * (TK / 4); e += NT) {
                const int l = e / (TK / 4), j = e % (TK / 4);
                const bool in = c0 + 4 * j < nx;
                cp_async16(&Xs[st][xs_at(l, j)],
                           in ? xl + (size_t)l * nx + 4 * j : x, in ? 16 : 0);
            }
        } else {
            for (int e = tid; e < nl * TK; e += NT) {
                const int l = e / TK, k = e % TK;
                const bool in = c0 + k < nx;
                cp_async4(&Xs[st][xs_at(l, k / 4) + k % 4],
                          in ? xl + (size_t)l * nx + k : x, in ? 4 : 0);
            }
        }
    };

    float acc[RPT][S];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int s = 0; s < S; ++s) acc[r][s] = 0.0f;

#pragma unroll
    for (int t = 0; t < STAGES - 1; ++t) {
        if (t < cnt) issue(t, t);
        cp_async_commit();
    }
    for (int t = 0; t < cnt; ++t) {
        cp_async_wait<STAGES - 2>();   // tile t is in (this thread's copies)
        __syncthreads();               // ... everyone's; stage t-1 is free
        if (t + STAGES - 1 < cnt)
            issue(t + STAGES - 1, (t + STAGES - 1) % STAGES);
        cp_async_commit();

        const float* T = Ts[t % STAGES] + w * RPT * TK;
        const float* X = Xs[t % STAGES];
#pragma unroll
        for (int h = 0; h < TK / 4; ++h) {
            float4 xv[S];
#pragma unroll
            for (int s = 0; s < S; ++s)
                xv[s] = *reinterpret_cast<const float4*>(
                    X + xs_at(g + 32 * s, h));
#pragma unroll
            for (int r = 0; r < RPT; ++r) {
                const float4 a =
                    *reinterpret_cast<const float4*>(T + r * TK + 4 * h);
#pragma unroll
                for (int s = 0; s < S; ++s) {
                    acc[r][s] = fmaf(a.x, xv[s].x, acc[r][s]);
                    acc[r][s] = fmaf(a.y, xv[s].y, acc[r][s]);
                    acc[r][s] = fmaf(a.z, xv[s].z, acc[r][s]);
                    acc[r][s] = fmaf(a.w, xv[s].w, acc[r][s]);
                }
            }
        }
    }

    const int row0 = blockIdx.x * TM + w * RPT;
#pragma unroll
    for (int s = 0; s < S; ++s) {
        const int l = g + 32 * s;
        if (l >= nl) continue;
        float* yl = y + (size_t)(l0 + l) * ny + row0;
        if (VEC && row0 + RPT <= ny) {
            *reinterpret_cast<float4*>(yl) =
                make_float4(acc[0][s], acc[1][s], acc[2][s], acc[3][s]);
        } else {
#pragma unroll
            for (int r = 0; r < RPT; ++r)
                if (row0 + r < ny) yl[r] = acc[r][s];
        }
    }
}

template <int S>
void launch(const float* vals, const int* col0, const int* row_ptr,
            const float* x, float* y, int B, int nx, int ny, int list_max,
            bool vec, cudaStream_t stream)
{
    const dim3 grid((ny + TM - 1) / TM, (B + 32 * S - 1) / (32 * S));
    const size_t list_bytes = sizeof(int) * list_max;
    if (vec)
        band_mv_f32_kernel<S, true><<<grid, NT, list_bytes, stream>>>(
            vals, col0, row_ptr, x, y, B, nx, ny);
    else
        band_mv_f32_kernel<S, false><<<grid, NT, list_bytes, stream>>>(
            vals, col0, row_ptr, x, y, B, nx, ny);
}

}  // namespace

// The tile shape the kernel was compiled for, as TM * 1000 + TK.
extern "C" int band_mv_f32_tile(void) { return TM * 1000 + TK; }

// vals (n_tiles, TM, TK) f32, col0 (n_tiles,) int32 counted from x's first
// column, row_ptr (n_row_tiles+1,) int32 with n_row_tiles * TM >= ny and at
// most list_max tiles in a row tile; x (B, nx) and y (B, ny) f32 (nx = ny = n
// for the whole band).  All contiguous on the current device, vals 16-byte
// aligned.  Launches on `stream` and returns cudaGetLastError().
extern "C" int band_mv_f32_launch(const float* vals, const int* col0,
                                  const int* row_ptr, const float* x,
                                  float* y, int B, int nx, int ny,
                                  int n_row_tiles, int list_max, void* stream)
{
    if (B <= 0 || ny <= 0) return 0;
    if (nx <= 0 || (long long)n_row_tiles * TM < ny || list_max < 0
        || (uintptr_t)vals % 16 != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const bool vec = nx % 4 == 0 && ny % 4 == 0 && (uintptr_t)x % 16 == 0
                     && (uintptr_t)y % 16 == 0;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (B <= 32)
        launch<1>(vals, col0, row_ptr, x, y, B, nx, ny, list_max, vec, st);
    else if (B <= 64)
        launch<2>(vals, col0, row_ptr, x, y, B, nx, ny, list_max, vec, st);
    else
        launch<4>(vals, col0, row_ptr, x, y, B, nx, ny, list_max, vec, st);
    return static_cast<int>(cudaGetLastError());
}
