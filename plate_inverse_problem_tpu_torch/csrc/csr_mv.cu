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
// loss gradient at every tier; every product of the flat multilevel cycle
// (its level operators, prolongations P and restrictions P^T, ops/mg.py),
// LOBPCG's K and M panel products on the flat tier (ops/lobpcg.py) and the
// sparse API's matvec (ops/sparse_api.py).
//
// What it computes.  data (S, nnz) holds the values of S operators on one
// pattern of n rows, in CSR order (rowptr (n+1,), col (nnz,), int32) or
// read through perm (data[:, perm] is in CSR order); x[l, c] sits at x + l
// * sxl + c * sxc, for any number of columns c (the pattern may be
// rectangular: the multilevel cycle's P and P^T, the sparse API's
// matrices; nothing here depends on x's width); y (S, L, n):
//     y[s, l, i] = sum_{k = rowptr[i]}^{rowptr[i+1]-1} data[s, k] * x[l, col[k]]
// with k ascending, one FMA per term and one thread per output element,
// starting from zero.  No atomics: two launches on the same inputs give the
// same bits, and every kernel below gives the bits of the first cut (one
// block per 32 consecutive rows, 32 lanes and 4 operators, x gathered from
// L1/L2 per nonzero), since each sums the same terms in the same order.
//
// What bounds it.  The least work reads the S x nnz values, the plan's
// index bytes (2.6 bytes a nonzero at n = 1466; 4 more where perm is
// read), x once and y once; at the bench
// plate (n = 1466, nnz = 34,220, S = 2, L = 1024, f64) that is 36.6 MB, 11
// us at 3.35 TB/s, against 2 S nnz L = 140 MFLOP, 4 us at the f64 rate:
// memory bounds it.  What costs more is what the bound does not count:
// reading x at a tile's scattered columns (a 32-byte sector for 8 bytes
// where the columns do not run together), the operator values once per
// 32-lane tile, and the staging's round trip before a block sums.
//
// The design.
//  * A host plan (ops/csr_kernel.py build_csr, once per pattern): the rows
//    go in groups of 4 consecutive rows, so y is written in whole 32-byte
//    sectors (with single rows, scattered 8-byte stores made the kernel
//    slower than the first cut where y outgrows L2), and the groups
//    in reverse Cuthill-McKee order of the pattern; a tile takes groups in
//    that order up to TILE_ROWS = 32 rows, 256 distinct columns (one-byte
//    slots) and the entries whose staging keeps two wide blocks on an SM.
//    Each tile has its rows (ascending), its sorted distinct columns and,
//    per nonzero, the slot of its column in that list.  The tiles touch ~4
//    nonzeros a staged column (3.8 at n = 1466, 6.2 on the 21k plate's
//    band-ordered pattern) where 32 consecutive rows touch ~2.2.  Taller
//    tiles are cut by the 256 columns first, were no faster on the card,
//    and give the narrow kernel fewer blocks.
//  * Wide lanes (L >= 32): one block of 16 warps per (row tile, 32-lane
//    tile), the row tiles fastest so a lane tile's x stays in L2.  It stages
//    with cp.async x at the tile's columns for its lanes, the tile's slots
//    and its entries for OP_GROUP operators (read through perm where the
//    data are not in CSR order: no gather pass over the data), then each
//    half-warp walks a row, each thread two neighbouring lanes, from shared
//    memory alone (the slot, the values, x through the slot as one 16-byte
//    read).  S operators go OP_GROUP at a time in registers, their entries
//    restaged, x staged once.  y goes through a shared tile, each warp one
//    lane's rows at a time.  x is read where the callers hold it: a
//    transposed copy (32 lanes of a column in 256 contiguous bytes) cost
//    more than its reads saved (chip_smoke.py times it beside each case).
//  * Narrow lanes (2 <= L < 32): the lane tile is the next power of two
//    LP >= L, a block takes max(4, 32 / LP) rows of one tile (376 blocks at
//    n = 1466, L = 16), stages their entries, slots and the tile's columns,
//    and gathers x (small at these widths) through L1, 8 gathers in flight.
//  * One lane (L = 1, the panels' row sums on x = ones): one thread per
//    (operator, row), neighbouring threads on neighbouring rows, a block's
//    128 rows' entries and columns staged first (beside a long row only
//    the other rows' entries, packed); one launch for every operator.
//  * Long rows (more than 256 distinct columns, or more entries than a
//    tile's staging holds: a dense row of a synthetic pencil, a coarse
//    level's restriction at a large coarsening factor, the sparse API's
//    matrices; no plate pattern has one): the plan keeps them out of every
//    tile and lists them, and a kernel of their own follows the tiles' one
//    on the stream.  What bounds it is x: a long row reads x at hundreds
//    to thousands of scattered columns for every lane, so x read straight
//    from global memory costs a 32-byte sector an 8-byte term, re-read for
//    every operator (the first cut, a warp a (lane, operator) item reduced
//    by a shuffle tree, took 4.3 ms at S = 2, L = 1024 on chip_smoke.py's
//    pattern, 2.9 % of its bound, on an NVIDIA H100 80GB HBM3 at 700 W).
//    The first cut also gathered each term's value through the data's
//    permutation once a (lane, operator), and a random 8-byte gather costs
//    a sector.  Now a first kernel gathers the long entries' values once,
//    operator by operator (so the values in flight stay in L2), into
//    entry order; the sums then read them in runs.  From 32 lanes on, the
//    plan groups the long rows 32 at a time and lists each group's
//    64-column windows of x that its rows touch; a block takes a group, a
//    32-lane tile and two operators, and walks the group's windows in
//    ascending order, a few a stage, through cp.async rings: x over the
//    stage's windows for its lanes as dense boxes (whole 32-byte sectors,
//    once for all 32 rows and both operators), the rows' entries in them
//    packed (their place in the staged x and their values), the rows'
//    entry bounds a stage ahead; each (row, lane, operator) summed from
//    shared memory, k ascending, one FMA a term, the sum carried in
//    registers: the tiles' order and bits.  Below 32 lanes there are too
//    few such chains (a row's lanes and operators) to keep enough loads in
//    flight one warp a row, so each long row is cut into segments of 128
//    entries, a warp a segment, its loads straight into registers (x
//    transposed by the wrapper, a column's lanes in one line), and a last
//    kernel adds each row's segment sums in order: a fixed two-level
//    order, the same in every run.
//  * Each call is one launch, of the kernel the wrapper picks from L, and
//    a second for the long rows where the plan has any.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int WARPS = 16;
constexpr int NT = 32 * WARPS;   // threads of a wide block
constexpr int LT = 32;           // lanes of a wide block
constexpr int XLD = LT + 2;      // a staged column's stride, wide block
constexpr int OP_GROUP = 2;      // operators summed at once, in registers
constexpr int UNROLL = 4;        // entries of a row per unrolled step
constexpr int BATCH = 8;         // x gathers in flight per narrow thread
constexpr int L1_ROWS = 128;     // rows (threads) of a one-lane block
constexpr int L1_BATCH = 8;      // loads in flight per one-lane thread

struct Plan {
    const int* tile_ptr;    // (T+1): tile t holds tile_rows[tile_ptr[t] ..]
    const int* tile_rows;   // (n): each tile's rows, ascending
    const int* col_ptr;     // (T+1): tile t's columns tile_cols[col_ptr[t] ..]
    const int* tile_cols;   // each tile's distinct columns, ascending
    const uint8_t* slot;    // (nnz): the column's place in its tile's list
    const int* row_off;     // (n): the row's first entry in its tile's list
    const int* rowptr;      // (n+1)
    const int* col;         // (nnz)
    const int* perm;        // (nnz): data's slot of each CSR entry, or null
};

// data's slot of CSR entry k: the operator data stay in the callers' order,
// and the staging reads them through the permutation
__device__ __forceinline__ int data_slot(const Plan& p, int k)
{
    return p.perm ? __ldg(p.perm + k) : k;
}

template <int B>
__device__ __forceinline__ void cp_async(void* dst, const void* src)
{
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"(d), "l"(src), "n"(B));
}

__device__ __forceinline__ void cp_async_wait_all()
{
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
}

// Issue xs[j * ld + l] = x[l0 + l, cols[j]] for j < nc, l < nl (0 past lane
// L).  The lanes of a warp take consecutive addresses of whichever x axis
// is contiguous.
template <typename T>
__device__ __forceinline__ void stage_x(
    T* xs, int ld, const T* __restrict__ x, long long sxl, long long sxc,
    const int* __restrict__ cols, int nc, int l0, int nl, int L)
{
    const int g = threadIdx.x & 31;
    const int w = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
    const bool cols_fast = sxc == 1 && sxl != 1;
    const int n_out = cols_fast ? nl : nc;     // the warps' loop
    const int n_in = cols_fast ? nc : nl;      // the lanes' loop
    for (int a = w; a < n_out; a += nw) {
        for (int b = g; b < n_in; b += 32) {
            const int j = cols_fast ? b : a;
            const int l = cols_fast ? a : b;
            T* dst = xs + j * ld + l;
            const int lg = l0 + l;
            if (lg < L)
                cp_async<sizeof(T)>(
                    dst, x + lg * sxl + (long long)__ldg(cols + j) * sxc);
            else
                *dst = T(0);
        }
    }
}

// Issue the entries of rows[0 .. nr) (a run of one tile's list, the first
// at local offset base) for operators s0 .. s0+G-1 into ds[s * ldd + ..],
// and with `slots` their slots into ss: a row's entries are contiguous in
// CSR order, a warp copies one row.
template <typename T>
__device__ __forceinline__ void stage_rows(
    T* ds, int ldd, uint8_t* ss, const int* rows, int nr, int base,
    const Plan& p, const T* __restrict__ data, long long nnz, int s0, int G,
    bool slots)
{
    const int g = threadIdx.x & 31;
    const int w = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
    for (int r = w; r < nr; r += nw) {
        const int i = rows[r];
        const int k0 = __ldg(p.rowptr + i);
        const int len = __ldg(p.rowptr + i + 1) - k0;
        const int off = __ldg(p.row_off + i) - base;
        for (int j = g; j < len; j += 32) {
            const int kd = data_slot(p, k0 + j);
            for (int s = 0; s < G; ++s)
                cp_async<sizeof(T)>(ds + s * ldd + off + j,
                                    data + (s0 + s) * nnz + kd);
            if (slots) ss[off + j] = __ldg(p.slot + k0 + j);
        }
    }
}

// acc[s][h] = sum_j ds[s * ldd + off + j] * xp[ss[off + j] * ld + h] for
// two neighbouring lanes h = 0, 1 (xp 16- or 8-byte aligned) and j = 0 ..
// len-1 ascending, one FMA a term; everything from shared memory.
template <typename T, int G>
__device__ __forceinline__ void row_sum2(
    T (&acc)[G][2], const T* ds, int ldd, const uint8_t* ss, int off,
    int len, const T* xp, int ld)
{
    using T2 = typename std::conditional<sizeof(T) == 8, double2,
                                         float2>::type;
    int j = 0;
    for (; j + UNROLL <= len; j += UNROLL) {
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const T2 xv = *reinterpret_cast<const T2*>(
                xp + ss[off + j + u] * ld);
#pragma unroll
            for (int s = 0; s < G; ++s) {
                const T d = ds[s * ldd + off + j + u];
                acc[s][0] = fma(d, xv.x, acc[s][0]);
                acc[s][1] = fma(d, xv.y, acc[s][1]);
            }
        }
    }
    for (; j < len; ++j) {
        const T2 xv = *reinterpret_cast<const T2*>(xp + ss[off + j] * ld);
#pragma unroll
        for (int s = 0; s < G; ++s) {
            const T d = ds[s * ldd + off + j];
            acc[s][0] = fma(d, xv.x, acc[s][0]);
            acc[s][1] = fma(d, xv.y, acc[s][1]);
        }
    }
}

// ---- wide lanes ----------------------------------------------------------

// Operators s0 .. s0+G-1 of one (row tile, lane tile), their entries
// staged in ds: each half-warp takes a row, each thread two neighbouring
// lanes of it (XLD, even, keeps a pair aligned), into ys; then ys out to y,
// the lanes over the warps and each lane's rows over the threads of one.
template <typename T, int G>
__device__ __forceinline__ void wide_group(
    const Plan& p, const T* xs, const T* ds, int ldd, const uint8_t* ss,
    T* ys, const int* rows, int nr, int ldy, T* __restrict__ y, int s0,
    int l0, int L, int n)
{
    const int g = threadIdx.x & 31;
    const int w = threadIdx.x >> 5;
    const int q = g & 15;                 // lanes 2q, 2q+1 of the tile
    const T* xp = xs + 2 * q;
    for (int r = 2 * w + (g >> 4); r < nr; r += 2 * WARPS) {
        const int i = rows[r];
        T acc[G][2];
#pragma unroll
        for (int s = 0; s < G; ++s) acc[s][0] = acc[s][1] = T(0);
        row_sum2<T, G>(acc, ds, ldd, ss, __ldg(p.row_off + i),
                       __ldg(p.rowptr + i + 1) - __ldg(p.rowptr + i), xp,
                       XLD);
#pragma unroll
        for (int s = 0; s < G; ++s) {
            ys[(s * LT + 2 * q) * ldy + r] = acc[s][0];
            ys[(s * LT + 2 * q + 1) * ldy + r] = acc[s][1];
        }
    }
    __syncthreads();
    const int lanes = min(LT, L - l0);
    for (int s = 0; s < G; ++s) {
        T* ysl = y + ((size_t)(s0 + s) * L + l0) * n;
        for (int l = w; l < lanes; l += WARPS)
            for (int r = g; r < nr; r += 32)
                ysl[(size_t)l * n + rows[r]] = ys[(s * LT + l) * ldy + r];
    }
    __syncthreads();
}

// One block per (row tile blockIdx.x, 32-lane tile blockIdx.y): the row
// tiles run fastest, so a lane tile's x stays in L2 while every tile of it
// is staged.
template <typename T>
__global__ void __launch_bounds__(NT, 2)
csr_mv_wide_kernel(const T* __restrict__ data, Plan p,
                   const T* __restrict__ x, long long sxl, long long sxc,
                   T* __restrict__ y, int S, int L, int n, long long nnz,
                   int max_rows, int max_cols, int max_nnz)
{
    extern __shared__ __align__(16) unsigned char smem[];
    const int ldy = max_rows | 1;
    const int g0 = min(S, OP_GROUP);
    T* xs = reinterpret_cast<T*>(smem);                  // [max_cols][XLD]
    T* ys = xs + max_cols * XLD;                         // [g0][LT][ldy]
    T* ds = ys + g0 * LT * ldy;                          // [g0][max_nnz]
    int* rows = reinterpret_cast<int*>(ds + g0 * max_nnz);
    uint8_t* ss = reinterpret_cast<uint8_t*>(rows + max_rows);
    const int t = blockIdx.x;
    const int l0 = blockIdx.y * LT;
    const int r0 = p.tile_ptr[t];
    const int nr = p.tile_ptr[t + 1] - r0;
    const int c0 = p.col_ptr[t];
    for (int r = threadIdx.x; r < nr; r += NT) rows[r] = p.tile_rows[r0 + r];
    __syncthreads();
    stage_x<T>(xs, XLD, x, sxl, sxc, p.tile_cols + c0,
               p.col_ptr[t + 1] - c0, l0, LT, L);
    stage_rows<T>(ds, max_nnz, ss, rows, nr, 0, p, data, nnz, 0, g0, true);
    cp_async_wait_all();
    __syncthreads();
    for (int s0 = 0; s0 < S; s0 += OP_GROUP) {
        const int G = min(OP_GROUP, S - s0);
        if (s0 > 0) {    // the previous group's entries are done with
            stage_rows<T>(ds, max_nnz, ss, rows, nr, 0, p, data, nnz, s0, G,
                          false);
            cp_async_wait_all();
            __syncthreads();
        }
        if (G == 1)
            wide_group<T, 1>(p, xs, ds, max_nnz, ss, ys, rows, nr, ldy, y,
                             s0, l0, L, n);
        else
            wide_group<T, 2>(p, xs, ds, max_nnz, ss, ys, rows, nr, ldy, y,
                             s0, l0, L, n);
    }
}

// ---- narrow lanes --------------------------------------------------------

// acc[s] = sum_j ds[s * ldd + off + j] * xl[tcols[ss[off + j]] * sxc] for j
// = 0 .. len-1 ascending, one FMA a term: slots, columns and values from
// shared memory, x from global memory (L1), BATCH gathers in flight.
template <typename T, int G>
__device__ __forceinline__ void row_sum_gather(
    T (&acc)[G], const T* ds, int ldd, const uint8_t* ss, const int* tcols,
    int off, int len, const T* __restrict__ xl, long long sxc)
{
    for (int j = 0; j < len; j += BATCH) {
        T xv[BATCH];
#pragma unroll
        for (int u = 0; u < BATCH; ++u)
            xv[u] = j + u < len ? __ldg(xl + tcols[ss[off + j + u]] * sxc)
                                : T(0);
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
            if (j + u < len) {
#pragma unroll
                for (int s = 0; s < G; ++s)
                    acc[s] = fma(ds[s * ldd + off + j + u], xv[u], acc[s]);
            }
        }
    }
}

// One block: rows q0 = blockIdx.y * RB .. of tile blockIdx.x, RB =
// blockDim.x / LP, for all L lanes; their entries, slots and the tile's
// columns staged (x itself is small at these widths, and read through L1);
// thread (r, l) = (threadIdx.x % RB, threadIdx.x / RB), so neighbouring
// threads write neighbouring rows of one lane.
template <typename T, int LP>
__global__ void __launch_bounds__(128)
csr_mv_narrow_kernel(const T* __restrict__ data, Plan p,
                     const T* __restrict__ x, long long sxl, long long sxc,
                     T* __restrict__ y, int S, int L, int n, long long nnz,
                     int max_rows, int max_cols, int max_nnz)
{
    extern __shared__ __align__(16) unsigned char smem[];
    const int g0 = min(S, OP_GROUP);
    T* ds = reinterpret_cast<T*>(smem);                  // [g0][max_nnz]
    int* tcols = reinterpret_cast<int*>(ds + g0 * max_nnz);  // [max_cols]
    uint8_t* ss = reinterpret_cast<uint8_t*>(tcols + max_cols);
    const int t = blockIdx.x;
    const int rb = blockDim.x / LP;
    const int q0 = blockIdx.y * rb;
    const int r0 = p.tile_ptr[t];
    const int nr = p.tile_ptr[t + 1] - r0;
    if (q0 >= nr) return;                                // the whole block
    const int nq = min(rb, nr - q0);
    const int* rows = p.tile_rows + r0 + q0;
    const int base = __ldg(p.row_off + rows[0]);
    const int c0 = p.col_ptr[t];
    for (int j = threadIdx.x; j < p.col_ptr[t + 1] - c0; j += blockDim.x)
        tcols[j] = __ldg(p.tile_cols + c0 + j);
    stage_rows<T>(ds, max_nnz, ss, rows, nq, base, p, data, nnz, 0, g0, true);
    cp_async_wait_all();
    __syncthreads();
    const int r = threadIdx.x % rb;
    const int l = threadIdx.x / rb;
    const bool active = r < nq && l < L;
    const int i = active ? rows[r] : 0;
    const int off = active ? __ldg(p.row_off + i) - base : 0;
    const int len = active ? __ldg(p.rowptr + i + 1) - __ldg(p.rowptr + i) : 0;
    const T* xl = x + l * sxl;
    for (int s0 = 0; s0 < S; s0 += OP_GROUP) {
        const int G = min(OP_GROUP, S - s0);
        if (s0 > 0) {
            __syncthreads();     // the previous group's entries are done with
            stage_rows<T>(ds, max_nnz, ss, rows, nq, base, p, data, nnz, s0,
                          G, false);
            cp_async_wait_all();
            __syncthreads();
        }
        if (!active) continue;
        if (G == 1) {
            T acc[1] = {T(0)};
            row_sum_gather<T, 1>(acc, ds, max_nnz, ss, tcols, off, len, xl,
                                 sxc);
            y[((size_t)s0 * L + l) * n + i] = acc[0];
        } else {
            T acc[2] = {T(0), T(0)};
            row_sum_gather<T, 2>(acc, ds, max_nnz, ss, tcols, off, len, xl,
                                 sxc);
            y[((size_t)s0 * L + l) * n + i] = acc[0];
            y[((size_t)(s0 + 1) * L + l) * n + i] = acc[1];
        }
    }
}

// ---- one lane ------------------------------------------------------------

// One block per (L1_ROWS consecutive rows, operator blockIdx.y): the entries
// of its rows (one contiguous run) and their columns staged, then one thread
// per row.  Where the plan has long rows (n_long > 0) a block stages only
// its other rows' entries, packed: each row's shift is the long rows'
// entries before it in the block (a block scan), a warp copies a row.  A
// block whose staged entries outgrow max_block_nnz reads them from global
// memory; a long row (row_off -1) is the long-row kernel's.  Every row sums
// its entries in one order, k ascending, staged or not.
template <typename T>
__global__ void __launch_bounds__(L1_ROWS)
csr_mv_l1_kernel(const T* __restrict__ data, Plan p,
                 const T* __restrict__ x, long long sxc, T* __restrict__ y,
                 int n, long long nnz, int max_block_nnz, int n_long)
{
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int shift[L1_ROWS + 1];   // long entries before each row
    const int i0 = blockIdx.x * L1_ROWS;
    const int s = blockIdx.y;
    const int k0 = __ldg(p.rowptr + i0);
    const int kn = __ldg(p.rowptr + min(n, i0 + L1_ROWS)) - k0;
    const int i = i0 + threadIdx.x;
    const int g = threadIdx.x & 31;
    const int w = threadIdx.x >> 5;
    const bool is_long = n_long > 0 && i < n && __ldg(p.row_off + i) < 0;
    int sh = 0;
    if (n_long > 0) {    // the block's exclusive scan of its long entries
        const int mine = is_long ? __ldg(p.rowptr + i + 1) - __ldg(p.rowptr + i)
                                 : 0;
        int inc = mine;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int v = __shfl_up_sync(0xffffffffu, inc, o);
            if (g >= o) inc += v;
        }
        if (g == 31) shift[w + 1] = inc;       // the warps' totals
        __syncthreads();
        if (threadIdx.x == 0) {
            shift[0] = 0;
            for (int v = 1; v <= L1_ROWS / 32; ++v) shift[v] += shift[v - 1];
        }
        __syncthreads();
        sh = shift[w] + inc - mine;
        __syncthreads();
        shift[threadIdx.x] = sh;
        if (threadIdx.x == L1_ROWS - 1) shift[L1_ROWS] = sh + mine;
        __syncthreads();
    }
    const int k_long = n_long > 0 ? shift[L1_ROWS] : 0;
    const bool staged = kn - k_long <= max_block_nnz;    // the whole block
    T* ds = reinterpret_cast<T*>(smem);                  // [kn - k_long]
    int* cs = reinterpret_cast<int*>(ds + (kn - k_long));
    if (staged && k_long > 0) {
        // the short rows' entries, packed past the long ones: a warp a row
        for (int r = w; r < L1_ROWS && i0 + r < n; r += L1_ROWS / 32) {
            const int ir = i0 + r;
            if (__ldg(p.row_off + ir) < 0) continue;
            const int a = __ldg(p.rowptr + ir);
            const int len = __ldg(p.rowptr + ir + 1) - a;
            const int dst = a - k0 - shift[r];
            for (int j = g; j < len; j += 32) {
                cp_async<sizeof(T)>(ds + dst + j,
                                    data + s * nnz + data_slot(p, a + j));
                cp_async<4>(cs + dst + j, p.col + a + j);
            }
        }
    } else {
        // L1_BATCH entries a thread at once: their data slots are all
        // loaded before the first copy is issued
        for (int j0 = threadIdx.x; staged && j0 < kn;
             j0 += L1_ROWS * L1_BATCH) {
            int kd[L1_BATCH];
#pragma unroll
            for (int u = 0; u < L1_BATCH; ++u) {
                const int j = j0 + u * L1_ROWS;
                kd[u] = j < kn ? data_slot(p, k0 + j) : 0;
            }
#pragma unroll
            for (int u = 0; u < L1_BATCH; ++u) {
                const int j = j0 + u * L1_ROWS;
                if (j < kn) {
                    cp_async<sizeof(T)>(ds + j, data + s * nnz + kd[u]);
                    cp_async<4>(cs + j, p.col + k0 + j);
                }
            }
        }
    }
    cp_async_wait_all();
    __syncthreads();
    if (i >= n || is_long) return;
    T acc = T(0);
    if (staged) {
        const int b = k0 + sh;     // entry k of this row is staged at k - b
        const int k1 = __ldg(p.rowptr + i + 1) - b;
        for (int k = __ldg(p.rowptr + i) - b; k < k1; k += L1_BATCH) {
            T xv[L1_BATCH];
#pragma unroll
            for (int j = 0; j < L1_BATCH; ++j)
                xv[j] = k + j < k1 ? __ldg(x + cs[k + j] * sxc) : T(0);
#pragma unroll
            for (int j = 0; j < L1_BATCH; ++j)
                if (k + j < k1) acc = fma(ds[k + j], xv[j], acc);
        }
    } else {     // the same sum, its entries read from global memory
        const int k1 = __ldg(p.rowptr + i + 1);
        for (int k = __ldg(p.rowptr + i); k < k1; ++k)
            acc = fma(__ldg(data + s * nnz + data_slot(p, k)),
                      __ldg(x + __ldg(p.col + k) * sxc), acc);
    }
    y[(size_t)s * n + i] = acc;
}

// ---- long rows -----------------------------------------------------------

// The long rows' plan (ops/csr_kernel.py _long_plan): the long rows in
// groups of LG (long_rows order), each group's column windows of LW columns
// that its rows touch, ascending, and every long entry's place in its
// group's staged x.  Entry indices e count the long rows' entries (rows in
// long_rows order, each row's in CSR order); CSR entry k = e + koff[row].
struct LongPlan {
    const int* rows;     // (n_long): the long rows, ascending
    const int* wptr;     // (groups+1): group g's windows win[wptr[g] ..]
    const int* win;      // each group's windows (first column / LW)
    const int* kptr;     // ((windows + groups) * LG): (wptr[g] + g + j) * LG
                         // + r: row r of group g's first entry in window j
                         // (j = the group's window count: its end)
    const int* xi;       // (long entries): window place * LW + column % LW
    const int* koff;     // (n_long): k - e
    const int* src;      // (long entries): the data slot of each (perm[k])
    const int* segptr;   // (n_long+1): row q's segments segptr[q] ..
    const int* segrow;   // (segments): each segment's long row
    int n_long;
    int n_entries;
};

// The long entries' values of S operators in entry order, dl[s, e] =
// data[s, src[e]]: one thread an (operator, entry), the operators slowest,
// so the blocks in flight gather from one operator's values at a time
// (they stay in L2) and the sum kernels read them in runs.
template <typename T>
__global__ void __launch_bounds__(256)
csr_mv_long_gather_kernel(const T* __restrict__ data,
                          const int* __restrict__ src, T* __restrict__ dl,
                          int S, int E, long long nnz)
{
    const long long q = (long long)blockIdx.x * 256 + threadIdx.x;
    if (q >= (long long)S * E) return;
    const long long s = q / E;
    dl[q] = __ldg(data + s * nnz + __ldg(src + (q - s * E)));
}

// Wide lanes (L >= 32).  One block per (group blockIdx.x of LG long rows,
// 32-lane tile blockIdx.y, operator group blockIdx.z of G operators).
// Thread t takes lane t % 32 of rows t / 32 + 8 u (u < 4), G operators
// each, in registers.  The block walks its group's windows cpb at a time
// (a stage), ascending, through a two-deep ring of cp.async copies in
// shared memory, so the copies of stage j + 1 are in flight while stage j
// is summed: x over the stage's windows for the block's lanes
// (xs[column][lane], a warp's copies on whichever x axis is contiguous),
// the rows' entries in those windows packed row after row, their x places
// and values, and the rows' entry bounds three stages ahead.  Each (row,
// lane, operator) sums its row's entries with k ascending, one FMA a term,
// the sum carried in registers from stage to stage: the order, and the
// bits, of every other kernel here.  x is staged once a stage for every
// row of the group and both operators; the rows' values once for all 32
// lanes.  (A third stage in flight, or x's windows as TMA bulk copies on
// an mbarrier, measured no faster on an NVIDIA H100 80GB HBM3: PERF.md.)
constexpr int LG = 32;     // long rows of a group (the plan's LONG_GROUP)
constexpr int LW = 64;     // columns of a window (the plan's LONG_WIN)
constexpr int LONG_NT = 256;             // threads of a wide long block
constexpr int LONG_XLD = 33;             // a staged column's stride (lanes)
constexpr int LONG_KD = 4;               // the entry bounds' ring

// Bytes of one stage's buffer: x over cpb windows, es entries' values for
// G operators and x places, each row's offset and count; rounded up to 16
// bytes.
template <typename T, int G>
__host__ __device__ constexpr size_t long_v_bytes(int cpb, int es)
{
    return (sizeof(T) * ((size_t)cpb * LW * LONG_XLD + (size_t)G * es)
            + sizeof(int) * ((size_t)es + 2 * LG) + 15) / 16 * 16;
}

template <typename T, int G>
__global__ void __launch_bounds__(LONG_NT)
csr_mv_long_kernel(const T* __restrict__ dl, LongPlan lp,
                   const T* __restrict__ x, long long sxl, long long sxc,
                   T* __restrict__ y, int S, int L, int n, int n_cols,
                   int cpb, int es)
{
    constexpr int RT = LG / (LONG_NT / 32);   // rows a thread
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int row[LG];
    const int g = blockIdx.x;
    const int l0 = blockIdx.y * 32;
    const int s0 = blockIdx.z * G;
    const int t = threadIdx.x;
    const int lane = t & 31;
    const int warp = t >> 5;
    const int nr = min(LG, lp.n_long - g * LG);
    const int wbase = __ldg(lp.wptr + g);
    const int nw = __ldg(lp.wptr + g + 1) - wbase;
    const int kbase = (wbase + g) * LG;
    const int nst = (nw + cpb - 1) / cpb;
    const long long E = lp.n_entries;
    const int lanes = min(32, L - l0);
    if (t < nr) row[t] = __ldg(lp.rows + g * LG + t);
    const size_t vbytes = long_v_bytes<T, G>(cpb, es);
    // buffer b: xs [cpb LW][LONG_XLD], ds [G][es], cs [es], and each row's
    // offset and count [LG] each; then the K ring [LONG_KD][LG]
    auto xs_of = [&](int b) { return reinterpret_cast<T*>(smem + b * vbytes); };
    auto ds_of = [&](int b) { return xs_of(b) + cpb * LW * LONG_XLD; };
    auto cs_of = [&](int b) {
        return reinterpret_cast<int*>(ds_of(b) + G * es);
    };
    int* kb = reinterpret_cast<int*>(smem + 2 * vbytes);

    // K: the rows' first entries at stage j's first window (the group's
    // end past its last stage)
    auto issue_k = [&](int j) {
        if (warp == 0)
            cp_async<4>(kb + (j % LONG_KD) * LG + lane,
                        lp.kptr + kbase + min(j * cpb, nw) * LG + lane);
    };
    // V: x over the stage's windows, then each row's entries (every warp
    // scans the 32 rows' counts for their offsets in the packed stage)
    auto issue_values = [&](int j) {
        const int j0 = j * cpb;
        const int nbw = min(cpb, nw - j0);
        T* xs = xs_of(j & 1);
        T* ds = ds_of(j & 1);
        int* cs = cs_of(j & 1);
        const bool cols_fast = sxc == 1 && sxl != 1;
        for (int w = 0; w < nbw; ++w) {
            const long long cb = (long long)__ldg(lp.win + wbase + j0 + w) * LW;
            T* xw = xs + w * LW * LONG_XLD;
#pragma unroll
            for (int q = t; q < LW * 32; q += LONG_NT) {
                const int c = cols_fast ? q % LW : q / 32;
                const int l = cols_fast ? q / LW : q % 32;
                if (cb + c < n_cols && l < lanes)
                    cp_async<sizeof(T)>(xw + c * LONG_XLD + l,
                                        x + (l0 + l) * sxl + (cb + c) * sxc);
            }
        }
        const int a = kb[(j % LONG_KD) * LG + lane];
        const int cnt = lane < nr ? kb[((j + 1) % LONG_KD) * LG + lane] - a
                                  : 0;
        int inc = cnt;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int v = __shfl_up_sync(0xffffffffu, inc, o);
            if (lane >= o) inc += v;
        }
        const int off = inc - cnt;
        if (warp == 0) {
            cs[es + lane] = off;
            cs[es + LG + lane] = cnt;
        }
        for (int r = warp; r < nr; r += LONG_NT / 32) {
            const int e0 = __shfl_sync(0xffffffffu, a, r);
            const int o0 = __shfl_sync(0xffffffffu, off, r);
            const int cr = __shfl_sync(0xffffffffu, cnt, r);
            for (int e = lane; e < cr; e += 32) {
                cp_async<4>(cs + o0 + e, lp.xi + e0 + e);
#pragma unroll
                for (int s = 0; s < G; ++s)
                    if (s0 + s < S)
                        cp_async<sizeof(T)>(ds + s * es + o0 + e,
                                            dl + (s0 + s) * E + e0 + e);
            }
        }
    };

    T acc[RT][G];
#pragma unroll
    for (int u = 0; u < RT; ++u)
#pragma unroll
        for (int s = 0; s < G; ++s) acc[u][s] = T(0);
    __syncthreads();
    if (nst > 0) {
        issue_k(0);
        issue_k(1);
        issue_k(2);
        cp_async_wait_all();
        __syncthreads();
        issue_values(0);
    }
    for (int j = 0; j < nst; ++j) {
        cp_async_wait_all();   // V of stage j, K of stage j + 2
        __syncthreads();
        if (j + 1 < nst) issue_values(j + 1);
        if (j + 3 <= nst) issue_k(j + 3);
        const T* xs = xs_of(j & 1) + lane;
        const int xoff = j * cpb * LW;    // the stage's first x place
        const T* ds = ds_of(j & 1);
        const int* cs = cs_of(j & 1);
#pragma unroll
        for (int u = 0; u < RT; ++u) {
            const int r = warp + (LONG_NT / 32) * u;
            if (r >= nr) break;
            const int o0 = cs[es + r];
            const int len = cs[es + LG + r];
#pragma unroll 4
            for (int e = o0; e < o0 + len; ++e) {
                const T xv = xs[(cs[e] - xoff) * LONG_XLD];
#pragma unroll
                for (int s = 0; s < G; ++s)
                    acc[u][s] = fma(ds[s * es + e], xv, acc[u][s]);
            }
        }
    }
    if (lane >= lanes) return;
#pragma unroll
    for (int u = 0; u < RT; ++u) {
        const int r = warp + (LONG_NT / 32) * u;
        if (r >= nr) break;
#pragma unroll
        for (int s = 0; s < G; ++s)
            if (s0 + s < S)
                y[((size_t)(s0 + s) * L + l0 + lane) * n + row[r]] =
                    acc[u][s];
    }
}

// Narrow lanes (L < 32).  Few (row, lane, operator) chains there (256 x
// 32 on chip_smoke.py's pattern): one warp a long row leaves the card
// short of loads in flight (a warp a row, its chunks staged through its
// own ring, took 0.14 ms at S = 2, L = 16, the parent's kernel 0.07).  So
// each long row is cut into segments of LONG_SEG entries (the plan's, by
// the row's length alone), a warp takes a (segment, operator tile), LP
// lanes (L's next power of two) times 32 / LP operators a thread, and
// sums its segment's entries with k ascending, one FMA a term, loading
// the columns, the values (gathered in entry order) and x (transposed by
// the wrapper, a column's lanes side by side) straight into registers,
// LONG_BATCH entries in flight; a second kernel adds each row's segment
// sums in order, the first plus the second, plus the third...  A fixed
// two-level order that depends on the plan and the shape alone.
constexpr int LONG_SEG = 128;      // entries a segment (the plan's)
constexpr int LONG_BATCH = 16;     // entries a warp loads at once

template <typename T, int LP>
__global__ void __launch_bounds__(128)
csr_mv_long_narrow_kernel(const T* __restrict__ dl,
                          const int* __restrict__ rowptr,
                          const int* __restrict__ col, LongPlan lp,
                          int n_seg, int op_tiles, const T* __restrict__ x,
                          long long sxl, long long sxc, T* __restrict__ part,
                          int S, int L)
{
    constexpr int OT = 32 / LP;              // operators of the warp
    const int lane = threadIdx.x & 31;
    const long long unit = (long long)blockIdx.x * 4 + (threadIdx.x >> 5);
    if (unit >= (long long)n_seg * op_tiles) return;
    const int seg = static_cast<int>(unit % n_seg);  // operator tiles slowest
    const int s0 = static_cast<int>(unit / n_seg) * OT;
    const int q = __ldg(lp.segrow + seg);
    const int p = seg - __ldg(lp.segptr + q);
    const int i = __ldg(lp.rows + q);
    const int kb = __ldg(rowptr + i) + p * LONG_SEG;
    const int m = min(LONG_SEG, __ldg(rowptr + i + 1) - kb);
    const long long eb = kb - __ldg(lp.koff + q);
    const int l = lane % LP;
    const int o = lane / LP;
    const bool live = l < L && s0 + o < S;
    const T* xl = x + (live ? l : 0) * sxl;
    const T* dr = dl + (long long)(live ? s0 + o : 0) * lp.n_entries + eb;
    T acc = T(0);
    for (int j0 = 0; j0 < m; j0 += LONG_BATCH) {
        int c[LONG_BATCH];
#pragma unroll
        for (int u = 0; u < LONG_BATCH; ++u)
            c[u] = j0 + u < m ? __ldg(col + kb + j0 + u) : 0;
        T xv[LONG_BATCH], dv[LONG_BATCH];
#pragma unroll
        for (int u = 0; u < LONG_BATCH; ++u) {
            xv[u] = j0 + u < m ? __ldg(xl + c[u] * sxc) : T(0);
            dv[u] = j0 + u < m ? __ldg(dr + j0 + u) : T(0);
        }
#pragma unroll
        for (int u = 0; u < LONG_BATCH; ++u)
            if (j0 + u < m) acc = fma(dv[u], xv[u], acc);
    }
    if (live) part[((long long)(s0 + o) * L + l) * n_seg + seg] = acc;
}

// y at each long row: its segment sums added in order, one thread an
// (operator, lane, long row)
template <typename T>
__global__ void __launch_bounds__(256)
csr_mv_long_combine_kernel(const T* __restrict__ part, LongPlan lp,
                           int n_seg, T* __restrict__ y, int S, int L,
                           int n)
{
    const long long t = (long long)blockIdx.x * 256 + threadIdx.x;
    if (t >= (long long)S * L * lp.n_long) return;
    const int q = static_cast<int>(t % lp.n_long);
    const long long sl = t / lp.n_long;
    const int a = __ldg(lp.segptr + q);
    const int b = __ldg(lp.segptr + q + 1);
    const T* pr = part + sl * n_seg;
    T v = pr[a];
    for (int k = a + 1; k < b; ++k) v += pr[k];
    y[sl * n + __ldg(lp.rows + q)] = v;
}

// ---- launchers -----------------------------------------------------------

constexpr int SMEM_MAX = 232448;   // a block's shared memory on an H100

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes)
{
    if (bytes > SMEM_MAX) return cudaErrorInvalidValue;
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(bytes));
}

int done(cudaError_t err)
{
    if (err == cudaSuccess) err = cudaGetLastError();
    return err == cudaSuccess ? 1 : -static_cast<int>(err);
}

struct Shape {
    int S, L, n;
    long long nnz;
    int n_tiles, max_rows, max_cols, max_nnz, max_block_nnz, n_long;
};

template <typename T>
int launch_wide(const T* data, const Plan& p, const T* x, long long sxl,
                long long sxc, T* y, const Shape& sh, cudaStream_t st)
{
    const dim3 grid(sh.n_tiles, (sh.L + LT - 1) / LT);
    if (grid.y > 65535) return -static_cast<int>(cudaErrorInvalidValue);
    const size_t g0 = sh.S < OP_GROUP ? sh.S : OP_GROUP;
    const size_t smem = sizeof(T) * ((size_t)sh.max_cols * XLD
                                     + g0 * LT * (sh.max_rows | 1)
                                     + g0 * sh.max_nnz)
                        + sizeof(int) * sh.max_rows + sh.max_nnz;
    const cudaError_t err = allow_smem(csr_mv_wide_kernel<T>, smem);
    if (err != cudaSuccess) return -static_cast<int>(err);
    csr_mv_wide_kernel<T><<<grid, NT, smem, st>>>(
        data, p, x, sxl, sxc, y, sh.S, sh.L, sh.n, sh.nnz, sh.max_rows,
        sh.max_cols, sh.max_nnz);
    return done(cudaSuccess);
}

template <typename T, int LP>
int launch_narrow_lp(const T* data, const Plan& p, const T* x,
                     long long sxl, long long sxc, T* y, const Shape& sh,
                     cudaStream_t st)
{
    constexpr int RB = 32 / LP > 4 ? 32 / LP : 4;   // rows of a block
    const dim3 grid(sh.n_tiles, (sh.max_rows + RB - 1) / RB);
    const size_t g0 = sh.S < OP_GROUP ? sh.S : OP_GROUP;
    const size_t smem = sizeof(T) * g0 * sh.max_nnz
                        + sizeof(int) * sh.max_cols + sh.max_nnz;
    const cudaError_t err = allow_smem(csr_mv_narrow_kernel<T, LP>, smem);
    if (err != cudaSuccess) return -static_cast<int>(err);
    csr_mv_narrow_kernel<T, LP><<<grid, RB * LP, smem, st>>>(
        data, p, x, sxl, sxc, y, sh.S, sh.L, sh.n, sh.nnz, sh.max_rows,
        sh.max_cols, sh.max_nnz);
    return done(cudaSuccess);
}

template <typename T>
int launch_narrow(const T* data, const Plan& p, const T* x, long long sxl,
                  long long sxc, T* y, const Shape& sh, cudaStream_t st)
{
    if (sh.L <= 2) return launch_narrow_lp<T, 2>(data, p, x, sxl, sxc, y, sh, st);
    if (sh.L <= 4) return launch_narrow_lp<T, 4>(data, p, x, sxl, sxc, y, sh, st);
    if (sh.L <= 8) return launch_narrow_lp<T, 8>(data, p, x, sxl, sxc, y, sh, st);
    if (sh.L <= 16) return launch_narrow_lp<T, 16>(data, p, x, sxl, sxc, y, sh, st);
    return launch_narrow_lp<T, 32>(data, p, x, sxl, sxc, y, sh, st);
}

template <typename T>
int launch_l1(const T* data, const Plan& p, const T* x, long long sxc, T* y,
              const Shape& sh, cudaStream_t st)
{
    if (sh.S > 65535) return -static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((sh.n + L1_ROWS - 1) / L1_ROWS, sh.S);
    const size_t smem = (sizeof(T) + sizeof(int)) * (size_t)sh.max_block_nnz;
    const cudaError_t err = allow_smem(csr_mv_l1_kernel<T>, smem);
    if (err != cudaSuccess) return -static_cast<int>(err);
    csr_mv_l1_kernel<T><<<grid, L1_ROWS, smem, st>>>(
        data, p, x, sxc, y, sh.n, sh.nnz, sh.max_block_nnz, sh.n_long);
    return done(cudaSuccess);
}

// a wide long-row block's shared memory at most: two blocks an H100 SM
constexpr size_t LONG_SMEM = 110 * 1024;
// stage widths (windows a stage) the plan counts a group's entries for
constexpr int LONG_BATCHES = 5;     // 1, 2, 4, 8, 16 windows

template <typename T, int G>
int launch_long_wide(const T* dl, const LongPlan& lp, int n_groups,
                     const int* stage_max, const T* x, long long sxl,
                     long long sxc, T* y, int S, int L, int n, int n_cols,
                     cudaStream_t st)
{
    const long long lane_tiles = ((long long)L + 31) / 32;
    const long long op_groups = ((long long)S + G - 1) / G;
    if (lane_tiles > 65535 || op_groups > 65535)
        return -static_cast<int>(cudaErrorInvalidValue);
    // the widest stage whose ring fits LONG_SMEM (one window always)
    auto bytes = [](int cpb, int es) {
        return 2 * long_v_bytes<T, G>(cpb, es) + sizeof(int) * LONG_KD * LG;
    };
    int cpb = 1, es = stage_max[0];
    for (int c = LONG_BATCHES - 1; c > 0; --c)
        if (bytes(1 << c, stage_max[c]) <= LONG_SMEM) {
            cpb = 1 << c;
            es = stage_max[c];
            break;
        }
    es = es > 0 ? es : 1;
    const size_t smem = bytes(cpb, es);
    const cudaError_t err = allow_smem(csr_mv_long_kernel<T, G>, smem);
    if (err != cudaSuccess) return -static_cast<int>(err);
    const dim3 grid(n_groups, lane_tiles, op_groups);
    csr_mv_long_kernel<T, G><<<grid, LONG_NT, smem, st>>>(
        dl, lp, x, sxl, sxc, y, S, L, n, n_cols, cpb, es);
    return done(cudaSuccess);
}

// the segment sums and their combine: returns 2, or minus a cudaError
template <typename T, int LP>
int launch_long_narrow(const T* dl, T* part, const int* rowptr,
                       const int* col, const LongPlan& lp, int n_seg,
                       const T* x, long long sxl, long long sxc, T* y, int S,
                       int L, int n, cudaStream_t st)
{
    const int op_tiles = (S + 32 / LP - 1) / (32 / LP);
    const long long blocks = ((long long)n_seg * op_tiles + 3) / 4;
    const long long cblocks = ((long long)S * L * lp.n_long + 255) / 256;
    if (blocks > 2147483647LL || cblocks > 2147483647LL)
        return -static_cast<int>(cudaErrorInvalidValue);
    csr_mv_long_narrow_kernel<T, LP><<<(unsigned)blocks, 128, 0, st>>>(
        dl, rowptr, col, lp, n_seg, op_tiles, x, sxl, sxc, part, S, L);
    const int rc = done(cudaSuccess);
    if (rc < 0) return rc;
    csr_mv_long_combine_kernel<T><<<(unsigned)cblocks, 256, 0, st>>>(
        part, lp, n_seg, y, S, L, n);
    const int rc2 = done(cudaSuccess);
    return rc2 < 0 ? rc2 : 2;
}

// The long entries' values gathered into dl (S, n_entries), then the wide
// kernel from 32 lanes on, two operators a thread (one where S = 1), or
// below the narrow one (its lane tile L's next power of two) into the
// segment sums part (S, L, n_seg) and their sums: two or three kernels, one
// long-row product; returns how many were launched
template <typename T>
int launch_long(const T* data, T* dl, T* part, const int* rowptr,
                const int* col, const LongPlan& lp, int n_groups, int n_seg,
                const int* stage_max, const T* x, long long sxl,
                long long sxc, T* y, int S, int L, int n, int n_cols,
                long long nnz, void* stream)
{
    if (S <= 0 || L <= 0 || lp.n_long <= 0) return 0;
    if (lp.n_long > n || n_groups != (lp.n_long + LG - 1) / LG
            || lp.n_entries <= 0)
        return -static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const long long items = (long long)S * lp.n_entries;
    if ((items + 255) / 256 > 2147483647LL)
        return -static_cast<int>(cudaErrorInvalidValue);
    csr_mv_long_gather_kernel<T><<<(unsigned)((items + 255) / 256), 256, 0,
                                   st>>>(data, lp.src, dl, S, lp.n_entries,
                                         nnz);
    const int rc = done(cudaSuccess);
    if (rc < 0) return rc;
    int sums;    // the kernels after the gather
#define LONG_NARROW(LP_)                                                      \
    sums = launch_long_narrow<T, LP_>(dl, part, rowptr, col, lp, n_seg, x,    \
                                      sxl, sxc, y, S, L, n, st)
    if (L == 1) LONG_NARROW(1);
    else if (L == 2) LONG_NARROW(2);
    else if (L <= 4) LONG_NARROW(4);
    else if (L <= 8) LONG_NARROW(8);
    else if (L <= 16) LONG_NARROW(16);
    else if (L < 32) LONG_NARROW(32);
#undef LONG_NARROW
    else if (S == 1)
        sums = launch_long_wide<T, 1>(dl, lp, n_groups, stage_max, x, sxl,
                                      sxc, y, S, L, n, n_cols, st);
    else
        sums = launch_long_wide<T, 2>(dl, lp, n_groups, stage_max, x, sxl,
                                      sxc, y, S, L, n, n_cols, st);
    return sums < 0 ? sums : 1 + sums;
}

enum Regime { ONE_LANE, NARROW, WIDE };

template <typename T>
int launch(Regime regime, const T* data, const Plan& p, const T* x,
           long long sxl, long long sxc, T* y, const Shape& sh, void* stream)
{
    if (sh.S <= 0 || sh.L <= 0 || sh.n <= 0) return 0;
    const bool ok = regime == ONE_LANE ? sh.L == 1
                  : regime == NARROW ? (sh.L >= 2 && sh.L < LT)
                  : sh.L >= LT;
    if (!ok || sh.nnz < 0 || sh.n_tiles <= 0 || sh.max_rows <= 0
            || sh.max_cols > 256)
        return -static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (regime) {
    case ONE_LANE: return launch_l1<T>(data, p, x, sxc, y, sh, st);
    case NARROW: return launch_narrow<T>(data, p, x, sxl, sxc, y, sh, st);
    default: return launch_wide<T>(data, p, x, sxl, sxc, y, sh, st);
    }
}

}  // namespace

// data (S, nnz) contiguous, in CSR order or, with perm (nnz,) (else null),
// data[:, perm] in CSR order; the plan (ops/csr_kernel.py build_csr):
// tile_ptr (T+1,), tile_rows (n,), col_ptr (T+1,), tile_cols, slot (nnz,)
// uint8, row_off (n,), rowptr (n+1,), col (nnz,), int32 unless stated, and
// its largest tile's rows, columns and entries and the most
// entries L1_ROWS consecutive rows hold; x[l, c] at x + l * sxl + c * sxc;
// y (S, L, n) contiguous; n_long, the plan's long rows (rows of no tile);
// all on the current device.  Each launches one kernel on `stream` (the
// regime its name says: L = 1, 2 <= L < 32, L >= 32) for the tiles' rows
// and returns 1, 0 for an empty product, or minus the cudaError of a
// launch that failed.
#define CSR_MV_ENTRY(NAME, T, REGIME)                                         \
    extern "C" int NAME(const T* data, const int* tile_ptr,                   \
                        const int* tile_rows, const int* col_ptr,             \
                        const int* tile_cols, const uint8_t* slot,            \
                        const int* row_off, const int* rowptr,                \
                        const int* col, const int* perm, const T* x,          \
                        long long sxl, long long sxc, T* y, int S, int L,     \
                        int n,                                                \
                        long long nnz, int n_tiles, int max_rows,             \
                        int max_cols, int max_nnz, int max_block_nnz,         \
                        int n_long, void* stream)                             \
    {                                                                         \
        const Plan p{tile_ptr, tile_rows, col_ptr, tile_cols, slot, row_off,  \
                     rowptr, col, perm};                                      \
        const Shape sh{S, L, n, nnz, n_tiles, max_rows, max_cols, max_nnz,    \
                       max_block_nnz, n_long};                                \
        return launch<T>(REGIME, data, p, x, sxl, sxc, y, sh, stream);        \
    }

CSR_MV_ENTRY(csr_mv_l1_f64, double, ONE_LANE)
CSR_MV_ENTRY(csr_mv_narrow_f64, double, NARROW)
CSR_MV_ENTRY(csr_mv_wide_f64, double, WIDE)
CSR_MV_ENTRY(csr_mv_l1_f32, float, ONE_LANE)
CSR_MV_ENTRY(csr_mv_narrow_f32, float, NARROW)
CSR_MV_ENTRY(csr_mv_wide_f32, float, WIDE)

// The long rows of the pattern (rowptr, col as above; the long-row plan
// of ops/csr_kernel.py _long_plan: long_rows (n_long,), wptr
// (n_groups+1,), win, kptr, xi, koff (n_long,), src (n_entries,), segptr
// (n_long+1,), segrow (n_seg,), int32, and stage_max (LONG_BATCHES,): a
// group's most entries in a stage of 1, 2, 4, 8, 16 windows), for all S
// operators and L lanes, into the same y, with the scratch dl (S,
// n_entries) of the entries' values and, below 32 lanes, part (S, L,
// n_seg) of the segment sums: on `stream`, after the tiles' kernel, the
// gather and the sums (two or three kernels, one long-row product).
// Below 32 lanes x is read by its strides as the caller hands it
// (transposed, a column's lanes side by side).  Returns the number of
// kernels launched (2 from 32 lanes, 3 below), 0 for an empty product, or
// minus the cudaError of a launch that failed.
#define CSR_MV_LONG_ENTRY(NAME, T)                                            \
    extern "C" int NAME(const T* data, T* dl, T* part, const int* rowptr,     \
                        const int* col, const int* long_rows, int n_long,     \
                        const int* wptr, const int* win, const int* kptr,     \
                        const int* xi, const int* koff, const int* src,       \
                        const int* segptr, const int* segrow, int n_entries,  \
                        int n_groups, int n_seg, const int* stage_max,        \
                        const T* x, long long sxl, long long sxc, T* y,       \
                        int S, int L, int n, int n_cols, long long nnz,       \
                        void* stream)                                         \
    {                                                                         \
        const LongPlan lp{long_rows, wptr, win, kptr, xi, koff, src, segptr,  \
                          segrow, n_long, n_entries};                         \
        return launch_long<T>(data, dl, part, rowptr, col, lp, n_groups,      \
                              n_seg, stage_max, x, sxl, sxc, y, S, L, n,      \
                              n_cols, nnz, stream);                           \
    }

CSR_MV_LONG_ENTRY(csr_mv_long_f64, double)
CSR_MV_LONG_ENTRY(csr_mv_long_f32, float)
