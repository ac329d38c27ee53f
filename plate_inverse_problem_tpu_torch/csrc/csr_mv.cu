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
//    128 rows' entries and columns staged first; one launch for every
//    operator.
//  * Long rows (more than 256 distinct columns, or more entries than a
//    tile's staging holds: a dense row of a synthetic pencil, a coarse
//    level's restriction at a large coarsening factor; no plate pattern
//    has one): the plan keeps them out of every tile and lists them, and a
//    kernel of their own follows the tiles' one on the stream.  One block
//    of 8 warps takes a long row for 8 (lane, operator) items, a warp an
//    item; thread g of a warp sums the entries g, g + 32, ... in ascending
//    order, one FMA each, reading the data (through perm) and x straight
//    from global memory, and the warp's 32 partial sums are reduced by a
//    fixed shuffle tree: the same bits in every run.  (A first cut with
//    a block of 256 threads a (row, lane), reduced through shared memory,
//    took 11.1 ms at S = 2, L = 1024 on chip_smoke.py's long-row pattern,
//    a warp a lane 5.0 ms, a warp an item 4.3 ms, on an NVIDIA H100 80GB
//    HBM3 at 700 W.)  The one-lane kernel skips
//    the long rows, and a block of it whose entries outgrow its staging
//    reads them from global memory.  The regime is simple, not fast: it
//    reads x at the row's columns once a lane and operator, from L2, and
//    the row's values once a lane, from L1.
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
constexpr int LONG_NT = 256;     // threads of a long-row block
constexpr int LONG_LANES = LONG_NT / 32;   // its (lane, operator) items

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

// One block per (L1_ROWS consecutive rows, operator blockIdx.y): their
// entries (one contiguous run) and columns staged, then one thread per row.
// A block whose run holds more than max_block_nnz entries (it has a long
// row) reads them from global memory; a long row (row_off -1, where the
// plan has any: n_long > 0) is the long-row kernel's.
template <typename T>
__global__ void __launch_bounds__(L1_ROWS)
csr_mv_l1_kernel(const T* __restrict__ data, Plan p,
                 const T* __restrict__ x, long long sxc, T* __restrict__ y,
                 int n, long long nnz, int max_block_nnz, int n_long)
{
    extern __shared__ __align__(16) unsigned char smem[];
    const int i0 = blockIdx.x * L1_ROWS;
    const int s = blockIdx.y;
    const int k0 = __ldg(p.rowptr + i0);
    const int kn = __ldg(p.rowptr + min(n, i0 + L1_ROWS)) - k0;
    const bool staged = kn <= max_block_nnz;             // the whole block
    T* ds = reinterpret_cast<T*>(smem);                  // [kn]
    int* cs = reinterpret_cast<int*>(ds + kn);           // [kn]
    // L1_BATCH entries a thread at once: their data slots are all loaded
    // before the first copy is issued
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
    cp_async_wait_all();
    __syncthreads();
    const int i = i0 + threadIdx.x;
    if (i >= n) return;
    if (n_long > 0 && __ldg(p.row_off + i) < 0) return;
    T acc = T(0);
    if (staged) {
        const int k1 = __ldg(p.rowptr + i + 1) - k0;
        for (int k = __ldg(p.rowptr + i) - k0; k < k1; k += L1_BATCH) {
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

// One block per long row long_rows[blockIdx.x] and LONG_LANES (lane,
// operator) items q = blockIdx.y * LONG_LANES + w (and every gridDim.y *
// LONG_LANES-th item after them; lane q / S, operator q % S, so the warps
// of a block share a lane's x in L1 and the row's values and columns);
// warp w takes one item: its thread g sums the row's entries g, g + 32,
// ... in ascending order, one FMA each, data (through perm) and x read
// from global memory, and the 32 partial sums are added by a fixed
// shuffle tree: the same bits in every run.
template <typename T>
__global__ void __launch_bounds__(LONG_NT)
csr_mv_long_kernel(const T* __restrict__ data, const int* __restrict__ rowptr,
                   const int* __restrict__ col, const int* __restrict__ perm,
                   const int* __restrict__ long_rows,
                   const T* __restrict__ x, long long sxl, long long sxc,
                   T* __restrict__ y, int S, int L, int n, long long nnz)
{
    const int i = __ldg(long_rows + blockIdx.x);
    const int k0 = __ldg(rowptr + i);
    const int k1 = __ldg(rowptr + i + 1);
    const int g = threadIdx.x & 31;
    const long long items = (long long)S * L;
    for (long long q = (long long)blockIdx.y * LONG_LANES + (threadIdx.x >> 5);
         q < items; q += (long long)gridDim.y * LONG_LANES) {
        const int l = static_cast<int>(q / S);
        const int s = static_cast<int>(q % S);
        const T* xl = x + l * sxl;
        const T* ds = data + s * nnz;
        T acc = T(0);
        for (int k = k0 + g; k < k1; k += 32)
            acc = fma(__ldg(ds + (perm ? __ldg(perm + k) : k)),
                      __ldg(xl + __ldg(col + k) * sxc), acc);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
            acc += __shfl_down_sync(0xffffffffu, acc, o);
        if (g == 0) y[((size_t)s * L + l) * n + i] = acc;
    }
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

template <typename T>
int launch_long(const T* data, const int* rowptr, const int* col,
                const int* perm, const int* long_rows, int n_long,
                const T* x, long long sxl, long long sxc, T* y, int S, int L,
                int n, long long nnz, void* stream)
{
    if (S <= 0 || L <= 0 || n_long <= 0) return 0;
    if (n_long > n) return -static_cast<int>(cudaErrorInvalidValue);
    const long long item_blocks =
        ((long long)S * L + LONG_LANES - 1) / LONG_LANES;
    const dim3 grid(n_long, item_blocks < 65535 ? item_blocks : 65535);
    csr_mv_long_kernel<T><<<grid, LONG_NT, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        data, rowptr, col, perm, long_rows, x, sxl, sxc, y, S, L, n, nnz);
    return done(cudaSuccess);
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

// The long rows long_rows (n_long,) int32 of the pattern (rowptr, col,
// perm as above), for all S operators and L lanes, into the same y: one
// launch on `stream`, after the tiles' kernel.  Returns 1, 0 for an empty
// product, or minus the cudaError of a launch that failed.
#define CSR_MV_LONG_ENTRY(NAME, T)                                            \
    extern "C" int NAME(const T* data, const int* rowptr, const int* col,     \
                        const int* perm, const int* long_rows, int n_long,    \
                        const T* x, long long sxl, long long sxc, T* y,       \
                        int S, int L, int n, long long nnz, void* stream)     \
    {                                                                         \
        return launch_long<T>(data, rowptr, col, perm, long_rows, n_long, x,  \
                              sxl, sxc, y, S, L, n, nnz, stream);             \
    }

CSR_MV_LONG_ENTRY(csr_mv_long_f64, double)
CSR_MV_LONG_ENTRY(csr_mv_long_f32, float)
