// The FGMRES cycle's Givens least squares for Hopper (sm_90a), f64: one
// launch an Arnoldi step (givens_step, K7a) and one a cycle (backsub, K7b).
//
// Replaces no Pallas kernel.  In the JAX package the whole FGMRES cycle,
// plate_inverse_problem_tpu/ops/mixed.py _pgmres_cycle_body (l.349), is one
// compiled while_loop, and XLA fuses its scalar least-squares work into the
// loop body on the device: the rotations of the new Hessenberg column
// (l.393-414), the new rotation, g and the residual estimate (l.416-452),
// the re-anchored target (l.459-463) and the back-substitution (l.479-496).
// The port's eager torch ran the same arithmetic as some 390 elementwise
// launches an Arnoldi step and 180 a cycle, each over a few lanes
// (ops/fgmres_kernel.py's plain versions).  These two kernels are the
// port's counterpart of that fused loop body, as K3 (csr_mv.cu) is of
// _fused_mv.
//
// What it computes.  Per frequency lane l, in split complex (re, im):
//   givens_step: the CGS2 coefficients h (k+1 of them) with h[j+1] = the
//     new basis vector's norm go through the k accumulated rotations
//     [[c, s], [-conj(s), c]]; a new rotation annihilating h[j+1] (its
//     degenerate branches: a = 0 -> c = 0, s the phase of conj(b); b = 0 ->
//     s = 0; both -> the identity); column j of R; g[j], g[j+1]; the
//     residual estimate rn2 = |g[j+1]|^2; on the first step of an anchored
//     cycle the target tol2 = (tol_rel max(sqrt(rn2), 1e-13 beta0))^2.
//     Only what changes is written, and only on the lanes where `active`
//     holds: R's column j, cs[j], sn[j], g[j], g[j+1], rn2 and tol2.
//   backsub: y from R y = g by back-substitution, g's rows at and past the
//     lane's step count j_fin taken as 0 (y = 0 there).
// Both repeat their plain torch versions (ops/fgmres_kernel.py) operation
// for operation, in the same order, and every product, sum, difference,
// quotient and square root is written as its round-to-nearest intrinsic
// (__dmul_rn, __dadd_rn, __dsub_rn, __ddiv_rn, __dsqrt_rn), which nvcc never
// contracts into a fused multiply-add whatever its flags: each is one IEEE
// f64 operation rounded to nearest, as torch's elementwise kernels round
// it, and the kernels give the plain versions' bits.  The plain
// back-substitution sums its row products in column order, one addition at
// a time, and so does backsub: its k^2 products form a chain of dependent
// additions that no reordering may shorten.
//
// What bounds it.  The work is a short scalar recurrence a lane: ~30 k
// flops an Arnoldi step, ~8 k^2 a back-substitution, and a few KB of state
// a lane (k = 8: R is 1 KB; 512 lanes move ~1 MB, 0.3 us at 3.35 TB/s).
// Neither bytes nor operations bound it: the latency of the loads a lane
// waits on and the chain of its dependent f64 operations do, beside the
// launch.  The first version (a thread a lane walking R, g, cs and sn in
// global memory, 32 lanes a warp on 32 lines 1 KB apart, h and y in a
// local-memory frame indexed by the runtime k and j) waited on an L2 load
// at every step of that chain.
//
// The design.  One thread a lane; a block takes a few lanes, so that a
// launch's lanes spread over about FGMRES_SPREAD blocks (the H100's 132
// SMs) and each SM stages little.  A block's lanes are contiguous in every
// state tensor.  One thread initialises an mbarrier with the bytes to come,
// and the block's state is staged in shared memory by the bulk copy engine
// (cp.async.bulk, Hopper's one-dimensional TMA copy), completing on that
// barrier, while the threads read their lanes' scalars; every thread then
// waits on the barrier and runs its lane's recurrence from registers and
// shared memory alone.
//   givens_step stages the block's slabs of hre, him, cs and sn as they
//     lie in global memory (four copies; a slab of an odd number of
//     doubles, in the last block of an odd L only, has its last 8 bytes
//     copied by that thread, since a bulk copy moves multiples of 16);
//     R is written, not read, and only g[j] of g is read.
//   backsub stages each lane's R and g with a copy a lane, issued by the
//     lane's thread, into a padded stride: an odd number of 16-byte units,
//     so that the 8 lanes of a quarter warp reading a complex entry each
//     hit 8 distinct bank groups (at k = 8 a lane's R is exactly 1 KB, and
//     without the pad every lane of a warp would hit the same bank).
// k is a template width KP in {8, 16, 32, 64} (the launcher takes the
// smallest KP >= k; a k past 64 is an error).  givens_step walks the
// column with one slot carried in registers (rotation i leaves slot i
// final), its loop unrolled to KP with k a predicate and the runtime j a
// select, at every KP: no array.  backsub's y is an array: at KP = 8 and
// 16 it lives in registers, the loops unrolled to KP in the same way (no
// stack frame); at KP = 32 and 64 the loops stay loops and y has a padded
// slot a lane in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#define FGMRES_KMAX 64
// one thread a lane: the most lanes a block takes
#define FGMRES_MAX_LANES 32
// a launch's lanes are spread over about this many blocks
#define FGMRES_SPREAD 128
// dynamic shared memory a block takes without an opt-in
#define FGMRES_SMEM_DEFAULT (48 * 1024)
// the mbarrier's slot at the start of a block's shared memory
#define FGMRES_BAR_BYTES 16

// one f64 operation each, rounded to nearest, never fused
__device__ __forceinline__ double mul(double a, double b)
{
    return __dmul_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b)
{
    return __dadd_rn(a, b);
}
__device__ __forceinline__ double sub(double a, double b)
{
    return __dsub_rn(a, b);
}
__device__ __forceinline__ double dvd(double a, double b)
{
    return __ddiv_rn(a, b);
}

// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ double clamp_min(double x, double lo)
{
    return (x != x) ? x : (x > lo ? x : lo);
}

// torch.maximum(a, b): NaN wins
__device__ __forceinline__ double tmax(double a, double b)
{
    if (a != a) return a;
    if (b != b) return b;
    return a > b ? a : b;
}

// ---------------------------------------------------------------------------
// the staging: an mbarrier and the bulk copy engine
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t shared_addr(const void* p)
{
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// one arrival (the thread that states the bytes), made visible to the
// copy engine
__device__ __forceinline__ void barrier_init(uint64_t* bar)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 "fence.mbarrier_init.release.cluster;\n"
                 :: "r"(shared_addr(bar)) : "memory");
}

// the arrival, with the bytes the copies will bring
__device__ __forceinline__ void barrier_expect(uint64_t* bar, uint32_t bytes)
{
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(shared_addr(bar)), "r"(bytes) : "memory");
}

// global -> shared, `bytes` a multiple of 16, both addresses 16-byte
// aligned; completes on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar)
{
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::"
                 "complete_tx::bytes [%0], [%1], %2, [%3];\n"
                 :: "r"(shared_addr(dst)), "l"(src), "r"(bytes),
                    "r"(shared_addr(bar)) : "memory");
}

// until the barrier's first phase has completed: the arrival and every
// byte of the copies.  A copy that never lands traps (a launch failure the
// wrapper raises) after ~2^34 cycles, some 10 s, rather than hang the card
__device__ __forceinline__ void barrier_wait(uint64_t* bar)
{
    const uint32_t parity = 0;
    const long long start = clock64();
    uint32_t done = 0;
    while (!done) {
        asm volatile("{\n"
                     ".reg .pred p;\n"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     "selp.u32 %0, 1, 0, p;\n"
                     "}\n"
                     : "=r"(done) : "r"(shared_addr(bar)), "r"(parity)
                     : "memory");
        if (!done && clock64() - start > (1LL << 34)) __trap();
    }
}

// the part of a slab of `bytes` (a multiple of 8) the bulk copy moves
__device__ __forceinline__ uint32_t bulk_part(uint32_t bytes)
{
    return bytes & ~15u;
}

// a slab of `bytes` from global `src` to shared `dst`: its multiple of 16
// by the copy engine, an odd last double by this thread
__device__ __forceinline__ void stage(double* dst, const double* src,
                                      uint32_t bytes, uint64_t* bar)
{
    const uint32_t bulk = bulk_part(bytes);
    if (bulk) bulk_load(dst, src, bulk, bar);
    if (bytes != bulk) dst[bulk / 8] = src[bulk / 8];
}

// ---------------------------------------------------------------------------
// K7a: one Arnoldi step's Givens update
// ---------------------------------------------------------------------------

// slots i (a) and i+1 (b) of the column after the rotation [[c, s],
// [-conj(s), c]], as the plain version computes them.  Returned by value:
// references into the caller's register arrays would put them on the stack
struct rotated {
    double a0, a1, b0, b1;
};

__device__ __forceinline__ rotated rotate(double a0, double a1, double b0,
                                          double b1, double c, double s0,
                                          double s1)
{
    const double zc = mul(0.0, c);
    double t0 = sub(mul(c, a0), mul(zc, a1));
    double t1 = add(mul(c, a1), mul(zc, a0));
    t0 = sub(add(t0, mul(s0, b0)), mul(s1, b1));
    t1 = add(add(t1, mul(s0, b1)), mul(s1, b0));
    double u0 = sub(mul(c, b0), mul(zc, b1));
    double u1 = add(mul(c, b1), mul(zc, b0));
    u0 = sub(sub(u0, mul(s0, a0)), mul(s1, a1));
    u1 = add(sub(u1, mul(s0, a1)), mul(s1, a0));
    return {t0, t1, u0, u1};
}

// shared memory a lane of a givens_step block takes after the barrier:
// its share of the slabs of hre, him (k+1 each), cs (k) and sn (2k)
static size_t givens_lane_bytes(int k)
{
    return (size_t)(5 * k + 2) * sizeof(double);
}

template <int KP>
__global__ void __launch_bounds__(FGMRES_MAX_LANES)
givens_step_kernel(const double* __restrict__ hre,
                   const double* __restrict__ him,
                   const double* __restrict__ hlast,
                   double* __restrict__ cs, double* __restrict__ sn,
                   double* __restrict__ R, double* __restrict__ g,
                   double* __restrict__ rn2, double* __restrict__ tol2,
                   const double* __restrict__ beta0,
                   const double* __restrict__ tol_rel,
                   const uint8_t* __restrict__ active,
                   int L, int k, int j, int anchor)
{
    extern __shared__ __align__(16) unsigned char smem[];
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
    const int nb = blockDim.x;                  // lanes a block, even
    const int t = threadIdx.x;
    const int l0 = blockIdx.x * nb;
    const int l = l0 + t;
    const int nl = min(nb, L - l0);             // this block's lanes
    // the slabs as they lie in global memory; nb even keeps each one
    // 16-byte aligned
    double* hre_s = reinterpret_cast<double*>(smem + FGMRES_BAR_BYTES);
    double* him_s = hre_s + (size_t)nb * (k + 1);
    double* cs_s = him_s + (size_t)nb * (k + 1);
    double* sn_s = cs_s + (size_t)nb * k;

    if (t == 0) {
        const uint32_t hb = nl * (k + 1) * 8, cb = nl * k * 8,
                       sb = nl * k * 16;
        barrier_init(bar);
        barrier_expect(bar, 2 * bulk_part(hb) + bulk_part(cb) + sb);
        stage(hre_s, hre + (size_t)l0 * (k + 1), hb, bar);
        stage(him_s, him + (size_t)l0 * (k + 1), hb, bar);
        stage(cs_s, cs + (size_t)l0 * k, cb, bar);
        bulk_load(sn_s, sn + (size_t)l0 * k * 2, sb, bar);
    }
    // the lane's scalars and g[j], read while the copies run
    const bool live = l < L && active[l];
    double hl = 0.0, g0 = 0.0, g1 = 0.0, b0v = 0.0, trv = 0.0;
    double2* g_l = reinterpret_cast<double2*>(g) + (size_t)l * (k + 1);
    if (live) {
        hl = hlast[l];
        const double2 gj = g_l[j];
        g0 = gj.x;
        g1 = gj.y;
        if (anchor) {
            b0v = beta0[l];
            trv = tol_rel[l];
        }
    }
    __syncthreads();            // the barrier's initialisation, a last double
    barrier_wait(bar);
    if (!live) return;          // an inactive lane's state stays as it was

    const double tiny = 1e-300;
    const double* hr_s = hre_s + (size_t)t * (k + 1);
    const double* hi_s = him_s + (size_t)t * (k + 1);
    const double* cs_l = cs_s + (size_t)t * k;
    const double2* sn_l = reinterpret_cast<const double2*>(sn_s) +
                          (size_t)t * k;
    double2* Rc = reinterpret_cast<double2*>(R) + (size_t)l * k * k + j;
    // the accumulated rotations (those past the current step are the
    // identity, applied all the same, as the plain version does).
    // Rotation i leaves slot i final, so the column is walked with one
    // slot carried in registers: slot i goes to R's row i, or is a (i =
    // j); b is slot j+1 as rotation j+1 leaves it (as rotation j does,
    // if j is the last step).  Unrolled to KP, k a predicate and j a
    // select: no array, no stack.
    double cr = hr_s[0], ci = hi_s[0];
    double a0 = 0.0, a1 = 0.0, b0 = 0.0, b1 = 0.0;
#pragma unroll
    for (int i = 0; i < KP; ++i) {
        if (i < k) {
            const double2 s = sn_l[i];
            const rotated r = rotate(cr, ci, i == j ? hl : hr_s[i + 1],
                                     hi_s[i + 1], cs_l[i], s.x, s.y);
            if (i == j) {
                a0 = r.a0;
                a1 = r.a1;
            } else {
                Rc[(size_t)i * k] = make_double2(r.a0, r.a1);
            }
            if (i == j + 1) {
                b0 = r.a0;
                b1 = r.a1;
            }
            cr = r.b0;
            ci = r.b1;
        }
    }
    if (j + 1 == k) {
        b0 = cr;
        b1 = ci;
    }

    // the new rotation annihilating slot j+1
    const double amag = __dsqrt_rn(add(mul(a0, a0), mul(a1, a1)));
    const double bmag = __dsqrt_rn(add(mul(b0, b0), mul(b1, b1)));
    const double rho = __dsqrt_rn(add(mul(amag, amag), mul(bmag, bmag)));
    const bool a_ok = amag > tiny;
    const bool b_ok = bmag > tiny;
    const double c = a_ok ? dvd(amag, clamp_min(rho, tiny))
                          : (b_ok ? 0.0 : 1.0);
    const double p0 = a_ok ? dvd(a0, clamp_min(amag, tiny)) : 1.0;
    const double p1 = a_ok ? dvd(a1, clamp_min(amag, tiny)) : 0.0;
    const double denom = a_ok ? clamp_min(rho, tiny) : clamp_min(bmag, tiny);
    const double q0 = dvd(b0, denom);
    const double q1 = dvd(-b1, denom);
    double s0 = sub(mul(p0, q0), mul(p1, q1));
    double s1 = add(mul(p0, q1), mul(p1, q0));
    s0 = b_ok ? s0 : 0.0;
    s1 = b_ok ? s1 : 0.0;
    cs[(size_t)l * k + j] = c;
    reinterpret_cast<double2*>(sn)[(size_t)l * k + j] = make_double2(s0, s1);

    const double zc = mul(0.0, c);
    const double t0 = sub(mul(c, a0), mul(zc, a1));
    const double t1 = add(mul(c, a1), mul(zc, a0));
    Rc[(size_t)j * k] = make_double2(sub(add(t0, mul(s0, b0)), mul(s1, b1)),
                                     add(add(t1, mul(s0, b1)), mul(s1, b0)));

    const double top0 = sub(mul(c, g0), mul(zc, g1));
    const double top1 = add(mul(c, g1), mul(zc, g0));
    const double bot0 = -add(mul(s0, g0), mul(s1, g1));
    const double bot1 = -sub(mul(s0, g1), mul(s1, g0));
    g_l[j] = make_double2(top0, top1);
    g_l[j + 1] = make_double2(bot0, bot1);
    const double r2 = add(mul(bot0, bot0), mul(bot1, bot1));
    rn2[l] = r2;
    // the first step of an anchored cycle re-anchors the target at what is
    // left after it
    if (anchor) {
        const double anc = tmax(__dsqrt_rn(r2), mul(1e-13, b0v));
        const double tt = mul(trv, anc);
        tol2[l] = mul(tt, tt);
    }
}

// ---------------------------------------------------------------------------
// K7b: the cycle's back-substitution
// ---------------------------------------------------------------------------

// a lane's stride in shared memory, in 16-byte units (one complex f64):
// odd, so that a quarter warp's 8 lanes read 8 distinct bank groups
__host__ __device__ __forceinline__ int padded(int units)
{
    return units | 1;
}

// shared memory a lane of a backsub block takes after the barrier: its R
// (k^2 complex) and g (k+1), padded, and at KP > 16 its y
static size_t backsub_lane_bytes(int k, int kp)
{
    return (size_t)(padded(k * k) + padded(k + 1) +
                    (kp > 16 ? padded(k) : 0)) * 16;
}

// y[r] of the back-substitution from row r's sum of products with y
// (acc), g[r] (0 at and past the lane's step count) and R's diagonal d
__device__ __forceinline__ double2 backsub_row(double acc_re, double acc_im,
                                               double2 gr, double2 d)
{
    const double tiny = 1e-300;
    const double num0 = sub(gr.x, acc_re);
    const double num1 = sub(gr.y, acc_im);
    const double den = add(mul(d.x, d.x), mul(d.y, d.y));
    const double w0 = dvd(d.x, clamp_min(den, tiny));
    const double w1 = dvd(-d.y, clamp_min(den, tiny));
    return make_double2(sub(mul(num0, w0), mul(num1, w1)),
                        add(mul(num0, w1), mul(num1, w0)));
}

template <int KP>
__global__ void __launch_bounds__(FGMRES_MAX_LANES)
backsub_kernel(const double* __restrict__ R, const double* __restrict__ g,
               const int64_t* __restrict__ j_fin, double* __restrict__ y,
               int L, int k)
{
    extern __shared__ __align__(16) unsigned char smem[];
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
    const int nb = blockDim.x;
    const int t = threadIdx.x;
    const int l0 = blockIdx.x * nb;
    const int l = l0 + t;
    const int nl = min(nb, L - l0);
    const int rs = padded(k * k), gs = padded(k + 1);
    double2* R_s = reinterpret_cast<double2*>(smem + FGMRES_BAR_BYTES);
    double2* g_s = R_s + (size_t)nb * rs;

    if (t == 0) {
        barrier_init(bar);
        barrier_expect(bar, nl * (k * k + k + 1) * 16);
    }
    __syncthreads();            // the barrier's initialisation
    if (l < L) {
        bulk_load(R_s + (size_t)t * rs, R + (size_t)l * k * k * 2,
                  k * k * 16, bar);
        bulk_load(g_s + (size_t)t * gs, g + (size_t)l * (k + 1) * 2,
                  (k + 1) * 16, bar);
    }
    const int64_t jf = l < L ? j_fin[l] : 0;
    barrier_wait(bar);
    if (l >= L) return;

    const double2* R_l = R_s + (size_t)t * rs;     // row r at R_l + r k
    const double2* g_l = g_s + (size_t)t * gs;
    double2* y_l = reinterpret_cast<double2*>(y) + (size_t)l * k;
    const double2 zero = make_double2(0.0, 0.0);
    if constexpr (KP <= 16) {
        // y in registers, rows and columns unrolled to KP with k a
        // predicate: the rows from k-1 down, each row's products in
        // column order (y is 0 past the rows done)
        double yr[KP], yi[KP];
#pragma unroll
        for (int p = 0; p < KP; ++p) {
            yr[p] = 0.0;
            yi[p] = 0.0;
        }
#pragma unroll
        for (int r = KP - 1; r >= 0; --r) {
            if (r < k) {
                const double2* row = R_l + (size_t)r * k;
                double2 e = row[0];
                double rr = mul(e.x, yr[0]), ii = mul(e.y, yi[0]);
                double ri = mul(e.x, yi[0]), ir = mul(e.y, yr[0]);
#pragma unroll
                for (int p = 1; p < KP; ++p) {
                    if (p < k) {
                        e = row[p];
                        rr = add(rr, mul(e.x, yr[p]));
                        ii = add(ii, mul(e.y, yi[p]));
                        ri = add(ri, mul(e.x, yi[p]));
                        ir = add(ir, mul(e.y, yr[p]));
                    }
                }
                const double2 yv = backsub_row(sub(rr, ii), add(ri, ir),
                                               r < jf ? g_l[r] : zero,
                                               row[r]);
                yr[r] = yv.x;
                yi[r] = yv.y;
            }
        }
#pragma unroll
        for (int p = 0; p < KP; ++p) {
            if (p < k) y_l[p] = make_double2(yr[p], yi[p]);
        }
    } else {
        // y in a padded shared slot a lane
        double2* ys = g_s + (size_t)nb * gs + (size_t)t * padded(k);
        for (int p = 0; p < k; ++p) ys[p] = zero;
        for (int r = k - 1; r >= 0; --r) {
            const double2* row = R_l + (size_t)r * k;
            double2 e = row[0], v = ys[0];
            double rr = mul(e.x, v.x), ii = mul(e.y, v.y);
            double ri = mul(e.x, v.y), ir = mul(e.y, v.x);
            for (int p = 1; p < k; ++p) {
                e = row[p];
                v = ys[p];
                rr = add(rr, mul(e.x, v.x));
                ii = add(ii, mul(e.y, v.y));
                ri = add(ri, mul(e.x, v.y));
                ir = add(ir, mul(e.y, v.x));
            }
            ys[r] = backsub_row(sub(rr, ii), add(ri, ir),
                                r < jf ? g_l[r] : zero, row[r]);
        }
        for (int p = 0; p < k; ++p) y_l[p] = ys[p];
    }
}

// ---------------------------------------------------------------------------
// the C interface
// ---------------------------------------------------------------------------

extern "C" int fgmres_lsq_kmax(void) { return FGMRES_KMAX; }

// the width bucket the kernels take for k: the smallest of 8, 16, 32, 64
// that holds it, 0 for none
extern "C" int fgmres_lsq_bucket(int k)
{
    if (k <= 0) return 0;
    for (int kp = 8; kp <= FGMRES_KMAX; kp *= 2)
        if (k <= kp) return kp;
    return 0;
}

// lanes a block: enough to spread L over about FGMRES_SPREAD blocks, at
// most FGMRES_MAX_LANES and as many as fit `budget` bytes of shared
// memory at `lane_bytes` a lane (one at least); a multiple of `step`
static int lanes_a_block(int L, int step, size_t lane_bytes, size_t budget)
{
    const int spread = (L + FGMRES_SPREAD - 1) / FGMRES_SPREAD;
    const int fit = (int)((budget - FGMRES_BAR_BYTES) / lane_bytes) / step
                    * step;
    int lanes = spread < FGMRES_MAX_LANES ? spread : FGMRES_MAX_LANES;
    lanes = (lanes + step - 1) / step * step;
    lanes = lanes < fit ? lanes : fit;
    return lanes > step ? lanes : step;
}

// the state of a cycle that givens_step updates, filled once a cycle by
// the caller: cs (L, k); sn (L, k, 2); R (L, k, k, 2); g (L, k+1, 2); rn2,
// tol2, beta0, tol_rel (L,); all f64, contiguous on one device; cs, sn, R
// and g 16-byte aligned
struct fgmres_state {
    double *cs, *sn, *R, *g, *rn2, *tol2;
    const double *beta0, *tol_rel;
    int L, k;
};

template <int KP>
static int givens_step_bucket(const fgmres_state* s, const double* hre,
                              const double* him, const double* hlast,
                              const uint8_t* active, int j, int anchor,
                              cudaStream_t stream)
{
    // an even count keeps every slab 16-byte aligned; two lanes of the
    // widest bucket take 5 KB
    const int k = s->k;
    const int lanes = lanes_a_block(s->L, 2, givens_lane_bytes(k),
                                    FGMRES_SMEM_DEFAULT);
    const size_t smem = FGMRES_BAR_BYTES + lanes * givens_lane_bytes(k);
    const int blocks = (s->L + lanes - 1) / lanes;
    givens_step_kernel<KP><<<blocks, lanes, smem, stream>>>(
        hre, him, hlast, s->cs, s->sn, s->R, s->g, s->rn2, s->tol2, s->beta0,
        s->tol_rel, active, s->L, k, j, anchor);
    return static_cast<int>(cudaGetLastError());
}

// step j of the cycle whose state is `s`: hre, him (L, k+1) f64, 16-byte
// aligned; hlast (L,) f64; active (L,) bytes; 0 <= j < k <= FGMRES_KMAX.
// Updates the state in place on the active lanes.  Launches on `stream` and
// returns cudaGetLastError().
extern "C" int givens_step_launch(const fgmres_state* s, const double* hre,
                                  const double* him, const double* hlast,
                                  const uint8_t* active, int j, int anchor,
                                  void* stream)
{
    if (s->L <= 0) return 0;
    if (j < 0 || j >= s->k) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (fgmres_lsq_bucket(s->k)) {
    case 8: return givens_step_bucket<8>(s, hre, him, hlast, active, j,
                                         anchor, st);
    case 16: return givens_step_bucket<16>(s, hre, him, hlast, active, j,
                                           anchor, st);
    case 32: return givens_step_bucket<32>(s, hre, him, hlast, active, j,
                                           anchor, st);
    case 64: return givens_step_bucket<64>(s, hre, him, hlast, active, j,
                                           anchor, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

template <int KP>
static int backsub_bucket(const double* R, const double* g,
                          const int64_t* j_fin, double* y, int L, int k,
                          cudaStream_t stream)
{
    // a lane whose R passes the default (k > 54) takes a block of its own
    // and the memory it needs (67.6 KB at k = 64)
    const size_t lane = backsub_lane_bytes(k, KP);
    const int lanes = lanes_a_block(L, 1, lane, FGMRES_SMEM_DEFAULT);
    const size_t smem = FGMRES_BAR_BYTES + lanes * lane;
    if (smem > FGMRES_SMEM_DEFAULT) {
        const cudaError_t e = cudaFuncSetAttribute(
            backsub_kernel<KP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    const int blocks = (L + lanes - 1) / lanes;
    backsub_kernel<KP><<<blocks, lanes, smem, stream>>>(R, g, j_fin, y, L, k);
    return static_cast<int>(cudaGetLastError());
}

// R (L, k, k, 2), g (L, k+1, 2) f64, j_fin (L,) int64, y (L, k, 2) f64,
// all contiguous on the current device, R and g 16-byte aligned, k <=
// FGMRES_KMAX.  Launches on `stream` and returns cudaGetLastError().
extern "C" int backsub_launch(const double* R, const double* g,
                              const int64_t* j_fin, double* y, int L, int k,
                              void* stream)
{
    if (L <= 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (fgmres_lsq_bucket(k)) {
    case 8: return backsub_bucket<8>(R, g, j_fin, y, L, k, st);
    case 16: return backsub_bucket<16>(R, g, j_fin, y, L, k, st);
    case 32: return backsub_bucket<32>(R, g, j_fin, y, L, k, st);
    case 64: return backsub_bucket<64>(R, g, j_fin, y, L, k, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
