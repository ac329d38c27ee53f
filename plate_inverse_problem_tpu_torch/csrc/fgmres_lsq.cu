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
//     State is updated in place, on the lanes where `active` holds only.
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
// a time, and so does backsub.
//
// What bounds it.  The work is a short scalar recurrence a lane: ~30 k
// flops and ~(4 k + 2 k + 2 (k+1)) x 8 bytes of state an Arnoldi step (k
// = 8: ~2.2 KB a lane, ~1.1 MB for 512 lanes, 0.3 us at 3.35 TB/s).  A
// launch costs more than that: the launch bounds these kernels, and the
// gain is in replacing hundreds of launches by one.
//
// The design: one thread a lane (L from 1, a compacted rescue cycle, to a
// chunk's lanes), 128 threads a block.  A thread walks its lane's rows of
// R and g in global memory (k <= FGMRES_KMAX; the column h and y live in
// the thread's local arrays).  No shared memory, no synchronisation.

#include <cuda_runtime.h>
#include <stdint.h>

#define FGMRES_KMAX 64
#define FGMRES_THREADS 128

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

__global__ void __launch_bounds__(FGMRES_THREADS)
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
    const int l = blockIdx.x * blockDim.x + threadIdx.x;
    if (l >= L || !active[l]) return;
    const double tiny = 1e-300;
    double hr[FGMRES_KMAX + 1], hi[FGMRES_KMAX + 1];
    const double* hre_l = hre + (size_t)l * (k + 1);
    const double* him_l = him + (size_t)l * (k + 1);
    for (int i = 0; i <= k; ++i) {
        hr[i] = hre_l[i];
        hi[i] = him_l[i];
    }
    hr[j + 1] = hlast[l];
    double* cs_l = cs + (size_t)l * k;
    double* sn_l = sn + (size_t)l * k * 2;

    // the accumulated rotations (those past the current step are the
    // identity, applied all the same, as the plain version does)
    for (int i = 0; i < k; ++i) {
        const double a0 = hr[i], a1 = hi[i], b0 = hr[i + 1], b1 = hi[i + 1];
        const double s0 = sn_l[2 * i], s1 = sn_l[2 * i + 1];
        const double c = cs_l[i];
        const double zc = mul(0.0, c);
        double t0 = sub(mul(c, a0), mul(zc, a1));
        double t1 = add(mul(c, a1), mul(zc, a0));
        t0 = sub(add(t0, mul(s0, b0)), mul(s1, b1));
        t1 = add(add(t1, mul(s0, b1)), mul(s1, b0));
        double u0 = sub(mul(c, b0), mul(zc, b1));
        double u1 = add(mul(c, b1), mul(zc, b0));
        u0 = sub(sub(u0, mul(s0, a0)), mul(s1, a1));
        u1 = add(sub(u1, mul(s0, a1)), mul(s1, a0));
        hr[i] = t0;
        hr[i + 1] = u0;
        hi[i] = t1;
        hi[i + 1] = u1;
    }

    // the new rotation annihilating slot j+1
    const double a0 = hr[j], a1 = hi[j], b0 = hr[j + 1], b1 = hi[j + 1];
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
    cs_l[j] = c;
    sn_l[2 * j] = s0;
    sn_l[2 * j + 1] = s1;

    const double zc = mul(0.0, c);
    const double t0 = sub(mul(c, a0), mul(zc, a1));
    const double t1 = add(mul(c, a1), mul(zc, a0));
    hr[j] = sub(add(t0, mul(s0, b0)), mul(s1, b1));
    hi[j] = add(add(t1, mul(s0, b1)), mul(s1, b0));
    double* R_l = R + (size_t)l * k * k * 2;
    for (int i = 0; i < k; ++i) {
        R_l[((size_t)i * k + j) * 2] = hr[i];
        R_l[((size_t)i * k + j) * 2 + 1] = hi[i];
    }

    double* g_l = g + (size_t)l * (k + 1) * 2;
    const double g0 = g_l[2 * j], g1 = g_l[2 * j + 1];
    const double top0 = sub(mul(c, g0), mul(zc, g1));
    const double top1 = add(mul(c, g1), mul(zc, g0));
    const double bot0 = -add(mul(s0, g0), mul(s1, g1));
    const double bot1 = -sub(mul(s0, g1), mul(s1, g0));
    g_l[2 * j] = top0;
    g_l[2 * j + 1] = top1;
    g_l[2 * j + 2] = bot0;
    g_l[2 * j + 3] = bot1;
    const double r2 = add(mul(bot0, bot0), mul(bot1, bot1));
    rn2[l] = r2;
    // the first step of an anchored cycle re-anchors the target at what is
    // left after it
    if (anchor) {
        const double anc = tmax(__dsqrt_rn(r2), mul(1e-13, beta0[l]));
        const double t = mul(tol_rel[l], anc);
        tol2[l] = mul(t, t);
    }
}

__global__ void __launch_bounds__(FGMRES_THREADS)
backsub_kernel(const double* __restrict__ R, const double* __restrict__ g,
               const int64_t* __restrict__ j_fin, double* __restrict__ y,
               int L, int k)
{
    const int l = blockIdx.x * blockDim.x + threadIdx.x;
    if (l >= L) return;
    const double tiny = 1e-300;
    double yr[FGMRES_KMAX], yi[FGMRES_KMAX];
    for (int p = 0; p < k; ++p) {
        yr[p] = 0.0;
        yi[p] = 0.0;
    }
    const double* R_l = R + (size_t)l * k * k * 2;
    const double* g_l = g + (size_t)l * (k + 1) * 2;
    const int64_t jf = j_fin[l];
    for (int t = 0; t < k; ++t) {
        const int r = k - 1 - t;
        const double* row = R_l + (size_t)r * k * 2;
        // the row's products summed in column order
        double rr = mul(row[0], yr[0]), ii = mul(row[1], yi[0]);
        double ri = mul(row[0], yi[0]), ir = mul(row[1], yr[0]);
        for (int p = 1; p < k; ++p) {
            rr = add(rr, mul(row[2 * p], yr[p]));
            ii = add(ii, mul(row[2 * p + 1], yi[p]));
            ri = add(ri, mul(row[2 * p], yi[p]));
            ir = add(ir, mul(row[2 * p + 1], yr[p]));
        }
        const double acc_re = sub(rr, ii);
        const double acc_im = add(ri, ir);
        const double gr = r < jf ? g_l[2 * r] : 0.0;
        const double gi = r < jf ? g_l[2 * r + 1] : 0.0;
        const double num0 = sub(gr, acc_re);
        const double num1 = sub(gi, acc_im);
        const double d0 = row[2 * r], d1 = row[2 * r + 1];
        const double den = add(mul(d0, d0), mul(d1, d1));
        const double w0 = dvd(d0, clamp_min(den, tiny));
        const double w1 = dvd(-d1, clamp_min(den, tiny));
        yr[r] = sub(mul(num0, w0), mul(num1, w1));
        yi[r] = add(mul(num0, w1), mul(num1, w0));
    }
    double* y_l = y + (size_t)l * k * 2;
    for (int p = 0; p < k; ++p) {
        y_l[2 * p] = yr[p];
        y_l[2 * p + 1] = yi[p];
    }
}

extern "C" int fgmres_lsq_kmax(void) { return FGMRES_KMAX; }

// hre, him (L, k+1); hlast, rn2, tol2, beta0, tol_rel (L,); cs (L, k); sn
// (L, k, 2); R (L, k, k, 2); g (L, k+1, 2), all f64; active (L,) bytes;
// 0 <= j < k <= FGMRES_KMAX.  All contiguous on the current device.
// Updates cs, sn, R, g, rn2 and tol2 in place on the active lanes.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int givens_step_launch(const double* hre, const double* him,
                                  const double* hlast, double* cs, double* sn,
                                  double* R, double* g, double* rn2,
                                  double* tol2, const double* beta0,
                                  const double* tol_rel, const uint8_t* active,
                                  int L, int k, int j, int anchor,
                                  void* stream)
{
    if (L <= 0) return 0;
    if (k <= 0 || k > FGMRES_KMAX || j < 0 || j >= k)
        return static_cast<int>(cudaErrorInvalidValue);
    const int blocks = (L + FGMRES_THREADS - 1) / FGMRES_THREADS;
    givens_step_kernel<<<blocks, FGMRES_THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        hre, him, hlast, cs, sn, R, g, rn2, tol2, beta0, tol_rel, active, L,
        k, j, anchor);
    return static_cast<int>(cudaGetLastError());
}

// R (L, k, k, 2), g (L, k+1, 2) f64, j_fin (L,) int64, y (L, k, 2) f64,
// all contiguous on the current device, k <= FGMRES_KMAX.  Launches on
// `stream` and returns cudaGetLastError().
extern "C" int backsub_launch(const double* R, const double* g,
                              const int64_t* j_fin, double* y, int L, int k,
                              void* stream)
{
    if (L <= 0) return 0;
    if (k <= 0 || k > FGMRES_KMAX)
        return static_cast<int>(cudaErrorInvalidValue);
    const int blocks = (L + FGMRES_THREADS - 1) / FGMRES_THREADS;
    backsub_kernel<<<blocks, FGMRES_THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(R, g, j_fin, y, L,
                                                          k);
    return static_cast<int>(cudaGetLastError());
}
