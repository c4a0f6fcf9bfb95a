// Tridiagonal eigen-solve and batched secular Newton of one Gram Krylov
// step, in one launch of one block.
//
// Replaces what XLA fuses in the JAX package's step: tridiag_eigh
// (jnp.linalg.eigh of the m x m Lanczos tridiagonal) followed by
// secular_newton vmapped over the line search's L candidate
// regularizations (krylov_crn_tpu/ops/subproblem.py:48 and :58, a
// lax.while_loop each). In eager PyTorch the same two pieces were
// torch.linalg.eigh (cuSOLVER, whose info PyTorch checks on the host) and
// a Newton loop that read its done flag back once per Newton step, so a
// step could not run without the host, nor be captured as a CUDA graph.
//
// Bound: launch latency. The kernel reads m + (m - 1) + L + 2 numbers and
// writes m^2 + m + 2L (under 10 KB at m <= 20), and does a few thousand
// scalar operations; it runs as one block.
//
// Design:
//   eigen-solve  implicit-shift QL on (d, e) with eigenvectors (the
//                classic tqli), the rotation's radius taken as
//                |a| sqrt(1 + (b/a)^2) (no hypot). Thread 0 runs each
//                sweep's scalar recurrence and records the sweep's
//                rotations in shared memory; then thread k applies them,
//                in the same order, to row k of Z. Each element of Z thus
//                sees the same operations in the same order as in the
//                sequential algorithm. Then a selection sort to ascending
//                order (thread 0), and each thread permutes its row. After
//                QL_MAX_SWEEPS sweeps without convergence on one
//                eigenvalue, every theta is NaN.
//   Newton       thread j owns candidate j: the JAX while_loop's stopping
//                rule (|step| < xtol or it_max), its pole safeguard and the
//                c^2 = 0 masking, with the sums over the m modes in index
//                order.
// Every operation rounds on its own: build with --fmad=false, so that the
// emulation in ops/subproblem.py (tridiag_secular_emulated) reproduces the
// results bit for bit. No atomics, no host read.
//
// A second entry, eig_secular, runs only the Newton part, for L candidates
// over a dense spectrum (theta, c) of m up to MAX_SECULAR_M modes: the
// vmapped secular_newton of the JAX package's CRN "full" and SSCN steps
// (krylov_crn_tpu/ops/subproblem.py:58, behind cubic_solve_eigh), whose
// eigendecomposition csrc/eigh.cu makes. Bound: latency; each Newton step
// reads theta and c (m = 1000: 8 KB from L1) and does ~8 m operations.
// Design: one warp per candidate. Lane l sums the terms l, l + 32, ... in
// index order (c^2 = 0 terms dropped), then a fixed xor-shuffle tree adds
// the 32 partial sums, so every lane holds the same sums and takes the
// same branches; the stopping rule, the pole safeguard at lo and lo_strict
// are the JAX while_loop's. ops/subproblem.py:eig_secular_emulated
// reproduces it bit for bit.
//
// Plain C interface for ctypes; each entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAX_M = 64;        // largest tridiagonal (the race: 10, f*: 20)
constexpr int THREADS = 64;      // one per row of Z, one per candidate
constexpr int QL_MAX_SWEEPS = 60;  // per eigenvalue

__device__ __forceinline__ float absval(float x) { return fabsf(x); }
__device__ __forceinline__ double absval(double x) { return fabs(x); }
__device__ __forceinline__ float root(float x) { return sqrtf(x); }
__device__ __forceinline__ double root(double x) { return sqrt(x); }
__device__ __forceinline__ void set_nan(float& x) {
    x = __int_as_float(0x7fc00000);
}
__device__ __forceinline__ void set_nan(double& x) {
    x = __longlong_as_double(0x7ff8000000000000LL);
}
__device__ __forceinline__ void set_inf(float& x) {
    x = __int_as_float(0x7f800000);
}
__device__ __forceinline__ void set_inf(double& x) {
    x = __longlong_as_double(0x7ff0000000000000LL);
}

// sqrt(a^2 + b^2) as |a| sqrt(1 + (b/a)^2), the larger magnitude outside
template <typename T>
__device__ T radius(T a, T b) {
    const T absa = absval(a), absb = absval(b);
    if (absa > absb) {
        const T p = absb / absa;
        return absa * root(T(1) + p * p);
    }
    if (absb == T(0)) return T(0);
    const T p = absa / absb;
    return absb * root(T(1) + p * p);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
tridiag_secular_kernel(const T* __restrict__ alphas,
                       const T* __restrict__ betas,
                       const T* __restrict__ g_norm,
                       const T* __restrict__ regs,
                       const T* __restrict__ r0, T xtol, int it_max, int m,
                       int L, T* __restrict__ theta, T* __restrict__ Q,
                       T* __restrict__ lams, long long* __restrict__ its) {
    __shared__ T d[MAX_M], e[MAX_M], z[MAX_M * MAX_M];
    __shared__ T rot_c[MAX_M], rot_s[MAX_M], c2[MAX_M];
    __shared__ int perm[MAX_M];
    __shared__ int sweep_lo, sweep_hi, finished, failed;

    const int t = threadIdx.x;
    if (t < m) {
        d[t] = alphas[t];
        e[t] = t < m - 1 ? betas[t] : T(0);
        for (int k = 0; k < m; ++k) z[t * MAX_M + k] = k == t ? T(1) : T(0);
    }
    if (t == 0) failed = 0;
    __syncthreads();

    // ---- implicit-shift QL, one sweep per round ----
    int l = 0, sweeps = 0;  // thread 0's progress
    while (true) {
        if (t == 0) {
            finished = 1;
            sweep_lo = 0;
            sweep_hi = -1;
            while (l < m) {
                int mm = l;
                for (; mm < m - 1; ++mm) {
                    const T dd = absval(d[mm]) + absval(d[mm + 1]);
                    if (absval(e[mm]) + dd == dd) break;
                }
                if (mm == l) {  // d[l] has converged
                    ++l;
                    sweeps = 0;
                    continue;
                }
                if (sweeps == QL_MAX_SWEEPS) {
                    failed = 1;
                    l = m;
                    break;
                }
                ++sweeps;
                T g = (d[l + 1] - d[l]) / (T(2) * e[l]);
                T r = radius(g, T(1));
                g = d[mm] - d[l] + e[l] / (g + (g >= T(0) ? absval(r)
                                                           : -absval(r)));
                T s = T(1), c = T(1), p = T(0);
                int i = mm - 1;
                for (; i >= l; --i) {
                    const T f = s * e[i];
                    const T b = c * e[i];
                    r = radius(f, g);
                    e[i + 1] = r;
                    if (r == T(0)) {  // underflow: split here and retry
                        d[i + 1] = d[i + 1] - p;
                        e[mm] = T(0);
                        break;
                    }
                    s = f / r;
                    c = g / r;
                    g = d[i + 1] - p;
                    r = (d[i] - g) * s + T(2) * c * b;
                    p = s * r;
                    d[i + 1] = g + p;
                    g = c * r - b;
                    rot_c[i] = c;
                    rot_s[i] = s;
                }
                sweep_hi = mm - 1;
                sweep_lo = i + 1;
                if (!(r == T(0) && i >= l)) {
                    d[l] = d[l] - p;
                    e[l] = g;
                    e[mm] = T(0);
                }
                finished = 0;
                break;
            }
        }
        __syncthreads();
        if (finished) break;
        if (t < m) {  // the sweep's rotations on row t, in the sweep's order
            T* zr = z + t * MAX_M;
            for (int i = sweep_hi; i >= sweep_lo; --i) {
                const T c = rot_c[i], s = rot_s[i];
                const T f = zr[i + 1];
                zr[i + 1] = s * zr[i] + c * f;
                zr[i] = c * zr[i] - s * f;
            }
        }
        __syncthreads();
    }

    // ---- ascending order (selection sort, first minimum) ----
    if (t == 0) {
        for (int i = 0; i < m; ++i) perm[i] = i;
        for (int i = 0; i < m - 1; ++i) {
            int k = i;
            T p = d[i];
            for (int j = i + 1; j < m; ++j)
                if (d[j] < p) {
                    k = j;
                    p = d[j];
                }
            if (k != i) {
                d[k] = d[i];
                d[i] = p;
                const int q = perm[i];
                perm[i] = perm[k];
                perm[k] = q;
            }
        }
        if (failed)
            for (int i = 0; i < m; ++i) set_nan(d[i]);
    }
    __syncthreads();
    if (t < m) {
        for (int i = 0; i < m; ++i) Q[t * m + i] = z[t * MAX_M + perm[i]];
        theta[t] = d[t];
        const T c = g_norm[0] * z[perm[t]];  // g_norm * Q[0, t]
        c2[t] = c * c;
    }
    __syncthreads();

    // ---- secular Newton, one candidate per thread ----
    if (t < L) {
        const T M = regs[t];
        const T MM = M * M;
        T mn = d[0];
        for (int i = 1; i < m; ++i)
            if (d[i] < mn) mn = d[i];
        const T lo = -mn > T(0) ? -mn : T(0);
        const T lo_strict = lo > T(0) ? lo + T(1e-6) * (T(1) + lo) : lo;
        T lam = r0[0] >= lo_strict ? r0[0] : lo_strict;
        T step;
        set_inf(step);
        int it = 0;
        while (absval(step) >= xtol && it < it_max) {
            T s2 = T(0), s3 = T(0);
            for (int i = 0; i < m; ++i) {
                if (c2[i] > T(0)) {  // zero-weight modes drop out
                    const T sf = d[i] + lam;
                    const T sq = sf * sf;
                    s2 = s2 + c2[i] / sq;
                    s3 = s3 + c2[i] / (sq * sf);
                }
            }
            const T phi = lam * lam - MM * s2;
            const T dphi = T(2) * lam + T(2) * MM * s3;
            T lam_new = lam - phi / dphi;
            if (lam_new <= lo) lam_new = (lam + lo) / T(2);  // never cross the pole
            step = lam_new - lam;
            lam = lam_new;
            ++it;
        }
        lams[t] = lam;
        its[t] = it;
    }
}

template <typename T>
int launch(const T* alphas, const T* betas, const T* g_norm, const T* regs,
           const T* r0, double xtol, int it_max, int m, int L, T* theta,
           T* Q, T* lams, long long* its, void* stream) {
    if (m < 1 || m > MAX_M || L < 1 || L > THREADS)
        return (int)cudaErrorInvalidValue;
    tridiag_secular_kernel<T><<<1, THREADS, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        alphas, betas, g_norm, regs, r0, (T)xtol, it_max, m, L, theta, Q,
        lams, its);
    return (int)cudaGetLastError();
}


constexpr int SECULAR_WARPS = 4;      // candidates per block of eig_secular
constexpr int MAX_SECULAR_M = 2048;   // csrc/eigh.cu's largest matrix
constexpr int MAX_SECULAR_L = 1024;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
    for (int off = 16; off >= 1; off >>= 1)
        v = v + __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

template <typename T>
__global__ void __launch_bounds__(SECULAR_WARPS * 32)
eig_secular_kernel(const T* __restrict__ theta, const T* __restrict__ c,
                   const T* __restrict__ regs, const T* __restrict__ r0,
                   T xtol, int it_max, int m, int L, T* __restrict__ lams,
                   long long* __restrict__ its) {
    const int lane = threadIdx.x & 31;
    const int j = blockIdx.x * SECULAR_WARPS + (threadIdx.x >> 5);
    if (j >= L) return;  // the whole warp
    // min(theta), NaN if any theta is NaN (jnp.min's and torch.min's rule)
    T mn;
    set_inf(mn);
    int bad = 0;
    for (int i = lane; i < m; i += 32) {
        const T x = theta[i];
        bad |= x != x;
        if (x < mn) mn = x;
    }
    for (int off = 16; off >= 1; off >>= 1) {
        const T o = __shfl_xor_sync(0xffffffffu, mn, off);
        if (o < mn) mn = o;
    }
    bad = __any_sync(0xffffffffu, bad);
    if (bad) set_nan(mn);
    const T nmn = -mn;
    const T lo = (nmn > T(0) || nmn != nmn) ? nmn : T(0);
    const T lo_strict = lo > T(0) ? lo + T(1e-6) * (T(1) + lo) : lo;
    // max(r0, lo_strict), NaN if either is NaN (the JAX loop's start)
    const T r = r0[0];
    T lam = r >= lo_strict ? r : lo_strict;
    if (r != r) lam = r;
    const T M = regs[j];
    const T MM = M * M;
    T step;
    set_inf(step);
    int it = 0;
    while (absval(step) >= xtol && it < it_max) {
        T s2 = T(0), s3 = T(0);
        for (int i = lane; i < m; i += 32) {
            const T ci = c[i];
            const T c2 = ci * ci;
            if (c2 > T(0)) {  // zero-weight modes drop out
                const T sf = theta[i] + lam;
                const T sq = sf * sf;
                s2 = s2 + c2 / sq;
                s3 = s3 + c2 / (sq * sf);
            }
        }
        s2 = warp_sum(s2);
        s3 = warp_sum(s3);
        const T phi = lam * lam - MM * s2;
        const T dphi = T(2) * lam + T(2) * MM * s3;
        T lam_new = lam - phi / dphi;
        // never cross the pole
        if (lam_new <= lo) lam_new = (lam + lo) / T(2);
        step = lam_new - lam;
        lam = lam_new;
        ++it;
    }
    if (lane == 0) {
        lams[j] = lam;
        its[j] = it;
    }
}

template <typename T>
int launch_secular(const T* theta, const T* c, const T* regs, const T* r0,
                   double xtol, int it_max, int m, int L, T* lams,
                   long long* its, void* stream) {
    if (m < 1 || m > MAX_SECULAR_M || L < 1 || L > MAX_SECULAR_L)
        return (int)cudaErrorInvalidValue;
    const int grid = (L + SECULAR_WARPS - 1) / SECULAR_WARPS;
    eig_secular_kernel<T><<<grid, SECULAR_WARPS * 32, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        theta, c, regs, r0, (T)xtol, it_max, m, L, lams, its);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int tridiag_secular_max_m() { return MAX_M; }
int tridiag_secular_max_candidates() { return THREADS; }

// alphas (m), betas (m - 1), g_norm (1), regs (L), r0 (1) in; theta (m,
// ascending), Q (m x m, row-major, column i the eigenvector of theta[i]),
// lams (L) and its (L) out. All pointers are device memory; the launch
// goes on `stream` and does not synchronize.
int tridiag_secular_f32(const float* alphas, const float* betas,
                        const float* g_norm, const float* regs,
                        const float* r0, double xtol, int it_max, int m,
                        int L, float* theta, float* Q, float* lams,
                        long long* its, void* stream) {
    return launch<float>(alphas, betas, g_norm, regs, r0, xtol, it_max, m,
                         L, theta, Q, lams, its, stream);
}

int eig_secular_max_m() { return MAX_SECULAR_M; }
int eig_secular_max_candidates() { return MAX_SECULAR_L; }

// theta (m), c (m), regs (L), r0 (1) in; lams (L) and its (L) out: the
// secular Newton root of every candidate regularization. All pointers are
// device memory; the launch goes on `stream` and does not synchronize.
int eig_secular_f32(const float* theta, const float* c, const float* regs,
                    const float* r0, double xtol, int it_max, int m, int L,
                    float* lams, long long* its, void* stream) {
    return launch_secular<float>(theta, c, regs, r0, xtol, it_max, m, L,
                                 lams, its, stream);
}

int eig_secular_f64(const double* theta, const double* c,
                    const double* regs, const double* r0, double xtol,
                    int it_max, int m, int L, double* lams, long long* its,
                    void* stream) {
    return launch_secular<double>(theta, c, regs, r0, xtol, it_max, m, L,
                                  lams, its, stream);
}

int tridiag_secular_f64(const double* alphas, const double* betas,
                        const double* g_norm, const double* regs,
                        const double* r0, double xtol, int it_max, int m,
                        int L, double* theta, double* Q, double* lams,
                        long long* its, void* stream) {
    return launch<double>(alphas, betas, g_norm, regs, r0, xtol, it_max, m,
                          L, theta, Q, lams, its, stream);
}

}  // extern "C"
