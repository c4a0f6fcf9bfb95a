// Dense symmetric eigendecomposition, (theta ascending, Q), in one launch.
//
// Replaces jnp.linalg.eigh of the JAX package's CRN "full" step (the d x d
// Hessian, krylov_crn_tpu/solvers/crn.py:105) and SSCN step (the m x m
// coordinate Hessian, krylov_crn_tpu/solvers/sscn.py:92), which XLA runs
// on the device inside the jitted step. In eager PyTorch the same call is
// cuSOLVER, whose info PyTorch checks on the host, so a step that holds it
// can neither run ahead of the host nor be captured as a CUDA graph. This
// kernel reads nothing back.
//
// Bound: operations, and in practice the grid barrier between rounds. A
// sweep rotates every pair once, 6 n^3 multiply-adds on A and V together;
// each round moves A twice and V once through L2 (n = 1000 fp32: 12 MB,
// which stays in the 50 MB L2), and a round is short, so the barrier's
// latency is of the order of the round's work at these sizes.
//
// Design: a parallel two-sided cyclic Jacobi (Golub and Van Loan, 8.5).
//   pad      n is padded to an even N with one decoupled row and column
//            (zero off-diagonal) where n is odd. A pair whose a_pq is 0 is
//            not rotated, so the pad never moves and is dropped by index
//            at the end; it adds no eigenvalue. For the same reason exact
//            zeros stay exact (SSCN's Hessians have many empty rows).
//   rounds   a sweep is the N - 1 rounds of the round-robin tournament;
//            a round rotates its N / 2 disjoint pairs (p, q) at once:
//            A <- J^T A J, V <- V J, J = [[c, s], [-s, c]] on (p, q), with
//            t, c, s from a_pp, a_qq, a_pq (sym.schur2; t = 1 / (2 tau)
//            where tau^2 would overflow). A pair's rotation moves x_p and
//            x_q as x_p - s (x_q + r x_p) and x_q + s (x_p - r x_q) with
//            r = s / (1 + c) (Rutishauser's form: no drift of the column
//            norms from c's rounding). A is double-buffered: a thread owns
//            the 2 x 2 block of a pair of pairs (a, b), reads it from the
//            old A and writes it into the new A; where a > b it computes
//            the mirror block (b, a) as that block's thread does (A is
//            bitwise symmetric, so the bits read are the same) and writes
//            it transposed, so A stays bitwise symmetric and every thread
//            reads and writes along rows. The pivots' diagonal becomes
//            a_pp - t a_pq and a_qq + t a_pq, their off-diagonal 0. V is
//            kept transposed and rotated in place, a thread per (pair,
//            row), neighbouring threads on neighbouring rows. At the start
//            of a round each block computes the round's N / 2 rotations
//            from the old A into shared memory (every block the same
//            bits), so a thread reads only the elements it rotates.
//   barrier  one grid-wide barrier per round (a counter per launch, zeroed
//            by the launch; an arrival atomic and a bounded spin that traps
//            rather than hang the card). The launch is cooperative
//            (cudaLaunchCooperativeKernel, which a stream capture records
//            as a cooperative graph node): the driver makes every block
//            resident at once, whatever runs on other streams, or refuses
//            the launch, so the spin's bound is only a backstop. The grid
//            never exceeds the blocks that can be resident at once (the
//            occupancy API); one block needs only __syncthreads.
//   converge off(A)^2 = sum_{i != j} a_ij^2 against (EPS_FACTOR eps)^2
//            ||A||_F^2, before the first sweep and after each: a thread
//            sums a row in column order, then each block adds the row sums
//            in row order (every block the same sum, so every block takes
//            the same branch). After MAX_SWEEPS sweeps without meeting it
//            every theta is NaN: a failure is loud, as a failed eigh is.
//   sort     theta ascending by a stable rank (the number of smaller
//            values, then of equal values at lower index), Q's columns
//            moved with it.
// No atomics in any sum, no host read. Every operation rounds on its own
// (built with --fmad=false), so ops/eigh.py:sym_eigh_emulated reproduces
// the results bit for bit.
//
// Plain C interface for ctypes; each entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr int MAX_N = 2048;
constexpr int MAX_SWEEPS = 60;
constexpr int EPS_FACTOR = 4;
constexpr int THREADS = 256;
constexpr int MAX_BLOCKS_PER_SM = 2;
constexpr long long SPIN_CYCLES = 20000000000LL;  // ~10 s at 1.98 GHz

template <typename T> struct Limits;
template <> struct Limits<float> {
    static __device__ float eps() { return FLT_EPSILON; }
    static __device__ float tau_big() { return 1e18f; }
    static __device__ float nan() { return __int_as_float(0x7fc00000); }
};
template <> struct Limits<double> {
    static __device__ double eps() { return DBL_EPSILON; }
    static __device__ double tau_big() { return 1e150; }
    static __device__ double nan() {
        return __longlong_as_double(0x7ff8000000000000LL);
    }
};

__device__ __forceinline__ float absval(float x) { return fabsf(x); }
__device__ __forceinline__ double absval(double x) { return fabs(x); }
__device__ __forceinline__ float root(float x) { return sqrtf(x); }
__device__ __forceinline__ double root(double x) { return sqrt(x); }

// All blocks wait here until every block has arrived. `arrived` counts the
// arrivals of this launch; `target` (the same in every thread) the
// arrivals that complete this barrier.
__device__ __forceinline__ void grid_sync(unsigned* arrived,
                                          unsigned& target) {
    __syncthreads();
    if (gridDim.x == 1) return;
    target += gridDim.x;
    if (threadIdx.x == 0) {
        __threadfence();
        atomicAdd(arrived, 1u);
        const long long t0 = clock64();
        while (*(volatile unsigned*)arrived < target)
            if (clock64() - t0 > SPIN_CYCLES) __trap();
        __threadfence();
    }
    __syncthreads();
}

// pair k of round r of the round-robin tournament on N indices, p < q
__device__ __forceinline__ void pair_of(int N, int r, int k, int& p, int& q) {
    int a, b;
    if (k == 0) {
        a = N - 1;
        b = r;
    } else {
        a = (r + k) % (N - 1);
        b = (r - k + (N - 1)) % (N - 1);
    }
    p = a < b ? a : b;
    q = a < b ? b : a;
}

template <typename T>
struct Rot {
    T t, s, r;  // tangent, sine, s / (1 + c); all 0 when not rotated
    bool on;
};

template <typename T>
__device__ __forceinline__ Rot<T> rotation(const T* A, int N, int p, int q) {
    const T app = __ldcg(A + (size_t)p * N + p);
    const T aqq = __ldcg(A + (size_t)q * N + q);
    const T apq = __ldcg(A + (size_t)p * N + q);
    Rot<T> R;
    if (apq == T(0)) {
        R.t = R.s = R.r = T(0);
        R.on = false;
        return R;
    }
    const T tau = (aqq - app) / (T(2) * apq);
    const T atau = absval(tau);
    T t;
    if (atau > Limits<T>::tau_big())
        t = T(0.5) / tau;
    else
        t = (tau >= T(0) ? T(1) : T(-1)) / (atau + root(T(1) + tau * tau));
    const T c = T(1) / root(T(1) + t * t);
    R.t = t;
    R.s = t * c;
    R.r = R.s / (T(1) + c);
    R.on = true;
    return R;
}

// a 2 x 2 block of A: rows by J_row^T, then columns by J_col
template <typename T>
__device__ __forceinline__ void block_rotate(T b11, T b12, T b21, T b22,
                                             const Rot<T>& Rr,
                                             const Rot<T>& Rc, T& y11,
                                             T& y12, T& y21, T& y22) {
    const T x11 = b11 - Rr.s * (b21 + Rr.r * b11);
    const T x12 = b12 - Rr.s * (b22 + Rr.r * b12);
    const T x21 = b21 + Rr.s * (b11 - Rr.r * b21);
    const T x22 = b22 + Rr.s * (b12 - Rr.r * b22);
    y11 = x11 - Rc.s * (x12 + Rc.r * x11);
    y12 = x12 + Rc.s * (x11 - Rc.r * x12);
    y21 = x21 - Rc.s * (x22 + Rc.r * x21);
    y22 = x22 + Rc.s * (x21 - Rc.r * x22);
}

template <typename T>
__device__ T ordered_total(const T* rs, int N) {
    T tot = T(0);
    for (int i = 0; i < N; ++i) tot = tot + __ldcg(rs + i);
    return tot;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
sym_eigh_kernel(const T* __restrict__ H, int n, int N, T* A0, T* A1, T* Vt,
                T* rs_all, T* rs_off, int* rank, unsigned* arrived,
                T* __restrict__ theta, T* __restrict__ Q,
                int* __restrict__ sweeps_out) {
    __shared__ int go_on;
    __shared__ T shared_bound;
    // the round's pairs and rotations (dynamic: N / 2 of each)
    extern __shared__ __align__(16) unsigned char round_smem[];
    Rot<T>* rots = reinterpret_cast<Rot<T>*>(round_smem);
    int* pair_p = reinterpret_cast<int*>(rots + N / 2);
    int* pair_q = pair_p + N / 2;
    const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long G = (long long)gridDim.x * blockDim.x;
    const long long NN = (long long)N * N;
    unsigned target = 0;

    // A from H's lower triangle, the pad zero; V = I
    for (long long idx = g; idx < NN; idx += G) {
        const int i = (int)(idx / N), j = (int)(idx % N);
        T a = T(0);
        if (i < n && j < n)
            a = i >= j ? H[(size_t)i * n + j] : H[(size_t)j * n + i];
        A0[idx] = a;
        Vt[idx] = i == j ? T(1) : T(0);
    }
    grid_sync(arrived, target);
    for (long long i = g; i < N; i += G) {
        const T* row = A0 + i * N;
        T all = T(0), off = T(0);
        for (int j = 0; j < N; ++j) {
            const T a = __ldcg(row + j);
            const T sq = a * a;
            all = all + sq;
            if (j != i) off = off + sq;
        }
        rs_all[i] = all;
        rs_off[i] = off;
    }
    grid_sync(arrived, target);
    if (threadIdx.x == 0) {
        const T tol = T(EPS_FACTOR) * Limits<T>::eps();
        shared_bound = (tol * tol) * ordered_total(rs_all, N);
        go_on = !(ordered_total(rs_off, N) <= shared_bound);
    }
    __syncthreads();
    const T bound = shared_bound;

    const int h = N / 2;
    const long long n_blocks = (long long)h * h;           // pair blocks
    const long long items = n_blocks + (long long)N * h;   // + V items
    T* cur = A0;
    T* nxt = A1;
    int sweeps = 0;
    while (go_on && sweeps < MAX_SWEEPS) {
        for (int r = 0; r < N - 1; ++r) {
            // the round's pairs and rotations, once per block
            for (int k = threadIdx.x; k < h; k += blockDim.x) {
                int p, q;
                pair_of(N, r, k, p, q);
                pair_p[k] = p;
                pair_q[k] = q;
                rots[k] = rotation(cur, N, p, q);
            }
            __syncthreads();
            for (long long it = g; it < items; it += G) {
                if (it < n_blocks) {
                    // pair block (a, b): rows p_a, q_a, columns p_b, q_b
                    const int a = (int)(it / h), b = (int)(it % h);
                    const int pa = pair_p[a], qa = pair_q[a];
                    const Rot<T> Ra = rots[a];
                    if (a == b) {
                        const T app = __ldcg(cur + (size_t)pa * N + pa);
                        const T aqq = __ldcg(cur + (size_t)qa * N + qa);
                        const T apq = __ldcg(cur + (size_t)pa * N + qa);
                        const T tp = Ra.t * apq;
                        nxt[(size_t)pa * N + pa] = Ra.on ? app - tp : app;
                        nxt[(size_t)qa * N + qa] = Ra.on ? aqq + tp : aqq;
                        nxt[(size_t)pa * N + qa] = T(0);
                        nxt[(size_t)qa * N + pa] = T(0);
                        continue;
                    }
                    const int pb = pair_p[b], qb = pair_q[b];
                    const Rot<T> Rb = rots[b];
                    const T e11 = __ldcg(cur + (size_t)pa * N + pb);
                    const T e12 = __ldcg(cur + (size_t)pa * N + qb);
                    const T e21 = __ldcg(cur + (size_t)qa * N + pb);
                    const T e22 = __ldcg(cur + (size_t)qa * N + qb);
                    T y11, y12, y21, y22;
                    if (a < b) {
                        block_rotate(e11, e12, e21, e22, Ra, Rb, y11, y12,
                                     y21, y22);
                    } else {
                        // the mirror of block (b, a), computed as that
                        // block is (A is bitwise symmetric), transposed
                        block_rotate(e11, e21, e12, e22, Rb, Ra, y11, y21,
                                     y12, y22);
                    }
                    nxt[(size_t)pa * N + pb] = y11;
                    nxt[(size_t)pa * N + qb] = y12;
                    nxt[(size_t)qa * N + pb] = y21;
                    nxt[(size_t)qa * N + qb] = y22;
                } else {
                    // V's columns p, q of pair k at row i, in place (V is
                    // kept transposed: Vt[p][i] = V[i][p])
                    const long long w = it - n_blocks;
                    const int k = (int)(w / N), i = (int)(w % N);
                    const int p = pair_p[k], q = pair_q[k];
                    const Rot<T> R = rots[k];
                    T* vp = Vt + (size_t)p * N + i;
                    T* vq = Vt + (size_t)q * N + i;
                    const T xp = __ldcg(vp), xq = __ldcg(vq);
                    *vp = xp - R.s * (xq + R.r * xp);
                    *vq = xq + R.s * (xp - R.r * xq);
                }
            }
            grid_sync(arrived, target);
            T* tmp = cur;
            cur = nxt;
            nxt = tmp;
        }
        ++sweeps;
        for (long long i = g; i < N; i += G) {
            const T* row = cur + i * N;
            T off = T(0);
            for (int j = 0; j < N; ++j) {
                if (j == i) continue;
                const T a = __ldcg(row + j);
                off = off + a * a;
            }
            rs_off[i] = off;
        }
        grid_sync(arrived, target);
        if (threadIdx.x == 0) go_on = !(ordered_total(rs_off, N) <= bound);
        __syncthreads();
    }
    const bool converged = !go_on;

    // ascending order: a stable rank of the diagonal, the pad left out
    for (long long i = g; i < n; i += G) {
        const T d = __ldcg(cur + i * N + i);
        int k = (int)i;
        if (converged) {
            k = 0;
            for (int j = 0; j < n; ++j) {
                const T e = __ldcg(cur + (size_t)j * N + j);
                k += (e < d) || (e == d && j < i);
            }
        }
        rank[i] = k;
        theta[k] = converged ? d : Limits<T>::nan();
    }
    grid_sync(arrived, target);
    const long long nn = (long long)n * n;
    for (long long idx = g; idx < nn; idx += G) {
        const int i = (int)(idx / n), row = (int)(idx % n);
        Q[(size_t)row * n + __ldcg(rank + i)] =
            __ldcg(Vt + (size_t)i * N + row);
    }
    if (g == 0) sweeps_out[0] = sweeps;
}

size_t align256(size_t b) { return (b + 255) & ~(size_t)255; }

// a round's table in shared memory: N / 2 rotations and pairs (at MAX_N in
// fp64, 40 KB: under the 48 KB a launch may ask without an opt-in)
template <typename T>
size_t round_smem_bytes(int N) {
    return (size_t)(N / 2) * (sizeof(Rot<T>) + 2 * sizeof(int));
}

// workspace: the arrival counter, A0, A1, V^T (N x N each), two row-sum
// vectors (N each) and the rank (N ints), each 256-byte aligned
size_t workspace_bytes(int n, int itemsize) {
    const size_t N = (size_t)(n + (n & 1));
    return align256(sizeof(unsigned)) + 3 * align256(N * N * itemsize)
           + 2 * align256(N * itemsize) + align256(N * sizeof(int));
}

template <typename T>
int launch(const T* H, int n, T* theta, T* Q, int* sweeps, void* work,
           void* stream) {
    if (n < 1 || n > MAX_N) return (int)cudaErrorInvalidValue;
    const int N = n + (n & 1);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    char* w = static_cast<char*>(work);
    unsigned* arrived = reinterpret_cast<unsigned*>(w);
    w += align256(sizeof(unsigned));
    T* A0 = reinterpret_cast<T*>(w);
    w += align256((size_t)N * N * sizeof(T));
    T* A1 = reinterpret_cast<T*>(w);
    w += align256((size_t)N * N * sizeof(T));
    T* V = reinterpret_cast<T*>(w);
    w += align256((size_t)N * N * sizeof(T));
    T* rs_all = reinterpret_cast<T*>(w);
    w += align256((size_t)N * sizeof(T));
    T* rs_off = reinterpret_cast<T*>(w);
    w += align256((size_t)N * sizeof(T));
    int* rank = reinterpret_cast<int*>(w);

    // the resident blocks, asked once (before any capture: a graph's
    // warm-up step launches eagerly first)
    static int sms = 0, per_sm = 0, coop = 0;
    if (sms == 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, sym_eigh_kernel<T>, THREADS, round_smem_bytes<T>(MAX_N));
        if (per_sm > MAX_BLOCKS_PER_SM) per_sm = MAX_BLOCKS_PER_SM;
    }
    if (!coop) return (int)cudaErrorNotSupported;
    if (sms < 1 || per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
    const long long h = N / 2;
    const long long items = h * h + (long long)N * h;
    long long grid = (items + THREADS - 1) / THREADS;
    if (grid > (long long)sms * per_sm) grid = (long long)sms * per_sm;
    if (grid < 1) grid = 1;

    cudaMemsetAsync(arrived, 0, sizeof(unsigned), s);
    void* args[] = {(void*)&H,      (void*)&n,      (void*)&N,
                    (void*)&A0,     (void*)&A1,     (void*)&V,
                    (void*)&rs_all, (void*)&rs_off, (void*)&rank,
                    (void*)&arrived, (void*)&theta, (void*)&Q,
                    (void*)&sweeps};
    const cudaError_t err = cudaLaunchCooperativeKernel(
        sym_eigh_kernel<T>, dim3((unsigned)grid), dim3(THREADS), args,
        round_smem_bytes<T>(N), s);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int sym_eigh_max_n() { return MAX_N; }
int sym_eigh_max_sweeps() { return MAX_SWEEPS; }
int sym_eigh_eps_factor() { return EPS_FACTOR; }
long long sym_eigh_workspace(int n, int itemsize) {
    return (long long)workspace_bytes(n, itemsize);
}

// H (n x n, row-major, read from its lower triangle) in; theta (n,
// ascending), Q (n x n, row-major, column i the eigenvector of theta[i])
// and sweeps (one int) out; work holds sym_eigh_workspace(n, itemsize)
// bytes. All pointers are device memory; the launch goes on `stream` and
// does not synchronize.
int sym_eigh_f32(const float* H, int n, float* theta, float* Q, int* sweeps,
                 void* work, void* stream) {
    return launch<float>(H, n, theta, Q, sweeps, work, stream);
}

int sym_eigh_f64(const double* H, int n, double* theta, double* Q,
                 int* sweeps, void* work, void* stream) {
    return launch<double>(H, n, theta, Q, sweeps, work, stream);
}

}  // extern "C"
