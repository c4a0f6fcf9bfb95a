// Compensated (two-float) folds of the last axis, one launch a call:
// sum2 and dot2 of ops/math.py, for a batch of rows.
//
// Replaces no TPU kernel: the JAX package's folds (krylov_crn_tpu/ops/
// math.py, sum2 and dot2) are XLA fusions, with no pallas_call. In eager
// PyTorch the same fold (ops/math.py:_lane_fold) is a row pass of two_sum
// over ceil(n / 1024) rows (five kernels a row) and a ten-level halving
// tree (about six a level): some 170 small kernels a fold at n = 20,480,
// and dot2 adds Dekker's two-product (about sixteen more). A Gram Krylov
// step makes 24 folds.
//
// Bound: launch latency. A call reads 80-400 KB (under 0.15 us at
// 3.35 TB/s) and writes two numbers a row; each thread's row pass is a
// chain of dependent two_sums.
//
// Design: one block a batch row, one thread a lane (LANES = 1024).
//   row pass  thread l folds x[r * LANES + l] for r = 0, 1, ... in order,
//             exactly as _lane_fold does: the first row taken as it is,
//             then (hi, e) = two_sum(hi, v), lo = lo + e. A read past n
//             is a zero, as F.pad's. Loads go out Fold<T>::unroll rows
//             at a time, ahead of the chain that consumes them.
//   tree      lane l merges lane l + h for h = 512, 256, ..., 1:
//             (hi, e) = two_sum(hi_l, hi_l+h), lo = (lo_l + lo_l+h) + e;
//             through shared memory down to one warp, then by shuffles.
//   dot2      forms p = fl(x y) and its error e (Dekker, splitter 4097 in
//             fp32, 134217729 in fp64) in registers and folds p as above,
//             adding each row's e into lo after that row's two_sum error:
//             lo = (lo + err) + e, the first row's lo its e. Every error
//             term goes into the one lo, in the order it arises; the tree
//             is sum2's. No temporary in device memory.
// Each operand has a row stride, 0 for an operand that broadcasts.
// Every operation rounds on its own: build with --fmad=false
// (ops/_kernels.py, KERNEL_FLAGS), so that ops/math.py's plain version
// (_lane_fold) reproduces the results bit for bit. No atomics.
//
// Plain C interface for ctypes; each entry returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int LANES = 1024;  // ops/math.py:LANES

template <typename T>
struct Fold;
template <>
struct Fold<float> {
    static constexpr float splitter = 4097.0f;  // 2^12 + 1
    static constexpr int unroll = 8;
};
template <>
struct Fold<double> {
    static constexpr double splitter = 134217729.0;  // 2^27 + 1
    static constexpr int unroll = 4;
};

// Knuth two-sum: s = fl(a + b) and the rounding error e, a + b = s + e
template <typename T>
__device__ __forceinline__ void two_sum(T a, T b, T& s, T& e) {
    s = a + b;
    const T bb = s - a;
    e = (a - (s - bb)) + (b - bb);
}

// Dekker two-product: p = fl(a b) and the error e, a b = p + e
template <typename T>
__device__ __forceinline__ void two_prod(T a, T b, T& p, T& e) {
    p = a * b;
    T c = Fold<T>::splitter * a;
    const T ah = c - (c - a);
    const T al = a - ah;
    c = Fold<T>::splitter * b;
    const T bh = c - (c - b);
    const T bl = b - bh;
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl;
}

template <typename T, bool DOT>
__global__ void __launch_bounds__(LANES)
fold_kernel(const T* __restrict__ x, long long x_stride,
            const T* __restrict__ y, long long y_stride, int n,
            T* __restrict__ out_hi, T* __restrict__ out_lo) {
    constexpr int U = Fold<T>::unroll;
    __shared__ T s_hi[LANES];
    __shared__ T s_lo[LANES];
    const int lane = threadIdx.x;
    const T* xr = x + blockIdx.x * x_stride;
    const T* yr = DOT ? y + blockIdx.x * y_stride : nullptr;
    const int rows = n > LANES ? (n + LANES - 1) / LANES : 1;

    T hi = T(0), lo = T(0);
    for (int r0 = 0; r0 < rows; r0 += U) {
        T v[U], e[U];
#pragma unroll
        for (int k = 0; k < U; ++k) {
            const long long i = (long long)(r0 + k) * LANES + lane;
            v[k] = T(0);
            e[k] = T(0);
            if (i < n) {
                if constexpr (DOT) {
                    two_prod(xr[i], yr[i], v[k], e[k]);
                } else {
                    v[k] = xr[i];
                }
            }
        }
#pragma unroll
        for (int k = 0; k < U; ++k) {
            const int r = r0 + k;
            if (r == 0) {
                hi = v[k];
                lo = e[k];
            } else if (r < rows) {
                T s, err;
                two_sum(hi, v[k], s, err);
                hi = s;
                lo = lo + err;
                if constexpr (DOT) lo = lo + e[k];
            }
        }
    }

    // the halving tree: shared memory while more than a warp merges
    s_hi[lane] = hi;
    s_lo[lane] = lo;
    __syncthreads();
    for (int h = LANES / 2; h >= 32; h >>= 1) {
        if (lane < h) {
            T s, err;
            two_sum(hi, s_hi[lane + h], s, err);
            hi = s;
            lo = (lo + s_lo[lane + h]) + err;
            s_hi[lane] = hi;
            s_lo[lane] = lo;
        }
        __syncthreads();
    }
    // then the first warp by shuffles: lane l < h reads lane l + h < 2h,
    // which the level before left right
    if (lane < 32) {
        for (int h = 16; h >= 1; h >>= 1) {
            const T ohi = __shfl_down_sync(0xffffffffu, hi, h);
            const T olo = __shfl_down_sync(0xffffffffu, lo, h);
            T s, err;
            two_sum(hi, ohi, s, err);
            hi = s;
            lo = (lo + olo) + err;
        }
        if (lane == 0) {
            out_hi[blockIdx.x] = hi;
            out_lo[blockIdx.x] = lo;
        }
    }
}

template <typename T, bool DOT>
int launch(const T* x, long long x_stride, const T* y, long long y_stride,
           int n, int batch, T* hi, T* lo, void* stream) {
    if (n < 0 || batch < 1) return (int)cudaErrorInvalidValue;
    fold_kernel<T, DOT><<<batch, LANES, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        x, x_stride, y, y_stride, n, hi, lo);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int fold_lanes() { return LANES; }

// x: batch rows of n values, row r at x + r * x_stride (0: one row for
// all); hi, lo (batch) out: each row's compensated sum. All pointers are
// device memory; the launch goes on `stream` and does not synchronize.
int sum2_f32(const float* x, long long x_stride, int n, int batch,
             float* hi, float* lo, void* stream) {
    return launch<float, false>(x, x_stride, nullptr, 0, n, batch, hi, lo,
                                stream);
}

int sum2_f64(const double* x, long long x_stride, int n, int batch,
             double* hi, double* lo, void* stream) {
    return launch<double, false>(x, x_stride, nullptr, 0, n, batch, hi, lo,
                                 stream);
}

// x, y: batch rows of n values each, as for sum2; hi, lo (batch) out:
// each row's compensated dot product <x_r, y_r>.
int dot2_f32(const float* x, long long x_stride, const float* y,
             long long y_stride, int n, int batch, float* hi, float* lo,
             void* stream) {
    return launch<float, true>(x, x_stride, y, y_stride, n, batch, hi, lo,
                               stream);
}

int dot2_f64(const double* x, long long x_stride, const double* y,
             long long y_stride, int n, int batch, double* hi, double* lo,
             void* stream) {
    return launch<double, true>(x, x_stride, y, y_stride, n, batch, hi, lo,
                                stream);
}

}  // extern "C"
