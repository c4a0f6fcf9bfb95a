// Dense matrix-vector product y = K x: K (n, m) row-major with leading
// dimension ld, fp32 or bf16; x and y fp32; fp32 accumulation.
//
// Replaces the Pallas TPU kernel tools/measure_matvec.py:_matvec_kernel
// (launched by matvec_pallas). That kernel walked a (n/bm, m/bk) grid in
// order and carried each (bm, 1) output block across the column steps j.
// Hopper blocks run in parallel and in no order, so nothing can be carried
// between them: a row's columns are cut into `splits` fixed segments, each
// reduced by one warp, and a second pass sums the segments.
//
// Bound: device memory bandwidth. The kernel reads n*m*itemsize bytes of K
// once (plus x, which stays in L1/L2) and does 2 flops per element, far
// below the card's ratio of compute to bandwidth.
//
// Design (deterministic, no atomics):
//   pass 1  grid (ceil(n / WARPS), splits); warp w of block (bx, s) reduces
//           row bx*WARPS + w over columns [s*width, min(m, (s+1)*width)).
//           Lane l reads the 16-byte vector at column base + l*V of each
//           warp step (V = 4 fp32 or 8 bf16; UNROLL loads in flight per
//           lane), accumulates its elements in column order with fmaf, and
//           the warp folds its 32 lane sums with a fixed shuffle tree. The
//           partial goes to W[s*n + row], or straight to y when splits == 1.
//   pass 2  y[r] = sum_s W[s*n + r] in fixed s order.
//   splits  a function of (n, m, itemsize) only, chosen by the wrapper
//           (ops/matvec.py:split_plan): enough warps in flight to fill 132
//           SMs when n is small (A^T of a tall-skinny A has a few hundred
//           long rows), one split when n is large.
// So the result is bitwise reproducible from run to run.
//
// Rows whose start is not 16-byte aligned (ld*itemsize % 16 != 0, e.g. a
// contiguous bf16 matrix with 300 columns) or unaligned pointers take the
// scalar-load variant of pass 1, which visits the same elements in the
// same order, so both variants give the same bits. The ragged column edge
// (m not a multiple of V) and the ragged row edge are masked in-kernel.
//
// Plain C interface for ctypes; each entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int WARPS = 8;                 // warps (rows) per block
constexpr int THREADS = WARPS * 32;
constexpr int UNROLL = 4;                // 16-byte loads in flight per lane

template <typename T> struct Elem;
template <> struct Elem<float> {
    static constexpr int V = 4;
    __device__ static float f(float v) { return v; }
};
template <> struct Elem<__nv_bfloat16> {
    static constexpr int V = 8;
    __device__ static float f(__nv_bfloat16 v) { return __bfloat162float(v); }
};

// V elements of row `row` starting at column c (c % V == 0) into k[];
// entries at or beyond c1 are zero.
template <typename T, bool VECTOR>
__device__ __forceinline__ void load_k(const T* __restrict__ row, int c,
                                       int c1, float* k) {
    constexpr int V = Elem<T>::V;
    if (VECTOR && c + V <= c1) {
        const uint4 raw = *reinterpret_cast<const uint4*>(row + c);
        const T* e = reinterpret_cast<const T*>(&raw);
        #pragma unroll
        for (int i = 0; i < V; ++i) k[i] = Elem<T>::f(e[i]);
    } else {
        #pragma unroll
        for (int i = 0; i < V; ++i)
            k[i] = (c + i < c1) ? Elem<T>::f(row[c + i]) : 0.f;
    }
}

template <typename T, bool VECTOR>
__global__ void __launch_bounds__(THREADS)
matvec_rows(const T* __restrict__ K, const float* __restrict__ x,
            float* __restrict__ out, int n, int m, long long ld, int width) {
    constexpr int V = Elem<T>::V;
    constexpr int STEP = 32 * V;
    const int lane = threadIdx.x & 31;
    const int r = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (r >= n) return;  // uniform per warp: the shuffles below stay full
    const int c0 = blockIdx.y * width;
    const int c1 = min(m, c0 + width);
    const T* row = K + (size_t)r * (size_t)ld;

    float acc = 0.f;
    for (int base = c0; base < c1; base += STEP * UNROLL) {
        float k[UNROLL][V];
        #pragma unroll
        for (int u = 0; u < UNROLL; ++u)
            load_k<T, VECTOR>(row, base + u * STEP + lane * V, c1, k[u]);
        #pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const int c = base + u * STEP + lane * V;
            #pragma unroll
            for (int i = 0; i < V; ++i)
                if (c + i < c1) acc = fmaf(k[u][i], __ldg(x + c + i), acc);
        }
    }
    #pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) out[(size_t)blockIdx.y * n + r] = acc;
}

__global__ void matvec_sum_splits(const float* __restrict__ W,
                                  float* __restrict__ y, int n, int splits) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= n) return;
    float s = W[r];
    for (int q = 1; q < splits; ++q) s += W[(size_t)q * n + r];
    y[r] = s;
}

template <typename T>
int launch(const T* K, const float* x, float* y, float* W, int n, int m,
           long long ld, int splits, int width, int vector, void* stream) {
    // split boundaries must fall on whole 16-byte vectors
    if (n < 1 || splits < 1 || width % Elem<T>::V != 0 ||
        (long long)splits * width < m)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    float* out = splits > 1 ? W : y;
    const dim3 grid((unsigned)((n + WARPS - 1) / WARPS), (unsigned)splits);
    if (vector)
        matvec_rows<T, true><<<grid, THREADS, 0, s>>>(K, x, out, n, m, ld,
                                                      width);
    else
        matvec_rows<T, false><<<grid, THREADS, 0, s>>>(K, x, out, n, m, ld,
                                                       width);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || splits == 1) return (int)err;
    matvec_sum_splits<<<(n + 255) / 256, 256, 0, s>>>(W, y, n, splits);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y = K x for K (n, m) with row stride ld (elements), its columns cut into
// `splits` segments of `width` (a multiple of the 16-byte vector's element
// count). W: workspace of splits * n floats (unused when splits == 1).
// vector != 0 only when K and x are 16-byte aligned and ld * sizeof(elem)
// % 16 == 0. All pointers are device memory; the launches go on `stream`
// and do not synchronize.
int matvec_f32(const float* K, const float* x, float* y, float* W, int n,
               int m, long long ld, int splits, int width, int vector,
               void* stream) {
    return launch<float>(K, x, y, W, n, m, ld, splits, width, vector, stream);
}

int matvec_bf16(const void* K, const float* x, float* y, float* W, int n,
                int m, long long ld, int splits, int width, int vector,
                void* stream) {
    return launch<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(K), x, y,
                                 W, n, m, ld, splits, width, vector, stream);
}

}  // extern "C"
