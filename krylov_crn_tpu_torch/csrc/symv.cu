// Upper-triangle symmetric matrix-vector product y = K x, fp32.
//
// Replaces the Pallas TPU kernel krylov_crn_tpu/ops/symv.py:_symv_kernel
// (launched by _symv_call). K = A A^T is bitwise symmetric by construction
// (the K build symmetrizes it), so reading only the nb(nb+1)/2 upper
// BS x BS tiles gives the full product: an off-diagonal tile (i < j)
// contributes K_ij x_j to y_i and K_ij^T x_i to y_j in one visit.
//
// Bound: device memory bandwidth. At n = 20480 the kernel reads
// n(n+BS)/2 * 4 B = 842 MB of K, against 1.68 GB for a full matvec, and
// does 2 flops per element read.
//
// Design (deterministic, no atomics):
//   pass 1  one thread block per upper tile (i <= j). The block loads its
//           tile once, coalesced (float4 rows), into padded shared memory,
//           then writes the row partial K_ij x_j to W[i][j][:] and, for
//           i < j, the column partial K_ij^T x_i to W[j][i][:]. Every one
//           of the nb*nb slots of W is written exactly once.
//   pass 2  y[r*BS + c] = sum_s W[r][s][c] in fixed s order.
// Every sum runs in a fixed order, so the result is bitwise reproducible
// from run to run: the solver's trust-but-verify loop compares exact values
// across chunks, and rounding order alone moved the certified crossing of
// the JAX package by three iterations. The TPU kernel carried y across a
// sequential grid; on Hopper blocks run in parallel and in no order, which
// is what the workspace and second pass stand in for.
//
// Plain C interface for ctypes; each entry returns cudaGetLastError().
// symv_upper_f32_at reads K's address from a device slot, so that a
// captured step can be replayed on any K of its shape (ops/symv.py, KSlot).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BS = 64;          // tile edge; divides the 256-row padding
constexpr int THREADS = 256;    // 4 groups of 64 threads
constexpr int GROUPS = THREADS / BS;
constexpr int LD = BS + 1;      // padded shared row: conflict-free columns

__device__ __forceinline__ long long row_start(long long i, long long nb) {
    // index of tile (i, i) in the row-major upper-triangle numbering
    return i * nb - i * (i - 1) / 2;
}

// pass 1 for the tile of this block (the body of both tile kernels below)
__device__ __forceinline__ void upper_tile(const float* __restrict__ K,
                                           const float* __restrict__ x,
                                           float* __restrict__ W, int n,
                                           int nb) {
    __shared__ float tile[BS * LD];
    __shared__ float xi[BS];
    __shared__ float xj[BS];
    __shared__ float part[2][GROUPS][BS];

    // tile number -> (i, j), row-major over the upper triangle
    const long long t = blockIdx.x;
    const double b = 2.0 * nb + 1.0;
    long long i = (long long)floor((b - sqrt(b * b - 8.0 * (double)t)) * 0.5);
    if (i < 0) i = 0;
    while (i > 0 && row_start(i, nb) > t) --i;
    while (i + 1 < nb && row_start(i + 1, nb) <= t) ++i;
    const long long j = i + (t - row_start(i, nb));

    const int tid = threadIdx.x;
    const float* Kt = K + (size_t)(i * BS) * n + (size_t)(j * BS);

    // coalesced load: 16 float4 per tile row, 1024 float4 per tile
    #pragma unroll
    for (int k = 0; k < (BS * BS / 4) / THREADS; ++k) {
        const int idx = tid + k * THREADS;
        const int r = idx / (BS / 4);
        const int c4 = idx % (BS / 4);
        const float4 v = reinterpret_cast<const float4*>(Kt + (size_t)r * n)[c4];
        float* dst = tile + r * LD + 4 * c4;
        dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
    }
    if (tid < BS) {
        xi[tid] = x[i * BS + tid];
    } else if (tid < 2 * BS) {
        xj[tid - BS] = x[j * BS + tid - BS];
    }
    __syncthreads();

    // each thread: one row (and one column) of the tile, over a quarter
    const int lane = tid % BS;
    const int g = tid / BS;
    const int k0 = g * (BS / GROUPS);
    float row = 0.f, col = 0.f;
    #pragma unroll
    for (int k = k0; k < k0 + BS / GROUPS; ++k) {
        row += tile[lane * LD + k] * xj[k];   // (K_ij x_j)[lane]
        col += tile[k * LD + lane] * xi[k];   // (K_ij^T x_i)[lane]
    }
    part[0][g][lane] = row;
    part[1][g][lane] = col;
    __syncthreads();

    if (tid < BS) {
        float s = part[0][0][tid];
        #pragma unroll
        for (int q = 1; q < GROUPS; ++q) s += part[0][q][tid];
        W[((size_t)i * nb + j) * BS + tid] = s;
    } else if (tid < 2 * BS && i != j) {
        const int c = tid - BS;
        float s = part[1][0][c];
        #pragma unroll
        for (int q = 1; q < GROUPS; ++q) s += part[1][q][c];
        W[((size_t)j * nb + i) * BS + c] = s;
    }
}

__global__ void __launch_bounds__(THREADS)
symv_upper_tiles(const float* __restrict__ K, const float* __restrict__ x,
                 float* __restrict__ W, int n, int nb) {
    upper_tile(K, x, W, n, nb);
}

// The same pass with K's address read from device memory, the slot: one
// 8-byte load a block (every thread of the block reads the same word). A
// CUDA graph that launches it reads whichever K the slot names when it is
// replayed, where one that launches symv_upper_tiles keeps the address it
// was captured with.
__global__ void __launch_bounds__(THREADS)
symv_upper_tiles_at(const long long* __restrict__ slot,
                    const float* __restrict__ x, float* __restrict__ W,
                    int n, int nb) {
    upper_tile(reinterpret_cast<const float*>(*slot), x, W, n, nb);
}

__global__ void symv_reduce(const float* __restrict__ W,
                            float* __restrict__ y, int n, int nb) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= n) return;
    const int rb = r / BS, c = r % BS;
    const float* w = W + (size_t)rb * nb * BS + c;
    float s = 0.f;
    for (int q = 0; q < nb; ++q) s += w[(size_t)q * BS];
    y[r] = s;
}

}  // namespace

extern "C" {

int symv_upper_block() { return BS; }

// y = K x for a bitwise-symmetric row-major fp32 K (n x n), n % BS == 0.
// W: workspace of (n / BS)^2 * BS floats. All pointers are device memory;
// the launches go on `stream` and do not synchronize.
int symv_upper_f32(const float* K, const float* x, float* y, float* W,
                   int n, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int nb = n / BS;
    const long long tiles = (long long)nb * (nb + 1) / 2;
    symv_upper_tiles<<<(unsigned)tiles, THREADS, 0, s>>>(K, x, W, n, nb);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    symv_reduce<<<(n + 255) / 256, 256, 0, s>>>(W, y, n, nb);
    return (int)cudaGetLastError();
}

// symv_upper_f32 for the K whose address the device word *slot holds (a
// one-element int64 tensor): the same tiles, read at that address, and the
// same bits. slot, x, y and W are device memory.
int symv_upper_f32_at(const long long* slot, const float* x, float* y,
                      float* W, int n, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int nb = n / BS;
    const long long tiles = (long long)nb * (nb + 1) / 2;
    symv_upper_tiles_at<<<(unsigned)tiles, THREADS, 0, s>>>(slot, x, W, n,
                                                           nb);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    symv_reduce<<<(n + 255) / 256, 256, 0, s>>>(W, y, n, nb);
    return (int)cudaGetLastError();
}

}  // extern "C"
