// Dense matrix-vector product y = K x: K (n, m) row-major with leading
// dimension ld, fp32 or bf16; x and y fp32; fp32 accumulation.
//
// Replaces the Pallas TPU kernel tools/measure_matvec.py:_matvec_kernel
// (launched by matvec_pallas). That kernel walked a (n/bm, m/bk) grid in
// order and carried each (bm, 1) output block across the column steps j.
// Hopper blocks run in parallel and in no order, so nothing is carried
// between them: work is cut into fixed units, and the partial sums of a
// row that several blocks share are added in a fixed order.
//
// Bound: device memory bandwidth. The product reads n*m*itemsize bytes of
// K once and does 2 flops per element (0.5 flop per fp32 byte), far below
// the card's ratio of compute to bandwidth, so the tensor cores (wgmma)
// have nothing to offer: the design is about keeping enough bytes of K in
// flight and every SM busy until the end.
//
// Design for Hopper (deterministic, no floating-point atomics):
//   tiles   K is cut into tiles of TR rows x TCV 16-byte vectors (V = 4
//           fp32 or 8 bf16 elements each). A row is read by LPR lanes
//           (TR = 256 / LPR): long rows by a whole warp, in CT column
//           chunks of TCV = 128 vectors (256 where there are fewer row
//           tiles than SMs); short rows (w8a's 300 columns) whole, with
//           several rows to a warp. A unit is one (row tile, column
//           chunk), numbered row tile major.
//   grid    persistent: GRID blocks (three per SM on 132 SMs; one per SM
//           for short rows and for fewer row tiles than SMs; fewer when
//           there are fewer units). Block b takes the contiguous units
//           [b*U/GRID, (b+1)*U/GRID): an equal share of the bytes, so
//           every shape fills every SM in one wave, however its rows and
//           columns fall.
//   stream  a producer warp streams each unit's K tile into a ring of
//           STAGES shared-memory slots with TMA bulk copies
//           (cp.async.bulk, one per tile row, completing on the slot's
//           "full" mbarrier), and x's chunk beside it; eight consumer warps
//           wait on the barrier, reduce the tile from shared memory in
//           16-byte vectors and release the slot on its "empty" mbarrier.
//           So STAGES units (three of 16-24 KB) are in flight per block,
//           nine per SM, independent of registers and of the consumers'
//           pace. x is staged once when a row is one chunk (CT == 1), else
//           its chunk rides with each tile (from L2). A tile whose rows
//           lie back to back in memory goes in one copy.
//   sum     lane g of a row's LPR lanes takes the row's vectors g, g+LPR,
//           ... of each chunk in order and accumulates their elements in
//           column order with fmaf, across the consecutive chunks of the
//           tile that the block holds; then a fixed shuffle-down tree over
//           the LPR lanes. A tile wholly inside one block writes y; the
//           partials of a tile that several blocks share go to a
//           workspace (two slots per block: its first and its last tile),
//           and the last of those blocks to finish it (an integer ticket
//           per tile: __threadfence, then atomicAdd on an int) gathers
//           them into shared memory and sums them in block order, in the
//           same launch.
// Every choice is a function of (n, m, itemsize) made by the wrapper
// (ops/matvec.py:split_plan), never of scheduling, so the result is
// bitwise reproducible from run to run.
//
// The bulk copies move whole 16-byte vectors: the last vector of a row may
// run past column m into the row's padding (ld is a multiple of V; the
// wrapper checks that the last row's storage runs that far), and the
// consumers skip every element at or past m; x's whole 16-byte pieces
// before m go by bulk copy, its last one to three floats by plain loads.
// Rows whose start is not 16-byte aligned
// (ld*itemsize % 16 != 0, e.g. a contiguous bf16 matrix with 300 columns)
// or unaligned pointers take the scalar variant: the producer warp fills
// the same slots by plain loads (zeros past the edges), and the consumers'
// arithmetic is the same, so both variants give the same bits.
//
// Plain C interface for ctypes; each entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// ops/matvec.py mirrors CONSUMERS (as THREADS), STAGES and BLOCKS_PER_SM
constexpr int CONSUMERS = 256;            // eight consumer warps
constexpr int THREADS = CONSUMERS + 32;   // and one producer warp
constexpr int STAGES = 3;                 // ring slots (units in flight)
constexpr int BLOCKS_PER_SM = 3;          // resident blocks the grid plans
constexpr int PARTIALS = 1024;            // partials a shared tile's sum
                                          // gathers into shared memory at once

template <typename T> struct Elem;
// Raw: the element's bits; f: its fp32 value (bf16 widens exactly)
template <> struct Elem<float> {
    static constexpr int V = 4;
    using Raw = float;
    __device__ static float f(float v) { return v; }
};
template <> struct Elem<__nv_bfloat16> {
    static constexpr int V = 8;
    using Raw = unsigned short;
    __device__ static float f(unsigned short v) {
        return __uint_as_float((unsigned)v << 16);
    }
};

// ---- mbarriers and TMA bulk copies (PTX for sm_90) ----
__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                 :: "r"(smem_addr(bar)) : "memory");
}
// the barrier's current phase also waits for `bytes` of copies
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
    asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
// Wait for the phase of the given parity to complete. A wait that spins
// for seconds traps (a fault the caller sees) rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
    unsigned done, spins = 0;
    do {
        asm volatile("{\n\t.reg .pred p;\n\t"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                     "selp.u32 %0, 1, 0, p;\n\t}"
                     : "=r"(done) : "r"(smem_addr(bar)), "r"(parity)
                     : "memory");
        if (++spins == (1u << 28)) __trap();
    } while (!done);
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
                 "::bytes [%0], [%1], %2, [%3];"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(bytes),
                    "r"(smem_addr(bar)) : "memory");
}
// the eight consumer warps only (the producer warp runs its own loop)
__device__ __forceinline__ void consumers_sync() {
    asm volatile("bar.sync 1, %0;" :: "n"(CONSUMERS) : "memory");
}

struct Geometry {
    int n, m, lpr, tr, tcv, ct;
    long long ld, units;
};

__device__ __forceinline__ long long unit_start(long long b, long long units,
                                                long long grid) {
    return b * units / grid;
}

// 16-byte vectors of row chunk c that hold columns before m (at least 1)
__device__ __forceinline__ int chunk_vectors(const Geometry& g, int V, int c) {
    const int mv = (g.m + V - 1) / V;
    return min(g.tcv, mv - c * g.tcv);
}

// x[col0, col0 + count) into xf, zeros at and past m: the producer
// warp's lanes, plain loads (the scalar variant).
__device__ __forceinline__ void load_x(float* xf, const float* __restrict__ x,
                                       int m, int col0, int count, int lane) {
    for (int q = lane; q < count; q += 32)
        xf[q] = col0 + q < m ? __ldg(x + col0 + q) : 0.f;
}

// x[col0, min(col0 + count, m)) into xf: whole 16-byte pieces by a TMA
// bulk copy on `bar`, the last one to three floats by plain loads (the
// consumers never read past m). One thread.
__device__ __forceinline__ void copy_x(float* xf, const float* __restrict__ x,
                                       int m, int col0, int count,
                                       uint64_t* bar) {
    const int avail = max(0, min(count, m - col0));
    const int whole = avail & ~3;
    if (whole) {
        mbar_expect_tx(bar, 4u * whole);
        bulk_copy(xf, x + col0, 4u * whole, bar);
    }
    if (whole < avail) {
        for (int i = whole; i < avail; ++i) xf[i] = __ldg(x + col0 + i);
        // a later bulk copy into this slot comes after these stores
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    }
}

// The producer fills slot s with unit u and x's chunk (with_x): by TMA
// bulk copies that the slot's full barrier expects (VECTOR: lane 0 alone,
// then it arrives), or by the producer warp's plain loads, zeros past the
// edges (then each lane arrives).
template <typename T, bool VECTOR>
__device__ void fill_slot(uint4* slot, float* xs, const T* __restrict__ K,
                          const float* __restrict__ x, const Geometry& g,
                          long long u, bool with_x, uint64_t* full,
                          int lane) {
    constexpr int V = Elem<T>::V;
    using Raw = typename Elem<T>::Raw;
    const long long t = u / g.ct;
    const int c = (int)(u - t * g.ct);
    const long long row0 = t * g.tr;
    if (VECTOR) {
        const int nv = chunk_vectors(g, V, c);
        const int rows = (int)min((long long)g.tr, g.n - row0);
        const unsigned row_bytes = 16u * nv;
        mbar_expect_tx(full, row_bytes * rows);
        const T* src = K + row0 * g.ld + (long long)c * g.tcv * V;
        if (g.ld == (long long)g.tcv * V)  // the tile is one run of memory
            bulk_copy(slot, src, row_bytes * rows, full);
        else
            for (int r = 0; r < rows; ++r)
                bulk_copy(slot + r * g.tcv, src + r * g.ld, row_bytes, full);
        if (with_x) copy_x(xs, x, g.m, c * g.tcv * V, g.tcv * V, full);
    } else {
        const int kvec = g.tr * g.tcv;
        for (int v = lane; v < kvec; v += 32) {
            const int r = v / g.tcv;
            const long long row = row0 + r;
            const int col = (c * g.tcv + v - r * g.tcv) * V;
            const Raw* src =
                reinterpret_cast<const Raw*>(K + (row < g.n ? row : 0) * g.ld);
            union { uint4 u; Raw e[V]; } pack;
            #pragma unroll
            for (int i = 0; i < V; ++i)
                pack.e[i] = (row < g.n && col + i < g.m) ? src[col + i]
                                                         : Raw(0);
            slot[v] = pack.u;
        }
        if (with_x) load_x(xs, x, g.m, c * g.tcv * V, g.tcv * V, lane);
    }
    mbar_arrive(full);  // release: this lane's stores
}

// After a block has left its partial of a shared tile t in W: the last of
// the tile's blocks to arrive (an integer ticket) sums the partials of all
// of them in block order into y and resets the ticket for the next launch.
// Which block sums varies; the order of the sum does not. Consumers only.
// The consumers first gather the partials into shared memory together (one
// round trip to L2 for up to PARTIALS of them): read one at a time, a
// round trip each, a tile over 98 blocks took 46 us.
__device__ void finish_shared_tile(float* __restrict__ y,
                                   const float* __restrict__ W,
                                   int* __restrict__ tickets,
                                   const Geometry& g, long long t,
                                   long long G, int* last) {
    __shared__ float part[PARTIALS];
    // owners of the tile's first and last units
    const long long b_lo = ((t * g.ct + 1) * G - 1) / g.units;
    const long long b_hi = (((t + 1) * g.ct) * G - 1) / g.units;
    __threadfence();   // this block's partial is visible device-wide ...
    consumers_sync();  // ... before its ticket is taken
    if (threadIdx.x == 0)
        *last = atomicAdd(tickets + t, 1) == (int)(b_hi - b_lo);
    consumers_sync();
    const bool mine = *last;
    consumers_sync();  // every consumer has read the flag
    if (!mine) return;
    __threadfence();
    // every block after b_lo starts inside tile t, so holds its partial in
    // its first slot; b_lo does only if it starts the tile
    const int s_lo = unit_start(b_lo, g.units, G) / g.ct == t ? 0 : 1;
    const int nb = (int)(b_hi - b_lo + 1);
    const int per = PARTIALS / g.tr;  // blocks a pass gathers
    float acc = 0.f;
    for (int k0 = 0; k0 < nb; k0 += per) {
        const int kn = min(per, nb - k0);
        for (int i = threadIdx.x; i < kn * g.tr; i += CONSUMERS) {
            const int k = k0 + i / g.tr;
            part[i] = __ldcg(W + ((b_lo + k) * 2 + (k ? 0 : s_lo)) * g.tr
                             + i % g.tr);
        }
        consumers_sync();
        if (threadIdx.x < g.tr)
            for (int k = 0; k < kn; ++k) {
                const float p = part[k * g.tr + threadIdx.x];
                acc = (k0 + k == 0) ? p : acc + p;
            }
        consumers_sync();  // the pass is summed before the next overwrites
    }
    const long long row = t * g.tr + threadIdx.x;
    if (threadIdx.x < g.tr && row < g.n) y[row] = acc;
    if (threadIdx.x == 0) tickets[t] = 0;
}

template <typename T, bool VECTOR>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
matvec_stream(const T* __restrict__ K, const float* __restrict__ x,
              float* __restrict__ y, float* __restrict__ W,
              int* __restrict__ tickets, Geometry g) {
    constexpr int V = Elem<T>::V;
    extern __shared__ uint4 smem[];
    __shared__ uint64_t full[STAGES], empty[STAGES];
    __shared__ int last;
    const long long G = gridDim.x, b = blockIdx.x;
    const long long u0 = unit_start(b, g.units, G);
    const long long u1 = unit_start(b + 1, g.units, G);
    const int nst = (int)(u1 - u0);
    const bool x_once = g.ct == 1;
    const int kvec = g.tr * g.tcv;
    const int xq = g.tcv * V / 4;  // x's 16-byte pieces per chunk
    const int slot_sz = kvec + (x_once ? 0 : xq);
    float* xbuf = reinterpret_cast<float*>(smem + STAGES * slot_sz);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            // the producer's lane 0 (TMA), or its 32 lanes
            mbar_init(&full[s], VECTOR ? 1 : 32);
            mbar_init(&empty[s], CONSUMERS / 32);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    if (warp == CONSUMERS / 32) {  // ---- the producer warp
        if (VECTOR && lane != 0) return;
        for (int i = 0; i < nst; ++i) {
            const int s = i % STAGES;
            if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
            uint4* slot = smem + s * slot_sz;
            if (i == 0 && x_once) {  // released with the first unit
                if (VECTOR)
                    copy_x(xbuf, x, g.m, 0, g.tcv * V, &full[0]);
                else
                    load_x(xbuf, x, g.m, 0, g.tcv * V, lane);
            }
            fill_slot<T, VECTOR>(slot, reinterpret_cast<float*>(slot + kvec),
                                 K, x, g, u0 + i, !x_once, &full[s], lane);
        }
        return;
    }

    // ---- the consumer warps
    const int rt = threadIdx.x / g.lpr;  // row within the tile
    const int lg = threadIdx.x % g.lpr;  // lane within the row's lanes
    const long long tf = u0 / g.ct;      // the block's first tile
    float acc = 0.f;
    for (int i = 0; i < nst; ++i) {
        const int s = i % STAGES;
        mbar_wait(&full[s], (i / STAGES) & 1);
        const long long u = u0 + i;
        const long long t = u / g.ct;
        const int c = (int)(u - t * g.ct);
        const int nv = chunk_vectors(g, V, c);
        const int col0 = c * g.tcv * V;
        const uint4* ks = smem + s * slot_sz + rt * g.tcv;
        const float4* xs = reinterpret_cast<const float4*>(
            x_once ? xbuf : reinterpret_cast<float*>(smem + s * slot_sz + kvec));
        for (int j = lg; j < nv; j += g.lpr) {
            union { uint4 u; typename Elem<T>::Raw e[V]; } raw;
            raw.u = ks[j];
            const int lim = g.m - (col0 + j * V);  // elements before m
            #pragma unroll
            for (int h = 0; h < V / 4; ++h) {
                const float4 xv = xs[j * (V / 4) + h];
                const float xe[4] = {xv.x, xv.y, xv.z, xv.w};
                #pragma unroll
                for (int e = 0; e < 4; ++e)
                    if (4 * h + e < lim)
                        acc = fmaf(Elem<T>::f(raw.e[4 * h + e]), xe[e], acc);
            }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);  // the slot is free

        if (c == g.ct - 1 || i == nst - 1) {  // the tile ends here
            for (int off = g.lpr >> 1; off > 0; off >>= 1)
                acc += __shfl_down_sync(0xffffffffu, acc, off, g.lpr);
            const long long row = t * g.tr + rt;
            if (t * g.ct >= u0 && (t + 1) * g.ct <= u1) {  // the whole tile
                if (lg == 0 && row < g.n) y[row] = acc;
            } else {
                if (lg == 0 && row < g.n)
                    W[(b * 2 + (t == tf ? 0 : 1)) * g.tr + rt] = acc;
                finish_shared_tile(y, W, tickets, g, t, G, &last);
            }
            acc = 0.f;
        }
    }
}

// Once per kernel: allow all the dynamic shared memory a block may have
// (above 48 KB only on request), and ask for the largest shared-memory
// carveout of the SM's 256 KB, so that BLOCKS_PER_SM rings fit on one
// SM.
template <typename T, bool VECTOR>
cudaError_t configure() {
    static cudaError_t done = cudaErrorNotReady;
    if (done == cudaSuccess) return done;
    int dev = 0, optin = 0;
    cudaFuncAttributes attr;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess)
        e = cudaFuncGetAttributes(&attr, matvec_stream<T, VECTOR>);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(
            matvec_stream<T, VECTOR>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            optin - (int)attr.sharedSizeBytes);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(
            matvec_stream<T, VECTOR>,
            cudaFuncAttributePreferredSharedMemoryCarveout,
            cudaSharedmemCarveoutMaxShared);
    done = e;
    return e;
}

template <typename T>
int launch(const T* K, const float* x, float* y, float* W, int* tickets,
           int n, int m, long long ld, int lpr, int tcv, int ct, int grid,
           int vector, void* stream) {
    constexpr int V = Elem<T>::V;
    const int tr = lpr > 0 ? CONSUMERS / lpr : 0;
    if (n < 1 || m < 1 || lpr < 1 || lpr > 32 || (32 % lpr) != 0 ||
        tcv < 1 || ct < 1 || (long long)ct * tcv * V < m || grid < 1)
        return (int)cudaErrorInvalidValue;
    Geometry g{n, m, lpr, tr, tcv, ct, ld, 0};
    g.units = ((n + tr - 1) / tr) * (long long)ct;
    if (grid > g.units) return (int)cudaErrorInvalidValue;
    const int xq = tcv * V / 4;
    const int slot_sz = tr * tcv + (ct == 1 ? 0 : xq);
    const int smem = 16 * (STAGES * slot_sz + (ct == 1 ? xq : 0));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t e = vector ? configure<T, true>() : configure<T, false>();
    if (e != cudaSuccess) return (int)e;
    if (vector)
        matvec_stream<T, true><<<grid, THREADS, smem, s>>>(K, x, y, W,
                                                           tickets, g);
    else
        matvec_stream<T, false><<<grid, THREADS, smem, s>>>(K, x, y, W,
                                                            tickets, g);
    return (int)cudaGetLastError();
}

template <typename T, bool VECTOR>
int occupancy(int smem) {
    int blocks = 0;
    cudaError_t e = configure<T, VECTOR>();
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, matvec_stream<T, VECTOR>, THREADS, smem);
    return e == cudaSuccess ? blocks : -(int)e;
}

}  // namespace

extern "C" {

// y = K x for K (n, m) with row stride ld (elements), in one launch. The
// plan (lpr lanes per row, tcv 16-byte vectors per row chunk, ct chunks
// per row, grid blocks) comes from ops/matvec.py:split_plan. W: workspace
// of 2 * grid * (256 / lpr) floats; tickets: one int per row tile, all 0
// (the kernel leaves them 0 again), used where a tile is shared by several
// blocks. vector != 0 only when K and x are 16-byte aligned,
// ld * sizeof(elem) % 16 == 0 and the storage of K's last row runs to a
// whole 16-byte vector past column m. All pointers are device memory; the
// launch goes on `stream` and does not synchronize.
int matvec_f32(const float* K, const float* x, float* y, float* W,
               int* tickets, int n, int m, long long ld, int lpr, int tcv,
               int ct, int grid, int vector, void* stream) {
    return launch<float>(K, x, y, W, tickets, n, m, ld, lpr, tcv, ct, grid,
                         vector, stream);
}

int matvec_bf16(const void* K, const float* x, float* y, float* W,
                int* tickets, int n, int m, long long ld, int lpr, int tcv,
                int ct, int grid, int vector, void* stream) {
    return launch<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(K), x, y,
                                 W, tickets, n, m, ld, lpr, tcv, ct, grid,
                                 vector, stream);
}

// Blocks of the kernel (bf16 != 0: the bf16 one; vector != 0: the TMA
// variant) that one SM holds at `smem` bytes of dynamic shared memory, or
// a negative CUDA error.
int matvec_blocks_per_sm(int bf16, int vector, int smem) {
    if (bf16)
        return vector ? occupancy<__nv_bfloat16, true>(smem)
                      : occupancy<__nv_bfloat16, false>(smem);
    return vector ? occupancy<float, true>(smem)
                  : occupancy<float, false>(smem);
}

}  // extern "C"
