// Edge-list GO and BFS kernels for Hopper (sm_90a), behind a plain C
// interface that nebula_tpu_torch/tpu/edge_ops.py loads with ctypes.
//
// Replaces the edge-list programs of nebula_tpu/tpu/kernels.py:
//   make_go_kernel (:284, body _go_body :264) = edge_seed + edge_final
//       at one step; from two, edge_hop from the start list itself,
//       edge_hop x (steps - 2) from the frontier, edge_final
//   make_go_filtered_kernel (:296) = the same with edge_final_where:
//       K9's test with the WHERE (expr_core.cuh) evaluated inside it,
//       on the edges that pass the test only
//   make_bfs_kernel (:315) = edge_seed x 2 + edge_bfs_level (first) +
//       per level edge_hop + edge_bfs_level; the host reads the level's
//       two flags before launching the next, as jax.lax.while_loop
//       tests its condition.
//   make_sharded_go_kernel's per-shard hop (:364) = edge_scan_hop: a
//       shard holds an equal slice of the edge list, padded, which is
//       not a CSR of its own, so it keeps the scan over every edge.
//
// Layout: edge_src / edge_dst / edge_etype int32 [m] (the mirror's edge
// arrays, both directions, signed etypes), sorted by source, with
// row_ptr int32 [n + 1] the CSR row index (row v is edges [row_ptr[v],
// row_ptr[v + 1])); a frontier is one byte a vertex, bool [n]; a start
// list int32 with -1 padding; depths int32 [n], INT32_INF unreached.
//
// Bound on this card: device-memory bytes.  K8 (edge_hop) must read
// the frontier (n bytes, or the start list), row_ptr at its live
// sources, etype and dst of their edges (8 B an edge) and write the
// next frontier (n bytes); the reference's scan reads src, etype and
// dst of every edge (100.6 MB at the serve graph's 8,385,118 edge rows).
// Design: a block owns a tile of 1024 sources (frontier bytes, 4 a
// thread by one 4-byte load, or start ids); its threads find the live
// ones, read their row ranges, and a block scan lays the live rows'
// edges end to end in shared memory; then the block's threads take the
// tile's edges in turn (a binary search of the row offsets, 4 edges in
// flight a thread), so consecutive threads read consecutive edges of a
// row and a hub's row is spread over the whole block.  A grid row of
// blocks splits each tile's edges further, to at least 12 blocks an SM
// (a start list is one tile, split 64 ways; the serve graph's 512
// tiles 4 ways: more blocks cost a sparse frontier the empty blocks'
// start-up, fewer leave a hub's tile to one or two blocks).  The
// reference's scatter-max becomes a plain store of 1 (every writer
// stores the same byte, so no atomic is needed) into a buffer zeroed
// first by cudaMemsetAsync.  On a frontier where every source is live
// the walk and the scan make the same 4.2M random one-byte stores into
// the next frontier, and those stores, not the reads, set both
// kernels' pace.  edge_seed writes every byte of its bitmap once: a
// block owns 4 KB, sets its starts in a shared tile and stores it 16
// bytes a thread.  BFS levels are one thread a vertex; the loop flags
// are a block OR and one atomicOr.
//
// The fused WHERE.  The reference computes final = frontier[src] & ok &
// filter_mask with the WHERE evaluated on every edge (kernels.py:296,
// :264-281).  Every operation of the interpreter is total, so the
// WHERE's value matters only where keep = f[src[e]] && in_over(et[e])
// holds, and edge_final_where evaluates it only there: its bound is
// K9's bytes (src and etype 4 B each, the frontier bytes, 1 B out an
// edge) plus the used columns over the kept edges.  A warp scans 32
// edges at a time and queues its kept ones in shared memory (ballot +
// popc); each time 32 are queued, every lane interprets one, so no lane
// idles through a program while others run it.  The grid is a few
// blocks an SM, so that a warp scans enough edges to fill its queue.
//
// Every entry point runs on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() after its
// launches (0 = launched).

#include <cuda_runtime.h>
#include <stdint.h>

#include "expr_core.cuh"
#include "sm_count.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1LL << 20;
constexpr int kMaxOver = 32;
constexpr int32_t kInt32Inf = 0x7FFFFFFF;      // kernels.py INT32_INF
constexpr int kWarps = kThreads / 32;
constexpr int kQueue = 64;                     // a warp's queued edges
constexpr int kFinalBlocksPerSM = 8;           // edge_final_where's grid
constexpr int kSeedTile = kThreads * 16;       // edge_seed's bytes a block
constexpr int kHopThreads = 256;               // K8's block
constexpr int kHopWarps = kHopThreads / 32;
constexpr int kHopItems = 4;                   // K8's sources a thread
constexpr int kHopTile = kHopThreads * kHopItems;
constexpr int kHopUnroll = 4;                  // K8's edges in flight
constexpr int kHopBlocksPerSM = 12;            // K8's grid, at least
constexpr int kHopMaxSplit = 64;               // K8's blocks a tile

// The OVER set as signed etypes (negative = REVERSELY), by value.
struct OverSet {
    int et[kMaxOver];
    int n;
};

// The host array the entry points take, as the kernels' argument.
inline bool over_set(const int32_t* over, int n_over, OverSet* ov) {
    if (n_over < 1 || n_over > kMaxOver) return false;
    ov->n = n_over;
    for (int k = 0; k < n_over; ++k) ov->et[k] = over[k];
    return true;
}

inline unsigned grid_for(long long total) {
    long long blocks = (total + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    if (blocks < 1) blocks = 1;
    return (unsigned)blocks;
}

__device__ __forceinline__ bool in_over(const OverSet& ov, int et) {
    bool ok = false;
    for (int k = 0; k < ov.n; ++k) ok |= (et == ov.et[k]);
    return ok;
}

// kernels.py bitmap_from_idx in one pass: block b owns f's bytes
// [b * kSeedTile, (b + 1) * kSeedTile), zeroes them in shared memory,
// sets the starts that fall there (every block reads the whole list)
// and stores the tile once, 16 bytes a thread where f is 16-byte
// aligned.
__global__ void __launch_bounds__(kThreads)
edge_seed_kernel(uint8_t* __restrict__ f, const int32_t* __restrict__ idx,
                 long long S, long long n) {
    __shared__ __align__(16) uint8_t tile[kSeedTile];
    const long long lo = (long long)blockIdx.x * kSeedTile;
    reinterpret_cast<uint4*>(tile)[threadIdx.x] = make_uint4(0, 0, 0, 0);
    __syncthreads();
    for (long long i = threadIdx.x; i < S; i += blockDim.x) {
        const long long v = idx[i];
        if (v >= lo && v < lo + kSeedTile && v < n) tile[v - lo] = 1;
    }
    __syncthreads();
    const long long at = lo + threadIdx.x * 16;
    if (at + 16 <= n && (reinterpret_cast<uintptr_t>(f) & 15) == 0) {
        *reinterpret_cast<uint4*>(f + at) =
            reinterpret_cast<const uint4*>(tile)[threadIdx.x];
    } else {
        for (int k = 0; k < 16 && at + k < n; ++k)
            f[at + k] = tile[threadIdx.x * 16 + k];
    }
}

// K8, _go_body's hop next = zeros(n).at[dst].max(f[src] & ok), as a
// walk over the CSR rows of the live sources (see the head of this
// file).  Sources: the frontier bytes f [n] or, with f null, the start
// ids ids [count] (-1 padded; ids outside [0, n) dropped, a repeat
// stores the same bytes again).  Grid: x a tile of kHopTile sources, y
// a share of the tile's edges; out zeroed before the launch.
__global__ void __launch_bounds__(kHopThreads)
edge_hop_kernel(const uint8_t* __restrict__ f,
                const int32_t* __restrict__ ids, long long count,
                uint8_t* __restrict__ out,
                const int32_t* __restrict__ row_ptr,
                const int32_t* __restrict__ dst,
                const int32_t* __restrict__ et, long long n, OverSet ov) {
    __shared__ int32_t s_begin[kHopTile];      // a live row's first edge
    __shared__ int32_t s_off[kHopTile + 1];    // its place in the tile
    __shared__ int32_t s_rows[kHopWarps], s_edges[kHopWarps];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long first = (long long)blockIdx.x * kHopTile
                            + threadIdx.x * kHopItems;
    int32_t begin[kHopItems], len[kHopItems];
    uint32_t word = 0;                 // the frontier's 4 bytes
    if (ids == nullptr) {
        if (first + kHopItems <= n &&
            (reinterpret_cast<uintptr_t>(f + first) & 3) == 0) {
            word = *reinterpret_cast<const uint32_t*>(f + first);
        } else {
            for (int k = 0; k < kHopItems && first + k < n; ++k)
                word |= (uint32_t)f[first + k] << (8 * k);
        }
    }
    int rows = 0, edges = 0;
#pragma unroll
    for (int k = 0; k < kHopItems; ++k) {
        long long v = -1;
        if (ids == nullptr) {
            if ((word >> (8 * k)) & 0xFFu) v = first + k;
        } else if (first + k < count) {
            v = ids[first + k];
            if (v >= n) v = -1;
        }
        len[k] = 0;
        if (v >= 0) {
            begin[k] = row_ptr[v];
            len[k] = row_ptr[v + 1] - begin[k];
        }
        rows += len[k] > 0;
        edges += len[k];
    }
    // block scan of (rows, edges): warps by shuffles, then the warp sums
    int r_in = rows, e_in = edges;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int a = __shfl_up_sync(0xFFFFFFFFu, r_in, o);
        const int b = __shfl_up_sync(0xFFFFFFFFu, e_in, o);
        if (lane >= o) {
            r_in += a;
            e_in += b;
        }
    }
    if (lane == 31) {
        s_rows[warp] = r_in;
        s_edges[warp] = e_in;
    }
    __syncthreads();
    if (warp == 0) {
        int a = lane < kHopWarps ? s_rows[lane] : 0;
        int b = lane < kHopWarps ? s_edges[lane] : 0;
#pragma unroll
        for (int o = 1; o < kHopWarps; o <<= 1) {
            const int x = __shfl_up_sync(0xFFFFFFFFu, a, o);
            const int y = __shfl_up_sync(0xFFFFFFFFu, b, o);
            if (lane >= o) {
                a += x;
                b += y;
            }
        }
        if (lane < kHopWarps) {
            s_rows[lane] = a;
            s_edges[lane] = b;
        }
    }
    __syncthreads();
    const int R = s_rows[kHopWarps - 1], E = s_edges[kHopWarps - 1];
    if (E == 0) return;                // the same on every thread
    int pos = r_in - rows + (warp ? s_rows[warp - 1] : 0);
    int off = e_in - edges + (warp ? s_edges[warp - 1] : 0);
#pragma unroll
    for (int k = 0; k < kHopItems; ++k) {
        if (len[k] > 0) {
            s_begin[pos] = begin[k];
            s_off[pos] = off;
            ++pos;
            off += len[k];
        }
    }
    if (threadIdx.x == 0) s_off[R] = E;
    __syncthreads();
    // this block's share of the tile's E edges, kHopUnroll in flight
    const int lo = (int)((long long)E * blockIdx.y / gridDim.y);
    const int hi = (int)((long long)E * (blockIdx.y + 1) / gridDim.y);
    int r0 = 0;                        // j only grows: search from here
    for (int j0 = lo + threadIdx.x; j0 < hi;
         j0 += kHopThreads * kHopUnroll) {
        int e[kHopUnroll];
#pragma unroll
        for (int u = 0; u < kHopUnroll; ++u) {
            const int j = j0 + u * kHopThreads;
            e[u] = -1;
            if (j < hi) {
                int a = r0, b = R - 1;     // the last row with off <= j
                while (a < b) {
                    const int mid = (a + b + 1) >> 1;
                    if (s_off[mid] <= j) a = mid;
                    else b = mid - 1;
                }
                r0 = a;
                e[u] = s_begin[a] + (j - s_off[a]);
            }
        }
        int t[kHopUnroll], d[kHopUnroll];
#pragma unroll
        for (int u = 0; u < kHopUnroll; ++u) {
            if (e[u] >= 0) {
                t[u] = et[e[u]];
                d[u] = dst[e[u]];
            }
        }
#pragma unroll
        for (int u = 0; u < kHopUnroll; ++u)
            if (e[u] >= 0 && in_over(ov, t[u])) out[d[u]] = 1;
    }
}

// make_sharded_go_kernel's per-shard hop: the scan over every edge of
// a slice that is not a CSR of its own.
__global__ void edge_scan_hop_kernel(const uint8_t* __restrict__ f,
                                     uint8_t* __restrict__ out,
                                     const int32_t* __restrict__ src,
                                     const int32_t* __restrict__ dst,
                                     const int32_t* __restrict__ et,
                                     long long m, OverSet ov) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         e < m; e += stride) {
        if (f[src[e]] && in_over(ov, et[e])) out[dst[e]] = 1;
    }
}

// _go_body's final mask: f[src] & ok (& the fused WHERE mask).
__global__ void edge_final_kernel(const uint8_t* __restrict__ f,
                                  const int32_t* __restrict__ src,
                                  const int32_t* __restrict__ et,
                                  const uint8_t* __restrict__ fmask,
                                  uint8_t* __restrict__ out, long long m,
                                  OverSet ov) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         e < m; e += stride) {
        bool keep = f[src[e]] && in_over(ov, et[e]);
        if (fmask != nullptr) keep = keep && fmask[e];
        out[e] = keep ? 1 : 0;
    }
}

// make_go_filtered_kernel's final mask with the WHERE fused (see the
// head of this file): out[e] = f[src[e]] && in_over(et[e]) && the
// program's value at e, the program run only where the first two hold.
__global__ void __launch_bounds__(kThreads)
edge_final_where_kernel(const uint8_t* __restrict__ f,
                        const int32_t* __restrict__ src,
                        const int32_t* __restrict__ dst,
                        const int32_t* __restrict__ et, OverSet ov,
                        const int32_t* __restrict__ ins, int n_ins,
                        int out_reg, ExprSlots slots, long long m,
                        uint8_t* __restrict__ out) {
    extern __shared__ uint32_t smem[];
    __shared__ long long queue[kWarps][kQueue];
    int32_t* prog = reinterpret_cast<int32_t*>(smem);
    uint32_t* regs = smem + n_ins * 5 + threadIdx.x;
    expr::load_program(prog, ins, n_ins);
    __syncthreads();
    const int lane = threadIdx.x & 31;
    long long* q = queue[threadIdx.x >> 5];
    const unsigned below = (1u << lane) - 1u;
    const long long warps = (long long)gridDim.x * kWarps;
    int qn = 0;                         // the same on every lane
    // every lane of a warp runs the same trip count
    for (long long base = ((long long)blockIdx.x * kWarps
                           + (threadIdx.x >> 5)) * 32;
         base < m; base += warps * 32) {
        const long long e = base + lane;
        bool keep = false;
        if (e < m) {
            keep = f[src[e]] && in_over(ov, et[e]);
            if (!keep) out[e] = 0;
        }
        const unsigned ball = __ballot_sync(0xFFFFFFFFu, keep);
        if (keep) q[qn + __popc(ball & below)] = e;
        qn += __popc(ball);
        __syncwarp();
        if (qn >= 32) {
            const long long x = q[lane];
            out[x] = expr::eval(prog, n_ins, out_reg, regs, slots, src, dst,
                                x) ? 1 : 0;
            __syncwarp();
            if (lane < qn - 32) q[lane] = q[32 + lane];
            qn -= 32;
            __syncwarp();
        }
    }
    if (lane < qn) {
        const long long x = q[lane];
        out[x] = expr::eval(prog, n_ins, out_reg, regs, slots, src, dst, x)
                     ? 1 : 0;
    }
}

// make_bfs_kernel's body after the hop (kernels.py:340-347) and the
// next loop condition's two reductions.
__global__ void edge_bfs_level_kernel(uint8_t* __restrict__ reached,
                                      int32_t* __restrict__ d,
                                      const uint8_t* __restrict__ targets,
                                      int32_t* __restrict__ flags,
                                      int step, int first, int stop,
                                      long long n) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    int any_new = 0, any_open = 0;
    for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         v < n; v += stride) {
        const bool r = reached[v] != 0;
        int32_t dv;
        bool newly;
        if (first) {
            dv = r ? 0 : kInt32Inf;
            newly = r;
        } else {
            dv = d[v];
            newly = r && dv == kInt32Inf;
            if (newly) dv = step + 1;
            reached[v] = newly ? 1 : 0;
        }
        if (first || newly) d[v] = dv;
        any_new |= newly;
        if (stop) any_open |= (targets[v] != 0) && dv == kInt32Inf;
    }
    any_new = __syncthreads_or(any_new);
    any_open = __syncthreads_or(any_open);
    if (threadIdx.x == 0) {
        if (any_new) atomicOr(&flags[0], 1);
        if (any_open) atomicOr(&flags[1], 1);
    }
}

}  // namespace

extern "C" {

int edge_seed(void* f, const void* idx, int64_t S, int64_t n,
              void* stream) {
    if (n <= 0 || S < 0) return -1;
    edge_seed_kernel<<<(unsigned)((n + kSeedTile - 1) / kSeedTile),
                       kThreads, 0, (cudaStream_t)stream>>>(
        (uint8_t*)f, (const int32_t*)idx, S, n);
    return (int)cudaGetLastError();
}

// K8: out bool [n] (zeroed here) = the OVER edges' destinations of the
// live sources: the frontier f [n], or with f null the start ids
// [count].  Each tile's edges are shared among as many blocks as give
// about kHopBlocksPerSM blocks an SM, at most kHopMaxSplit.
int edge_hop(const void* f, const void* ids, int64_t count, void* out,
             const void* row_ptr, const void* dst, const void* et,
             int64_t n, const int32_t* over, int n_over, void* stream) {
    OverSet ov;
    if (n <= 0 || count < 0 || (f == nullptr) == (ids == nullptr) ||
        !over_set(over, n_over, &ov))
        return -1;
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t rc = cudaMemsetAsync(out, 0, (size_t)n, st);
    if (rc != cudaSuccess) return (int)rc;
    const long long items = f != nullptr ? n : count;
    if (items == 0) return (int)cudaGetLastError();
    const long long tiles = (items + kHopTile - 1) / kHopTile;
    const int sms = sm_count();
    if (sms == 0) return (int)cudaErrorInvalidDevice;
    const long long want = (long long)sms * kHopBlocksPerSM;
    long long split = (want + tiles - 1) / tiles;
    if (split > kHopMaxSplit) split = kHopMaxSplit;
    edge_hop_kernel<<<dim3((unsigned)tiles, (unsigned)split), kHopThreads,
                      0, st>>>(
        (const uint8_t*)f, (const int32_t*)ids, count, (uint8_t*)out,
        (const int32_t*)row_ptr, (const int32_t*)dst, (const int32_t*)et, n,
        ov);
    return (int)cudaGetLastError();
}

int edge_scan_hop(const void* f, void* out, const void* src,
                  const void* dst, const void* et, int64_t m, int64_t n,
                  const int32_t* over, int n_over, void* stream) {
    OverSet ov;
    if (n <= 0 || m < 0 || !over_set(over, n_over, &ov)) return -1;
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t rc = cudaMemsetAsync(out, 0, (size_t)n, st);
    if (rc != cudaSuccess) return (int)rc;
    if (m > 0)
        edge_scan_hop_kernel<<<grid_for(m), kThreads, 0, st>>>(
            (const uint8_t*)f, (uint8_t*)out, (const int32_t*)src,
            (const int32_t*)dst, (const int32_t*)et, m, ov);
    return (int)cudaGetLastError();
}

int edge_final(const void* f, const void* src, const void* et,
               const void* fmask, void* out, int64_t m,
               const int32_t* over, int n_over, void* stream) {
    OverSet ov;
    if (m < 0 || !over_set(over, n_over, &ov)) return -1;
    if (m == 0) return (int)cudaGetLastError();
    edge_final_kernel<<<grid_for(m), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)f, (const int32_t*)src, (const int32_t*)et,
        (const uint8_t*)fmask, (uint8_t*)out, m, ov);
    return (int)cudaGetLastError();
}

// go_filtered's final pass: out bool [m] = f[src] && etype in OVER &&
// the WHERE (ins: int32 [n_ins, 5] on the card, n_regs registers, the
// slot table as expr_filter takes it), the WHERE run only where the
// first two hold.
int edge_final_where(const void* f, const void* src, const void* dst,
                     const void* et, const int32_t* over, int n_over,
                     const void* ins, int n_ins, int n_regs, int out_reg,
                     ExprSlots slots, int64_t m, void* out, void* stream) {
    OverSet ov;
    if (m < 0 || !over_set(over, n_over, &ov) ||
        !expr::program_ok(n_ins, n_regs, out_reg, slots))
        return -1;
    if (m == 0) return (int)cudaGetLastError();
    const int sms = sm_count();
    if (sms == 0) return (int)cudaErrorInvalidDevice;
    const long long most = (long long)sms * kFinalBlocksPerSM;
    const long long need = (m + kThreads - 1) / kThreads;
    edge_final_where_kernel<<<(unsigned)(need < most ? need : most),
                              kThreads,
                              expr::smem_bytes(n_ins, n_regs, kThreads),
                              (cudaStream_t)stream>>>(
        (const uint8_t*)f, (const int32_t*)src, (const int32_t*)dst,
        (const int32_t*)et, ov, (const int32_t*)ins, n_ins, out_reg, slots,
        m, (uint8_t*)out);
    return (int)cudaGetLastError();
}

int edge_bfs_level(void* reached, void* d, const void* targets,
                   void* flags, int step, int first, int stop, int64_t n,
                   void* stream) {
    if (n <= 0 || step < 0 || (stop && targets == nullptr)) return -1;
    edge_bfs_level_kernel<<<grid_for(n), kThreads, 0,
                            (cudaStream_t)stream>>>(
        (uint8_t*)reached, (int32_t*)d, (const uint8_t*)targets,
        (int32_t*)flags, step, first, stop, n);
    return (int)cudaGetLastError();
}

}  // extern "C"
