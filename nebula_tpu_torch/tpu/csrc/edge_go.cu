// Edge-list GO and BFS kernels for Hopper (sm_90a), behind a plain C
// interface that nebula_tpu_torch/tpu/edge_ops.py loads with ctypes.
//
// Replaces the edge-list programs of nebula_tpu/tpu/kernels.py:
//   make_go_kernel (:284, body _go_body :264) = edge_seed + edge_hop x
//       (steps - 1) + edge_final
//   make_go_filtered_kernel (:296) = edge_seed + edge_hop x (steps - 1)
//       + edge_final_where: K9's test with the WHERE (expr_core.cuh)
//       evaluated inside it, on the edges that pass the test only
//   make_bfs_kernel (:315) = edge_seed x 2 + edge_bfs_level (first) +
//       per level edge_hop + edge_bfs_level; the host reads the level's
//       two flags before launching the next, as jax.lax.while_loop
//       tests its condition.
//
// Layout: edge_src / edge_dst / edge_etype int32 [m] (the mirror's edge
// arrays, both directions, signed etypes); a frontier is one byte a
// vertex, bool [n]; depths int32 [n] with INT32_INF for unreached.
//
// Bound on this card: device-memory bytes.  A hop reads 12 bytes an
// edge (src, dst, etype) plus the frontier bytes its sources gather
// (scattered, a 32-byte sector each when sparse); at the serve graph's
// 8,385,118 edge rows that is 100.6 MB, 30.0 us at 3.35 TB/s.  The
// final mask reads src and etype (8 B) and writes 1 B an edge.  Design:
// one thread an edge, grid-stride; the hop's scatter-max of the
// reference becomes a plain store of 1 (every writer stores the same
// byte, so no atomic is needed) into a buffer zeroed first by
// cudaMemsetAsync; the two frontier buffers ping-pong.  BFS levels are
// one thread a vertex; the loop flags are a block OR and one atomicOr.
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

// kernels.py bitmap_from_idx: f[idx[i]] = 1 for every id in [0, n).
__global__ void edge_seed_kernel(uint8_t* __restrict__ f,
                                 const int32_t* __restrict__ idx,
                                 long long S, long long n) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < S; i += stride) {
        const int32_t v = idx[i];
        if (v >= 0 && v < n) f[v] = 1;
    }
}

// _go_body's hop: next = zeros(n).at[dst].max(f[src] & ok).
__global__ void edge_hop_kernel(const uint8_t* __restrict__ f,
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
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t rc = cudaMemsetAsync(f, 0, (size_t)n, st);
    if (rc != cudaSuccess) return (int)rc;
    if (S > 0)
        edge_seed_kernel<<<grid_for(S), kThreads, 0, st>>>(
            (uint8_t*)f, (const int32_t*)idx, S, n);
    return (int)cudaGetLastError();
}

int edge_hop(const void* f, void* out, const void* src, const void* dst,
             const void* et, int64_t m, int64_t n, const int32_t* over,
             int n_over, void* stream) {
    OverSet ov;
    if (n <= 0 || m < 0 || !over_set(over, n_over, &ov)) return -1;
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t rc = cudaMemsetAsync(out, 0, (size_t)n, st);
    if (rc != cudaSuccess) return (int)rc;
    if (m > 0)
        edge_hop_kernel<<<grid_for(m), kThreads, 0, st>>>(
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
