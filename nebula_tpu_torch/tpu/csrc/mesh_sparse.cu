// The frontier-sharded mesh's kernels for Hopper (sm_90a), behind a
// plain C interface that nebula_tpu_torch/tpu/ell_ops.py loads with
// ctypes.
//
// Replaces nebula_tpu/tpu/ell.py:1954 _mesh_sparse_tools' per-device
// blocks inside ell.py:2052 make_frontier_sharded_sparse_go_kernel
// (mesh_sparse_go) and ell.py:2179 make_frontier_sharded_sparse_bfs_
// kernel (mesh_sparse_bfs).  Shard s owns global rows [s * chunk,
// (s + 1) * chunk) and keeps its pairs of every query's frontier as a
// (qid, row) list.  The reference sorts every candidate by (owner, q,
// u) to route it, and sorts again at the owner to dedup; here a
// candidate goes straight to its owner's slot block through a per-
// owner atomic counter, and the owner's dedup is a mark bitmap that
// the sparse GO's K5 pair_compact (csrc/sparse_go.cu) scans in (q, row)
// order (with the shard's row base), so neither side sorts:
//
//   X1 mesh_route      one warp per live pair walks the pair's row in
//                      the shard's local bucket block and sends every
//                      slot whose etype is in the negated OVER set to
//                      slot block u / chunk of the exchange buffer
//                      (int64 [k, 1 + cap]: the block's count, then up
//                      to cap keys q << 32 | u); the count covers every
//                      pair sent, a count past cap raises the overflow.
//                      Hub mode sends (q, e0 + j), j < ecnt, for each
//                      pair whose row owns an extra-row run, and checks
//                      the runs' 64-bit total against the budget (the
//                      list's length) and the per-pair clamp, as
//                      _segmented_hub_iota (ell.py:402) does.
//   X2 mesh_mark       the owner ORs every received key into its mark
//                      bitmap [q rows, ceil(chunk / 32)] as bit
//                      (q, u - base).
//   X3 mesh_bfs_stamp  the BFS level: each compacted pair whose depth
//                      [chunk, qmax] is unset gets step + 1 and stays
//                      in the frontier, the other live ones become
//                      the pad (K5's pads are left as they are); it
//                      counts the live pairs and takes the targets it
//                      reaches off the shard's count of unfound target
//                      cells.  Its init stamps the starts at depth 0,
//                      sets the target bitmap and counts the unfound
//                      target cells.
//
// Every kernel runs on the caller's stream, allocates nothing and does
// not synchronise; each entry point returns cudaGetLastError() after
// its launches (0 = launched, -1 = an argument the kernels cannot
// take).  Bound on this card: bytes — X1 the list's ids, the live
// pairs' qids and slot rows (8 bytes a slot) and the keys written, X2
// the keys read and their bitmap words, X3 the list's ids and the live
// pairs' qids, depth and target cells; a pad moves its ids word only,
// which matters because a BFS level's list is mostly pads.  The per-owner
// counters are few (k) and every candidate adds to one: a wide frontier
// serialises on them; the design keeps them because the reference's
// sort would cost more bytes, and a warp-aggregated add is the next
// step if the counters show.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBuckets = 32;
constexpr int kMaxOver = 32;
constexpr int kMaxShards = 32;
constexpr int32_t kBigQ = 1 << 30;            // ell.py BIG_Q
constexpr int16_t kInf16 = 0x7FFF;            // ell.py INT16_INF

// ctl: int64 [8], a shard's device-side scalars (ell_ops.CTL_*).
constexpr int kOvf = 1;       // sticky overflow
constexpr int kHubTotal = 2;  // hub mode: the extra-row runs' total
constexpr int kLive = 6;      // BFS: live pairs stamped this level
constexpr int kUnfound = 7;   // BFS: target cells still unset

struct MeshBuckets {
    long long g0[kMaxBuckets];     // bucket's first global row
    long long g1[kMaxBuckets];     // one past its last
    long long lo[kMaxBuckets];     // global row of block row 0
    long long mx[kMaxBuckets];     // block rows
    long long slot0[kMaxBuckets];  // block's first slot
    int D[kMaxBuckets];
    int n;
};

struct OverSet {
    int et[kMaxOver];
    int n;
};

inline unsigned blocks_for(long long threads, int per_block) {
    long long b = (threads + per_block - 1) / per_block;
    if (b > (1LL << 30)) b = 1LL << 30;
    return (unsigned)(b < 1 ? 1 : b);
}

// One pair's key into its owner's slot block; a place past cap is
// counted and raises the overflow.
__device__ __forceinline__ void send_pair(long long* send, long long cap,
                                          long long chunk, long long q,
                                          long long u, long long* ctl) {
    long long* blk = send + (u / chunk) * (1 + cap);
    const unsigned long long pos = atomicAdd(
        reinterpret_cast<unsigned long long*>(blk), 1ULL);
    if ((long long)pos < cap)
        blk[1 + pos] = (q << 32) | u;
    else
        ctl[kOvf] = 1;
}

// The send buffer's k counts (and, in hub mode, the runs' total) to 0.
__global__ void route_reset_kernel(long long* send, long long cap, int k,
                                   long long* ctl, int hub) {
    const int t = threadIdx.x;
    if (t < k) send[(long long)t * (1 + cap)] = 0;
    if (t == 0 && hub) ctl[kHubTotal] = 0;
}

// ---------------------------------------------------------------- X1
// Candidate mode: warp p < c_in takes the shard's pair p (live when
// ids[p] is a real row), warp c_in + j the j-th received hub key
// (block j / recv_cap, live below the block's count and cap).
__global__ void route_cand_kernel(const int32_t* __restrict__ ids,
                                  const int32_t* __restrict__ qid,
                                  long long c_in,
                                  const long long* __restrict__ recv,
                                  long long recv_cap, int recv_blocks,
                                  const int32_t* __restrict__ nbr,
                                  const int32_t* __restrict__ et,
                                  MeshBuckets bk, OverSet neg,
                                  long long n_rows, long long chunk,
                                  long long* __restrict__ send,
                                  long long cap,
                                  long long* __restrict__ ctl) {
    const int lane = threadIdx.x & 31;
    const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
    const long long total = c_in + (long long)recv_blocks * recv_cap;
    for (long long p = ((long long)blockIdx.x * blockDim.x + threadIdx.x)
                       >> 5;
         p < total; p += warps) {
        long long v, q = -1;                     // q: read once live
        if (p < c_in) {
            v = ids[p];
        } else {
            const long long j = p - c_in;
            const long long* blk = recv + (j / recv_cap) * (1 + recv_cap);
            const long long i = j % recv_cap;
            const long long cnt = blk[0] < recv_cap ? blk[0] : recv_cap;
            if (i >= cnt) continue;
            const long long key = blk[1 + i];
            q = key >> 32;
            v = key & 0xFFFFFFFFLL;
        }
        if (v < 0 || v >= n_rows) continue;      // the pad: inactive
        if (p < c_in) q = qid[p];
        int b = -1;
        for (int t = 0; t < bk.n; ++t)
            if (v >= bk.g0[t] && v < bk.g1[t]) b = t;
        if (b < 0) continue;
        const long long loc = v - bk.lo[b];
        if (loc < 0 || loc >= bk.mx[b]) continue;
        const int D = bk.D[b];
        const long long base = bk.slot0[b] + loc * D;
        for (int j = lane; j < D; j += 32) {
            const int e = et[base + j];
            bool ok = false;
            for (int t = 0; t < neg.n; ++t) ok |= (e == neg.et[t]);
            if (!ok) continue;
            const long long u = nbr[base + j];
            if (u < 0 || u >= n_rows) continue;
            send_pair(send, cap, chunk, q, u, ctl);
        }
    }
}

// Hub mode: warp p takes the shard's pair p; a live pair whose row
// owns a run of ecnt extra rows sends (q, e0 + j) for j < ecnt.  Lane
// 0 adds the run to the 64-bit total: the add that carries it past ex
// (the budget) raises the overflow, as does a run past c_lim.
__global__ void route_hub_kernel(const int32_t* __restrict__ ids,
                                 const int32_t* __restrict__ qid,
                                 long long c_in,
                                 const int32_t* __restrict__ ecnt,
                                 const int32_t* __restrict__ e0,
                                 long long base, long long n_rows,
                                 long long chunk,
                                 long long* __restrict__ send,
                                 long long cap, long long* __restrict__ ctl,
                                 long long ex, long long c_lim) {
    const int lane = threadIdx.x & 31;
    const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
    for (long long p = ((long long)blockIdx.x * blockDim.x + threadIdx.x)
                       >> 5;
         p < c_in; p += warps) {
        const long long v = ids[p];
        if (v < 0 || v >= n_rows) continue;
        long long li = v - base;
        li = li < 0 ? 0 : (li >= chunk ? chunk - 1 : li);
        const long long ce = ecnt[li];
        if (ce <= 0) continue;
        const long long first = e0[li];
        const long long q = qid[p];
        if (lane == 0) {
            const unsigned long long old = atomicAdd(
                reinterpret_cast<unsigned long long*>(ctl + kHubTotal),
                (unsigned long long)ce);
            if ((long long)old + ce > ex || ce > c_lim) ctl[kOvf] = 1;
        }
        for (long long j = lane; j < ce; j += 32) {
            const long long r = first + j;
            if (r < 0 || r >= n_rows) continue;
            send_pair(send, cap, chunk, q, r, ctl);
        }
    }
}

// ---------------------------------------------------------------- X2
__global__ void mark_kernel(const long long* __restrict__ recv,
                            long long blocks, long long cap, long long base,
                            long long chunk, uint32_t* __restrict__ mark,
                            long long W, long long words) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         t < blocks * cap; t += stride) {
        const long long* blk = recv + (t / cap) * (1 + cap);
        const long long i = t % cap;
        const long long cnt = blk[0] < cap ? blk[0] : cap;
        if (i >= cnt) continue;
        const long long key = blk[1 + i];
        const long long q = key >> 32;
        const long long li = (key & 0xFFFFFFFFLL) - base;
        if (li < 0 || li >= chunk || q < 0) continue;
        const long long w = q * W + (li >> 5);
        if (w >= words) continue;
        atomicOr(mark + w, 1u << (li & 31));
    }
}

// ---------------------------------------------------------------- X3
__device__ __forceinline__ long long clampll(long long x, long long hi) {
    return x < 0 ? 0 : (x > hi ? hi : x);
}

// Init, pass 1: depth 0 at every live start; ctl[kLive] counts them.
__global__ void stamp_starts_kernel(const int32_t* __restrict__ ids,
                                    const int32_t* __restrict__ qid,
                                    long long c, int16_t* __restrict__ depth,
                                    long long chunk, long long qmax,
                                    long long base, long long n_rows,
                                    long long* __restrict__ ctl) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < c; i += stride) {
        const long long u = ids[i];
        if (u == n_rows) continue;
        const long long li = clampll(u - base, chunk - 1);
        const long long q = clampll(qid[i], qmax - 1);
        depth[li * qmax + q] = 0;
        atomicAdd(reinterpret_cast<unsigned long long*>(ctl + kLive), 1ULL);
    }
}

// Init, pass 2: each live target sets its bit; the first to set a bit
// whose depth is still unset adds one unfound cell.
__global__ void stamp_targets_kernel(const int32_t* __restrict__ tids,
                                     const int32_t* __restrict__ tqid,
                                     long long c,
                                     const int16_t* __restrict__ depth,
                                     long long chunk, long long qmax,
                                     uint32_t* __restrict__ tbits,
                                     long long W, long long base,
                                     long long n_rows,
                                     long long* __restrict__ ctl) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < c; i += stride) {
        const long long u = tids[i];
        if (u == n_rows) continue;
        const long long li = clampll(u - base, chunk - 1);
        const long long q = clampll(tqid[i], qmax - 1);
        const uint32_t bit = 1u << (li & 31);
        const uint32_t old = atomicOr(tbits + q * W + (li >> 5), bit);
        if (!(old & bit) && depth[li * qmax + q] == kInf16)
            atomicAdd(reinterpret_cast<unsigned long long*>(ctl + kUnfound),
                      1ULL);
    }
}

// A level: the compacted pairs are distinct cells, so each depth cell
// is read and written by one thread at most.  A pad (n_rows, BIG_Q) as
// K5 writes it is read and left: only its ids word moves.
__global__ void stamp_level_kernel(int32_t* __restrict__ ids,
                                   int32_t* __restrict__ qid, long long c,
                                   int16_t* __restrict__ depth,
                                   long long chunk, long long qmax,
                                   const uint32_t* __restrict__ tbits,
                                   long long W, long long base,
                                   long long n_rows, int16_t next,
                                   long long* __restrict__ ctl) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < c; i += stride) {
        const long long u = ids[i];
        if (u == n_rows) continue;
        const long long li = clampll(u - base, chunk - 1);
        const long long q = clampll(qid[i], qmax - 1);
        int16_t* cell = depth + li * qmax + q;
        if (*cell == kInf16) {
            *cell = next;
            atomicAdd(reinterpret_cast<unsigned long long*>(ctl + kLive),
                      1ULL);
            if ((tbits[q * W + (li >> 5)] >> (li & 31)) & 1u)
                atomicAdd(reinterpret_cast<unsigned long long*>(
                              ctl + kUnfound),
                          ~0ULL);                 // one less
        } else {
            ids[i] = (int32_t)n_rows;
            qid[i] = kBigQ;
        }
    }
}

}  // namespace

extern "C" {

// X1.  bucket_desc: host int64 [n_buckets * 6] (g0, g1, lo, mx, slot0,
// D); neg: host int32 [n_neg], the negated OVER set.  hub != 0: hub mode
// (recv unused; ecnt / e0 the shard's chunk-local runs; the budget is
// c_in).  recv null or recv_blocks 0: no received pairs.
int mesh_route(int hub, const void* ids, const void* qid, int64_t c_in,
               const void* recv, int64_t recv_cap, int recv_blocks,
               const void* nbr, const void* et, const int64_t* bucket_desc,
               int n_buckets, const int32_t* neg, int n_neg,
               const void* ecnt, const void* e0, int64_t base,
               int64_t chunk, int64_t n_rows, void* send, int64_t cap,
               int k, void* ctl, int64_t c_lim, void* stream) {
    if (n_buckets < 1 || n_buckets > kMaxBuckets || n_neg < 1 ||
        n_neg > kMaxOver || c_in < 0 || chunk <= 0 || cap <= 0 || k < 1 ||
        k > kMaxShards || recv_blocks < 0 ||
        (recv_blocks > 0 && (recv == nullptr || recv_cap <= 0)))
        return -1;
    cudaStream_t s = (cudaStream_t)stream;
    route_reset_kernel<<<1, 32, 0, s>>>((long long*)send, cap, k,
                                        (long long*)ctl, hub);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (hub) {
        if (c_in == 0) return 0;
        route_hub_kernel<<<blocks_for(c_in * 32, kThreads), kThreads, 0,
                           s>>>(
            (const int32_t*)ids, (const int32_t*)qid, c_in,
            (const int32_t*)ecnt, (const int32_t*)e0, base, n_rows, chunk,
            (long long*)send, cap, (long long*)ctl, c_in, c_lim);
        return (int)cudaGetLastError();
    }
    MeshBuckets bk;
    bk.n = n_buckets;
    for (int b = 0; b < n_buckets; ++b) {
        bk.g0[b] = bucket_desc[6 * b];
        bk.g1[b] = bucket_desc[6 * b + 1];
        bk.lo[b] = bucket_desc[6 * b + 2];
        bk.mx[b] = bucket_desc[6 * b + 3];
        bk.slot0[b] = bucket_desc[6 * b + 4];
        bk.D[b] = (int)bucket_desc[6 * b + 5];
    }
    OverSet ov;
    ov.n = n_neg;
    for (int t = 0; t < n_neg; ++t) ov.et[t] = neg[t];
    const long long pairs = c_in + (long long)recv_blocks * recv_cap;
    if (pairs == 0) return 0;
    route_cand_kernel<<<blocks_for(pairs * 32, kThreads), kThreads, 0, s>>>(
        (const int32_t*)ids, (const int32_t*)qid, c_in,
        (const long long*)recv, recv_cap, recv_blocks, (const int32_t*)nbr,
        (const int32_t*)et, bk, ov, n_rows, chunk, (long long*)send, cap,
        (long long*)ctl);
    return (int)cudaGetLastError();
}

// X2.  recv: int64 [blocks, 1 + cap]; mark: uint32 [words], W words a
// query row.
int mesh_mark(const void* recv, int64_t blocks, int64_t cap, int64_t base,
              int64_t chunk, void* mark, int64_t W, int64_t words,
              void* stream) {
    if (blocks < 1 || cap <= 0 || chunk <= 0 || W <= 0 || words <= 0)
        return -1;
    mark_kernel<<<blocks_for(blocks * cap, kThreads), kThreads, 0,
                  (cudaStream_t)stream>>>(
        (const long long*)recv, blocks, cap, base, chunk, (uint32_t*)mark,
        W, words);
    return (int)cudaGetLastError();
}

// X3.  init != 0: the starts (ids, qid, c) and targets (tids, tqid, ct);
// else one level over the compacted list (ids, qid, c) at step.
int mesh_bfs_stamp(int init, void* ids, void* qid, int64_t c,
                   const void* tids, const void* tqid, int64_t ct,
                   void* depth, int64_t chunk, int64_t qmax, void* tbits,
                   int64_t W, int64_t base, int64_t n_rows, int64_t step,
                   void* ctl, void* stream) {
    if (c < 0 || chunk <= 0 || qmax <= 0 || W <= 0 || step < 0 ||
        step >= kInf16 - 1 || (init && (ct < 0 || (ct > 0 && !tids))))
        return -1;
    cudaStream_t s = (cudaStream_t)stream;
    if (init) {
        if (c > 0) {
            stamp_starts_kernel<<<blocks_for(c, kThreads), kThreads, 0,
                                  s>>>(
                (const int32_t*)ids, (const int32_t*)qid, c,
                (int16_t*)depth, chunk, qmax, base, n_rows,
                (long long*)ctl);
            cudaError_t err = cudaGetLastError();
            if (err != cudaSuccess) return (int)err;
        }
        if (ct > 0)
            stamp_targets_kernel<<<blocks_for(ct, kThreads), kThreads, 0,
                                   s>>>(
                (const int32_t*)tids, (const int32_t*)tqid, ct,
                (const int16_t*)depth, chunk, qmax, (uint32_t*)tbits, W,
                base, n_rows, (long long*)ctl);
        return (int)cudaGetLastError();
    }
    cudaError_t err = cudaMemsetAsync((long long*)ctl + kLive, 0,
                                      sizeof(long long), s);
    if (err != cudaSuccess) return (int)err;
    if (c == 0) return 0;
    stamp_level_kernel<<<blocks_for(c, kThreads), kThreads, 0, s>>>(
        (int32_t*)ids, (int32_t*)qid, c, (int16_t*)depth, chunk, qmax,
        (const uint32_t*)tbits, W, base, n_rows, (int16_t)(step + 1),
        (long long*)ctl);
    return (int)cudaGetLastError();
}

}  // extern "C"
