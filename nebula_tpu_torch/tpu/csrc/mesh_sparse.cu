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
//                      its owner d = u / chunk: into the block the owner
//                      receives from this shard (int64 [1 + cap]: the
//                      block's count, then up to cap keys q << 32 | u)
//                      when the owner shares the card, else into this
//                      shard's send block for d, which mesh.all_to_all
//                      copies across; the count covers every pair
//                      sent, a count past cap raises the overflow.
//                      Hub mode sends (q, e0 + j), j < ecnt, for each
//                      pair whose row owns an extra-row run, and checks
//                      the runs' 64-bit total against the budget (the
//                      list's length) and the per-pair clamp, as
//                      _segmented_hub_iota (ell.py:402) does.
//   X2 mesh_mark       the owner ORs every received key into its mark
//                      bitmap [q rows, ceil(chunk / 32)] as bit
//                      (q, u - base); K5 then compacts the bitmap and
//                      clears the exchange blocks the hop consumed
//                      (mesh_dedup: X2 and K5 in one call).
//   agree              the overflow agreed over every shard of a card.
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
// Each stage runs once for all the shards that share a card (a card
// group; blockIdx.y is the member): their buffers are [members, ...]
// slabs — the start and frontier lists [members, c], ctl [members, 8],
// the mark bitmaps [members, words], and the exchange slabs [members, k,
// 1 + cap]: a receive slab holds member m's block from every mesh shard
// s at [m, s], a send slab member m's block for every mesh shard d at
// [m, d] (only blocks for owners on other cards are used).  The
// members' tables come by value (MeshCard).
//
// Every kernel runs on the caller's stream, allocates nothing and does
// not synchronise; each entry point returns cudaGetLastError() after
// its launches (0 = launched, -1 = an argument the kernels cannot
// take).  Bound on this card: bytes — X1 the list's ids, the live
// pairs' qids and slot rows (8 bytes a slot) and the keys written, X2
// the keys read and their bitmap words, X3 the list's ids and the live
// pairs' qids, depth and target cells; a pad moves its ids word only,
// which matters because a BFS level's list is mostly pads.  The per-owner
// counters are few (k a source) and every candidate adds to one: a wide
// frontier serialises on them; the design keeps them because the
// reference's sort would cost more bytes, and a warp-aggregated add is
// the next step if the counters show in a profile.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kCardShards = 16;           // members of one launch
constexpr int kMaxShards = 32;            // shards of a mesh

// A card group of the frontier-sharded mesh, by value (global scope: the
// extern "C" entries take it): each member's tables (its local bucket
// blocks, nbr / et, and its chunk of the hub expansion, ecnt / e0) and
// its shard s in the mesh; near[d] is mesh shard d's member index on
// this card, -1 when d sits on another card.
struct MeshCard {
    const int32_t* nbr[kCardShards];
    const int32_t* et[kCardShards];
    const int32_t* ecnt[kCardShards];
    const int32_t* e0[kCardShards];
    long long shard[kCardShards];
    int near[kMaxShards];
    int n;
    int k;
};

// csrc/sparse_go.cu: K5 over a card's members
extern "C" int sg_compact_card(void* mark, int64_t words, int64_t R1w,
                               int64_t c_out, void* ids_out, void* qid_out,
                               int64_t ids_stride, void* scan, void* ctl,
                               int64_t n_rows, int members,
                               const int64_t* bases, const int32_t* shards,
                               int k, void* const* slabs,
                               const int64_t* caps, const int32_t* recv,
                               void* stream);

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBuckets = 32;
constexpr int kMaxOver = 32;
constexpr int kCtlWords = 8;
constexpr int32_t kBigQ = 1 << 30;            // ell.py BIG_Q
constexpr int16_t kInf16 = 0x7FFF;            // ell.py INT16_INF

// ctl: int64 [8], a shard's device-side scalars (ell_ops.CTL_*).
constexpr int kOvf = 1;       // sticky overflow
constexpr int kHubTotal = 2;  // hub mode: the extra-row runs' total
constexpr int kLive = 6;      // BFS: live pairs stamped this level
constexpr int kUnfound = 7;   // BFS: target cells still unset

// The buckets, the same for every shard (every shard's block of a
// bucket is padded to mx rows): a shard's block of bucket b starts at
// global row max(g0, its first row).
struct MeshBuckets {
    long long g0[kMaxBuckets];     // bucket's first global row
    long long g1[kMaxBuckets];     // one past its last
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

// One pair's key from member y (shard s) into the block its owner d =
// u / chunk receives from s: in the receive slab when d shares the
// card, else in y's send block for d.  A place past cap is counted and
// raises the overflow.
__device__ __forceinline__ void send_pair(const MeshCard& cd, int y,
                                          long long* recv, long long* send,
                                          long long cap, long long chunk,
                                          long long q, long long u,
                                          long long* ctl) {
    const long long d = u / chunk;
    const int m = cd.near[d];
    long long* blk = m >= 0
        ? recv + ((long long)m * cd.k + cd.shard[y]) * (1 + cap)
        : send + ((long long)y * cd.k + d) * (1 + cap);
    const unsigned long long pos = atomicAdd(
        reinterpret_cast<unsigned long long*>(blk), 1ULL);
    if ((long long)pos < cap)
        blk[1 + pos] = (q << 32) | u;
    else
        ctl[kOvf] = 1;
}

// ---------------------------------------------------------------- X1
// Candidate mode, member y: warp p < c_in takes the member's pair p
// (live when ids[p] is a real row), warp c_in + j the j-th hub key it
// received (block j / hub_cap of its hub receive row, live below the
// block's count and cap).
__global__ void route_cand_kernel(MeshCard cd, MeshBuckets bk, OverSet neg,
                                  const int32_t* __restrict__ ids,
                                  const int32_t* __restrict__ qid,
                                  long long c_in,
                                  const long long* __restrict__ hub,
                                  long long hub_cap, long long n_rows,
                                  long long chunk,
                                  long long* __restrict__ recv,
                                  long long* __restrict__ send,
                                  long long cap,
                                  long long* __restrict__ ctl) {
    const int y = (int)blockIdx.y;
    const long long base = cd.shard[y] * chunk;
    ids += y * c_in;
    qid += y * c_in;
    ctl += y * kCtlWords;
    const int32_t* __restrict__ nbr = cd.nbr[y];
    const int32_t* __restrict__ et = cd.et[y];
    const long long* hb = hub ? hub + (long long)y * cd.k * (1 + hub_cap)
                              : nullptr;
    const int lane = threadIdx.x & 31;
    const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
    const long long total = c_in + (hb ? (long long)cd.k * hub_cap : 0);
    for (long long p = ((long long)blockIdx.x * blockDim.x + threadIdx.x)
                       >> 5;
         p < total; p += warps) {
        long long v, q = -1;                     // q: read once live
        if (p < c_in) {
            v = ids[p];
        } else {
            const long long j = p - c_in;
            const long long* blk = hb + (j / hub_cap) * (1 + hub_cap);
            const long long i = j % hub_cap;
            const long long cnt = blk[0] < hub_cap ? blk[0] : hub_cap;
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
        const long long lo = bk.g0[b] > base ? bk.g0[b] : base;
        const long long loc = v - lo;
        if (loc < 0 || loc >= bk.mx[b]) continue;
        const int D = bk.D[b];
        const long long first = bk.slot0[b] + loc * D;
        for (int j = lane; j < D; j += 32) {
            const int e = et[first + j];
            bool ok = false;
            for (int t = 0; t < neg.n; ++t) ok |= (e == neg.et[t]);
            if (!ok) continue;
            const long long u = nbr[first + j];
            if (u < 0 || u >= n_rows) continue;
            send_pair(cd, y, recv, send, cap, chunk, q, u, ctl);
        }
    }
}

// Hub mode, member y: warp p takes the member's pair p; a live pair
// whose row owns a run of ecnt extra rows sends (q, e0 + j) for j <
// ecnt.  Lane 0 adds the run to the 64-bit total: the add that carries
// it past ex (the budget) raises the overflow, as does a run past
// c_lim.  The total starts at 0 (the slab's memset, then each hop's K5).
__global__ void route_hub_kernel(MeshCard cd,
                                 const int32_t* __restrict__ ids,
                                 const int32_t* __restrict__ qid,
                                 long long c_in, long long n_rows,
                                 long long chunk,
                                 long long* __restrict__ recv,
                                 long long* __restrict__ send,
                                 long long cap, long long* __restrict__ ctl,
                                 long long ex, long long c_lim) {
    const int y = (int)blockIdx.y;
    const long long base = cd.shard[y] * chunk;
    ids += y * c_in;
    qid += y * c_in;
    ctl += y * kCtlWords;
    const int32_t* __restrict__ ecnt = cd.ecnt[y];
    const int32_t* __restrict__ e0 = cd.e0[y];
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
            send_pair(cd, y, recv, send, cap, chunk, q, r, ctl);
        }
    }
}

// ---------------------------------------------------------------- X2
// Member y ORs every live key of its receive row (k blocks) into its
// mark bitmap as bit (q, u - its first row).
__global__ void mark_kernel(MeshCard cd, const long long* __restrict__ recv,
                            long long cap, long long chunk,
                            uint32_t* __restrict__ mark, long long W,
                            long long words) {
    const int y = (int)blockIdx.y;
    const long long base = cd.shard[y] * chunk;
    recv += (long long)y * cd.k * (1 + cap);
    mark += y * words;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         t < cd.k * cap; t += stride) {
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

// The overflow agreed over a card's members (the reference's psum,
// ell.py:2148): one warp ORs their ctl[kOvf] words into every one.
__global__ void agree_kernel(long long* __restrict__ ctl, int members) {
    const int t = threadIdx.x;
    const bool o = t < members && ctl[(long long)t * kCtlWords + kOvf] != 0;
    const unsigned any = __any_sync(0xFFFFFFFFu, o);
    if (t < members) ctl[(long long)t * kCtlWords + kOvf] = any ? 1 : 0;
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

static bool card_ok(const MeshCard& cd) {
    if (cd.n < 1 || cd.n > kCardShards || cd.k < 1 || cd.k > kMaxShards)
        return false;
    for (int d = 0; d < cd.k; ++d)
        if (cd.near[d] >= cd.n) return false;
    return true;
}

// X1 for every member of a card.  ids / qid: [members, c_in]; recv /
// send: [members, k, 1 + cap] (send null when every owner shares the
// card); ctl: [members, 8]; bucket_desc: host int64 [n_buckets * 5]
// (g0, g1, mx, slot0, D); neg: host int32 [n_neg], the negated OVER
// set.  hub != 0: hub mode (the members' ecnt / e0, the budget c_in);
// else hub_recv [members, k, 1 + hub_cap] are the hub pairs received
// (null: none).
int mesh_route(int hub, MeshCard cd, const void* ids, const void* qid,
               int64_t c_in, const void* hub_recv, int64_t hub_cap,
               const int64_t* bucket_desc, int n_buckets,
               const int32_t* neg, int n_neg, int64_t chunk,
               int64_t n_rows, void* recv, void* send, int64_t cap,
               void* ctl, int64_t c_lim, void* stream) {
    if (!card_ok(cd) || n_buckets < 1 || n_buckets > kMaxBuckets ||
        n_neg < 1 || n_neg > kMaxOver || c_in < 0 || chunk <= 0 ||
        cap <= 0 || (hub_recv && (hub || hub_cap <= 0)))
        return -1;
    for (int d = 0; d < cd.k; ++d)
        if (cd.near[d] < 0 && send == nullptr) return -1;
    cudaStream_t s = (cudaStream_t)stream;
    if (hub) {
        if (c_in == 0) return 0;
        route_hub_kernel<<<dim3(blocks_for(c_in * 32, kThreads),
                                (unsigned)cd.n), kThreads, 0, s>>>(
            cd, (const int32_t*)ids, (const int32_t*)qid, c_in, n_rows,
            chunk, (long long*)recv, (long long*)send, cap,
            (long long*)ctl, c_in, c_lim);
        return (int)cudaGetLastError();
    }
    MeshBuckets bk;
    bk.n = n_buckets;
    for (int b = 0; b < n_buckets; ++b) {
        bk.g0[b] = bucket_desc[5 * b];
        bk.g1[b] = bucket_desc[5 * b + 1];
        bk.mx[b] = bucket_desc[5 * b + 2];
        bk.slot0[b] = bucket_desc[5 * b + 3];
        bk.D[b] = (int)bucket_desc[5 * b + 4];
    }
    OverSet ov;
    ov.n = n_neg;
    for (int t = 0; t < n_neg; ++t) ov.et[t] = neg[t];
    const long long pairs = c_in + (hub_recv ? cd.k * hub_cap : 0);
    if (pairs == 0) return 0;
    route_cand_kernel<<<dim3(blocks_for(pairs * 32, kThreads),
                             (unsigned)cd.n), kThreads, 0, s>>>(
        cd, bk, ov, (const int32_t*)ids, (const int32_t*)qid, c_in,
        (const long long*)hub_recv, hub_cap, n_rows, chunk,
        (long long*)recv, (long long*)send, cap, (long long*)ctl);
    return (int)cudaGetLastError();
}

// X2 then K5 for every member of a card.  recv: [members, k, 1 + cap];
// mark: [members, words] uint32, W words a query row; ids_out /
// qid_out: [members, ids_stride]; scan: K5's look-back state (members *
// sg_compact_state(words) int64 words, zero before its first call);
// ctl: [members, 8]; slabs / caps / recvs: the four exchange slabs K5's
// finishing block clears (null: absent) and which of them are receive
// slabs.  Two launches: X2, then K5.
int mesh_dedup(MeshCard cd, const void* recv, int64_t cap, int64_t chunk,
               void* mark, int64_t W, int64_t words, int64_t c_out,
               void* ids_out, void* qid_out, int64_t ids_stride, void* scan,
               void* ctl, int64_t n_rows, void* const* slabs,
               const int64_t* caps, const int32_t* recvs, void* stream) {
    if (!card_ok(cd) || cap <= 0 || chunk <= 0 || W <= 0 || words <= 0 ||
        words % W != 0)
        return -1;
    cudaStream_t s = (cudaStream_t)stream;
    mark_kernel<<<dim3(blocks_for(cd.k * cap, kThreads), (unsigned)cd.n),
                  kThreads, 0, s>>>(cd, (const long long*)recv, cap, chunk,
                                    (uint32_t*)mark, W, words);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    int64_t bases[kCardShards];
    int32_t shards[kCardShards];
    for (int y = 0; y < cd.n; ++y) {
        bases[y] = cd.shard[y] * chunk;
        shards[y] = (int32_t)cd.shard[y];
    }
    return sg_compact_card(mark, words, W, c_out, ids_out, qid_out,
                           ids_stride, scan, ctl, n_rows, cd.n, bases,
                           shards, cd.k, slabs, caps, recvs, stream);
}

// The overflow agreement over a card's members: ctl [members, 8].
int mesh_agree(void* ctl, int members, void* stream) {
    if (members < 1 || members > kCardShards) return -1;
    agree_kernel<<<1, 32, 0, (cudaStream_t)stream>>>((long long*)ctl,
                                                     members);
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
