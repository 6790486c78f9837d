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
//   X1 mesh_route      each live pair's row, walked in the shard's
//                      local bucket block, sends every slot whose etype
//                      is in the negated OVER set to its owner d = u /
//                      chunk: into the block the owner receives from
//                      this shard (int64 [1 + cap]: the block's count,
//                      then up to cap keys q << 32 | u) when the owner
//                      shares the card, else into this shard's send
//                      block for d, which mesh.all_to_all copies across;
//                      the count covers every pair sent, a count past
//                      cap raises the overflow.  Hub mode sends (q, e0 +
//                      j), j < ecnt, for each pair whose row owns an
//                      extra-row run, and checks the runs' 64-bit total
//                      against the budget (the list's length) and the
//                      per-pair clamp, as _segmented_hub_iota
//                      (ell.py:402) does.
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
// the mark bitmaps [members, words], the BFS depth [members, chunk,
// qmax] and target bitmaps [members, words], and the exchange slabs
// [members, k, 1 + cap]: a receive slab holds member m's block from
// every mesh shard s at [m, s], a send slab member m's block for every
// mesh shard d at [m, d] (only blocks for owners on other cards are
// used).  The members' tables come by value (MeshCard).
//
// Every kernel runs on the caller's stream, allocates nothing and does
// not synchronise; each entry point returns cudaGetLastError() after
// its launches (0 = launched, -1 = an argument the kernels cannot
// take).  Bound on this card: bytes — X1 the live places' ids and qids
// and slot rows (8 bytes a slot) and the keys written, X2 the keys read
// and their bitmap words, X3 the live places' ids and qids, depth and
// target cells.  A list K5 built holds its live pairs in its first
// min(ctl[kCnt], c) places and pads after them (a BFS level's list of
// 2^17 places holds a few thousand), so X1 and X3 can be told to read
// that prefix only ("counted"; the count is read on the card, no host
// read); X3's init leaves the BFS starts' extent there too, and the
// GO's start list is read whole.  X1 and X3 are latency-bound at these
// sizes (the pair, then its row's slots, then the owner's counter), so:
//   - X1's grid is a few blocks an SM striding over the member's live
//     places and the hub keys it received (their blocks' counts read
//     once a block into shared memory, no division a key); a short
//     list's rows are cut into segments of kSeg slots, one a warp, so a
//     512-slot row is walked by four warps at once; a warp takes a tile
//     of T consecutive items, T = the items over the warps (1 to 32),
//     reads their ids and qids together and walks each live one with
//     every lane, kUnits slots a lane in flight (et and nbr together),
//     the OVER test a bitmask, the bucket found by a count over the
//     kernel's parameters; a walked segment's candidates count
//     themselves per owner in a warp histogram in shared memory, and one
//     lane an owner adds the count to its block (one atomicAdd an owner
//     a segment, where the parent added once a slot on k counters);
//   - hub mode gives a lane a place, one 64-bit add a tile to the runs'
//     total, and sends a run's keys with one atomicAdd an owner a round
//     (__match_any_sync on the owner, the leader adds the peers' count);
//   - X3 is one call a card group (init two launches: the starts' depth
//     0 must be stored before the targets read depth; a level one), a
//     thread kStampUnroll places loaded together, over a grid of a few
//     blocks an SM, a thread's first places read beside the count; each
//     block sums its fresh and found pairs into one 64-bit atomicAdd
//     that also takes a ticket, and the member's last block writes
//     ctl[kLive] and resets the scratch word, so no memset precedes the
//     launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm_count.cuh"

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
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBuckets = 32;
constexpr int kMaxOver = 32;
constexpr int kCtlWords = 8;
constexpr int kRouteBlocksPerSm = 8;       // X1's grid, over the members
constexpr int kUnits = 4;                  // X1: slots a lane loads at once
constexpr int kSeg = 32 * kUnits;          // X1: a row segment's slots
constexpr int kStampBlocksPerSm = 2;       // X3's grid, over the members
constexpr int kStampUnroll = 4;            // X3: places a thread loads at once
constexpr int kTicketBits = 24;            // X3: blocks a member, at most
constexpr int32_t kBigQ = 1 << 30;            // ell.py BIG_Q
constexpr int16_t kInf16 = 0x7FFF;            // ell.py INT16_INF
constexpr unsigned kFull = 0xFFFFFFFFu;

// ctl: int64 [8], a shard's device-side scalars (ell_ops.CTL_*).
constexpr int kCnt = 0;       // the list's count, as K5 left it
constexpr int kOvf = 1;       // sticky overflow
constexpr int kHubTotal = 2;  // hub mode: the extra-row runs' total
constexpr int kLive = 6;      // BFS: live pairs stamped this level
constexpr int kUnfound = 7;   // BFS: target cells still unset

// The buckets, the same for every shard (every shard's block of a
// bucket is padded to mx rows): a shard's block of bucket b starts at
// global row max(g0, its first row).  g0 nondecreasing (the wrapper
// checks), g1[b] = g0[b + 1] or n_rows for the last.
struct MeshBuckets {
    long long g0[kMaxBuckets];     // bucket's first global row
    long long g1[kMaxBuckets];     // one past its last
    long long mx[kMaxBuckets];     // block rows
    long long slot0[kMaxBuckets];  // block's first slot
    int D[kMaxBuckets];
    int n;
};

// The negated OVER set, with a bitmask of etype + 32 when every member
// lies in [-32, 31] (use_mask).
struct OverSet {
    int et[kMaxOver];
    int n;
    int use_mask;
    unsigned long long mask;
};

__device__ __forceinline__ bool in_neg(int e, const OverSet& ov) {
    if (ov.use_mask) {
        const unsigned k = (unsigned)(e + 32);
        return k < 64u && ((ov.mask >> k) & 1ull);
    }
    bool ok = false;
    for (int t = 0; t < ov.n; ++t) ok |= (e == ov.et[t]);
    return ok;
}

inline unsigned blocks_for(long long threads, int per_block) {
    long long b = (threads + per_block - 1) / per_block;
    if (b > (1LL << 30)) b = 1LL << 30;
    return (unsigned)(b < 1 ? 1 : b);
}

// A grid row of at most `per_sm` blocks an SM over the members (at
// least one), and at most `most`; 0 when the device cannot be queried.
inline unsigned member_blocks(int per_sm, int members, long long most) {
    const long long sms = sm_count();
    if (sms == 0) return 0;
    long long b = (per_sm * sms + members - 1) / members;
    if (b > most) b = most;
    return (unsigned)(b < 1 ? 1 : b);
}

// The places member y reads: min(ctl[kCnt], c) of a list whose live
// places lie below ctl[kCnt] (`counted`: K5's count, or the BFS starts'
// extent X3's init leaves), else all c.
__device__ __forceinline__ long long live_places(const long long* ctl,
                                                 long long c, int counted) {
    if (!counted) return c;
    const long long n = ctl[kCnt];
    return n < c ? (n < 0 ? 0 : n) : c;
}

// The block owner d receives from member y's shard: in the receive slab
// when d shares the card, else y's send block for d.
__device__ __forceinline__ long long* owner_block(const MeshCard& cd, int y,
                                                  long long* recv,
                                                  long long* send,
                                                  long long cap, int d) {
    const int m = cd.near[d];
    return m >= 0 ? recv + ((long long)m * cd.k + cd.shard[y]) * (1 + cap)
                  : send + ((long long)y * cd.k + d) * (1 + cap);
}

// The lanes of a warp with `has` send key q << 32 | u to owner d (each
// its own d) into owner_block(d).  The lanes bound for one owner take
// their places with one atomicAdd by their leader; a place past cap is
// counted and raises the overflow.  Every lane of the warp calls it.
__device__ __forceinline__ void send_keys(const MeshCard& cd, int y,
                                          long long* recv, long long* send,
                                          long long cap, bool has, int d,
                                          long long key, long long* ctl) {
    const unsigned any = __ballot_sync(kFull, has);
    if (!any) return;
    const unsigned peers = __match_any_sync(kFull, has ? d : -1);
    if (!has) return;
    const int lane = threadIdx.x & 31;
    const int leader = __ffs(peers) - 1;
    long long* blk = owner_block(cd, y, recv, send, cap, d);
    unsigned long long pos = 0;
    if (lane == leader)
        pos = atomicAdd(reinterpret_cast<unsigned long long*>(blk),
                        (unsigned long long)__popc(peers));
    pos = __shfl_sync(any, pos, leader)
          + __popc(peers & ((1u << lane) - 1u));
    if ((long long)pos < cap)
        blk[1 + pos] = key;
    else
        ctl[kOvf] = 1;
}

// ---------------------------------------------------------------- X1
// n <= kSeg consecutive slots from `first` of pair (q, ...) of member y:
// each lane loads kUnits slots (et and nbr together, all in flight),
// takes a place for each of its candidates in the warp's per-owner
// histogram `hist` (shared, zero between calls), lanes d < k add the
// counts to their owners' blocks (one atomicAdd an owner a call, all in
// flight) into `base`, and each candidate is stored at base + its place;
// a place past cap is counted and raises the overflow.  Every lane of
// the warp calls it.
__device__ __forceinline__ void route_slots(const MeshCard& cd, int y,
                                            const OverSet& neg,
                                            const int32_t* __restrict__ nbr,
                                            const int32_t* __restrict__ et,
                                            long long first, int n,
                                            long long q, long long n_rows,
                                            unsigned chunk, long long* recv,
                                            long long* send, long long cap,
                                            long long* ctl, int* hist,
                                            long long* base) {
    const int lane = threadIdx.x & 31;
    int e[kUnits], u[kUnits];
#pragma unroll
    for (int h = 0; h < kUnits; ++h) {
        const int j = lane + 32 * h;
        e[h] = 0;
        u[h] = -1;
        if (j < n) {
            e[h] = __ldg(et + first + j);
            u[h] = __ldg(nbr + first + j);
        }
    }
    int d[kUnits], off[kUnits];
#pragma unroll
    for (int h = 0; h < kUnits; ++h) {
        const bool has = u[h] >= 0 && u[h] < n_rows && in_neg(e[h], neg);
        d[h] = has ? (int)((unsigned)u[h] / chunk) : -1;
        off[h] = has ? atomicAdd(hist + d[h], 1) : 0;
    }
    __syncwarp();
    if (lane < cd.k && hist[lane]) {
        base[lane] = (long long)atomicAdd(
            reinterpret_cast<unsigned long long*>(
                owner_block(cd, y, recv, send, cap, lane)),
            (unsigned long long)hist[lane]);
        hist[lane] = 0;
    }
    __syncwarp();
#pragma unroll
    for (int h = 0; h < kUnits; ++h) {
        if (d[h] < 0) continue;
        const long long pos = base[d[h]] + off[h];
        if (pos < cap)
            owner_block(cd, y, recv, send, cap, d[h])[1 + pos] =
                (q << 32) | u[h];
        else
            ctl[kOvf] = 1;
    }
    __syncwarp();
}

// Pair (q, v) of member y (shard base `base`): its row in the shard's
// local block of v's bucket (the last bucket whose g0 <= v, found by a
// count over the kernel's parameters), its segment seg of kSeg slots
// (none past the row's end).  Every lane of the warp calls it with the
// same pair.
__device__ __forceinline__ void route_row(const MeshCard& cd, int y,
                                          const MeshBuckets& bk,
                                          const OverSet& neg,
                                          const int32_t* __restrict__ nbr,
                                          const int32_t* __restrict__ et,
                                          long long base, long long q,
                                          long long v, int seg,
                                          long long n_rows, unsigned chunk,
                                          long long* recv, long long* send,
                                          long long cap, long long* ctl,
                                          int* hist, long long* sbase) {
    int b = 0;
    for (int t = 1; t < bk.n; ++t) b += bk.g0[t] <= v;
    if (v < bk.g0[b] || v >= bk.g1[b]) return;
    const long long lo = bk.g0[b] > base ? bk.g0[b] : base;
    const long long loc = v - lo;
    if (loc < 0 || loc >= bk.mx[b]) return;
    const int D = bk.D[b];
    const int j0 = seg * kSeg;
    if (j0 >= D) return;
    route_slots(cd, y, neg, nbr, et, bk.slot0[b] + loc * D + j0,
                D - j0 < kSeg ? D - j0 : kSeg, q, n_rows, chunk, recv, send,
                cap, ctl, hist, sbase);
}

// Candidate mode, member y: the pairs it reads are its list's first
// `live` places (live_places), then the hub keys it received (hub
// receive block s holds min(count, hub_cap) keys from shard s; their
// counts read once a block into shared memory as an inclusive scan).
// An item is one of a pair's `segs` row segments of kSeg slots (segs:
// the longest row's; a segment past the row's end is empty), so a long
// row is walked by several warps at once: with an item a warp (T = 1)
// a pair's segments go to neighbouring warps, with tiles of T > 1 pairs
// (T = the items over the member's warps, at most 32) a tile holds one
// segment of T consecutive pairs.  Lane l < T reads pair l of its tile
// (id and qid together), the lanes past T repeat lane 0's, and the warp
// walks each live one; with T = 1 the warp's first pair is read beside
// the count.
__global__ void __launch_bounds__(kThreads)
route_cand_kernel(MeshCard cd, MeshBuckets bk, OverSet neg,
                  const int32_t* __restrict__ ids,
                  const int32_t* __restrict__ qid, long long c_in,
                  int counted, const long long* __restrict__ hub,
                  long long hub_cap, int segs, long long n_rows,
                  long long chunk, long long* __restrict__ recv,
                  long long* __restrict__ send, long long cap,
                  long long* __restrict__ ctl) {
    __shared__ long long hsum[kMaxShards + 1];  // hsum[s]: keys before s
    __shared__ int hist[kWarps][kMaxShards];
    __shared__ long long sbase[kWarps][kMaxShards];
    const int y = (int)blockIdx.y;
    const long long base = cd.shard[y] * chunk;
    ids += y * c_in;
    qid += y * c_in;
    ctl += y * kCtlWords;
    const int32_t* __restrict__ nbr = cd.nbr[y];
    const int32_t* __restrict__ et = cd.et[y];
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    const long long w0 = (long long)blockIdx.x * kWarps + wid;
    // the pair of the warp's first item if the list is short (an item a
    // segment, a warp an item), read beside the count
    const long long p0 = w0 / segs;
    const long long v0 = p0 < c_in ? __ldg(ids + p0) : -1;
    const long long q0 = p0 < c_in ? __ldg(qid + p0) : 0;
    const long long live = live_places(ctl, c_in, counted);
    hist[wid][lane] = 0;
    const long long* hb = hub ? hub + (long long)y * cd.k * (1 + hub_cap)
                              : nullptr;
    long long keys = 0;
    if (hb) {
        if (wid == 0) {
            long long n = 0;
            if (lane < cd.k) {
                n = hb[(long long)lane * (1 + hub_cap)];
                n = n < hub_cap ? n : hub_cap;
            }
            for (int o = 1; o < 32; o <<= 1) {
                const long long x = __shfl_up_sync(kFull, n, o);
                if (lane >= o) n += x;
            }
            hsum[lane + 1] = n;
            if (lane == 0) hsum[0] = 0;
        }
        __syncthreads();
        keys = hsum[cd.k];
    }
    __syncwarp();
    const long long pairs = live + keys;
    const long long warps = (long long)gridDim.x * kWarps;
    long long T = (pairs * segs + warps - 1) / warps;
    T = T < 1 ? 1 : (T > 32 ? 32 : T);
    const long long per_seg = (pairs + T - 1) / T;      // tiles a segment
    const unsigned tile = T == 32 ? kFull : (1u << T) - 1u;
    const unsigned uchunk = (unsigned)chunk;
    for (long long t = w0; t < per_seg * segs; t += warps) {
        long long p;
        int seg;
        if (T == 1) {                     // pair-major
            p = t / segs;
            seg = (int)(t - p * segs);
        } else {                          // segment-major
            seg = (int)(t / per_seg);
            p = (t - seg * per_seg) * T + (lane < T ? lane : 0);
        }
        long long v = -1, q = 0;
        if (p < live) {
            const bool first = T == 1 && p == p0;
            v = first ? v0 : __ldg(ids + p);
            q = first ? q0 : __ldg(qid + p);
        } else if (p < pairs) {
            const long long j = p - live;
            int s = 0;            // its hub block: hsum[s] <= j < hsum[s + 1]
            for (int r = 1; r < cd.k; ++r) s += hsum[r] <= j;
            const long long key =
                hb[(long long)s * (1 + hub_cap) + 1 + (j - hsum[s])];
            q = key >> 32;
            v = key & 0xFFFFFFFFLL;
        }
        const bool ok = p < pairs && v >= 0 && v < n_rows;
        if (T == 1) {                     // every lane holds the item
            if (ok)
                route_row(cd, y, bk, neg, nbr, et, base, q, v, seg, n_rows,
                          uchunk, recv, send, cap, ctl, hist[wid],
                          sbase[wid]);
            continue;
        }
        unsigned todo = __ballot_sync(kFull, ok) & tile;
        while (todo) {
            const int src = __ffs(todo) - 1;
            todo &= todo - 1u;
            route_row(cd, y, bk, neg, nbr, et, base,
                      __shfl_sync(kFull, q, src), __shfl_sync(kFull, v, src),
                      seg, n_rows, uchunk, recv, send, cap, ctl, hist[wid],
                      sbase[wid]);
        }
    }
}

// Hub mode, member y: a lane a place of the live prefix; a live pair
// whose row owns a run of ecnt extra rows sends (q, e0 + j) for j <
// ecnt, the whole warp on each run.  A warp adds its runs' sum to the
// 64-bit total once: the add that carries it past ex (the budget)
// raises the overflow (so does any add, once the total is past it), as
// does a run past c_lim.  The total starts at 0 (the slab's memset,
// then each hop's K5).
__global__ void __launch_bounds__(kThreads)
route_hub_kernel(MeshCard cd, const int32_t* __restrict__ ids,
                 const int32_t* __restrict__ qid, long long c_in,
                 int counted, long long n_rows, long long chunk,
                 long long* __restrict__ recv, long long* __restrict__ send,
                 long long cap, long long* __restrict__ ctl, long long ex,
                 long long c_lim) {
    const int y = (int)blockIdx.y;
    const long long base = cd.shard[y] * chunk;
    ids += y * c_in;
    qid += y * c_in;
    ctl += y * kCtlWords;
    const int32_t* __restrict__ ecnt = cd.ecnt[y];
    const int32_t* __restrict__ e0 = cd.e0[y];
    const int lane = threadIdx.x & 31;
    const long long live = live_places(ctl, c_in, counted);
    const long long stride = (long long)gridDim.x * kThreads;
    const unsigned uchunk = (unsigned)chunk;
    // every lane of a warp runs the same trip count
    for (long long p0 = (long long)blockIdx.x * kThreads
                        + (threadIdx.x & ~31);
         p0 < live; p0 += stride) {
        const long long p = p0 + lane;
        long long ce = 0, first = 0, q = 0;
        if (p < live) {
            const long long v = __ldg(ids + p);
            if (v >= 0 && v < n_rows) {
                long long li = v - base;
                li = li < 0 ? 0 : (li >= chunk ? chunk - 1 : li);
                ce = __ldg(ecnt + li);
                if (ce > 0) {
                    first = __ldg(e0 + li);
                    q = __ldg(qid + p);
                }
            }
        }
        unsigned hubs = __ballot_sync(kFull, ce > 0);
        if (!hubs) continue;
        unsigned long long sum = ce > 0 ? (unsigned long long)ce : 0ull;
        for (int o = 16; o > 0; o >>= 1)
            sum += __shfl_xor_sync(kFull, sum, o);
        const unsigned big = __ballot_sync(kFull, ce > c_lim);
        if (lane == 0) {
            const unsigned long long old = atomicAdd(
                reinterpret_cast<unsigned long long*>(ctl + kHubTotal), sum);
            if ((long long)(old + sum) > ex || big) ctl[kOvf] = 1;
        }
        while (hubs) {
            const int src = __ffs(hubs) - 1;
            hubs &= hubs - 1u;
            const long long f = __shfl_sync(kFull, first, src);
            const long long c = __shfl_sync(kFull, ce, src);
            const long long key_q = __shfl_sync(kFull, q, src) << 32;
            for (long long j0 = 0; j0 < c; j0 += 32) {
                const long long r = f + j0 + lane;
                const bool has = j0 + lane < c && r >= 0 && r < n_rows;
                send_keys(cd, y, recv, send, cap, has,
                          has ? (int)((unsigned)r / uchunk) : -1, key_q | r,
                          ctl);
            }
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

// This block's count `n` (every thread passes its own) and a ticket added
// to member y's scratch word *tick in one 64-bit atomicAdd (the count
// above kTicketBits, the ticket below): the block whose ticket is the
// member's last writes the total into *out and resets the word.
__device__ __forceinline__ void block_total(long long n,
                                            long long* __restrict__ tick,
                                            long long* __restrict__ out) {
    __shared__ long long part[kWarps];
    for (int o = 16; o > 0; o >>= 1) n += __shfl_xor_sync(kFull, n, o);
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = n;
    __syncthreads();
    if (threadIdx.x == 0) {
        long long b = 0;
        for (int w = 0; w < kWarps; ++w) b += part[w];
        const unsigned long long old = atomicAdd(
            reinterpret_cast<unsigned long long*>(tick),
            ((unsigned long long)b << kTicketBits) + 1ull);
        if ((old & ((1ull << kTicketBits) - 1ull)) == gridDim.x - 1ull) {
            *out = (long long)(old >> kTicketBits) + b;
            *tick = 0;
        }
    }
}

// Sum of every thread's `n` over the block, added to *out by one
// thread (nothing when 0).
__device__ __forceinline__ void block_add(long long n,
                                          long long* __restrict__ out) {
    __shared__ long long part[kWarps];
    for (int o = 16; o > 0; o >>= 1) n += __shfl_xor_sync(kFull, n, o);
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = n;
    __syncthreads();
    if (threadIdx.x == 0) {
        long long b = 0;
        for (int w = 0; w < kWarps; ++w) b += part[w];
        if (b)
            atomicAdd(reinterpret_cast<unsigned long long*>(out),
                      (unsigned long long)b);
    }
}

// A thread's places of a member's list: kStampUnroll a round, kThreads
// apart, all loaded before any is used.
struct Places {
    long long i0, stride;
};

__device__ __forceinline__ Places places() {
    return Places{(long long)blockIdx.x * kThreads * kStampUnroll
                      + threadIdx.x,
                  (long long)gridDim.x * kThreads * kStampUnroll};
}

// Init, pass 1: depth 0 at every live start of member y (ids == n_rows:
// a pad; the list read whole, or its counted prefix); ctl[kLive] = their
// count; one past the last live start's place, the list's extent, into
// the scratch word tick[1] by atomicMax (pass 2 moves it to ctl[kCnt]).
__global__ void __launch_bounds__(kThreads)
stamp_starts_kernel(MeshCard cd, const int32_t* __restrict__ ids,
                    const int32_t* __restrict__ qid, long long c,
                    int counted, int16_t* __restrict__ depth,
                    long long chunk, long long qmax, long long n_rows,
                    long long* __restrict__ ctl,
                    long long* __restrict__ tick) {
    const long long y = blockIdx.y;
    const long long base = cd.shard[y] * chunk;
    ids += y * c;
    qid += y * c;
    depth += y * chunk * qmax;
    ctl += y * kCtlWords;
    const long long live = live_places(ctl, c, counted);
    const Places pl = places();
    long long n = 0, ext = 0;
    for (long long i0 = pl.i0; i0 < live; i0 += pl.stride) {
        int32_t u[kStampUnroll];
#pragma unroll
        for (int h = 0; h < kStampUnroll; ++h) {
            const long long i = i0 + h * kThreads;
            u[h] = i < live ? __ldg(ids + i) : (int32_t)n_rows;
        }
#pragma unroll
        for (int h = 0; h < kStampUnroll; ++h) {
            if (u[h] == n_rows) continue;
            const long long i = i0 + h * kThreads;
            const long long li = clampll(u[h] - base, chunk - 1);
            const long long q = clampll(__ldg(qid + i), qmax - 1);
            depth[li * qmax + q] = 0;
            ++n;
            ext = i + 1;
        }
    }
    for (int o = 16; o > 0; o >>= 1) {
        const long long x = __shfl_xor_sync(kFull, ext, o);
        ext = x > ext ? x : ext;
    }
    if ((threadIdx.x & 31) == 0 && ext)
        atomicMax(reinterpret_cast<unsigned long long*>(tick + 2 * y + 1),
                  (unsigned long long)ext);
    block_total(n, tick + 2 * y, ctl + kLive);
}

// Init, pass 2: each live target of member y sets its bit; the first to
// set a bit whose depth is still unset adds one unfound cell.  Block 0
// moves the starts' extent from tick[1] to ctl[kCnt] (pass 1 is done),
// so the first level's X1 reads the starts to it.
__global__ void __launch_bounds__(kThreads)
stamp_targets_kernel(MeshCard cd, const int32_t* __restrict__ tids,
                     const int32_t* __restrict__ tqid, long long ct,
                     const int16_t* __restrict__ depth, long long chunk,
                     long long qmax, uint32_t* __restrict__ tbits,
                     long long W, long long words, long long n_rows,
                     long long* __restrict__ ctl,
                     long long* __restrict__ tick) {
    const long long y = blockIdx.y;
    const long long base = cd.shard[y] * chunk;
    if (blockIdx.x == 0 && threadIdx.x == 0) {
        ctl[y * kCtlWords + kCnt] = tick[2 * y + 1];
        tick[2 * y + 1] = 0;
    }
    tids += y * ct;
    tqid += y * ct;
    depth += y * chunk * qmax;
    tbits += y * words;
    const Places pl = places();
    long long n = 0;
    for (long long i0 = pl.i0; i0 < ct; i0 += pl.stride) {
        int32_t u[kStampUnroll];
#pragma unroll
        for (int h = 0; h < kStampUnroll; ++h) {
            const long long i = i0 + h * kThreads;
            u[h] = i < ct ? __ldg(tids + i) : (int32_t)n_rows;
        }
#pragma unroll
        for (int h = 0; h < kStampUnroll; ++h) {
            if (u[h] == n_rows) continue;
            const long long li = clampll(u[h] - base, chunk - 1);
            const long long q = clampll(__ldg(tqid + i0 + h * kThreads),
                                        qmax - 1);
            const uint32_t bit = 1u << (li & 31);
            const uint32_t old = atomicOr(tbits + q * W + (li >> 5), bit);
            if (!(old & bit) && depth[li * qmax + q] == kInf16) ++n;
        }
    }
    block_add(n, ctl + y * kCtlWords + kUnfound);
}

// A level of member y: the compacted pairs are distinct cells, so each
// depth cell is read and written by one thread at most.  A pad (n_rows,
// BIG_Q) as K5 writes it is read and left: only its ids word moves.
// ctl[kLive] = the fresh pairs (the member's last block writes it);
// ctl[kUnfound] less the fresh ones on a target bit, a block at a time.
// A thread's first places are read beside the count.
__global__ void __launch_bounds__(kThreads)
stamp_level_kernel(MeshCard cd, int32_t* __restrict__ ids,
                   int32_t* __restrict__ qid, long long c, int counted,
                   int16_t* __restrict__ depth, long long chunk,
                   long long qmax, const uint32_t* __restrict__ tbits,
                   long long W, long long words, long long n_rows,
                   int16_t next, long long* __restrict__ ctl,
                   long long* __restrict__ tick) {
    const long long y = blockIdx.y;
    const long long base = cd.shard[y] * chunk;
    ids += y * c;
    qid += y * c;
    depth += y * chunk * qmax;
    tbits += y * words;
    ctl += y * kCtlWords;
    const Places pl = places();
    int32_t u[kStampUnroll], v[kStampUnroll];
#pragma unroll
    for (int h = 0; h < kStampUnroll; ++h) {
        const long long i = pl.i0 + h * kThreads;
        u[h] = i < c ? ids[i] : (int32_t)n_rows;
        v[h] = i < c ? qid[i] : 0;
    }
    const long long live = live_places(ctl, c, counted);
    long long fresh = 0, found = 0;
    for (long long i0 = pl.i0; i0 < live; i0 += pl.stride) {
        if (i0 != pl.i0) {
#pragma unroll
            for (int h = 0; h < kStampUnroll; ++h) {
                const long long i = i0 + h * kThreads;
                u[h] = i < live ? ids[i] : (int32_t)n_rows;
                v[h] = i < live ? qid[i] : 0;
            }
        }
#pragma unroll
        for (int h = 0; h < kStampUnroll; ++h) {
            const long long i = i0 + h * kThreads;
            if (i >= live || u[h] == n_rows) continue;
            const long long li = clampll(u[h] - base, chunk - 1);
            const long long q = clampll(v[h], qmax - 1);
            int16_t* cell = depth + li * qmax + q;
            const uint32_t tw = __ldg(tbits + q * W + (li >> 5));
            if (*cell == kInf16) {
                *cell = next;
                ++fresh;
                found += (tw >> (li & 31)) & 1u;
            } else {
                ids[i] = (int32_t)n_rows;
                qid[i] = kBigQ;
            }
        }
    }
    block_add(-found, ctl + kUnfound);
    block_total(fresh, tick + 2 * y, ctl + kLive);
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

// X1 for every member of a card.  ids / qid: [members, c_in]; counted:
// member y reads the first min(ctl[y, 0], c_in) places (a list K5
// built), else all c_in; recv / send: [members, k, 1 + cap] (send null
// when every owner shares the card); ctl: [members, 8]; bucket_desc:
// host int64 [n_buckets * 5] (g0, g1, mx, slot0, D; g0 nondecreasing);
// neg: host int32 [n_neg], the negated OVER set.  hub != 0: hub mode
// (the members' ecnt / e0, the budget c_in); else hub_recv [members, k,
// 1 + hub_cap] are the hub pairs received (null: none).  One launch.
int mesh_route(int hub, MeshCard cd, const void* ids, const void* qid,
               int64_t c_in, int counted, const void* hub_recv,
               int64_t hub_cap, const int64_t* bucket_desc, int n_buckets,
               const int32_t* neg, int n_neg, int64_t chunk,
               int64_t n_rows, void* recv, void* send, int64_t cap,
               void* ctl, int64_t c_lim, void* stream) {
    if (!card_ok(cd) || n_buckets < 1 || n_buckets > kMaxBuckets ||
        n_neg < 1 || n_neg > kMaxOver || c_in < 0 || chunk <= 0 ||
        chunk > 0x7FFFFFFF || cap <= 0 ||
        (hub_recv && (hub || hub_cap <= 0)))
        return -1;
    for (int d = 0; d < cd.k; ++d)
        if (cd.near[d] < 0 && send == nullptr) return -1;
    cudaStream_t s = (cudaStream_t)stream;
    if (hub) {
        if (c_in == 0) return 0;
        const unsigned bx = member_blocks(kRouteBlocksPerSm, cd.n,
                                          (c_in + kThreads - 1) / kThreads);
        if (bx == 0) return (int)cudaErrorInvalidDevice;
        route_hub_kernel<<<dim3(bx, (unsigned)cd.n), kThreads, 0, s>>>(
            cd, (const int32_t*)ids, (const int32_t*)qid, c_in, counted,
            n_rows, chunk, (long long*)recv, (long long*)send, cap,
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
        if (b > 0 && bk.g0[b] < bk.g0[b - 1]) return -1;
    }
    OverSet ov;
    ov.n = n_neg;
    ov.use_mask = 1;
    ov.mask = 0;
    for (int t = 0; t < n_neg; ++t) {
        ov.et[t] = neg[t];
        if (neg[t] < -32 || neg[t] > 31)
            ov.use_mask = 0;
        else
            ov.mask |= 1ull << (neg[t] + 32);
    }
    const long long pairs = c_in + (hub_recv ? cd.k * hub_cap : 0);
    if (pairs == 0) return 0;
    int d_max = 1;
    for (int b = 0; b < n_buckets; ++b)
        d_max = bk.D[b] > d_max ? bk.D[b] : d_max;
    const int segs = (d_max + kSeg - 1) / kSeg;
    // a block for 8 places at least (a warp a place), at most
    // kRouteBlocksPerSm blocks an SM over the members
    const unsigned bx = member_blocks(kRouteBlocksPerSm, cd.n,
                                      (pairs + kWarps - 1) / kWarps);
    if (bx == 0) return (int)cudaErrorInvalidDevice;
    route_cand_kernel<<<dim3(bx, (unsigned)cd.n), kThreads, 0, s>>>(
        cd, bk, ov, (const int32_t*)ids, (const int32_t*)qid, c_in, counted,
        (const long long*)hub_recv, hub_cap, segs, n_rows, chunk,
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

// X3 for every member of a card.  ids / qid: [members, c] (init: the
// starts, else the compacted list, made pads in place); counted: member
// y reads the first min(ctl[y, 0], c) places, else all c; depth: int16
// [members, chunk, qmax]; tbits: [members, words], W words a query row;
// ctl: [members, 8]; tick: int64 [members, 2], zero before and after.
// init != 0: the starts, then the targets (tids, tqid: [members, ct]),
// two launches, ctl[y, 0] = one past member y's last live start; else
// one level at step, one launch.
int mesh_bfs_stamp(int init, MeshCard cd, void* ids, void* qid, int64_t c,
                   int counted, const void* tids, const void* tqid,
                   int64_t ct, void* depth, int64_t chunk, int64_t qmax,
                   void* tbits, int64_t W, int64_t words, int64_t n_rows,
                   int64_t step, void* ctl, void* tick, void* stream) {
    if (!card_ok(cd) || c < 0 || chunk <= 0 || qmax <= 0 || W <= 0 ||
        words < qmax * W || step < 0 || step >= kInf16 - 1 || !tick ||
        (init && (ct < 0 || (ct > 0 && !tids))))
        return -1;
    cudaStream_t s = (cudaStream_t)stream;
    const long long per_block = (long long)kThreads * kStampUnroll;
    const dim3 grid(member_blocks(kStampBlocksPerSm, cd.n,
                                  (c + per_block - 1) / per_block),
                    (unsigned)cd.n);
    if (grid.x == 0) return (int)cudaErrorInvalidDevice;
    if (!init) {
        stamp_level_kernel<<<grid, kThreads, 0, s>>>(
            cd, (int32_t*)ids, (int32_t*)qid, c, counted, (int16_t*)depth,
            chunk, qmax, (const uint32_t*)tbits, W, words, n_rows,
            (int16_t)(step + 1), (long long*)ctl, (long long*)tick);
        return (int)cudaGetLastError();
    }
    stamp_starts_kernel<<<grid, kThreads, 0, s>>>(
        cd, (const int32_t*)ids, (const int32_t*)qid, c, counted,
        (int16_t*)depth, chunk, qmax, n_rows, (long long*)ctl,
        (long long*)tick);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const dim3 tgrid(member_blocks(kStampBlocksPerSm, cd.n,
                                   (ct + per_block - 1) / per_block),
                     (unsigned)cd.n);
    stamp_targets_kernel<<<tgrid, kThreads, 0, s>>>(
        cd, (const int32_t*)tids, (const int32_t*)tqid, ct,
        (const int16_t*)depth, chunk, qmax, (uint32_t*)tbits, W, words,
        n_rows, (long long*)ctl, (long long*)tick);
    return (int)cudaGetLastError();
}

}  // extern "C"
