// Sparse pair-list GO and the adaptive single-query GO for Hopper
// (sm_90a), behind a plain C interface that
// nebula_tpu_torch/tpu/ell_ops.py loads with ctypes.
//
// Replaces nebula_tpu/tpu/ell.py:1222 make_batched_sparse_go_kernel
// (sparse_go, sparse_go_count, sparse_go_limit) and ell.py:1493
// make_adaptive_go_kernel (adaptive_go).  The reference carries each
// hop's frontier as a (query, vertex) pair list and dedups it with a
// sort of every candidate slot; here the candidates land as bits of a
// mark bitmap [nq, R1w] uint32 (R1w = ceil((n_rows + 1) / 32) words per
// query row), and a scan over that bitmap yields the same pair list —
// sorted by (query, vertex), deduped, cut to the hop's cap, with the
// unique count before the cut — without a sort:
//
//   K4 sparse_expand   a grid of a few blocks an SM strides over the
//                      live pairs only (K5's count, or the host's); a
//                      warp lays a tile of pairs' row slots end to end
//                      over its lanes, walks each hub's extra-row run
//                      whole, and atomicOrs bit (q, u) for every slot
//                      whose etype is in the negated OVER set (the push
//                      direction).  It adds the pairs' extra-row counts
//                      to the hop's 64-bit hub budget total, one add a
//                      warp.  Self mode marks (q, v) itself (the UPTO
//                      union's and the adaptive bitmap's start state).
//   K5 pair_compact    one pass, one launch: each chunk of the bitmap
//                      read once, its bits counted and scanned, its
//                      offset from a decoupled look-back over the
//                      earlier chunks, then the first c_out set bits
//                      written in (q, v) order; the block of the last
//                      chunk does the count, the cap and hub budget
//                      checks and the sticky overflow.  The words read
//                      are re-zeroed for the next hop, and optionally
//                      ORed into the UPTO union bitmap or copied into
//                      the adaptive state bitmap.
//   K6 pair_reduce     the output: the plain pair list in its layout,
//                      the COUNT fold (per-query int32 sum of deg), or
//                      the LIMIT cut (each query's shortest prefix whose
//                      exclusive degree sum is < limit, zero-degree
//                      vertices dropped) compacted to c_red.
//   K7 adaptive_switch the adaptive program's per-hop decision: the
//                      previous sparse hop's overflow, the hub test on
//                      the frontier list, the mode word of this hop.
//   bitmap_lanes       the adaptive dense arm's layout change: the
//                      state bitmap as lane 0 of a [R1, 4]-byte lane
//                      frontier for the dense hop (ell_go_hop), and
//                      back.
//
// K5 and K6's plain emit also serve the frontier-sharded mesh: one
// launch covers every shard of a card (blockIdx.y the shard; the mesh's
// mesh_dedup and sg_emit entries), K5 with each shard's row base and
// clearing the exchange blocks the mesh's hop consumed.
//
// Each program is one checked C call (sg_program, ad_program) that
// enqueues all of its launches: the per-call work on the host is one
// ctypes call, and the host never waits on the card.  sg_program runs
// ell.py:1222's program on a workspace the caller allocates once a call
// (ctl, the mark bitmap, the UPTO union, K5's look-back state, LIMIT's
// scratch, two pair buffers), its first four cleared by one memset.
// ad_program runs every hop of ell.py:1493's program with the mode
// chosen on the card, as the reference's lax.cond chooses it: K7 writes
// the hop's mode word into ctl, and every kernel of the sparse arm (K4,
// K5) and of the dense arm (the layout change to and from lanes, ell_lanes.cu's
// hop and merge) reads that word and returns at once when the hop is
// not its arm's (its blocks still launch: the gated grid-stride kernels,
// the layout change and the hop's gather, take a grid of a few blocks an
// SM, so a hop of the other arm costs the card about a microsecond a
// launch and the host nothing).
//
// Every kernel runs on the caller's stream, allocates nothing and does
// not synchronise; each entry point returns cudaGetLastError() after its
// launches (0 = launched, -1 = an argument the kernels cannot take).
// Bound on this card: bytes — K4 the live pairs' slot rows (8 bytes per
// slot) and their bitmap words, K5 the bitmap words read (and zeroed)
// plus the pairs written, K6 the pair list and the degrees it reads.

#include <atomic>

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm_count.cuh"

constexpr int kSgBuckets = 32;                // ell_ops.MAX_BUCKETS
constexpr int kSgOver = 32;                   // ell_ops.MAX_OVER

// The sparse programs' tables, by value (ell_ops._sparse_desc, made once
// a table generation and OVER set): the slot tables, the hub expansion
// (ecnt / e0, null without hub extra rows), the buckets' (row0, slot0,
// D), the negated OVER set (the push direction), and the geometry.  At
// global scope: the extern "C" entries take it by value.
struct SparseTables {
    const int32_t* nbr;
    const int32_t* et;
    const int32_t* ecnt;
    const int32_t* e0;
    long long row0[kSgBuckets];
    long long slot0[kSgBuckets];
    int D[kSgBuckets];
    int n_buckets;
    int neg[kSgOver];
    int n_neg;
    long long n;
    long long n_rows;
    long long R1w;
};

// csrc/ell_lanes.cu: the packed hop (gather and hub merge), here the
// adaptive program's dense arm, gated on its mode word.
extern "C" int ell_go_hop(const void* fp, void* accp, void* out,
                          const void* nbr, const void* et,
                          const int64_t* plan, int n_buckets,
                          int64_t blocks, int lgc, int wide,
                          const void* eslot, const void* hrows,
                          int64_t n_extras, const int32_t* over, int n_over,
                          int64_t n, int64_t n_rows, int64_t W,
                          const void* gate, int64_t want, void* stream);

namespace {

constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;            // single-block scans
constexpr int kMaxBuckets = kSgBuckets;
constexpr int kMaxOver = kSgOver;
constexpr int kCardShards = 16;               // members of one launch
constexpr int kClearSlabs = 4;                // K5's exchange slabs
constexpr int32_t kBigQ = 1 << 30;            // ell.py BIG_Q
constexpr int32_t kI32Max = 0x7FFFFFFF;

// ctl: int64 [8], the program's device-side scalars.
constexpr int kCnt = 0;       // last compaction's unique count
constexpr int kOvf = 1;       // sticky overflow
constexpr int kHubTotal = 2;  // this hop's hub extra rows (K4 adds)
constexpr int kHubBig = 3;    // this hop saw a clamped per-pair count
constexpr int kMode = 4;      // adaptive: 1 sparse arm, 2 dense arm
constexpr int kXBytes = 4;    // frontier-sharded mesh: bytes exchanged
constexpr int kSparse = 5;    // adaptive: sticky "may stay sparse"
constexpr int kConv = 6;      // adaptive: this hop is the first dense one
constexpr int kModeSparse = 1, kModeDense = 2;

// A kernel of one arm of the adaptive program runs only while the
// program's mode word says so: gate null (every other caller) or *gate
// == want.  Every thread reads the word before anything else, so a
// block returns whole.
__device__ __forceinline__ bool gated_off(const long long* gate,
                                          long long want) {
    return gate != nullptr && *gate != want;
}

// The buckets as K4 takes them: row0 nondecreasing (bucket b holds rows
// row0[b] .. row0[b + 1]), and a bit b of quads when bucket b's slots
// start on a 16-byte boundary and D[b] % 4 == 0 (the tables' pointers
// aligned too): hub extra rows there are read 16 bytes at a time.
struct Buckets {
    long long row0[kMaxBuckets];
    long long slot0[kMaxBuckets];
    int D[kMaxBuckets];
    int n;
    unsigned quads;
};

// The negated OVER set, with a bitmask of etype + 32 when every member
// lies in [-32, 31] (use_mask).
struct OverSet {
    int et[kMaxOver];
    int n;
    int use_mask;
    unsigned long long mask;
};

inline unsigned blocks_for(long long threads, int per_block) {
    long long b = (threads + per_block - 1) / per_block;
    if (b > (1LL << 30)) b = 1LL << 30;
    return (unsigned)(b < 1 ? 1 : b);
}

// A gated grid-stride launch's grid: at most two blocks an SM, so that
// the launch costs the card little on the hops it does not run; 0 when
// the device cannot be queried.
inline unsigned gated_blocks(unsigned blocks) {
    const unsigned most = 2u * (unsigned)sm_count();
    return blocks < most ? blocks : most;
}

// Exclusive scan of this block's per-thread values (blockDim a multiple
// of 32, at most 1024); returns the thread's exclusive prefix and the
// block total through *total.  All threads must call it.
__device__ long long block_excl_scan(long long x, long long* total) {
    __shared__ long long warp_tot[32];
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    const int nw = (blockDim.x + 31) >> 5;
    long long incl = x;
    for (int off = 1; off < 32; off <<= 1) {
        const long long y = __shfl_up_sync(0xFFFFFFFFu, incl, off);
        if (lane >= off) incl += y;
    }
    if (lane == 31) warp_tot[wid] = incl;
    __syncthreads();
    if (wid == 0) {
        long long t = lane < nw ? warp_tot[lane] : 0;
        for (int off = 1; off < 32; off <<= 1) {
            const long long y = __shfl_up_sync(0xFFFFFFFFu, t, off);
            if (lane >= off) t += y;
        }
        if (lane < nw) warp_tot[lane] = t;       // inclusive warp bases
    }
    __syncthreads();
    const long long base = wid > 0 ? warp_tot[wid - 1] : 0;
    *total = warp_tot[nw - 1];
    __syncthreads();                             // warp_tot reused next call
    return base + incl - x;
}

// Warp-wide inclusive sum (all 32 lanes active).
__device__ __forceinline__ long long warp_incl(long long x) {
    const int lane = threadIdx.x & 31;
    for (int off = 1; off < 32; off <<= 1) {
        const long long y = __shfl_up_sync(0xFFFFFFFFu, x, off);
        if (lane >= off) x += y;
    }
    return x;
}


// ---------------------------------------------------------------- K4
// Replaces nebula_tpu/tpu/ell.py:1315 (the hop's candidate matrix, +
// :1296, and _segmented_hub_iota :402).  The pair (q, v) is live unless
// v is the sentinel n_rows.  Rows walked: v, then (when the tables have
// extra rows) e0[v] .. e0[v] + ecnt[v] - 1.  The budget: ecnt[v] summed
// into ctl[kHubTotal] in 64 bits, and ctl[kHubBig] raised when ecnt[v] >
// c_lim (the reference's clamp).  qid may be null (one query).
//
// Bound on this card: bytes, and at the sizes the programs give it (a
// few to a few thousand pairs) the latency of its dependent loads: the
// pair, then its row's slots.  So: the grid strides over the live pairs
// only — the first `live` of the list, live = min(*cnt, c_in) (the
// count the previous K5 left; K5 pads the tail) or c_in (the host's
// count) — at a warp a tile of ppw consecutive pairs (ppw from c_in and
// the grid: a block for 8 pairs, at most 16 blocks an SM), so a short
// or gated-off list costs a few blocks and no pass over its pads; with
// one pair a tile (lists up to about 17,000 pairs on an H100) every lane
// reads it and the warp walks its row with no shuffle, with more the
// tile's main rows are laid end to end over the 32 lanes, so a warp
// serves many small rows at once; et and nbr of a slot are read
// together, the OVER test is a bitmask; a hub pair's extra-row run is
// walked by the whole warp, a run inside one bucket as one contiguous
// range of 16-byte units (where the bucket's slots are aligned), four
// a lane in flight; one 64-bit hub-budget add a warp.  Measured on an
// H100: 16-byte units on the main rows, the bucket lookup fully
// unrolled, or the tables' buckets staged in shared memory, each made
// the short lists slower (the code and registers they add).
constexpr int kExpandBlocksPerSm = 16;
constexpr int kExpandWarps = kThreads / 32;

__device__ __forceinline__ bool in_neg(int e, const OverSet& ov) {
    if (ov.use_mask) {
        const unsigned k = (unsigned)(e + 32);
        return k < 64u && ((ov.mask >> k) & 1ull);
    }
    bool ok = false;
    for (int t = 0; t < ov.n; ++t) ok |= (e == ov.et[t]);
    return ok;
}

// Row r's place in the tables: the last bucket whose row0 is <= r (0
// when none; row0 nondecreasing), found by a count over the kernel's
// parameters in a loop whose index every lane shares (each read one
// broadcast), then its first slot, width and unit (4 slots where the
// bucket's slots are 16-byte aligned, else 1).
struct RowAt {
    long long base;
    int b, D, uw;
};

__device__ __forceinline__ RowAt row_at(const Buckets& bk, long long r) {
    int b = 0;
    for (int k = 1; k < bk.n; ++k) b += bk.row0[k] <= r;
    return RowAt{bk.slot0[b] + (r - bk.row0[b]) * bk.D[b], b, bk.D[b],
                 (bk.quads >> b) & 1u ? 4 : 1};
}

__device__ __forceinline__ void push(uint32_t* row, int e, int u,
                                     const OverSet& ov, long long n_rows) {
    if (in_neg(e, ov) && u >= 0 && u < n_rows)
        atomicOr(row + (u >> 5), 1u << (u & 31));
}

// `nu` units of `uw` slots (4: 16 bytes, else 1) from slot `base`,
// spread over the warp's lanes (a hub's extra rows inside one bucket),
// four units a lane loaded together before their pushes.
__device__ __forceinline__ void walk_units(uint32_t* row, long long base,
                                           long long nu, int uw,
                                           const int32_t* nbr,
                                           const int32_t* et,
                                           const OverSet& ov,
                                           long long n_rows) {
    const int lane = threadIdx.x & 31;
    for (long long k0 = 0; k0 < nu; k0 += 128) {
        int4 e[4], u[4];
#pragma unroll
        for (int h = 0; h < 4; ++h) {
            const long long k = k0 + lane + 32 * h;
            e[h] = make_int4(0, 0, 0, 0);
            u[h] = make_int4(-1, -1, -1, -1);
            if (k < nu && uw == 4) {
                e[h] = __ldg(reinterpret_cast<const int4*>(et + base + 4 * k));
                u[h] = __ldg(reinterpret_cast<const int4*>(nbr + base
                                                           + 4 * k));
            } else if (k < nu) {
                e[h].x = __ldg(et + base + k);
                u[h].x = __ldg(nbr + base + k);
            }
        }
#pragma unroll
        for (int h = 0; h < 4; ++h) {
            push(row, e[h].x, u[h].x, ov, n_rows);
            push(row, e[h].y, u[h].y, ov, n_rows);
            push(row, e[h].z, u[h].z, ov, n_rows);
            push(row, e[h].w, u[h].w, ov, n_rows);
        }
    }
}

// A tile's main rows laid end to end over the warp's lanes: lane l <
// ppw holds pair l's slot count D (the other lanes 0), first slot and
// query; each lane walks items lane, lane + 32, ... and finds the pair
// it falls in by a search of the counts' inclusive scan (span: ppw
// rounded up to a power of two).  Every lane of the warp takes part.
__device__ __forceinline__ void spread_slots(int slots, long long base,
                                             int qv, int ppw, int span,
                                             uint32_t* mark, long long R1w,
                                             const int32_t* nbr,
                                             const int32_t* et,
                                             const OverSet& neg,
                                             long long n_rows) {
    const int lane = threadIdx.x & 31;
    int incl = slots;
    for (int o = 1; o < span; o <<= 1) {
        const int y = __shfl_up_sync(0xFFFFFFFFu, incl, o);
        if (lane >= o) incl += y;
    }
    const int total = __shfl_sync(0xFFFFFFFFu, incl, ppw - 1);
    const long long start = base - (incl - slots);  // base less the items
                                                     // before the pair
    for (int i0 = 0; i0 < total; i0 += 32) {
        const int i = i0 + lane;
        int o = 0;                            // the first lane with incl > i
        for (int st = span >> 1; st > 0; st >>= 1) {
            const int x = __shfl_sync(0xFFFFFFFFu, incl, o + st - 1);
            if (x <= i) o += st;
        }
        const long long os = __shfl_sync(0xFFFFFFFFu, start, o);
        const int oq = __shfl_sync(0xFFFFFFFFu, qv, o);
        if (i < total)
            push(mark + (long long)oq * R1w, __ldg(et + os + i),
                 __ldg(nbr + os + i), neg, n_rows);
    }
}

__global__ void __launch_bounds__(kThreads)
sparse_expand_kernel(const int32_t* __restrict__ ids,
                     const int32_t* __restrict__ qid, long long c_in,
                     const long long* __restrict__ cnt,
                     const int32_t* __restrict__ ecnt,
                     const int32_t* __restrict__ e0,
                     const int32_t* __restrict__ nbr,
                     const int32_t* __restrict__ et, Buckets bk,
                     OverSet neg, long long n, long long n_rows,
                     long long R1w, uint32_t* __restrict__ mark,
                     long long* __restrict__ ctl, long long c_lim,
                     int self_mode, int ppw,
                     const long long* __restrict__ gate, long long want) {
    const int lane = threadIdx.x & 31;
    const int span = 1 << (32 - __clz(ppw - 1));  // ppw up to a power of 2
    const long long warps = (long long)gridDim.x * kExpandWarps;
    const long long w0 = (long long)blockIdx.x * kExpandWarps
                         + (threadIdx.x >> 5);
    // lane l < ppw holds pair l of its warp's tile, the other lanes a copy
    // of pair 0 (with one pair a tile, every lane has its own); the first
    // tile's pair is read beside the gate and the count (one round trip:
    // the list holds c_in pairs whatever the count)
    const bool mine = lane < ppw;
    long long p = w0 * ppw + (mine ? lane : 0);
    int v = p < c_in ? __ldg(ids + p) : -1;
    int qv = p < c_in && qid ? __ldg(qid + p) : 0;
    const long long g = gate ? *gate : want;
    long long live = c_in;
    if (cnt) {
        const long long c = *cnt;
        live = c < c_in ? c : c_in;
    }
    if (g != want) return;
    for (long long t = w0; t * ppw < live; t += warps) {
        if (t != w0) {
            p = t * ppw + (mine ? lane : 0);
            v = p < live ? __ldg(ids + p) : -1;
            qv = p < live && qid ? __ldg(qid + p) : 0;
        }
        const bool ok = p < live && v >= 0 && v < n_rows;
        const long long q = qv;         // (qid < nq <= 2^30)
        if (self_mode) {
            if (ok && mine)
                atomicOr(mark + q * R1w + (v >> 5), 1u << (v & 31));
            continue;
        }
        int ce = 0, first = 0;
        if (ok && mine && ecnt != nullptr) {
            const long long vi = v < n ? v : n;
            ce = __ldg(ecnt + vi);
            first = __ldg(e0 + vi);
        }
        int slots = 0;
        long long base = 0;
        if (ok) {
            const RowAt at = row_at(bk, v);
            slots = at.D;
            base = at.base;
        }
        if (ppw == 1) {                 // the warp's one pair, no shuffles
            for (int i = lane; i < slots; i += 32)
                push(mark + q * R1w, __ldg(et + base + i),
                     __ldg(nbr + base + i), neg, n_rows);
        } else {
            spread_slots(mine ? slots : 0, base, qv, ppw, span, mark, R1w,
                         nbr, et, neg, n_rows);
        }
        if (ecnt == nullptr) continue;
        unsigned long long sum = (unsigned long long)ce;   // lanes < span
        for (int o = span >> 1; o > 0; o >>= 1)
            sum += __shfl_xor_sync(0xFFFFFFFFu, sum, o);
        const unsigned big = __ballot_sync(0xFFFFFFFFu, ce > 0 && ce > c_lim);
        if (lane == 0) {
            if (sum)
                atomicAdd(reinterpret_cast<unsigned long long*>(
                              ctl + kHubTotal), sum);
            if (big) ctl[kHubBig] = 1;
        }
        unsigned hubs = __ballot_sync(0xFFFFFFFFu, ce > 0);
        while (hubs) {
            const int src = __ffs(hubs) - 1;
            hubs &= hubs - 1u;
            const long long f = __shfl_sync(0xFFFFFFFFu, first, src);
            const long long c = __shfl_sync(0xFFFFFFFFu, ce, src);
            uint32_t* row = mark + __shfl_sync(0xFFFFFFFFu, q, src) * R1w;
            long long r = f < 0 ? 0 : f;
            const long long end = f + c < n_rows ? f + c : n_rows;
            while (r < end) {           // the run's part in one bucket
                const RowAt at = row_at(bk, r);
                long long stop = at.b + 1 < bk.n ? bk.row0[at.b + 1] : end;
                if (stop > end || stop <= r) stop = end;
                walk_units(row, at.base, (stop - r) * at.D / at.uw, at.uw,
                           nbr, et, neg, n_rows);
                r = stop;
            }
        }
    }
}

// ---------------------------------------------------------------- K5
// One launch covers every member of a call (blockIdx.y; one member on
// one card): member y's bitmap is mark + y * words, its look-back state
// scan + y * scan_stride, its ctl ctl + y * kCtlWords, its pairs
// ids_out / qid_out + y * ids_stride.
//
// A member's bitmap is cut into chunks of kChunk words, kWordsPer
// contiguous words a thread (16-byte loads; twice that on a bitmap of
// kWideWords or more), and each word is read once.  A block takes a
// chunk by an atomic ticket, so it only ever waits on chunks that
// started before it; it counts the chunk's bits,
// scans the counts over the block, publishes the chunk's aggregate, and
// learns the bits before the chunk by a decoupled look-back over the
// earlier chunks' descriptors, then publishes its inclusive prefix.
// Still holding its words in registers, it writes its pairs (the first
// c_out overall, in (q, v) order) and zeroes, ORs or copies the words.
// The block that takes the member's last chunk knows the count: it does
// the member's checks and clears the exchange blocks; the pad tail past
// the count is written once the count is known, by every block of the
// member's grid row, each waiting on the last chunk's inclusive prefix
// (at 2^17 pairs a quarter of the time the finishing block alone took
// on an H100).  The blocks loop over tickets until none is left, so
// the grid need not be resident: a block waits only after every chunk
// has been taken by a running block.
constexpr int kCtlWords = 8;
constexpr int kWordsPer = 8;                  // K5: words a thread
constexpr long long kChunk = (long long)kThreads * kWordsPer;

// The look-back state of a member: kScanHead words — the ticket, the
// count of the launch's blocks that have finished, the tag of the last
// call — then one descriptor a chunk: flag (aggregate or inclusive, 2
// bits) | tag (kTagBits) | value (kValBits).  A call's tag is the last
// call's plus one (1 .. kTagMask), so a descriptor an earlier call left
// on the same state never reads as ready; the call's last block to
// finish resets the ticket and the count and records the tag.  The
// state must be all zero before its first call: the programs clear it
// with their workspace's memset (one memset serves every hop).
constexpr int kScanHead = 4;
constexpr int kTicket = 0, kDoneBlocks = 1, kLastTag = 2;
constexpr int kValBits = 36, kTagBits = 26;
constexpr unsigned long long kValMask = (1ULL << kValBits) - 1;
constexpr unsigned long long kTagMask = (1ULL << kTagBits) - 1;
constexpr unsigned long long kAggregate = 1ULL << 62;
constexpr unsigned long long kInclusive = 2ULL << 62;

__device__ __forceinline__ unsigned long long desc_word(
    unsigned long long flag, unsigned long long tag, long long v) {
    return flag | (tag << kValBits) | ((unsigned long long)v & kValMask);
}

__device__ __forceinline__ unsigned long long read_desc(
    const unsigned long long* p) {
    return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void write_desc(unsigned long long* p,
                                           unsigned long long v) {
    *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

__device__ __forceinline__ bool desc_ready(unsigned long long d,
                                           unsigned long long tag) {
    return (d >> 62) != 0 && ((d >> kValBits) & kTagMask) == tag;
}

// Warp 0 of a block: the bits of every chunk before chunk j (> 0), the
// descriptors of j - 1, j - 2, ... summed 32 at a time back to the
// nearest inclusive one; spins while one of a window is not ready.
__device__ long long look_back(const unsigned long long* desc, long long j,
                               unsigned long long tag) {
    const int lane = threadIdx.x & 31;
    long long sum = 0;
    for (long long top = j - 1;; top -= 32) {
        const long long i = top - lane;
        unsigned long long d;
        bool ok;
        do {            // before chunk 0: an inclusive prefix of 0
            d = i >= 0 ? read_desc(desc + i) : desc_word(kInclusive, tag, 0);
            ok = desc_ready(d, tag);
        } while (!__all_sync(0xFFFFFFFFu, ok));
        const unsigned incl = __ballot_sync(0xFFFFFFFFu, (d >> 62) == 2);
        const int last = incl ? __ffs(incl) - 1 : 31;
        long long x = lane <= last ? (long long)(d & kValMask) : 0;
        for (int off = 16; off > 0; off >>= 1)
            x += __shfl_xor_sync(0xFFFFFFFFu, x, off);
        sum += x;
        if (incl) return sum;
    }
}

// A thread's run of N words at w (< words): 16-byte accesses when the
// member's row is 16-byte aligned (vec) and the run lies whole inside
// it, else word by word.
template <int N>
__device__ __forceinline__ void load_run(const uint32_t* p, long long w,
                                         long long words, bool vec,
                                         uint32_t (&v)[N]) {
    if (vec && w + N <= words) {
#pragma unroll
        for (int h = 0; h < N; h += 4) {
            const uint4 a = *reinterpret_cast<const uint4*>(p + w + h);
            v[h] = a.x; v[h + 1] = a.y; v[h + 2] = a.z; v[h + 3] = a.w;
        }
        return;
    }
#pragma unroll
    for (int k = 0; k < N; ++k)
        v[k] = w + k < words ? p[w + k] : 0u;
}

template <int N>
__device__ __forceinline__ void store_run(uint32_t* p, long long w,
                                          long long words, bool vec,
                                          const uint32_t (&v)[N]) {
    if (vec && w + N <= words) {
#pragma unroll
        for (int h = 0; h < N; h += 4)
            *reinterpret_cast<uint4*>(p + w + h) =
                make_uint4(v[h], v[h + 1], v[h + 2], v[h + 3]);
        return;
    }
#pragma unroll
    for (int k = 0; k < N; ++k)
        if (w + k < words) p[w + k] = v[k];
}

// The run's nonzero words (by 16-byte quarters where vec) set to zero.
template <int N>
__device__ __forceinline__ void zero_run(uint32_t* p, long long w,
                                         long long words, bool vec,
                                         const uint32_t (&v)[N]) {
    if (vec && w + N <= words) {
#pragma unroll
        for (int h = 0; h < N; h += 4)
            if (v[h] | v[h + 1] | v[h + 2] | v[h + 3])
                *reinterpret_cast<uint4*>(p + w + h) = make_uint4(0, 0, 0, 0);
        return;
    }
#pragma unroll
    for (int k = 0; k < N; ++k)
        if (w + k < words && v[k]) p[w + k] = 0u;
}

// The members of a frontier-sharded card, by value: each member's row
// base (its shard's first row; 0 on one card), and the exchange blocks
// its hop consumed, which the finishing block clears: member y's blocks
// [y * k, (y + 1) * k) of each slab, int64 [1 + cap[j]] each, the count
// first.  A receive slab's blocks from other shards (the member's own
// block excepted: shard[y]) are counted first into ctl[kXBytes], 8
// bytes a count and a kept key.  k = 0: nothing to clear.
struct CardCompact {
    long long base[kCardShards];
    long long* slab[kClearSlabs];
    long long cap[kClearSlabs];
    int recv[kClearSlabs];
    int shard[kCardShards];
    int k;
};

// One block of kScanThreads: vals[0..n) -> their exclusive prefix sums,
// in place; returns the total.  Each thread owns a contiguous run.
__device__ long long scan_inplace(unsigned long long* vals, long long n) {
    const long long per = (n + blockDim.x - 1) / blockDim.x;
    const long long lo = per * threadIdx.x;
    const long long hi = lo + per < n ? lo + per : n;
    long long local = 0;
    for (long long i = lo; i < hi; ++i) local += (long long)vals[i];
    long long total;
    long long run = block_excl_scan(local, &total);
    for (long long i = lo; i < hi; ++i) {
        const long long x = (long long)vals[i];
        vals[i] = (unsigned long long)run;
        run += x;
    }
    return total;
}

// The member's checks, by the block that took its last chunk: the unique
// count into ctl[kCnt], and the sticky overflow: count > c_out, or (ex
// >= 0) the hop's hub budget total > ex or a clamped per-pair count;
// the budget resets for the next hop.  With a card's exchange blocks
// (cc.k > 0): their counts cleared (the bytes of the received ones
// counted first) and the hub runs' total reset, for the next hop's
// router.
__device__ void compact_finish(long long total, long long c_out,
                               long long ex, long long* ctl,
                               const CardCompact& cc, int y) {
    if (threadIdx.x == 0) {
        ctl[kCnt] = total;
        bool ovf = total > c_out;
        if (ex >= 0) {
            ovf |= ctl[kHubTotal] > ex || ctl[kHubBig] != 0;
            ctl[kHubTotal] = 0;
            ctl[kHubBig] = 0;
        }
        if (ovf) ctl[kOvf] = 1;
        if (cc.k > 0) ctl[kHubTotal] = 0;
    }
    for (int j = 0; j < kClearSlabs; ++j) {
        if (!cc.slab[j]) continue;
        for (int t = threadIdx.x; t < cc.k; t += blockDim.x) {
            long long* blk = cc.slab[j] + ((long long)y * cc.k + t)
                                          * (1 + cc.cap[j]);
            if (cc.recv[j] && t != cc.shard[y]) {
                const long long c = blk[0] < cc.cap[j] ? blk[0] : cc.cap[j];
                atomicAdd(reinterpret_cast<unsigned long long*>(
                              ctl + kXBytes),
                          (unsigned long long)(8 * (1 + c)));
            }
            blk[0] = 0;
        }
    }
}

// K5: the first c_out set bits in word order ((q, v) order) as
// (ids_out, qid_out) pairs, the member's row base added to every vertex
// (a frontier-sharded shard's first row; 0 on one card); positions past
// the count, up to c_out, get the pads (n_rows, BIG_Q).  Each word read
// is zeroed (zero), ORed into uni, or copied into copy_to, as asked.
// qid_out may be null.  nb = ceil(words / chunk) chunks a member, of
// kThreads * WPT words each.
template <int WPT>
__global__ void __launch_bounds__(kThreads)
pair_compact_kernel(uint32_t* __restrict__ mark, long long words,
                    long long R1w, long long c_out,
                    int32_t* __restrict__ ids_out,
                    int32_t* __restrict__ qid_out, long long ids_stride,
                    unsigned long long* __restrict__ scan,
                    long long scan_stride, long long nb,
                    long long* __restrict__ ctl, long long ex,
                    uint32_t* __restrict__ uni,
                    uint32_t* __restrict__ copy_to, int zero,
                    long long n_rows, CardCompact cc,
                    const long long* __restrict__ gate, long long want) {
    if (gated_off(gate, want)) return;
    constexpr long long chunk = (long long)kThreads * WPT;
    __shared__ long long s_ticket, s_before;
    __shared__ unsigned long long s_tag;
    const int y = (int)blockIdx.y;
    const long long row_base = cc.base[y];
    mark += y * words;
    ids_out += y * ids_stride;
    if (qid_out) qid_out += y * ids_stride;
    ctl += y * kCtlWords;
    if (uni) uni += y * words;
    if (copy_to) copy_to += y * words;
    unsigned long long* head = scan + y * scan_stride;
    unsigned long long* desc = head + kScanHead;
    const bool vm = ((uintptr_t)mark & 15) == 0;
    const bool vu = ((uintptr_t)uni & 15) == 0;
    const bool vc = ((uintptr_t)copy_to & 15) == 0;
    const int lane = threadIdx.x & 31;
    if (threadIdx.x == 0) s_tag = head[kLastTag] % kTagMask + 1;
    long long total = -1;         // the count, in the last chunk's block
    for (;;) {
        if (threadIdx.x == 0)
            s_ticket = (long long)atomicAdd(head + kTicket, 1ULL);
        __syncthreads();
        const long long j = s_ticket;
        const unsigned long long tag = s_tag;
        if (j >= nb) break;
        const long long w = j * chunk + (long long)threadIdx.x * WPT;
        uint32_t v[WPT];
        load_run(mark, w, words, vm, v);
        int c = 0;
#pragma unroll
        for (int k = 0; k < WPT; ++k) c += __popc(v[k]);
        long long agg;
        const long long excl = block_excl_scan(c, &agg);
        if (threadIdx.x < 32) {
            long long before = 0;
            if (j == 0) {
                if (lane == 0)
                    write_desc(desc, desc_word(kInclusive, tag, agg));
            } else {
                if (lane == 0)
                    write_desc(desc + j, desc_word(kAggregate, tag, agg));
                before = look_back(desc, j, tag);
                if (lane == 0)
                    write_desc(desc + j,
                               desc_word(kInclusive, tag, before + agg));
            }
            if (lane == 0) s_before = before;
        }
        __syncthreads();
        const long long before = s_before;
        if (j == nb - 1) total = before + agg;
        long long pos = before + excl;
        for (int k = 0; k < WPT && pos < c_out; ++k) {
            uint32_t bits = v[k];
            if (!bits) continue;
            const long long q = (w + k) / R1w;
            const long long vb = (w + k - q * R1w) * 32;
            while (bits && pos < c_out) {
                const int b = __ffs(bits) - 1;
                bits &= bits - 1u;
                ids_out[pos] = (int32_t)(row_base + vb + b);
                if (qid_out) qid_out[pos] = (int32_t)q;
                ++pos;
            }
        }
        if (w < words) {
            if (uni) {
                uint32_t u[WPT];
                load_run(uni, w, words, vu, u);
#pragma unroll
                for (int k = 0; k < WPT; ++k) u[k] |= v[k];
                store_run(uni, w, words, vu, u);
            }
            if (copy_to) store_run(copy_to, w, words, vc, v);
            if (zero) zero_run(mark, w, words, vm, v);
        }
        __syncthreads();                 // s_ticket and s_before reused
    }
    const unsigned long long tag = s_tag;
    if (total >= 0) compact_finish(total, c_out, ex, ctl, cc, y);
    if (total < 0) {                     // wait for the last chunk's prefix
        if (threadIdx.x == 0) {
            unsigned long long d;
            do {
                d = read_desc(desc + nb - 1);
            } while (!desc_ready(d, tag) || (d >> 62) != 2);
            s_before = (long long)(d & kValMask);
        }
        __syncthreads();
        total = s_before;
    }
    for (long long g = total + (long long)blockIdx.x * blockDim.x
                       + threadIdx.x;
         g < c_out; g += (long long)gridDim.x * blockDim.x) {
        ids_out[g] = (int32_t)n_rows;
        if (qid_out) qid_out[g] = kBigQ;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        __threadfence();
        if (atomicAdd(head + kDoneBlocks, 1ULL) == gridDim.x - 1ULL) {
            head[kTicket] = 0;
            head[kDoneBlocks] = 0;
            head[kLastTag] = tag;
        }
    }
}

// K5 on a bitmap of kWideWords words or more takes chunks of
// kThreads * 16 words: half the chunks, so half the look-back chain, a
// third faster at 16.8M words (1024 queries) on an H100; smaller ones
// keep kChunk, a tenth faster at 131,200 words (8 queries).
constexpr long long kWideWords = 1LL << 20;

// K5's grid row a member: at most the blocks the card holds at once,
// shared by the members (the blocks loop over the chunks' tickets); 0
// when the device cannot be queried.
template <int WPT>
unsigned compact_blocks(long long nb, int members) {
    static std::atomic<int> per_sm{0};
    int per = per_sm.load(std::memory_order_relaxed);
    if (per < 1) {
        if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per, pair_compact_kernel<WPT>, kThreads, 0) !=
                cudaSuccess ||
            per < 1)
            return 0;
        per_sm.store(per, std::memory_order_relaxed);
    }
    const long long sms = sm_count();
    if (sms < 1) return 0;
    long long most = (long long)per * sms / members;
    if (most < 1) most = 1;
    return (unsigned)(nb < most ? nb : most);
}

// ---------------------------------------------------------------- K6
// Output layouts (ell.py:1440-1466): pack32 -> out[2 + i] = q * R1 + v
// (2^31-1 unused); else out[2 + i] = q (-1 unused), out[2 + c + i] = v
// (n_rows unused).
__device__ __forceinline__ void put_pair(int32_t* out, int pack32,
                                         long long i, long long c,
                                         long long q, long long v,
                                         long long R1) {
    if (pack32) {
        out[2 + i] = (int32_t)(q * R1 + v);
    } else {
        out[2 + i] = (int32_t)q;
        out[2 + c + i] = (int32_t)v;
    }
}

__device__ __forceinline__ void put_pad(int32_t* out, int pack32,
                                        long long i, long long c,
                                        long long n_rows) {
    if (pack32) {
        out[2 + i] = kI32Max;
    } else {
        out[2 + i] = -1;
        out[2 + c + i] = (int32_t)n_rows;
    }
}

__device__ __forceinline__ void put_head(int32_t* out,
                                         const long long* ctl) {
    out[0] = (int32_t)ctl[kCnt];
    out[1] = ctl[kOvf] ? 1 : 0;
}

// The plain result: the final pair list in its layout; member y of a
// card (blockIdx.y) writes its c pairs ids / qid + y * c into out + y *
// out_stride with the head from ctl + y * kCtlWords.
__global__ void pair_emit_kernel(const int32_t* __restrict__ ids,
                                 const int32_t* __restrict__ qid,
                                 long long c, int32_t* __restrict__ out,
                                 long long out_stride, int pack32,
                                 long long R1, long long n_rows,
                                 const long long* __restrict__ ctl) {
    ids += blockIdx.y * c;
    qid += blockIdx.y * c;
    out += blockIdx.y * out_stride;
    ctl += blockIdx.y * kCtlWords;
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t0 == 0) put_head(out, ctl);
    for (long long i = t0; i < c; i += stride) {
        const int32_t q = qid[i];
        if (q == kBigQ) put_pad(out, pack32, i, c, n_rows);
        else put_pair(out, pack32, i, c, q, ids[i], R1);
    }
}

// COUNT: out[2 + q] += deg[v] over the live pairs, as uint32 (int32 with
// wrap-around, the reference's .at[].add); out[2:] is zero before.
__global__ void pair_count_fold_kernel(const int32_t* __restrict__ ids,
                                       const int32_t* __restrict__ qid,
                                       long long c,
                                       const int32_t* __restrict__ deg,
                                       int32_t* __restrict__ out,
                                       long long qmax,
                                       const long long* __restrict__ ctl) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t0 == 0) put_head(out, ctl);
    for (long long i = t0; i < c; i += stride) {
        const int32_t q = qid[i];
        if (q == kBigQ || q < 0 || q >= qmax) continue;
        const uint32_t w = (uint32_t)deg[ids[i]];
        if (w)
            atomicAdd(reinterpret_cast<uint32_t*>(out + 2 + q), w);
    }
}

// First index in [0, c) whose qid is >= q (qids are nondecreasing:
// the list is sorted by (q, v), the pads BIG_Q at its end).
__device__ long long lower_q(const int32_t* qid, long long c, long long q) {
    long long lo = 0, hi = c;
    while (lo < hi) {
        const long long mid = (lo + hi) >> 1;
        if ((long long)qid[mid] < q) lo = mid + 1;
        else hi = mid;
    }
    return lo;
}

// LIMIT, pass 1: one warp per query q < nq walks its segment of the
// sorted list in 32-pair chunks with a warp scan of the degrees (64-bit,
// so the prefix is exact), and counts the kept pairs: deg > 0 and
// exclusive prefix < limit.  The prefix only grows, so the walk stops
// at the first chunk reaching the limit.  kept[q] gets the count.
__device__ long long limit_walk(const int32_t* ids, const int32_t* qid,
                                long long c, const int32_t* deg,
                                long long q, long long limit,
                                int32_t* out, int pack32, long long c_red,
                                long long R1, long long at) {
    const int lane = threadIdx.x & 31;
    const long long lo = lower_q(qid, c, q);
    const long long hi = lower_q(qid, c, q + 1);
    long long run = 0, kept = 0;
    for (long long s = lo; s < hi; s += 32) {
        const long long i = s + lane;
        const long long w = i < hi ? (long long)deg[ids[i]] : 0;
        const long long incl = warp_incl(w);
        const long long excl = run + incl - w;
        const bool keep = i < hi && w > 0 && excl < limit;
        const unsigned ball = __ballot_sync(0xFFFFFFFFu, keep);
        if (out != nullptr && keep) {
            const long long pos =
                at + kept + __popc(ball & ((1u << lane) - 1u));
            if (pos < c_red) put_pair(out, pack32, pos, c_red, q, ids[i], R1);
        }
        kept += __popc(ball);
        run += __shfl_sync(0xFFFFFFFFu, incl, 31);
        if (run >= limit) break;
    }
    return kept;
}

__global__ void limit_count_kernel(const int32_t* __restrict__ ids,
                                   const int32_t* __restrict__ qid,
                                   long long c,
                                   const int32_t* __restrict__ deg,
                                   long long nq, long long limit,
                                   unsigned long long* __restrict__ kept) {
    const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
    for (long long q = ((long long)blockIdx.x * blockDim.x + threadIdx.x)
                       >> 5;
         q < nq; q += warps) {
        const long long k = limit_walk(ids, qid, c, deg, q, limit, nullptr,
                                       0, 0, 0, 0);
        if ((threadIdx.x & 31) == 0) kept[q] = (unsigned long long)k;
    }
}

// LIMIT, pass 2 (one block): query offsets, the kept count into
// ctl[kCnt] and overflow when it passes c_red.
__global__ void limit_scan_kernel(unsigned long long* __restrict__ kept,
                                  long long nq, long long c_red,
                                  long long* __restrict__ ctl) {
    const long long total = scan_inplace(kept, nq);
    if (threadIdx.x == 0) {
        ctl[kCnt] = total;
        if (total > c_red) ctl[kOvf] = 1;
    }
}

// LIMIT, pass 3: the same walk writes each query's kept pairs at its
// offset (first c_red overall); then the pads and the head.
__global__ void limit_write_kernel(const int32_t* __restrict__ ids,
                                   const int32_t* __restrict__ qid,
                                   long long c,
                                   const int32_t* __restrict__ deg,
                                   long long nq, long long limit,
                                   const unsigned long long* __restrict__
                                       kept,
                                   int32_t* __restrict__ out, int pack32,
                                   long long c_red, long long R1,
                                   long long n_rows,
                                   const long long* __restrict__ ctl) {
    const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
    for (long long q = ((long long)blockIdx.x * blockDim.x + threadIdx.x)
                       >> 5;
         q < nq; q += warps)
        limit_walk(ids, qid, c, deg, q, limit, out, pack32, c_red, R1,
                   (long long)kept[q]);
    const long long total = ctl[kCnt];
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t0 == 0) put_head(out, ctl);
    for (long long g = t0; g < c_red; g += stride)
        if (g >= total) put_pad(out, pack32, g, c_red, n_rows);
}

// ---------------------------------------------------------------- K7
// The adaptive program's start (one launch): the frontier list fr [K] =
// the starts, padded with n_rows, and the sticky "may stay sparse" word
// set (the reference's cnt0 <= K: the caller passes at most K starts).
__global__ void adaptive_init_kernel(const int32_t* __restrict__ starts,
                                     long long S, int32_t* __restrict__ fr,
                                     long long K, long long n_rows,
                                     long long* __restrict__ ctl) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t0 == 0) ctl[kSparse] = 1;
    for (long long i = t0; i < K; i += stride)
        fr[i] = i < S ? starts[i] : (int32_t)n_rows;
}

// Before each adaptive hop (one block): a sparse previous hop whose
// unique count passed K ends the sparse mode for good; the sparse arm
// runs this hop only while the mode holds and no vertex of the frontier
// list is a hub (hub[min(v, n)], the list padded with n_rows).  kConv
// is 1 exactly at the hop where the mode first turns dense: the one
// whose layout change to lanes runs; that hop also adds one to *dense
// (null: no tally), so a tally read after many calls counts the calls
// that ran a dense hop.
__global__ void adaptive_switch_kernel(const int32_t* __restrict__ fr,
                                       long long K,
                                       const uint8_t* __restrict__ hub,
                                       long long n, long long n_rows,
                                       long long* __restrict__ ctl,
                                       unsigned long long* dense) {
    int hit = 0;
    for (long long i = threadIdx.x; i < K; i += blockDim.x) {
        const long long v = fr[i];
        if (v != n_rows && hub[v < n ? v : n]) hit = 1;
    }
    hit = __syncthreads_or(hit);
    if (threadIdx.x == 0) {
        long long sparse = ctl[kSparse];
        const long long was = ctl[kMode];
        if (was == kModeSparse && ctl[kCnt] > K) sparse = 0;
        const bool take_sparse = sparse != 0 && !hit;
        ctl[kMode] = take_sparse ? kModeSparse : kModeDense;
        ctl[kSparse] = take_sparse ? 1 : 0;
        const bool conv = !take_sparse && was != kModeDense;
        ctl[kConv] = conv;
        if (conv && dense != nullptr) atomicAdd(dense, 1ull);
    }
}

// The dense arm's layout change: to_lanes writes lane[r] = bit r
// of the state bitmap (lane 0 of a [R1, 4]-byte frontier, one 32-bit
// word per row, little-endian); from_lanes rebuilds the bitmap from bit
// 0 of each row's word.  Gated as the arms' kernels are.
__global__ void bitmap_to_lanes_kernel(const uint32_t* __restrict__ bits,
                                       uint32_t* __restrict__ lanes,
                                       long long R1,
                                       const long long* __restrict__ gate,
                                       long long want) {
    if (gated_off(gate, want)) return;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         r < R1; r += stride)
        lanes[r] = (bits[r >> 5] >> (r & 31)) & 1u;
}

__global__ void bitmap_from_lanes_kernel(const uint32_t* __restrict__ lanes,
                                         uint32_t* __restrict__ bits,
                                         long long R1, long long R1w,
                                         const long long* __restrict__ gate,
                                         long long want) {
    if (gated_off(gate, want)) return;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         w < R1w; w += stride) {
        uint32_t x = 0u;
        for (int k = 0; k < 32; ++k) {
            const long long r = w * 32 + k;
            if (r < R1 && (lanes[r] & 1u)) x |= 1u << k;
        }
        bits[w] = x;
    }
}

// sg_program's plan (ell_ops._sparse_plan owns it): the head words, then
// (c_out, ex, c_lim) per hop.  Offsets count int32 words of the
// workspace; ctl is its first 16 (int64 [8]); [0, zero) is cleared.
enum SparsePlan {
    kPHops, kPNq, kPQmax, kPUpto, kPOp, kPLimit, kPCFin, kPCRed, kPPack,
    kPCMax, kPMark, kPUni, kPScan, kPScratch, kPBufs, kPZero, kPWords,
    kPHead
};

// ad_program's plan (ell_ops._adaptive_plan), the same way.
enum AdaptivePlan {
    kAHops, kAK, kAState, kACand, kAScan, kAFr, kALanes, kAZero, kAWords,
    kAHead
};

}  // namespace

extern "C" {

// K4 over one pair list: the first c_in pairs, or (cnt, a device word)
// the first min(*cnt, c_in); gate / want as the gated kernels' (null:
// always run).  One launch, also on an empty list (the programs'
// launch counts are fixed).
static int expand_launch(const int32_t* ids, const int32_t* qid,
                         int64_t c_in, const long long* cnt,
                         const int32_t* ecnt, const int32_t* e0,
                         const int32_t* nbr, const int32_t* et,
                         const Buckets& bk, const OverSet& ov, int64_t n,
                         int64_t n_rows, int64_t R1w, uint32_t* mark,
                         long long* ctl, int64_t c_lim, int self_mode,
                         const long long* gate, long long want,
                         cudaStream_t s) {
    if (c_in < 0) return -1;
    const long long most = (long long)kExpandBlocksPerSm * sm_count();
    if (most == 0) return (int)cudaErrorInvalidDevice;
    long long blocks = (c_in + 7) / 8;        // at least a pair a warp
    if (blocks > most) blocks = most;
    if (blocks < 1) blocks = 1;
    const long long warps = blocks * kExpandWarps;
    long long ppw = (c_in + warps - 1) / warps;
    ppw = ppw < 1 ? 1 : (ppw > 32 ? 32 : ppw);
    sparse_expand_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
        ids, qid, c_in, cnt, ecnt, e0, nbr, et, bk, ov, n, n_rows, R1w,
        mark, ctl, c_lim, self_mode, (int)ppw, gate, want);
    return (int)cudaGetLastError();
}

// The buckets and the negated OVER set as K4 takes them; false when a
// count is out of range or row0 decreases.
static bool make_buckets(const long long* row0, const long long* slot0,
                         const int* D, int n_buckets, const void* nbr,
                         const void* et, Buckets* bk) {
    if (n_buckets < 1 || n_buckets > kMaxBuckets) return false;
    const bool aligned = (((uintptr_t)nbr | (uintptr_t)et) & 15) == 0;
    bk->n = n_buckets;
    bk->quads = 0u;
    for (int b = 0; b < n_buckets; ++b) {
        if (D[b] < 1 || (b > 0 && row0[b] < row0[b - 1])) return false;
        bk->row0[b] = row0[b];
        bk->slot0[b] = slot0[b];
        bk->D[b] = D[b];
        if (aligned && slot0[b] % 4 == 0 && D[b] % 4 == 0)
            bk->quads |= 1u << b;
    }
    return true;
}

static bool make_over(const int32_t* neg, int n_neg, OverSet* ov) {
    if (n_neg < 0 || n_neg > kMaxOver) return false;
    ov->n = n_neg;
    ov->use_mask = 1;
    ov->mask = 0ull;
    for (int k = 0; k < n_neg; ++k) {
        ov->et[k] = neg[k];
        if (neg[k] < -32 || neg[k] > 31) ov->use_mask = 0;
        else ov->mask |= 1ull << (neg[k] + 32);
    }
    return true;
}

// K4.  bucket_desc: host int64 [n_buckets * 3] (row0, slot0, D); neg:
// host int32 [n_neg], the negated OVER set.  ecnt / e0 null: no hub
// expansion.  qid null: every pair is query 0.  cnt: null, or a device
// int64 word (the previous K5's count, ctl[kCnt]) that cuts the list to
// its first min(*cnt, c_in) pairs.  gate: null, or a device int64 word
// (the adaptive program's mode word) that must equal `want` for the
// launch to run.
int sg_expand(const void* ids, const void* qid, int64_t c_in,
              const void* cnt, const void* ecnt, const void* e0,
              const void* nbr, const void* et, const int64_t* bucket_desc,
              int n_buckets, const int32_t* neg, int n_neg, int64_t n,
              int64_t n_rows, int64_t R1w, void* mark, void* ctl,
              int64_t c_lim, int self_mode, const void* gate, int64_t want,
              void* stream) {
    if (n_buckets < 1 || n_buckets > kMaxBuckets || R1w <= 0) return -1;
    long long row0[kMaxBuckets], slot0[kMaxBuckets];
    int D[kMaxBuckets];
    for (int b = 0; b < n_buckets; ++b) {
        row0[b] = bucket_desc[3 * b];
        slot0[b] = bucket_desc[3 * b + 1];
        D[b] = (int)bucket_desc[3 * b + 2];
    }
    Buckets bk;
    OverSet ov;
    if (!make_buckets(row0, slot0, D, n_buckets, nbr, et, &bk) ||
        !make_over(neg, n_neg, &ov))
        return -1;
    return expand_launch((const int32_t*)ids, (const int32_t*)qid, c_in,
                         (const long long*)cnt, (const int32_t*)ecnt,
                         (const int32_t*)e0, (const int32_t*)nbr,
                         (const int32_t*)et, bk, ov, n, n_rows, R1w,
                         (uint32_t*)mark, (long long*)ctl, c_lim, self_mode,
                         (const long long*)gate, want, (cudaStream_t)stream);
}

// K5's look-back state, int64 words a member, for a bitmap of `words`
// words (ell_ops.compact_state_words).
int64_t sg_compact_state(int64_t words) {
    return kScanHead + (words + kChunk - 1) / kChunk;
}

// K5 for the members of one launch (cc: their row bases and the
// exchange blocks to clear; one member and nothing to clear on one
// card); scan: members * sg_compact_state(words) int64 words, zero
// before its first call (it holds a descriptor a kChunk words, enough
// for either chunk size); gate / want: the adaptive arm's mode word
// (null: always run).  One launch.
static int compact_launch(void* mark, int64_t words, int64_t R1w,
                          int64_t c_out, void* ids_out, void* qid_out,
                          int64_t ids_stride, void* scan, void* ctl,
                          int64_t ex, void* uni, void* copy_to, int zero,
                          int64_t n_rows, int members,
                          const CardCompact& cc, cudaStream_t s,
                          const long long* gate = nullptr,
                          long long want = 0) {
    if (words <= 0 || R1w <= 0 || c_out <= 0 || members < 1 ||
        members > kCardShards || scan == nullptr ||
        (unsigned long long)words * 32 > kValMask)
        return -1;
    const bool wide = words >= kWideWords;
    const long long chunk = wide ? 2 * kChunk : kChunk;
    const long long nb = (words + chunk - 1) / chunk;
    const unsigned gx = wide ? compact_blocks<2 * kWordsPer>(nb, members)
                             : compact_blocks<kWordsPer>(nb, members);
    if (gx == 0) return (int)cudaErrorInvalidDevice;
    const dim3 grid(gx, (unsigned)members);
    if (wide)
        pair_compact_kernel<2 * kWordsPer><<<grid, kThreads, 0, s>>>(
            (uint32_t*)mark, words, R1w, c_out, (int32_t*)ids_out,
            (int32_t*)qid_out, ids_stride, (unsigned long long*)scan,
            sg_compact_state(words), nb, (long long*)ctl, ex,
            (uint32_t*)uni, (uint32_t*)copy_to, zero, n_rows, cc, gate,
            want);
    else
        pair_compact_kernel<kWordsPer><<<grid, kThreads, 0, s>>>(
            (uint32_t*)mark, words, R1w, c_out, (int32_t*)ids_out,
            (int32_t*)qid_out, ids_stride, (unsigned long long*)scan,
            sg_compact_state(words), nb, (long long*)ctl, ex,
            (uint32_t*)uni, (uint32_t*)copy_to, zero, n_rows, cc, gate,
            want);
    return (int)cudaGetLastError();
}

// K5 alone; gate: null, or a device int64 word (the adaptive program's
// mode word) that must equal `want` for the launch to run.
int sg_compact(void* mark, int64_t words, int64_t R1w, int64_t c_out,
               void* ids_out, void* qid_out, void* scan, void* ctl,
               int64_t ex, void* uni, void* copy_to, int zero,
               int64_t n_rows, int64_t row_base, const void* gate,
               int64_t want, void* stream) {
    CardCompact cc = {};
    cc.base[0] = row_base;
    return compact_launch(mark, words, R1w, c_out, ids_out, qid_out, 0,
                          scan, ctl, ex, uni, copy_to, zero, n_rows, 1, cc,
                          (cudaStream_t)stream, (const long long*)gate,
                          want);
}

// K5 over the members of a frontier-sharded card (mesh_sparse.cu's
// mesh_dedup): the marks [members, words], pairs [members, ids_stride],
// ctl [members, 8], scan [members, sg_compact_state(words)]; bases /
// shards: each member's row base and shard; slabs / caps / recv: the
// kClearSlabs exchange slabs [members, k, 1 + cap] (null: none),
// whether each is a receive slab.
int sg_compact_card(void* mark, int64_t words, int64_t R1w, int64_t c_out,
                    void* ids_out, void* qid_out, int64_t ids_stride,
                    void* scan, void* ctl, int64_t n_rows, int members,
                    const int64_t* bases, const int32_t* shards, int k,
                    void* const* slabs, const int64_t* caps,
                    const int32_t* recv, void* stream) {
    if (members < 1 || members > kCardShards || k < 1 ||
        ids_stride < c_out)
        return -1;
    CardCompact cc = {};
    cc.k = k;
    for (int y = 0; y < members; ++y) {
        cc.base[y] = bases[y];
        cc.shard[y] = shards[y];
    }
    for (int j = 0; j < kClearSlabs; ++j) {
        cc.slab[j] = (long long*)slabs[j];
        cc.cap[j] = caps[j];
        cc.recv[j] = recv[j];
        if (slabs[j] && caps[j] <= 0) return -1;
    }
    return compact_launch(mark, words, R1w, c_out, ids_out, qid_out,
                          ids_stride, scan, ctl, -1, nullptr, nullptr, 1,
                          n_rows, members, cc, (cudaStream_t)stream);
}

// K6's plain result (op 0, the unpacked layout) for the members of a
// frontier-sharded card at once: ids / qid [members, c], out [members,
// 2 + 2c], ctl [members, 8].
int sg_emit(const void* ids, const void* qid, int64_t c, void* out,
            int members, int64_t R1, int64_t n_rows, const void* ctl,
            void* stream) {
    if (c <= 0 || R1 <= 0 || members < 1 || members > kCardShards)
        return -1;
    pair_emit_kernel<<<dim3(blocks_for(c, kThreads), (unsigned)members),
                       kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)ids, (const int32_t*)qid, c, (int32_t*)out,
        2 + 2 * c, 0, R1, n_rows, (const long long*)ctl);
    return (int)cudaGetLastError();
}

// K6.  op 0: the plain layout of the c-pair list; 1: COUNT into
// out[2 .. 2 + qmax) (zero before); 2: LIMIT cut compacted to c_red
// (scratch: uint64 [nq]).  out[0..1] get (count, overflow) from ctl.
static int reduce_launch(int op, const int32_t* ids, const int32_t* qid,
                         int64_t c, const int32_t* deg, int32_t* out,
                         int pack32, int64_t R1, int64_t n_rows, int64_t nq,
                         int64_t qmax, int64_t limit, int64_t c_red,
                         unsigned long long* scratch, long long* ctl,
                         cudaStream_t s) {
    if (c <= 0 || R1 <= 0) return -1;
    if (op == 0) {
        pair_emit_kernel<<<blocks_for(c, kThreads), kThreads, 0, s>>>(
            ids, qid, c, out, 0, pack32, R1, n_rows, ctl);
        return (int)cudaGetLastError();
    }
    if (op == 1) {
        if (qmax <= 0 || deg == nullptr) return -1;
        pair_count_fold_kernel<<<blocks_for(c, kThreads), kThreads, 0,
                                 s>>>(ids, qid, c, deg, out, qmax, ctl);
        return (int)cudaGetLastError();
    }
    if (op != 2 || nq <= 0 || c_red <= 0 || limit < 0 || deg == nullptr)
        return -1;
    const unsigned warp_blocks = blocks_for(nq * 32, kThreads);
    limit_count_kernel<<<warp_blocks, kThreads, 0, s>>>(
        ids, qid, c, deg, nq, limit, scratch);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    limit_scan_kernel<<<1, kScanThreads, 0, s>>>(scratch, nq, c_red, ctl);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const long long pad_threads = c_red > nq * 32 ? c_red : nq * 32;
    limit_write_kernel<<<blocks_for(pad_threads, kThreads), kThreads, 0,
                         s>>>(ids, qid, c, deg, nq, limit, scratch, out,
                              pack32, c_red, R1, n_rows, ctl);
    return (int)cudaGetLastError();
}

int sg_reduce(int op, const void* ids, const void* qid, int64_t c,
              const void* deg, void* out, int pack32, int64_t R1,
              int64_t n_rows, int64_t nq, int64_t qmax, int64_t limit,
              int64_t c_red, void* scratch, void* ctl, void* stream) {
    return reduce_launch(op, (const int32_t*)ids, (const int32_t*)qid, c,
                         (const int32_t*)deg, (int32_t*)out, pack32, R1,
                         n_rows, nq, qmax, limit, c_red,
                         (unsigned long long*)scratch, (long long*)ctl,
                         (cudaStream_t)stream);
}

// The tables' buckets and negated OVER set as the kernels take them;
// false when a count is out of range.
static bool read_tables(const SparseTables& t, Buckets* bk, OverSet* ov) {
    if (t.n_neg < 1 || t.n < 0 || t.n_rows < t.n ||
        t.R1w != (t.n_rows + 32) / 32 || t.nbr == nullptr ||
        t.et == nullptr)
        return false;
    return make_buckets(t.row0, t.slot0, t.D, t.n_buckets, t.nbr, t.et,
                        bk) &&
           make_over(t.neg, t.n_neg, ov);
}

// true when [at, at + len) lies in [lo, hi)
static bool inside(int64_t at, int64_t len, int64_t lo, int64_t hi) {
    return len >= 0 && at >= lo && at + len <= hi;
}

// true when [a, a + n) and [b, b + m) share a word
static bool overlap(int64_t a, int64_t n, int64_t b, int64_t m) {
    return n > 0 && m > 0 && a < b + m && b < a + n;
}

// The sparse GO program (ell.py:1222 make_batched_sparse_go_kernel, the
// order of ell_ops._sparse_go_steps): one memset of the workspace's
// [0, zero) words (ctl, the mark bitmap, the UPTO union, K5's look-back
// state, which every K5 call of the program shares); with UPTO the
// starts' self-mark into the union; per hop K4 then K5 (one launch)
// into the next pair buffer, the union ORed; with UPTO the
// union's compaction to the final cap; then K6 in the asked form into
// out (COUNT zeroes out first: its fold adds).  ids / qid: int32 [c0]
// starts; deg: int32 [n_rows + 1] (COUNT and LIMIT); plan: host int64
// [n_plan]; ws: int32 [plan[kPWords]]; out: int32 [out_words].
// launched: host int32 [3], the K4, K5 and K6 calls made (each K5 call
// one launch, a LIMIT K6 three), written however the call ends.
// Returns 0, a cudaError_t, or -1 for an argument the kernels cannot
// take.
int sg_program(SparseTables t, const void* ids, const void* qid,
               int64_t c0, const void* deg, const int64_t* plan,
               int n_plan, void* ws, void* out, int64_t out_words,
               void* stream, int32_t* launched) {
    launched[0] = launched[1] = launched[2] = 0;
    Buckets bk;
    OverSet ov;
    if (n_plan < kPHead || !read_tables(t, &bk, &ov)) return -1;
    const long long hops = plan[kPHops], nq = plan[kPNq];
    const long long qmax = plan[kPQmax], op = plan[kPOp];
    const long long c_fin = plan[kPCFin], c_red = plan[kPCRed];
    const long long cmax = plan[kPCMax], total = plan[kPWords];
    const int upto = (int)plan[kPUpto], pack32 = (int)plan[kPPack];
    const long long R1 = t.n_rows + 1, words = nq * t.R1w;
    if (hops < 1 || n_plan != kPHead + 3 * hops || nq < 1 || nq > qmax ||
        c0 < 1 || op < 0 || op > 2 || cmax < 1 || c_fin < 1 ||
        (op != 0 && deg == nullptr))
        return -1;
    const long long width = op == 1 ? qmax : op == 2 ? c_red : c_fin;
    const long long want_out = 2 + (op != 1 && !pack32 ? 2 : 1) * width;
    if (width < 1 || out_words != want_out) return -1;
    const long long scan = 2 * sg_compact_state(words);   // int32 words
    if (plan[kPMark] != 16 ||
        plan[kPZero] < 16 + words * (upto ? 2 : 1) + scan ||
        !inside(plan[kPMark], words, 16, plan[kPZero]) ||
        (upto && (!inside(plan[kPUni], words, 16, plan[kPZero]) ||
                  overlap(plan[kPUni], words, plan[kPMark], words))) ||
        plan[kPScan] % 2 || !inside(plan[kPScan], scan, 16, plan[kPZero]) ||
        overlap(plan[kPScan], scan, plan[kPMark], words) ||
        (upto && overlap(plan[kPScan], scan, plan[kPUni], words)) ||
        plan[kPScratch] % 2 ||
        !inside(plan[kPScratch], op == 2 ? 2 * nq : 0, plan[kPZero],
                total) ||
        !inside(plan[kPBufs], 4 * cmax, plan[kPZero], total))
        return -1;
    for (long long h = 0; h < hops; ++h) {
        const int64_t* hp = plan + kPHead + 3 * h;
        if (hp[0] < 1 || hp[0] > cmax) return -1;
    }
    if (upto && c_fin > cmax) return -1;
    cudaStream_t s = (cudaStream_t)stream;
    int32_t* w = (int32_t*)ws;
    long long* ctl = (long long*)w;
    uint32_t* mark = (uint32_t*)(w + plan[kPMark]);
    uint32_t* uni = upto ? (uint32_t*)(w + plan[kPUni]) : nullptr;
    void* scan_at = w + plan[kPScan];
    int32_t* bufs = w + plan[kPBufs];
    const bool hubs = t.ecnt != nullptr && t.e0 != nullptr &&
                      t.n_rows > t.n;
    const CardCompact one = {};
    cudaError_t err = cudaMemsetAsync(ws, 0, (size_t)plan[kPZero] * 4, s);
    if (err != cudaSuccess) return (int)err;
    int rc = 0;
    if (upto) {
        rc = expand_launch((const int32_t*)ids, (const int32_t*)qid, c0,
                           nullptr, nullptr, nullptr, t.nbr, t.et, bk, ov,
                           t.n, t.n_rows, t.R1w, uni, ctl, 0, 1, nullptr, 0,
                           s);
        if (rc != 0) return rc;
        ++launched[0];
    }
    const int32_t* cur_i = (const int32_t*)ids;
    const int32_t* cur_q = (const int32_t*)qid;
    long long c_in = c0;
    for (long long h = 0; h < hops; ++h) {
        const int64_t* hp = plan + kPHead + 3 * h;    // c_out, ex, c_lim
        // from the second hop the list is K5's: its count in ctl
        rc = expand_launch(cur_i, cur_q, c_in, h > 0 ? ctl + kCnt : nullptr,
                           hubs ? t.ecnt : nullptr, hubs ? t.e0 : nullptr,
                           t.nbr, t.et, bk, ov, t.n, t.n_rows, t.R1w, mark,
                           ctl, hp[2], 0, nullptr, 0, s);
        if (rc != 0) return rc;
        ++launched[0];
        int32_t* nxt_i = bufs + (h % 2) * 2 * cmax;
        rc = compact_launch(mark, words, t.R1w, hp[0], nxt_i, nxt_i + cmax,
                            0, scan_at, ctl, hp[1], uni, nullptr, 1,
                            t.n_rows,
                            1, one, s);
        if (rc != 0) return rc;
        ++launched[1];
        cur_i = nxt_i;
        cur_q = nxt_i + cmax;
        c_in = hp[0];
    }
    if (upto) {
        int32_t* fin_i = bufs + (hops % 2) * 2 * cmax;
        rc = compact_launch(uni, words, t.R1w, c_fin, fin_i, fin_i + cmax,
                            0, scan_at, ctl, -1, nullptr, nullptr, 0,
                            t.n_rows, 1, one, s);
        if (rc != 0) return rc;
        ++launched[1];
        cur_i = fin_i;
        cur_q = fin_i + cmax;
        c_in = c_fin;
    }
    if (op == 1) {
        err = cudaMemsetAsync(out, 0, (size_t)out_words * 4, s);
        if (err != cudaSuccess) return (int)err;
    }
    rc = reduce_launch((int)op, cur_i, cur_q, c_in, (const int32_t*)deg,
                       (int32_t*)out, pack32, R1, t.n_rows, nq, qmax,
                       plan[kPLimit], c_red,
                       (unsigned long long*)(w + plan[kPScratch]), ctl, s);
    if (rc != 0) return rc;
    ++launched[2];
    return 0;
}

// K7.  hub: uint8 [n + 1]; fr: int32 [K] padded with n_rows; dense:
// null, or a device int64 tally of the calls that turned dense.
int ad_switch(const void* fr, int64_t K, const void* hub, int64_t n,
              int64_t n_rows, void* ctl, void* dense, void* stream) {
    if (K <= 0 || n < 0) return -1;
    adaptive_switch_kernel<<<1, kScanThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)fr, K, (const uint8_t*)hub, n, n_rows,
        (long long*)ctl, (unsigned long long*)dense);
    return (int)cudaGetLastError();
}

// The layout change (gate null: always; else only while *gate == want,
// on a grid of gated_blocks).
static int lanes_launch(int to_lanes, uint32_t* bits, uint32_t* lanes,
                        int64_t R1, const long long* gate, long long want,
                        cudaStream_t s) {
    if (R1 <= 0) return -1;
    const long long R1w = (R1 + 31) / 32;
    unsigned grid = blocks_for(to_lanes ? R1 : R1w, kThreads);
    if (gate != nullptr && (grid = gated_blocks(grid)) == 0)
        return (int)cudaErrorInvalidDevice;
    if (to_lanes)
        bitmap_to_lanes_kernel<<<grid, kThreads, 0, s>>>(bits, lanes, R1,
                                                         gate, want);
    else
        bitmap_from_lanes_kernel<<<grid, kThreads, 0, s>>>(lanes, bits, R1,
                                                           R1w, gate, want);
    return (int)cudaGetLastError();
}

// to_lanes 1: bits (uint32 [R1w]) -> lanes (uint32 [R1]); 0: back.
int ad_bitmap_lanes(int to_lanes, void* bits, void* lanes, int64_t R1,
                    void* stream) {
    return lanes_launch(to_lanes, (uint32_t*)bits, (uint32_t*)lanes, R1,
                        nullptr, 0, (cudaStream_t)stream);
}

// The adaptive single-query GO (ell.py:1493 make_adaptive_go_kernel, the
// order of ell_ops._adaptive_steps), every hop enqueued with its mode
// chosen on the card: one memset of the workspace's [0, zero) words
// (ctl, the state bitmap, the candidate bitmap, K5's look-back state,
// which every hop's K5 shares); the frontier list from
// the starts and the state's self-mark; then per hop K7, the layout
// change to lanes (only at the hop where the mode first turns dense),
// the sparse arm (K4 and K5: the list pushed, the candidates compacted
// to K ids, the state replaced by every candidate) and the dense arm
// (ell_lanes.cu's hop and hub merge on lane 0, lanes[h % 2] ->
// lanes[(h + 1) % 2]), each arm's kernels returning at once on the
// other arm's hops; last the layout change back into the state (only
// when a dense hop ran).  starts: int32 [S <= K]; hub: uint8 [n + 1];
// aplan: host int64 [kAHead]; hop_plan / blocks / lgc: ell_ops._hop_desc
// at W = 4 (4-byte columns); over: host int32 [n_over], the OVER set;
// eslot / hrows: the hub merge's arrays; dense: null, or a device int64
// tally to which K7 adds one when the call turns dense.  launched: host
// int32 [5], the K4, K5, K7, layout-change and hop calls made (the gated
// ones included), written however the call ends.
int ad_program(SparseTables t, const void* starts, int64_t S,
               const void* hub, const int64_t* aplan,
               const int64_t* hop_plan, int64_t blocks, int lgc,
               const int32_t* over, int n_over, const void* eslot,
               const void* hrows, void* dense, void* ws, void* stream,
               int32_t* launched) {
    for (int k = 0; k < 5; ++k) launched[k] = 0;
    Buckets bk;
    OverSet ov;
    if (!read_tables(t, &bk, &ov)) return -1;
    const long long hops = aplan[kAHops], K = aplan[kAK];
    const long long R1 = t.n_rows + 1, R1w = t.R1w;
    const long long total = aplan[kAWords], zero = aplan[kAZero];
    const long long scan = 2 * sg_compact_state(R1w);     // int32 words
    if (hops < 0 || K < 1 || S < 0 || S > K || aplan[kAState] != 16 ||
        !inside(aplan[kAState], R1w, 16, zero) ||
        !inside(aplan[kACand], R1w, 16, zero) ||
        overlap(aplan[kAState], R1w, aplan[kACand], R1w) ||
        aplan[kAScan] % 2 || !inside(aplan[kAScan], scan, 16, zero) ||
        overlap(aplan[kAScan], scan, aplan[kAState], R1w) ||
        overlap(aplan[kAScan], scan, aplan[kACand], R1w) ||
        !inside(aplan[kAFr], K, zero, total) ||
        !inside(aplan[kALanes], 2 * R1, zero, total))
        return -1;
    cudaStream_t s = (cudaStream_t)stream;
    int32_t* w = (int32_t*)ws;
    long long* ctl = (long long*)w;
    uint32_t* state = (uint32_t*)(w + aplan[kAState]);
    uint32_t* cand = (uint32_t*)(w + aplan[kACand]);
    int32_t* fr = w + aplan[kAFr];
    void* scan_at = w + aplan[kAScan];
    uint32_t* lanes = (uint32_t*)(w + aplan[kALanes]);
    const long long* mode = ctl + kMode;
    const CardCompact one = {};
    cudaError_t err = cudaMemsetAsync(ws, 0, (size_t)zero * 4, s);
    if (err != cudaSuccess) return (int)err;
    adaptive_init_kernel<<<blocks_for(K, kThreads), kThreads, 0, s>>>(
        (const int32_t*)starts, S, fr, K, t.n_rows, ctl);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    int rc = expand_launch(fr, nullptr, S, nullptr, nullptr, nullptr, t.nbr,
                           t.et, bk, ov, t.n, t.n_rows, R1w, state, ctl, 0,
                           1, nullptr, 0, s);
    if (rc != 0) return rc;
    ++launched[0];
    for (long long h = 0; h < hops; ++h) {
        uint32_t* f_in = lanes + (h % 2) * R1;
        uint32_t* f_out = lanes + ((h + 1) % 2) * R1;
        adaptive_switch_kernel<<<1, kScanThreads, 0, s>>>(
            fr, K, (const uint8_t*)hub, t.n, t.n_rows, ctl,
            (unsigned long long*)dense);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        ++launched[2];
        rc = lanes_launch(1, state, f_in, R1, ctl + kConv, 1, s);
        if (rc != 0) return rc;
        ++launched[3];
        // the first hop's list is the S starts; a later one is K5's,
        // its count in ctl
        rc = expand_launch(fr, nullptr, h > 0 ? K : S,
                           h > 0 ? ctl + kCnt : nullptr, nullptr, nullptr,
                           t.nbr, t.et, bk, ov, t.n, t.n_rows, R1w, cand,
                           ctl, 0, 0, mode, kModeSparse, s);
        if (rc != 0) return rc;
        ++launched[0];
        rc = compact_launch(cand, R1w, R1w, K, fr, nullptr, 0, scan_at,
                            ctl, -1, nullptr, state, 1, t.n_rows, 1, one,
                            s, mode, kModeSparse);
        if (rc != 0) return rc;
        ++launched[1];
        rc = ell_go_hop(f_in, nullptr, f_out, t.nbr, t.et, hop_plan,
                        t.n_buckets, blocks, lgc, 0, eslot, hrows,
                        t.n_rows - t.n, over, n_over, t.n, t.n_rows, 4,
                        mode, kModeDense, stream);
        if (rc != 0) return rc;
        ++launched[4];
    }
    rc = lanes_launch(0, state, lanes + (hops % 2) * R1, R1, mode,
                      kModeDense, s);
    if (rc != 0) return rc;
    ++launched[3];
    return 0;
}

}  // extern "C"
