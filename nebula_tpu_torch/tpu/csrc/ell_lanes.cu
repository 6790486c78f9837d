// Lane kernels for Hopper (sm_90a), behind a plain C interface that
// nebula_tpu_torch/tpu/ell_ops.py loads with ctypes: the continuous
// session's hop, join, extract and clear, the windowed path's packed
// frontier upload, per-lane COUNT(*) fold and BFS level pass, the
// replicated-frontier mesh's M1 gather and hub merge over every shard
// of a card, and the mesh's multi-source OR (psum_or's combine).
//
// Layout shared by every kernel: the resident frontier pair fp / accp is
// uint8 [n_rows + 1, W] row-major, 8 query lanes per byte (bit k of byte
// j is lane 8j + k), W % 4 == 0, so each row is a whole number of 32-bit
// words and the kernels work on uint32 words (the hop on 16-byte
// columns where W % 16 == 0).  Row n_rows is the pad row:
// every sentinel slot points at it and it stays zero.  Byte and word
// offsets are 64-bit (rows * W passes 2^31 at 2^24 rows and W = 128).
//
// Every kernel runs on the caller's stream, allocates nothing and does
// not synchronise; each entry point returns cudaGetLastError() after its
// launches (0 = launched).  Nothing here needs a matrix unit: every
// kernel is bound by device-memory traffic.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hop_plan.cuh"
#include "sm_count.cuh"

// The OR-combine's sources, by value: at global scope, since the
// extern "C" entry point builds it (a struct of an anonymous namespace
// would give that entry internal linkage under nvcc).
constexpr int kMaxSrcs = 16;
struct OrSources {
    const void* p[kMaxSrcs];
    int m;
};

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1LL << 20;   // grid-stride beyond this
constexpr int kUploadBytes = 8192;     // frontier bytes a block of the upload
constexpr int kCountWarps = kThreads / 32;
constexpr int kCountRows = 8;          // rows' words a count thread loads together
constexpr int kCountBlocksPerSm = 4;
constexpr int kCountReplicas = 16;     // the count's persistent accumulators
constexpr int kCountSparse = 2;        // set (or clear) bits a word adds by
                                       // shared atomics rather than pairs
constexpr uint32_t kCountPairDeg = 0xFFFu;  // the largest deg the pairs take:
                                       // 16 words at least between flushes
constexpr int kCountMaxLanes = 8 * 1024;                  // 8W, W <= 1024
constexpr int kCountTicket = kCountReplicas * kCountMaxLanes;  // state word
constexpr uint32_t kInt16Inf = 0x7FFF;         // ell.py:51 INT16_INF

inline unsigned grid_for(long long total) {
    long long blocks = (total + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    if (blocks < 1) blocks = 1;
    return (unsigned)blocks;
}

__device__ __forceinline__ uint4 or_v(uint4 a, uint4 b) {
    return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
}
__device__ __forceinline__ uint32_t or_v(uint32_t a, uint32_t b) {
    return a | b;
}

// the hop's plan, OVER set and element helpers (hop_plan.cuh)
using HopPlan = hop::Plan;
using hop::OverSet;
using hop::in_over;
using hop::kChunk;
using hop::shfl_x;
using hop::zero_v;

// ---------------------------------------------------------------- hop
// Replaces nebula_tpu/tpu/ell.py:665 make_continuous_hop_kernel (body
// _hop_body_packed :556, _bucket_expand_packed :541, _etype_ok :361):
// out[r] = OR over row r's D slots of fp[nbr] where the slot's etype is
// in the OVER set, and, with an accumulator, accp[r] |= out[r] (the
// UPTO union, fused: the hub merge below ORs its extra rows into both).
//
// Bound on this card: bytes — the slot tables (8 bytes a slot) once,
// the gathered source rows (mostly L2 hits at W = 16; at W = 128 the
// frontier passes the 50 MB L2), out written once and accp read and
// written once.  The design moves fewer and wider bytes with many in
// flight:
//   * a block takes kThreads / G consecutive rows of ONE bucket (the
//     host's plan), so it finds its bucket once;
//   * a row belongs to G = Cg * P lanes: Cg lanes split its C columns
//     (16 bytes each when V is uint4, W % 16 == 0; 4 bytes otherwise)
//     and P parts split its D slots; the parts read the row's slots as
//     consecutive 16-byte units (Q: 4 slots a unit) or 4-byte ones;
//   * a lane loads its chunk's kChunk slots before any gather, skips
//     pad slots (nbr == n_rows) and etypes outside OVER, and issues its
//     gathers together;
//   * the parts' partial ORs meet by __shfl_xor_sync, and part 0 writes
//     out and accp once;
//   * kMinBlocks > 1 caps the registers so more warps share an SM: at
//     8 or more 16-byte columns a row (W >= 128) most gathers miss the
//     L2 and more loads in flight win (on an H100 SXM at 700 W, 0.27
//     against 0.32 ms a hop at W = 128 on chip_smoke.py's serve
//     tables), while at W = 16 the same cap costs 9%.
// The plan and OVER set are hop_plan.cuh's.  The mesh's M1 runs the
// same rows over every shard of a card (mesh_gather_kernel below).  The
// output is a separate buffer: every gather reads the previous
// generation, so the caller ping-pongs two.  Block 0 zeroes the pad row
// of out (no other thread writes it); accp's pad row stays zero.

// block blk's bucket (uniform over the block)
__device__ __forceinline__ int plan_bucket(const HopPlan& pl, int blk) {
    int b = 0;
    for (int k = 1; k < pl.n; ++k)
        if (pl.blk0[k] <= blk) b = k;
    return b;
}

// The gather of block blk of bucket b, whose rows start at frontier row
// row0 and whose first `rows` block rows are live.
template <typename V, bool Q>
__device__ __forceinline__ void hop_rows(const V* __restrict__ fp,
                                         V* __restrict__ out,
                                         V* __restrict__ accp,
                                         const int32_t* __restrict__ nbr,
                                         const int32_t* __restrict__ et,
                                         const HopPlan& pl,
                                         const OverSet& ov,
                                         long long n_rows, int C, int lgc,
                                         int blk, int b, long long row0,
                                         long long rows) {
    const int lg = pl.lg[b];
    const int G = 1 << lg;
    const int lane = threadIdx.x & (G - 1);
    const long long lr = (long long)(blk - pl.blk0[b]) * (kThreads >> lg)
                         + (threadIdx.x >> lg);
    const bool live = lr < rows;
    const int D = pl.D[b];
    const int Cg = 1 << lgc;
    const int P = G >> lgc;             // slot parts of a row
    const int part = lane >> lgc;
    const int col0 = lane & (Cg - 1);
    constexpr int U = Q ? 4 : 1;        // slots a unit
    constexpr int UC = kChunk / U;      // units a lane holds at once
    const int NU = D / U;               // units of a row
    const long long base = pl.slot0[b] + lr * D;
    const int32_t pad = (int32_t)n_rows;
    const long long r = row0 + lr;
    // every lane runs the same trip counts (C, NU, P are the block's),
    // so the whole warp reaches each shuffle
    for (int cb = 0; cb < C; cb += Cg) {
        const int c = cb + col0;
        const bool act = live && c < C;
        V acc;
        zero_v(acc);
        for (int u0 = 0; u0 < NU; u0 += P * UC) {
            int nb[kChunk];
            unsigned ok = 0u;
#pragma unroll
            for (int q = 0; q < UC; ++q) {
                const int u = u0 + part + q * P;
                if constexpr (Q) {
                    int4 a = make_int4(pad, pad, pad, pad);
                    int4 e = make_int4(0, 0, 0, 0);
                    if (act && u < NU) {
                        a = __ldcs(reinterpret_cast<const int4*>(nbr + base)
                                   + u);
                        e = __ldcs(reinterpret_cast<const int4*>(et + base)
                                   + u);
                    }
                    nb[4 * q] = a.x;
                    nb[4 * q + 1] = a.y;
                    nb[4 * q + 2] = a.z;
                    nb[4 * q + 3] = a.w;
                    ok |= (unsigned)(a.x != pad && in_over(e.x, ov)) << 4 * q;
                    ok |= (unsigned)(a.y != pad && in_over(e.y, ov))
                          << (4 * q + 1);
                    ok |= (unsigned)(a.z != pad && in_over(e.z, ov))
                          << (4 * q + 2);
                    ok |= (unsigned)(a.w != pad && in_over(e.w, ov))
                          << (4 * q + 3);
                } else {
                    int a = pad, e = 0;
                    if (act && u < NU) {
                        a = __ldcs(nbr + base + u);
                        e = __ldcs(et + base + u);
                    }
                    nb[q] = a;
                    ok |= (unsigned)(a != pad && in_over(e, ov)) << q;
                }
            }
            V g[kChunk];
#pragma unroll
            for (int j = 0; j < kChunk; ++j) {
                zero_v(g[j]);
                if ((ok >> j) & 1u) g[j] = fp[(long long)nb[j] * C + c];
            }
#pragma unroll
            for (int j = 0; j < kChunk; ++j) acc = or_v(acc, g[j]);
        }
        for (int o = Cg; o < G; o <<= 1) acc = or_v(acc, shfl_x(acc, o));
        if (act && part == 0) {
            const long long i = r * C + c;
            out[i] = acc;
            if (accp) accp[i] = or_v(accp[i], acc);
        }
    }
}

// Plan block blk of the hop: block 0 also zeroes out's pad row.
template <typename V, bool Q>
__device__ __forceinline__ void gather_block(const V* __restrict__ fp,
                                             V* __restrict__ out,
                                             V* __restrict__ accp,
                                             const int32_t* __restrict__ nbr,
                                             const int32_t* __restrict__ et,
                                             const HopPlan& pl,
                                             const OverSet& ov,
                                             long long n_rows, int C,
                                             int lgc, int blk) {
    if (blk == 0)
        for (int t = threadIdx.x; t < C; t += blockDim.x)
            zero_v(out[n_rows * C + t]);
    const int b = plan_bucket(pl, blk);
    hop_rows<V, Q>(fp, out, accp, nbr, et, pl, ov, n_rows, C, lgc, blk, b,
                   pl.row0[b], pl.rows[b]);
}

template <typename V, bool Q, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
hop_gather_kernel(const V* __restrict__ fp, V* __restrict__ out,
                  V* __restrict__ accp, const int32_t* __restrict__ nbr,
                  const int32_t* __restrict__ et, HopPlan pl, OverSet ov,
                  long long n_rows, int C, int lgc) {
    gather_block<V, Q>(fp, out, accp, nbr, et, pl, ov, n_rows, C, lgc,
                       (int)blockIdx.x);
}

// The hop gated on a device word (the adaptive program's dense arm): it
// returns at once unless *gate == want, and walks the plan's n_blocks
// blocks from a grid of at most a full card's worth of resident blocks,
// so that a hop of the other arm costs the card one small launch, not
// the plan's whole grid of empty blocks.  The bounds say one block an
// SM, as hop_gather_kernel's do: with (kThreads) alone ptxas gave this
// loop 32 registers, fewer gathers in flight, and the open hop ran 10 %
// slower than the plain one (52 registers and about 2 % with these).
template <typename V, bool Q>
__global__ void __launch_bounds__(kThreads, 1)
hop_gather_gated_kernel(const V* __restrict__ fp, V* __restrict__ out,
                        V* __restrict__ accp,
                        const int32_t* __restrict__ nbr,
                        const int32_t* __restrict__ et, HopPlan pl,
                        OverSet ov, long long n_rows, int C, int lgc,
                        int n_blocks, const long long* __restrict__ gate,
                        long long want) {
    if (*gate != want) return;                      // the other arm's hop
    for (int blk = (int)blockIdx.x; blk < n_blocks; blk += gridDim.x)
        gather_block<V, Q>(fp, out, accp, nbr, et, pl, ov, n_rows, C, lgc,
                           blk);
}

// M1, the replicated-frontier mesh's gather (replaces the per-shard
// hop of nebula_tpu/tpu/ell.py:1740 _make_sharded_hop_packed): every
// member y of a card (blockIdx.y) gathers its shard's chunk rows from
// its replica fp + y * stride into out + y * stride, on shard 0's plan
// (the most rows any shard has a bucket; a shard's blocks past its own
// rows do nothing).  No accumulator, no merge: the merge runs after
// the replication.
template <typename V, bool Q, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
mesh_gather_kernel(const V* __restrict__ fp, V* __restrict__ out,
                   long long stride, hop::MeshHop mh, HopPlan pl,
                   OverSet ov, long long n_rows, int C, int lgc) {
    const int y = (int)blockIdx.y;
    const int blk = (int)blockIdx.x;
    fp += y * stride;
    out += y * stride;
    if (blk == 0)
        for (int t = threadIdx.x; t < C; t += blockDim.x)
            zero_v(out[n_rows * C + t]);
    const int b = plan_bucket(pl, blk);
    hop_rows<V, Q>(fp, out, nullptr, mh.nbr[y], mh.et[y], pl, ov, n_rows,
                   C, lgc, blk, b, pl.row0[b] + mh.shard[y] * mh.chunk[b],
                   hop::mesh_rows(mh, y, b, pl.rows[b]));
}


// Hub fix-up: OR each extra row n + e into its owner hrows[eslot[e]],
// in out and, when given, in accp (the hop's fused union: an extra row's
// out is final after the gather, since extra rows are never owners).
// Replaces the bit-plane max of _scatter_or_rows (ell.py:519), which
// exists only because XLA has no OR-scatter; a 32-bit atomicOr is exact
// for duplicate owners.  Owners >= n_rows are unclaimed growth spares
// and merge nowhere.  Extra rows keep their partial values (they are
// never gather sources and are re-derived next hop), as in the
// reference.  Bound: bytes, O(n_extras * W).
__device__ __forceinline__ void merge_rows(uint32_t* __restrict__ out,
                                           uint32_t* __restrict__ accp,
                                           const int32_t* __restrict__ eslot,
                                           const int32_t* __restrict__ hrows,
                                           long long n, long long n_rows,
                                           long long n_extras, int W4) {
    const long long total = n_extras * (long long)W4;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < total; i += stride) {
        const long long e = i / W4;
        const int w = (int)(i - e * W4);
        const long long owner = hrows[eslot[e]];
        if (owner < 0 || owner >= n_rows) continue;
        const uint32_t v = out[(n + e) * W4 + w];
        if (!v) continue;
        atomicOr(out + owner * W4 + w, v);
        if (accp) atomicOr(accp + owner * W4 + w, v);
    }
}

__global__ void hop_merge_kernel(uint32_t* __restrict__ out,
                                 uint32_t* __restrict__ accp,
                                 const int32_t* __restrict__ eslot,
                                 const int32_t* __restrict__ hrows,
                                 long long n, long long n_rows,
                                 long long n_extras, int W4,
                                 const long long* __restrict__ gate,
                                 long long want) {
    if (gate != nullptr && *gate != want) return;
    merge_rows(out, accp, eslot, hrows, n, n_rows, n_extras, W4);
}

// The mesh hop's merge on every replica of a card (blockIdx.y: the
// replica out + y * stride words), after the owned rows were replicated
// (ell.py:1780-1788).
__global__ void mesh_merge_kernel(uint32_t* __restrict__ out,
                                  long long stride,
                                  const int32_t* __restrict__ eslot,
                                  const int32_t* __restrict__ hrows,
                                  long long n, long long n_rows,
                                  long long n_extras, int W4) {
    merge_rows(out + blockIdx.y * stride, nullptr, eslot, hrows, n, n_rows,
               n_extras, W4);
}

// dst |= src[0] | ... | src[m - 1] over `words` 32-bit words: the first
// n16 * 4 as 16-byte loads and stores (every operand 16-byte aligned),
// the rest as words.  Replaces the combine of nebula_tpu/tpu/
// kernels.py:384's psum (the mesh's psum_or ORs each shard's receive
// slab into its output with one launch).  Bound: bytes, (m + 2) * 4 *
// words; a call of a few words is one warp.
__global__ void or_many_kernel(uint32_t* __restrict__ dst, OrSources src,
                               long long n16, long long words) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (long long i = t0; i < n16; i += stride) {
        uint4 v = d4[i];
        for (int k = 0; k < src.m; ++k)
            v = or_v(v, reinterpret_cast<const uint4*>(src.p[k])[i]);
        d4[i] = v;
    }
    for (long long i = 4 * n16 + t0; i < words; i += stride) {
        uint32_t v = dst[i];
        for (int k = 0; k < src.m; ++k)
            v |= reinterpret_cast<const uint32_t*>(src.p[k])[i];
        dst[i] = v;
    }
}

// --------------------------------------------------------------- join
// Replaces ell.py:691 make_lane_join_kernel (a scatter-ADD of single
// lane bits).  Under the clear contract (the host dedups each
// (row, lane) and a freed lane's bits are zero) add IS or, so a 32-bit
// atomicOr of val << 8 * (byte & 3) into the containing word is exact
// and needs no ordering between entries.  Entries aimed at the pad row
// (the padding) or out of range are skipped, and the pad row is zeroed
// by the first W4 threads — no entry writes it, so there is no race.
// accp may be null (one carrier).  Bound: bytes, a read-modify-write
// per entry in each carrier.
__global__ void lane_join_kernel(uint32_t* __restrict__ fp,
                                 uint32_t* __restrict__ accp,
                                 const int32_t* __restrict__ rows,
                                 const int32_t* __restrict__ words,
                                 const uint8_t* __restrict__ vals,
                                 long long S, long long n_rows, int W,
                                 int W4) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < W4) {
        fp[n_rows * W4 + i] = 0u;
        if (accp) accp[n_rows * W4 + i] = 0u;
    }
    if (i >= S) return;
    const long long r = rows[i];
    const int w = words[i];
    const uint32_t v = vals[i];
    if (r < 0 || r >= n_rows || w < 0 || w >= W || v == 0u) return;
    const long long byte = r * W + w;
    const uint32_t bits = v << (8u * (uint32_t)(byte & 3));
    atomicOr(fp + (byte >> 2), bits);
    if (accp) atomicOr(accp + (byte >> 2), bits);
}

// ---------------------------------------------------- frontier upload
// Replaces nebula_tpu/tpu/runtime.py:3251 _upload_frontier_packed's
// device half (zeros, then a scatter-add of the deduped lane bits).  The
// entries (rows[i], lanes[i]) come sorted by (row, lane), so an entry's
// byte offset row * W + lane / 8 never falls as i rises.  A block owns
// kUploadBytes consecutive bytes of the frontier: it finds its entries
// by two block-wide searches, ORs their bits into a shared tile and
// stores the tile once, 16 bytes a store (4 for a tail).  Every byte of
// [n_rows + 1, W] is written once and none is read; a block without
// entries stores zeros at once.  Entries aimed at row n_rows or beyond,
// or at a lane outside [0, 8W), are skipped, so the pad row ends zero;
// a duplicate is harmless (an OR).  Bound: bytes, (n_rows + 1) * W
// written and 8 bytes an entry read.
__device__ __forceinline__ long long entry_byte(const int32_t* rows,
                                                const int32_t* lanes, int W,
                                                long long i) {
    return (long long)rows[i] * W + (lanes[i] >> 3);
}

// The first i in [first, last) whose entry_byte is >= key, else last.
// Every thread of the block calls it with the same arguments: a round
// samples blockDim.x entries, one a thread, and the barrier's count of
// those below key narrows the range to the gap after the last of them.
__device__ long long block_lower_bound(const int32_t* rows,
                                       const int32_t* lanes, int W,
                                       long long first, long long last,
                                       long long key) {
    const long long T = blockDim.x;
    while (first < last) {
        const long long step = (last - first + T - 1) / T;
        const long long i = first + (long long)threadIdx.x * step;
        const long long below = __syncthreads_count(
            i < last && entry_byte(rows, lanes, W, i) < key);
        if (step == 1) return first + below;
        if (below == 0) return first;
        const long long end = min(last, first + below * step);
        first += (below - 1) * step + 1;
        last = end;
    }
    return first;
}

__global__ void __launch_bounds__(kThreads)
frontier_upload_kernel(uint8_t* __restrict__ out,
                       const int32_t* __restrict__ rows,
                       const int32_t* __restrict__ lanes, long long S,
                       long long n_rows, int W, long long total) {
    __shared__ uint4 tile[kUploadBytes / 16];
    uint32_t* t32 = reinterpret_cast<uint32_t*>(tile);
    const long long base = (long long)blockIdx.x * kUploadBytes;
    const int len = (int)min((long long)kUploadBytes, total - base);
    const long long lo = block_lower_bound(rows, lanes, W, 0, S, base);
    const long long hi = block_lower_bound(rows, lanes, W, lo, S,
                                           base + len);
    const bool any = lo < hi;                  // the same in every thread
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    if (any) {
        for (int j = threadIdx.x; j < kUploadBytes / 16; j += blockDim.x)
            tile[j] = zero;
        __syncthreads();
        for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
            const long long r = rows[i];
            const int l = lanes[i];
            if (r < 0 || r >= n_rows || l < 0 || l >= 8LL * W) continue;
            const int off = (int)(r * W + (l >> 3) - base);
            atomicOr(t32 + (off >> 2), 1u << (8 * (off & 3) + (l & 7)));
        }
        __syncthreads();
    }
    uint4* dst = reinterpret_cast<uint4*>(out + base);
    const int n16 = len >> 4;
    for (int j = threadIdx.x; j < n16; j += blockDim.x)
        dst[j] = any ? tile[j] : zero;
    uint32_t* d32 = reinterpret_cast<uint32_t*>(out + base);
    for (int j = 4 * n16 + threadIdx.x; j < (len >> 2); j += blockDim.x)
        d32[j] = any ? t32[j] : 0u;
}

// ------------------------------------------------------------ extract
// Replaces ell.py:726 make_lane_extract_kernel: out[:, j] = sel[j] ?
// accp[:, words[j]] : fp[:, words[j]] as uint8 [n_rows + 1, P] (a word
// outside [0, W) gives 0).  Bound: bytes — each output byte's source
// byte read once and the output written once; what the card moves is
// the sectors of the rows that hold a chosen word.  So a thread owns a
// row: each block first reduces the P (word, sel) pairs to the set of
// U-byte units of a row (U = 16 where the rows are 16-byte aligned,
// else 4) that hold a chosen word, in fp or in accp, and each pair to
// its byte in that set; then each thread loads only those units of its
// row (consecutive threads on consecutive rows: at W = 16 one uint4 a
// row, the whole rows read once), stages them in its own stretch of
// shared memory (an odd number of words a thread, so a warp's byte reads
// hit 32 banks), and builds its P output bytes there in registers,
// stored `vec` bytes at a time (16, 8, 4 or 1, as P and out allow).  No
// division by P a byte.  Shared memory (dynamic): the pairs' staged
// byte offsets [P], the unit list [units_max], the unit bitmap and its
// word prefix, then the threads' stretches.
constexpr int kExtractBlocksPerSm = 8;
constexpr int kExtractNone = 0xFFFF;          // a word outside the row

struct ExtractShape {
    int P, W, U, units_max, vec, map_words, stride_max;
};

// dynamic shared bytes of a block of `threads` threads
inline long long extract_smem(const ExtractShape& e, int threads) {
    return 4LL * (e.P + e.units_max + 2 * e.map_words + 1)
           + 4LL * threads * e.stride_max;
}

// The first len (<= 16) of the 16 bytes v stored at o, vec bytes at a
// time (16, 8, 4 or 1: what P and out's alignment allow).
__device__ __forceinline__ void store_chunk(uint8_t* o,
                                            const uint32_t (&v)[4], int len,
                                            int vec) {
    if (vec == 16) {
        *reinterpret_cast<uint4*>(o) = make_uint4(v[0], v[1], v[2], v[3]);
    } else if (vec == 8) {
        for (int h = 0; h < len; h += 8)
            *reinterpret_cast<uint2*>(o + h) =
                make_uint2(v[h >> 2], v[(h >> 2) + 1]);
    } else if (vec == 4) {
        for (int h = 0; h < len; h += 4)
            *reinterpret_cast<uint32_t*>(o + h) = v[h >> 2];
    } else {
        for (int h = 0; h < len; ++h)
            o[h] = (uint8_t)(v[h >> 2] >> (8 * (h & 3)));
    }
}

template <int U>
__global__ void __launch_bounds__(kThreads)
lane_extract_kernel(const uint8_t* __restrict__ fp,
                    const uint8_t* __restrict__ accp,
                    const int32_t* __restrict__ words,
                    const uint8_t* __restrict__ sel,
                    uint8_t* __restrict__ out, long long R1, ExtractShape e) {
    extern __shared__ uint32_t smem[];
    int* s_pos = reinterpret_cast<int*>(smem);             // [P]
    int* s_unit = s_pos + e.P;                             // [units_max]
    uint32_t* s_map = smem + e.P + e.units_max;            // [map_words]
    uint32_t* s_pre = s_map + e.map_words;                 // [map_words + 1]
    uint32_t* stage = s_pre + e.map_words + 1;
    const int per_src = e.W / U;                           // units a row
    for (int k = threadIdx.x; k < e.map_words; k += blockDim.x)
        s_map[k] = 0u;
    __syncthreads();
    for (int j = threadIdx.x; j < e.P; j += blockDim.x) {
        const int w = words[j];
        if (w >= 0 && w < e.W) {
            const int id = (sel[j] ? per_src : 0) + w / U;
            atomicOr(s_map + (id >> 5), 1u << (id & 31));
        }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        uint32_t run = 0;
        for (int k = 0; k < e.map_words; ++k) {
            s_pre[k] = run;
            run += __popc(s_map[k]);
        }
        s_pre[e.map_words] = run;
    }
    __syncthreads();
    const int units = (int)s_pre[e.map_words];
    const int stride = (units * U / 4) | 1;  // odd: a warp's reads spread
    for (int id = threadIdx.x; id < 2 * per_src; id += blockDim.x) {
        const uint32_t m = s_map[id >> 5];
        if ((m >> (id & 31)) & 1u) {
            const int k = s_pre[id >> 5] + __popc(m & ((1u << (id & 31)) - 1u));
            s_unit[k] = ((id >= per_src) << 30) | ((id % per_src) * U);
        }
    }
    for (int j = threadIdx.x; j < e.P; j += blockDim.x) {
        const int w = words[j];
        int pos = kExtractNone;
        if (w >= 0 && w < e.W) {
            const int id = (sel[j] ? per_src : 0) + w / U;
            const uint32_t m = s_map[id >> 5];
            pos = (s_pre[id >> 5] + __popc(m & ((1u << (id & 31)) - 1u))) * U
                  + w % U;
        }
        s_pos[j] = pos;
    }
    __syncthreads();
    uint32_t* st = stage + threadIdx.x * stride;
    const uint8_t* st8 = reinterpret_cast<const uint8_t*>(st);
    const long long step = (long long)gridDim.x * blockDim.x;
    for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         r < R1; r += step) {
        const long long row = r * e.W;
#pragma unroll 4
        for (int k = 0; k < units; ++k) {
            const int u = s_unit[k];
            const uint8_t* src = ((u >> 30) ? accp : fp) + row
                                 + (u & 0x3FFFFFFF);
            if (U == 16) {
                const uint4 x = __ldg(reinterpret_cast<const uint4*>(src));
                st[4 * k] = x.x;
                st[4 * k + 1] = x.y;
                st[4 * k + 2] = x.z;
                st[4 * k + 3] = x.w;
            } else {
                st[k] = __ldg(reinterpret_cast<const uint32_t*>(src));
            }
        }
        uint8_t* o = out + r * e.P;
        for (int j0 = 0; j0 < e.P; j0 += 16) {
            uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
            for (int jj = 0; jj < 16; ++jj) {
                const int j = j0 + jj;
                if (j < e.P) {
                    const int pos = s_pos[j];
                    const uint32_t b = pos == kExtractNone ? 0u : st8[pos];
                    v[jj >> 2] |= b << (8 * (jj & 3));
                }
            }
            store_chunk(o + j0, v, e.P - j0 < 16 ? e.P - j0 : 16, e.vec);
        }
    }
}

// The extract at W >= 32 with P a power of two (the session's P): a
// thread an output byte, 2^lp = P consecutive threads on one row's P
// bytes, so a warp's loads touch 32 / P rows (the row's chosen sectors;
// a thread a row would spread each warp load over 32 rows) and its
// stores are one 32-byte run; the pairs come from shared memory, the
// row and column by shifts.
__global__ void __launch_bounds__(kThreads)
lane_extract_bytes_kernel(const uint8_t* __restrict__ fp,
                          const uint8_t* __restrict__ accp,
                          const int32_t* __restrict__ words,
                          const uint8_t* __restrict__ sel,
                          uint8_t* __restrict__ out, long long R1, int lp,
                          int W) {
    extern __shared__ uint32_t smem[];
    int* s_word = reinterpret_cast<int*>(smem);    // [P]: -1 outside
    const int P = 1 << lp;
    for (int j = threadIdx.x; j < P; j += blockDim.x) {
        const int w = words[j];
        s_word[j] = w >= 0 && w < W ? (w | (sel[j] ? 1 << 30 : 0)) : -1;
    }
    __syncthreads();
    const long long total = R1 << lp;
    const long long step = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < total; i += step) {
        const int d = s_word[i & (P - 1)];
        uint8_t v = 0;
        if (d >= 0)
            v = __ldg(((d >> 30) ? accp : fp) + (i >> lp) * W
                      + (d & 0x3FFFFFFF));
        out[i] = v;
    }
}

// -------------------------------------------------------------- clear
// Replaces ell.py:713 make_lane_clear_kernel: fp &= keep and accp &=
// keep per word, in place.  Bound: bytes, 4 * (n_rows + 1) * W.
__global__ void lane_clear_kernel(uint32_t* __restrict__ fp,
                                  uint32_t* __restrict__ accp,
                                  const uint32_t* __restrict__ keep,
                                  long long total, int W4) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < total; i += stride) {
        const uint32_t k = keep[i % W4];
        fp[i] &= k;
        accp[i] &= k;
    }
}

// ----------------------------------------------------------- go count
// Replaces the COUNT(*) tail of ell.py:572 make_batched_go_lanes_kernel
// (count=True): counts[lane] = sum_r deg[r] * bit(out[r], lane) over all
// n_rows + 1 rows, int32 with wrap-around like the reference's int32
// product (deg is zero at extra rows and the pad row).  One launch, no
// clear of counts:
//   * a thread owns one 32-bit word column w (lanes 32w .. 32w + 31; lane
//     8j + k is bit k of byte j, the words little-endian) and strides
//     over the rows, kCountRows rows' words loaded together (a warp's
//     load covers 128 contiguous bytes; a wider load would give a thread
//     several columns); deg is read only for a nonzero word;
//   * each word costs what its kind needs, whatever the frontier's
//     density: an all-ones word adds deg to one register sum (full) that
//     the column's 32 lanes take at the end; a word with at most
//     kCountSparse set bits, or clear ones, adds deg at them by shared
//     atomics into the block's lane sums S (past 16 set bits deg to full
//     and -deg at the clear bits: the sums wrap); any other word with
//     deg <= kCountPairDeg adds into 16 register pairs, lanes k and
//     k + 16 in the low and high 16 bits of pair k (three operations a
//     pair), and the thread flushes them into S (32 atomics) before
//     their fields could carry (room: what a field can still take), so
//     at most once in 16 such words; a larger deg (a hub's row) takes
//     the atomic path (at most 16 atomics);
//   * at the end the threads of a warp that share a column sum full and
//     the pairs by shuffles, and one of them adds them into S;
//   * the block adds each nonzero lane sum into one of kCountReplicas
//     persistent accumulators (blockIdx % kCountReplicas: a sum address
//     takes the atomics of G / kCountReplicas blocks, not G), then takes
//     a ticket; the last block sums the replicas into counts and clears
//     them and the ticket, so the state is zero again for the next call.
// Bound: bytes, the frontier once, the deg sectors of rows with a nonzero
// word and counts: at most (n_rows + 1) * (W + 4) + 32W.

// The padded column count a block lays its threads out by: the next
// power of two up to 32 words, a multiple of 32 (a warp a 32 columns)
// above.
__host__ __device__ inline int count_cols(int W4) {
    if (W4 > 32) return (W4 + 31) & ~31;
    int p = 1;
    while (p < W4) p <<= 1;
    return p;
}

// Rows a block covers in one pass.
__host__ __device__ inline int count_rows_a_pass(int W4) {
    const int p = count_cols(W4);
    return p >= 32 ? kCountWarps / (p / 32) : kCountWarps * (32 / p);
}

// Lane k of column w in a block's sums, rotated by w so that the threads
// of a warp, one a column, add lane k in 32 different banks.
__device__ __forceinline__ int count_slot(int w, int k) {
    return 32 * w + ((k + w) & 31);
}

// Adds a thread's register pairs into the block's lane sums and clears
// them.
__device__ __forceinline__ void count_flush(uint32_t* S, int w,
                                            uint32_t (&pr)[16]) {
#pragma unroll
    for (int k = 0; k < 16; ++k) {
        const uint32_t lo = pr[k] & 0xFFFFu, hi = pr[k] >> 16;
        if (lo) atomicAdd(S + count_slot(w, k), lo);
        if (hi) atomicAdd(S + count_slot(w, k + 16), hi);
        pr[k] = 0u;
    }
}

__global__ void __launch_bounds__(kThreads, kCountBlocksPerSm)
go_count_kernel(const uint32_t* __restrict__ out,
                const int32_t* __restrict__ deg, uint32_t* __restrict__ counts,
                uint32_t* __restrict__ state, long long R1, int W4) {
    extern __shared__ uint32_t S[];               // [8W] lane sums
    __shared__ int last;
    const int B = 32 * W4;
    for (int L = threadIdx.x; L < B; L += blockDim.x) S[L] = 0u;
    __syncthreads();
    const int p = count_cols(W4);
    const int wpr = p >= 32 ? p / 32 : 1;        // warps a row
    const int nsw = kCountWarps / wpr;           // rows of warps
    const int rpb = count_rows_a_pass(W4);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int w = p < 32 ? (lane & (p - 1)) : (warp % wpr) * 32 + lane;
    const int rsub = p < 32 ? warp * (32 / p) + lane / p : warp / wpr;
    const bool active = warp < nsw * wpr && w < W4;

    uint32_t full = 0u, room = 0xFFFFu, pr[16];
    bool paired = false;
#pragma unroll
    for (int k = 0; k < 16; ++k) pr[k] = 0u;
    if (active) {
        const long long step = (long long)gridDim.x * rpb;
        for (long long r0 = (long long)blockIdx.x * rpb + rsub; r0 < R1;
             r0 += kCountRows * step) {
            uint32_t v[kCountRows], d[kCountRows];
#pragma unroll
            for (int u = 0; u < kCountRows; ++u) {
                const long long r = r0 + u * step;
                v[u] = r < R1 ? __ldcs(out + r * W4 + w) : 0u;
            }
#pragma unroll
            for (int u = 0; u < kCountRows; ++u)
                d[u] = v[u] ? (uint32_t)__ldg(deg + r0 + u * step) : 0u;
#pragma unroll
            for (int u = 0; u < kCountRows; ++u) {
                uint32_t x = v[u], dg = d[u];
                if (x == 0u) continue;
                const int n = __popc(x);
                if (n == 32) {
                    full += dg;
                    continue;
                }
                if (n > kCountSparse && n < 32 - kCountSparse &&
                    dg <= kCountPairDeg) {
                    if (dg > room) {
                        count_flush(S, w, pr);
                        room = 0xFFFFu;
                    }
                    room -= dg;
                    paired = true;
#pragma unroll
                    for (int k = 0; k < 16; ++k)
                        pr[k] += ((x >> k) & 0x00010001u) * dg;
                    continue;
                }
                if (n > 16) {
                    full += dg;
                    x = ~x;
                    dg = 0u - dg;
                }
                for (; x; x &= x - 1)
                    atomicAdd(S + count_slot(w, __ffs(x) - 1), dg);
            }
        }
    }
    // the warp's threads of one column are p lanes apart; one of them
    // (lane < p) adds the column's sums
    const bool adds = w < W4 && (p >= 32 || lane < p);
    for (int o = p; o < 32; o <<= 1)
        full += __shfl_xor_sync(0xFFFFFFFFu, full, o);
    if (full && adds) {
#pragma unroll
        for (int k = 0; k < 32; ++k) atomicAdd(S + count_slot(w, k), full);
    }
    if (__any_sync(0xFFFFFFFFu, paired)) {
#pragma unroll
        for (int k = 0; k < 16; ++k) {
            uint32_t lo = pr[k] & 0xFFFFu, hi = pr[k] >> 16;
            for (int o = p; o < 32; o <<= 1) {
                lo += __shfl_xor_sync(0xFFFFFFFFu, lo, o);
                hi += __shfl_xor_sync(0xFFFFFFFFu, hi, o);
            }
            if (adds && lo) atomicAdd(S + count_slot(w, k), lo);
            if (adds && hi) atomicAdd(S + count_slot(w, k + 16), hi);
        }
    }
    __syncthreads();

    uint32_t* mine = state + (long long)(blockIdx.x % kCountReplicas) * B;
    for (int L = threadIdx.x; L < B; L += blockDim.x) {
        const uint32_t s = S[count_slot(L >> 5, L & 31)];
        if (s) atomicAdd(mine + L, s);
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
        last = atomicAdd(state + kCountTicket, 1u) == gridDim.x - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    for (int L = threadIdx.x; L < B; L += blockDim.x) {
        uint32_t s = 0u;
#pragma unroll
        for (int r = 0; r < kCountReplicas; ++r)
            s += __ldcg(state + (long long)r * B + L);
        counts[L] = s;
#pragma unroll
        for (int r = 0; r < kCountReplicas; ++r)
            state[(long long)r * B + L] = 0u;
    }
    if (threadIdx.x == 0) state[kCountTicket] = 0u;
}

// The count's grid: kCountBlocksPerSm blocks an SM, no more than the
// rows fill; 0 when the device cannot be queried.
inline long long count_grid(long long R1, int W4) {
    const int sms = sm_count();
    if (sms <= 0) return 0;
    const long long rpb = count_rows_a_pass(W4);
    long long G = (long long)kCountBlocksPerSm * sms;
    if (G > (R1 + rpb - 1) / rpb) G = (R1 + rpb - 1) / rpb;
    return G < 1 ? 1 : G;
}

// ---------------------------------------------------------- bfs level
// Replaces the level body and the loop condition's reductions of
// ell.py:1080 make_batched_bfs_lanes_kernel.  The loop state is a packed
// "reached" bitmap seen, uint8 [n_rows + 1, W] in the frontier's own
// layout, and the depth matrix d [n_rows + 1, 8 * W] (lane l of row r at
// r * 8W + l) in the result's own form: int8 with -1 for unreached when
// the BFS returns int8 (max_steps <= 120), else int16 with INT16_INF.
// "Unreached" is a bit of seen, so no pass ever reads d: the reference's
// newly = bit(nxt) & (d == INF) is nxt & ~seen, a word operation.
// Bound: bytes.  The design's answer to the kernel it replaces (one
// dependent 2-byte d read a live bit, 15x its bound on a dense frontier;
// every thread storing the flag): the words of nxt, seen and the targets
// read once, coalesced, several a thread in flight; d written only in the
// 16-byte units that hold a newly reached lane; one store a block to each
// flag, after a warp vote, only where the block saw a 1.  The first pass
// writes d whole, consecutive threads on consecutive 16-byte units (a
// thread a frontier word, 32 or 64 bytes of d each, took 1.3-2x as long,
// PERF.md).  The mesh's level stage runs the same two kernels on a card
// group's replica slab: nxt is the first of `members` equal replicas,
// `rep` words apart, and the new frontier goes into every replica where
// it changed.

// Lanes of a 32-bit word of D: the byte mask of the lanes whose bits are
// x's low bits (bit i -> lane i; the multiply spreads 4 bits to 4 bytes,
// 2 bits to 2 halfwords, with no carries).
template <typename D>
__device__ __forceinline__ uint32_t lane_mask(uint32_t x);
template <>
__device__ __forceinline__ uint32_t lane_mask<uint8_t>(uint32_t x) {
    return (((x & 0xFu) * 0x204081u) & 0x01010101u) * 0xFFu;
}
template <>
__device__ __forceinline__ uint32_t lane_mask<uint16_t>(uint32_t x) {
    return (((x & 3u) * 0x8001u) & 0x00010001u) * 0xFFFFu;
}

// a 32-bit word of D lanes, every one `v`
template <typename D>
__device__ __forceinline__ uint32_t lanes_of(uint32_t v) {
    return sizeof(D) == 1 ? (v & 0xFFu) * 0x01010101u
                          : (v & 0xFFFFu) * 0x00010001u;
}

template <typename D>
__device__ __forceinline__ uint32_t unreached() {
    return sizeof(D) == 1 ? 0xFFFFFFFFu : lanes_of<uint16_t>(kInt16Inf);
}

// The block's flags: a warp vote, then at most one store a block to each
// flag, only when the block saw a 1 (all of the block's threads call it,
// after their loop).
__device__ __forceinline__ void raise_flags(bool f, bool r,
                                            int32_t* __restrict__ flags) {
    __shared__ int seen_any[2];
    if (threadIdx.x == 0) seen_any[0] = seen_any[1] = 0;
    __syncthreads();
    const bool wf = __any_sync(0xFFFFFFFFu, f);
    const bool wr = __any_sync(0xFFFFFFFFu, r);
    if ((threadIdx.x & 31) == 0) {
        if (wf) seen_any[0] = 1;
        if (wr) seen_any[1] = 1;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        if (seen_any[0]) flags[0] = 1;
        if (seen_any[1]) flags[1] = 1;
    }
}

// The first pass: seen = the start frontier, d = 0 on its bits and the
// unreached value elsewhere, written whole at the copy bound: a 16-byte
// unit of d (16 int8 lanes, their bits a uint16_t P of the frontier; 8
// int16 lanes, a byte) a step, consecutive threads on consecutive units,
// U units a thread loaded before any is stored (U loads in flight).
// flags[0]: any start bit; flags[1] (stop): any target bit not a start.
template <typename D, typename P, int U>
__global__ void __launch_bounds__(kThreads)
bfs_first_kernel(const P* __restrict__ nxt, const P* __restrict__ tp,
                 P* __restrict__ seen, uint4* __restrict__ d,
                 int32_t* __restrict__ flags, int stop, long long units) {
    constexpr int kLW = 4 / (int)sizeof(D);     // lanes a 32-bit word
    const long long stride = (long long)gridDim.x * blockDim.x;
    bool f = false, r = false;
    for (long long u0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         u0 < units; u0 += U * stride) {
        uint32_t v[U], t[U];
#pragma unroll
        for (int k = 0; k < U; ++k) {
            const long long u = u0 + k * stride;
            v[k] = u < units ? (uint32_t)nxt[u] : 0u;
            t[k] = u < units && stop ? (uint32_t)tp[u] : 0u;
        }
#pragma unroll
        for (int k = 0; k < U; ++k) {
            const long long u = u0 + k * stride;
            if (u >= units) break;
            seen[u] = (P)v[k];
            uint32_t q[4];
#pragma unroll
            for (int h = 0; h < 4; ++h)
                q[h] = unreached<D>() & ~lane_mask<D>(v[k] >> (h * kLW));
            d[u] = make_uint4(q[0], q[1], q[2], q[3]);
            f |= v[k] != 0u;
            r |= (t[k] & ~v[k]) != 0u;
        }
    }
    raise_flags(f, r, flags);
}

// A later level, a 32-bit word of the frontier (32 lanes) a step, U
// words a thread loaded before any is stored: newly = nxt & ~seen;
// seen |= newly; d = depth at the newly lanes; the frontier becomes
// newly (in every replica, where it changed); flags[0]: any newly lane;
// flags[1] (stop): any target bit still unreached.  The word's d lanes
// are 2 or 4 16-byte units; each unit with a newly lane is stored whole:
// from the unreached value where seen had none of its lanes (no read),
// else read, merged and stored.  (A store a newly lane instead took 2.8x
// as long on a dense level, PERF.md.)
template <typename D, int U>
__global__ void __launch_bounds__(kThreads)
bfs_level_kernel(uint32_t* __restrict__ nxt, long long rep, int members,
                 const uint32_t* __restrict__ tp,
                 uint32_t* __restrict__ seen, D* __restrict__ d,
                 int32_t* __restrict__ flags, int depth, int stop,
                 long long words) {
    constexpr int kLW = 4 / (int)sizeof(D);     // lanes a 32-bit word
    constexpr int kUL = 16 / (int)sizeof(D);    // lanes a 16-byte unit
    const long long stride = (long long)gridDim.x * blockDim.x;
    bool f = false, r = false;
    for (long long i0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i0 < words; i0 += U * stride) {
        uint32_t v[U], s[U], t[U];
#pragma unroll
        for (int k = 0; k < U; ++k) {
            const long long i = i0 + k * stride;
            v[k] = i < words ? nxt[i] : 0u;
            s[k] = i < words ? seen[i] : 0u;
            t[k] = i < words && stop ? tp[i] : 0u;
        }
#pragma unroll
        for (int k = 0; k < U; ++k) {
            const long long i = i0 + k * stride;
            if (i >= words) break;
            const uint32_t newly = v[k] & ~s[k];
            if (newly) {
                seen[i] = s[k] | newly;
                uint4* du = reinterpret_cast<uint4*>(d + 32LL * i);
#pragma unroll
                for (int c = 0; c < 32 / kUL; ++c) {
                    const uint32_t nb = (newly >> (c * kUL)) &
                                        ((1u << kUL) - 1u);
                    if (!nb) continue;
                    const bool read = ((s[k] >> (c * kUL)) &
                                       ((1u << kUL) - 1u)) != 0u;
                    uint4 o = read ? du[c]
                                   : make_uint4(unreached<D>(),
                                                unreached<D>(),
                                                unreached<D>(),
                                                unreached<D>());
                    uint32_t* ow = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
                    for (int h = 0; h < 4; ++h) {
                        const uint32_t m = lane_mask<D>(nb >> (h * kLW));
                        ow[h] = (ow[h] & ~m) | (lanes_of<D>(depth) & m);
                    }
                    du[c] = o;
                }
            }
            if (newly != v[k])
                for (int m = 0; m < members; ++m) nxt[m * rep + i] = newly;
            f |= newly != 0u;
            r |= (t[k] & ~(s[k] | newly)) != 0u;
        }
    }
    raise_flags(f, r, flags);
}

// The BFS result's int8 form of an int16 depth matrix (max_steps <= 120
// on the int8 route, whose level pass K15 keeps int16): -1 for INF, else
// the depth.  INT16_INF is 0x7FFF, whose low byte 0xFF is -1 as int8, so
// the low byte of every entry is the answer.  Eight entries a step: one
// 16-byte load, one byte permute a pair of words, one 8-byte store;
// consecutive threads on consecutive 16-byte units.  Entries past the
// last whole 8 (and all of them where d or out is not aligned for the
// vectors) one a step.  A grid of a few blocks an SM strides over the
// matrix.  Bound: bytes, 3 an entry.
__global__ void __launch_bounds__(kThreads)
bfs_depth_i8_kernel(const uint16_t* __restrict__ d, int8_t* __restrict__ out,
                    long long n8, long long total) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const uint4* dv = reinterpret_cast<const uint4*>(d);
    uint2* ov = reinterpret_cast<uint2*>(out);
    for (long long i = t0; i < n8; i += stride) {
        const uint4 a = dv[i];
        ov[i] = make_uint2(__byte_perm(a.x, a.y, 0x6420),
                           __byte_perm(a.z, a.w, 0x6420));
    }
    for (long long j = 8 * n8 + t0; j < total; j += stride)
        out[j] = (int8_t)(d[j] & 0xFF);
}

// The BFS level pass over R1 rows of W frontier bytes (both entries'
// launcher): `first` the first pass, else a level at `step`; nxt the
// first of `members` replicas `rep` 32-bit words apart; d of `dbytes`
// bytes an entry.  The grid is a few blocks an SM, striding; a thread
// loads 4 steps at once on an int8 d, 2 on an int16 one (measured: 4
// took an int16 level on a dense frontier 12 % longer than 1, PERF.md).
int launch_bfs_level(void* nxt, long long rep, int members, const void* tp,
                     void* seen, void* d, int dbytes, void* flags, int step,
                     int first, int stop, int64_t R1, int64_t W,
                     cudaStream_t s) {
    if (R1 <= 0 || W <= 0 || W % 4 != 0 || members < 1 ||
        (dbytes != 1 && dbytes != 2) || step < 0 ||
        step >= (dbytes == 1 ? 0x7F : 0x7FFE) ||
        ((uintptr_t)d & 15) != 0 ||
        (((uintptr_t)nxt | (uintptr_t)tp | (uintptr_t)seen |
          (uintptr_t)flags) & 3) != 0)
        return -1;
    const long long most = (long long)sm_count() * (2048 / kThreads);
    if (most == 0) return (int)cudaErrorInvalidDevice;
    int32_t* fl = (int32_t*)flags;
    if (first) {
        // 16-byte units of d: R1 * 8W lanes of dbytes bytes
        const long long units = R1 * W * dbytes / 2;
        const unsigned grid = (unsigned)(grid_for(units) < most
                                         ? grid_for(units) : most);
        if (dbytes == 1)
            bfs_first_kernel<uint8_t, uint16_t, 4><<<grid, kThreads, 0, s>>>(
                (const uint16_t*)nxt, (const uint16_t*)tp, (uint16_t*)seen,
                (uint4*)d, fl, stop, units);
        else
            bfs_first_kernel<uint16_t, uint8_t, 2><<<grid, kThreads, 0, s>>>(
                (const uint8_t*)nxt, (const uint8_t*)tp, (uint8_t*)seen,
                (uint4*)d, fl, stop, units);
        return (int)cudaGetLastError();
    }
    const long long words = R1 * (W / 4);
    const unsigned grid = (unsigned)(grid_for(words) < most
                                     ? grid_for(words) : most);
    if (dbytes == 1)
        bfs_level_kernel<uint8_t, 4><<<grid, kThreads, 0, s>>>(
            (uint32_t*)nxt, rep, members, (const uint32_t*)tp,
            (uint32_t*)seen, (uint8_t*)d, fl, step + 1, stop, words);
    else
        bfs_level_kernel<uint16_t, 2><<<grid, kThreads, 0, s>>>(
            (uint32_t*)nxt, rep, members, (const uint32_t*)tp,
            (uint32_t*)seen, (uint16_t*)d, fl, step + 1, stop, words);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// plan: host int64 [n_buckets * 6] = (row0, slot0, rows, D, lg, blk0)
// per bucket, ell_ops.hop_plan's launch plan, which owns it: 2^lg lanes
// a row, kThreads >> lg rows a block, blk0 each bucket's first block,
// `blocks` the grid, 2^lgc lanes a row's columns, `wide` the 16-byte row
// path (W % 16 == 0 and fp, out and accp 16-byte aligned; else the
// 4-byte path).  The entry checks only that the plan is safe to run:
// every block then reads and writes inside its own bucket's rows.  The
// 16-byte slot path runs when every bucket's slots start 16-byte
// aligned in nbr and et, else the 4-byte one.  over: host int32
// [n_over].  accp may be null (no union).  gate: null, or a device
// int64 word: the gather (hop_gather_gated_kernel, 4-byte rows only)
// and the merge then return at once unless it holds `want` (the
// adaptive program's dense arm, sparse_go.cu ad_program).  Returns 0, a
// cudaError_t, or -1 for an argument the kernels cannot take.
int ell_go_hop(const void* fp, void* accp, void* out, const void* nbr,
               const void* et, const int64_t* plan, int n_buckets,
               int64_t blocks, int lgc, int wide, const void* eslot,
               const void* hrows, int64_t n_extras, const int32_t* over,
               int n_over, int64_t n, int64_t n_rows, int64_t W,
               const void* gate, int64_t want, void* stream) {
    if (W <= 0 || W % 4 != 0 || n_rows < 0) return -1;
    const uintptr_t rows_at = (uintptr_t)fp | (uintptr_t)out |
                              (uintptr_t)accp;
    if (wide && (W % 16 != 0 || (rows_at & 15) != 0)) return -1;
    bool quads = (((uintptr_t)nbr | (uintptr_t)et) & 15) == 0;
    hop::Plan pl;
    hop::OverSet ov;
    if (!hop::read_plan(plan, n_buckets, blocks, lgc, &pl, &quads) ||
        !hop::read_over(over, n_over, &ov))
        return -1;
    cudaStream_t s = (cudaStream_t)stream;
    const unsigned grid = (unsigned)blocks;
    const int C = (int)(wide ? W / 16 : W / 4);
    const int32_t* nb = (const int32_t*)nbr;
    const int32_t* ev = (const int32_t*)et;
    const long long* g = (const long long*)gate;
    if (g != nullptr) {
        if (wide) return -1;
        const long long most = (long long)sm_count() * (2048 / kThreads);
        if (most == 0) return (int)cudaErrorInvalidDevice;
        const unsigned gg = (unsigned)(blocks < most ? blocks : most);
        if (quads)
            hop_gather_gated_kernel<uint32_t, true><<<gg, kThreads, 0, s>>>(
                (const uint32_t*)fp, (uint32_t*)out, (uint32_t*)accp, nb, ev,
                pl, ov, n_rows, C, lgc, (int)blocks, g, want);
        else
            hop_gather_gated_kernel<uint32_t, false><<<gg, kThreads, 0,
                                                       s>>>(
                (const uint32_t*)fp, (uint32_t*)out, (uint32_t*)accp, nb, ev,
                pl, ov, n_rows, C, lgc, (int)blocks, g, want);
    } else if (wide && quads && lgc >= 3)
        hop_gather_kernel<uint4, true, 7><<<grid, kThreads, 0, s>>>(
            (const uint4*)fp, (uint4*)out, (uint4*)accp, nb, ev, pl, ov,
            n_rows, C, lgc);
    else if (wide && quads)
        hop_gather_kernel<uint4, true, 1><<<grid, kThreads, 0, s>>>(
            (const uint4*)fp, (uint4*)out, (uint4*)accp, nb, ev, pl, ov,
            n_rows, C, lgc);
    else if (wide)
        hop_gather_kernel<uint4, false, 1><<<grid, kThreads, 0, s>>>(
            (const uint4*)fp, (uint4*)out, (uint4*)accp, nb, ev, pl, ov,
            n_rows, C, lgc);
    else if (quads)
        hop_gather_kernel<uint32_t, true, 1><<<grid, kThreads, 0, s>>>(
            (const uint32_t*)fp, (uint32_t*)out, (uint32_t*)accp, nb, ev,
            pl, ov, n_rows, C, lgc);
    else
        hop_gather_kernel<uint32_t, false, 1><<<grid, kThreads, 0, s>>>(
            (const uint32_t*)fp, (uint32_t*)out, (uint32_t*)accp, nb, ev,
            pl, ov, n_rows, C, lgc);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || n_extras <= 0) return (int)err;
    const int W4 = (int)(W / 4);
    hop_merge_kernel<<<grid_for(n_extras * W4), kThreads, 0, s>>>(
        (uint32_t*)out, (uint32_t*)accp, (const int32_t*)eslot,
        (const int32_t*)hrows, n, n_rows, n_extras, W4, g, want);
    return (int)cudaGetLastError();
}

// out: uint8 [n_rows + 1, W], 16-byte aligned, overwritten with the
// start frontier of the S entries rows[i], lanes[i] (int32, sorted by
// row, then lane): one launch, frontier_upload_kernel.
int ell_frontier_upload(void* out, const void* rows, const void* lanes,
                        int64_t S, int64_t n_rows, int64_t W,
                        void* stream) {
    if (W <= 0 || W % 4 != 0 || S < 0 || n_rows < 0) return -1;
    const long long total = (n_rows + 1) * (long long)W;
    const long long blocks = (total + kUploadBytes - 1) / kUploadBytes;
    frontier_upload_kernel<<<(unsigned)blocks, kThreads, 0,
                             (cudaStream_t)stream>>>(
        (uint8_t*)out, (const int32_t*)rows, (const int32_t*)lanes, S,
        n_rows, (int)W, total);
    return (int)cudaGetLastError();
}

// counts: int32 [8 * W], overwritten; state: state_words uint32, the
// count's replicas and ticket (ell_ops.count_state), zero before the
// first call and left zero by each, so calls in one stream's order share
// it.  W / 4 <= kThreads.
int ell_go_count(const void* out, const void* deg, void* counts, void* state,
                 int64_t state_words, int64_t R1, int64_t W, void* stream) {
    if (R1 <= 0 || W <= 0 || W % 4 != 0 || W / 4 > kThreads ||
        state_words <= kCountTicket)
        return -1;
    const long long G = count_grid(R1, (int)(W / 4));
    if (G <= 0) return (int)cudaErrorInvalidDevice;
    go_count_kernel<<<(unsigned)G, kThreads, 8 * W * sizeof(uint32_t),
                      (cudaStream_t)stream>>>(
        (const uint32_t*)out, (const int32_t*)deg, (uint32_t*)counts,
        (uint32_t*)state, R1, (int)(W / 4));
    return (int)cudaGetLastError();
}

// nxt, tp, seen: uint8 [R1, W] (4-byte aligned); d: [R1, 8 * W] of
// dbytes-byte entries (int8, or int16), 16-byte aligned; flags: int32
// [2], this level's slot (zero before the launch).
int ell_bfs_level(void* nxt, const void* tp, void* seen, void* d,
                  int dbytes, void* flags, int step, int first, int stop,
                  int64_t R1, int64_t W, void* stream) {
    return launch_bfs_level(nxt, 0, 1, tp, seen, d, dbytes, flags, step,
                            first, stop, R1, W, (cudaStream_t)stream);
}

// The mesh BFS's level stage over a card group (called by ell_mesh.cu's
// ell_mesh_hop, which checks the slab's geometry): slab, the group's
// [members, R1, W] replicas, a replica every `stride` bytes, all equal;
// the pass reads the first, updates the group's one reached bitmap seen
// and depth matrix d (as ell_bfs_level's) against the group's targets tp
// (uint8 [R1, W]), writes the new frontier into every replica and
// raises the group's flags (int32 [2]); with `first` it only builds seen
// and d from the first replica.
int ell_mesh_level(void* slab, int64_t stride, int members, const void* tp,
                   void* seen, void* d, int dbytes, void* flags, int step,
                   int first, int stop, int64_t R1, int64_t W,
                   void* stream) {
    if (stride % 4 != 0 || members > hop::kCardShards) return -1;
    return launch_bfs_level(slab, stride / 4, members, tp, seen, d, dbytes,
                            flags, step, first, stop, R1, W,
                            (cudaStream_t)stream);
}

// The mesh hop's M1 and merge over every member of a card: called by
// ell_mesh.cu's ell_mesh_hop (the entry ell_ops.mesh_hop calls), which
// checks its arguments.  fp / out: the card's [members, n_rows + 1, W]
// slabs, a replica every `stride` bytes; plan: shard 0's hop_plan as
// ell_go_hop takes it (`wide` as there, with every replica 16-byte
// aligned); mh: the members' tables and the chunk geometry.
int ell_mesh_gather(const void* fp, void* out, int64_t stride,
                    hop::MeshHop mh, const int64_t* plan, int n_buckets,
                    int64_t blocks, int lgc, int wide, const int32_t* over,
                    int n_over, int64_t n_rows, int64_t W, void* stream) {
    if (W <= 0 || W % 4 != 0 || n_rows < 0 || mh.n < 1 ||
        mh.n > hop::kCardShards || stride % 4 != 0)
        return -1;
    const uintptr_t rows_at = (uintptr_t)fp | (uintptr_t)out |
                              (uintptr_t)stride;
    if (wide && (W % 16 != 0 || (rows_at & 15) != 0)) return -1;
    bool quads = true;
    for (int y = 0; y < mh.n; ++y)
        quads = quads && (((uintptr_t)mh.nbr[y] | (uintptr_t)mh.et[y])
                          & 15) == 0;
    hop::Plan pl;
    hop::OverSet ov;
    if (!hop::read_plan(plan, n_buckets, blocks, lgc, &pl, &quads) ||
        !hop::read_over(over, n_over, &ov))
        return -1;
    const dim3 grid((unsigned)blocks, (unsigned)mh.n);
    cudaStream_t s = (cudaStream_t)stream;
    const int C = (int)(wide ? W / 16 : W / 4);
    const long long st = stride / (wide ? 16 : 4);
    if (wide && quads && lgc >= 3)
        mesh_gather_kernel<uint4, true, 7><<<grid, kThreads, 0, s>>>(
            (const uint4*)fp, (uint4*)out, st, mh, pl, ov, n_rows, C, lgc);
    else if (wide && quads)
        mesh_gather_kernel<uint4, true, 1><<<grid, kThreads, 0, s>>>(
            (const uint4*)fp, (uint4*)out, st, mh, pl, ov, n_rows, C, lgc);
    else if (wide)
        mesh_gather_kernel<uint4, false, 1><<<grid, kThreads, 0, s>>>(
            (const uint4*)fp, (uint4*)out, st, mh, pl, ov, n_rows, C, lgc);
    else if (quads)
        mesh_gather_kernel<uint32_t, true, 1><<<grid, kThreads, 0, s>>>(
            (const uint32_t*)fp, (uint32_t*)out, st, mh, pl, ov, n_rows, C,
            lgc);
    else
        mesh_gather_kernel<uint32_t, false, 1><<<grid, kThreads, 0, s>>>(
            (const uint32_t*)fp, (uint32_t*)out, st, mh, pl, ov, n_rows, C,
            lgc);
    return (int)cudaGetLastError();
}

int ell_mesh_merge(void* out, int64_t stride, int members,
                   const void* eslot, const void* hrows, int64_t n,
                   int64_t n_rows, int64_t W, void* stream) {
    if (W <= 0 || W % 4 != 0 || stride % 4 != 0 || members < 1 ||
        members > hop::kCardShards || n_rows < n)
        return -1;
    const long long n_extras = n_rows - n;
    if (n_extras == 0) return 0;
    const int W4 = (int)(W / 4);
    const dim3 grid(grid_for(n_extras * W4), (unsigned)members);
    mesh_merge_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (uint32_t*)out, stride / 4, (const int32_t*)eslot,
        (const int32_t*)hrows, n, n_rows, n_extras, W4);
    return (int)cudaGetLastError();
}

// dst |= srcs[0] | ... | srcs[m - 1] over nbytes bytes (or_many_kernel;
// nbytes % 4 == 0, every operand 4-byte aligned; srcs a host array of m
// device pointers, 1 <= m <= kMaxSrcs): the mesh's psum_or ORs a
// shard's receive slab into its output with it, and or_into is m = 1.
// The grid follows the bytes: a few words take one warp.
int ell_or_many(void* dst, const void* const* srcs, int m, int64_t nbytes,
                void* stream) {
    if (m < 1 || m > kMaxSrcs || nbytes < 0 || nbytes % 4 != 0) return -1;
    OrSources src;
    src.m = m;
    uintptr_t at = (uintptr_t)dst;
    for (int k = 0; k < m; ++k) {
        src.p[k] = srcs[k];
        at |= (uintptr_t)srcs[k];
    }
    if (at & 3) return -1;
    const long long words = nbytes / 4;
    if (words == 0) return 0;
    const long long n16 = (at & 15) ? 0 : words / 4;
    const long long items = n16 + (words - 4 * n16);
    const int threads = items < kThreads ? (int)((items + 31) / 32 * 32)
                                         : kThreads;
    or_many_kernel<<<grid_for(items), threads, 0, (cudaStream_t)stream>>>(
        (uint32_t*)dst, src, n16, words);
    return (int)cudaGetLastError();
}

// d: int16, out: int8, `total` entries each (any alignment: the vector
// path takes them where both are aligned for it).
int ell_bfs_depth_i8(const void* d, void* out, int64_t total,
                     void* stream) {
    if (total <= 0 || ((uintptr_t)d & 1) != 0) return -1;
    const long long most = (long long)sm_count() * (2048 / kThreads);
    if (most == 0) return (int)cudaErrorInvalidDevice;
    const bool vec = (((uintptr_t)d & 15) | ((uintptr_t)out & 7)) == 0;
    const long long n8 = vec ? total / 8 : 0;
    const long long items = n8 > 0 ? n8 : total;
    const unsigned grid = (unsigned)(grid_for(items) < most ? grid_for(items)
                                                             : most);
    bfs_depth_i8_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint16_t*)d, (int8_t*)out, n8, total);
    return (int)cudaGetLastError();
}

int ell_lane_join(void* fp, void* accp, const void* rows, const void* words,
                  const void* vals, int64_t S, int64_t n_rows, int64_t W,
                  void* stream) {
    if (W <= 0 || W % 4 != 0 || S < 0) return -1;
    const int W4 = (int)(W / 4);
    const long long threads = S > W4 ? S : W4;
    lane_join_kernel<<<(unsigned)((threads + kThreads - 1) / kThreads),
                       kThreads, 0, (cudaStream_t)stream>>>(
        (uint32_t*)fp, (uint32_t*)accp, (const int32_t*)rows,
        (const int32_t*)words, (const uint8_t*)vals, S, n_rows, (int)W,
        W4);
    return (int)cudaGetLastError();
}

// The extract: the per-byte kernel for rows of 32 bytes or more and a
// power-of-two P (the session's), else the staged one (a thread a row).
int ell_lane_extract(const void* fp, const void* accp, const void* words,
                     const void* sel, void* out, int64_t P, int64_t R1,
                     int64_t W, void* stream) {
    if (P <= 0 || P > (1 << 24) || R1 <= 0 || W <= 0 || W % 4 != 0 ||
        W > (1 << 24) || (((uintptr_t)fp | (uintptr_t)accp) & 3) != 0)
        return -1;
    cudaStream_t s = (cudaStream_t)stream;
    if (W >= 32 && P >= 8 && P <= 4096 && (P & (P - 1)) == 0) {
        const int lp = __builtin_ctzll((unsigned long long)P);
        lane_extract_bytes_kernel<<<grid_for(R1 << lp), kThreads,
                                    4 * (size_t)P, s>>>(
            (const uint8_t*)fp, (const uint8_t*)accp, (const int32_t*)words,
            (const uint8_t*)sel, (uint8_t*)out, R1, lp, (int)W);
        return (int)cudaGetLastError();
    }
    ExtractShape e;
    e.P = (int)P;
    e.W = (int)W;
    e.U = (W % 16 == 0 &&
           (((uintptr_t)fp | (uintptr_t)accp) & 15) == 0) ? 16 : 4;
    const long long per_src = W / e.U;
    e.units_max = (int)(P < 2 * per_src ? P : 2 * per_src);
    e.map_words = (int)((2 * per_src + 31) / 32);
    e.stride_max = (e.units_max * e.U / 4) | 1;
    const uintptr_t o = (uintptr_t)out;
    e.vec = P % 16 == 0 && o % 16 == 0 ? 16
          : P % 8 == 0 && o % 8 == 0 ? 8
          : P % 4 == 0 && o % 4 == 0 ? 4 : 1;
    int threads = kThreads;
    while (threads > 32 && extract_smem(e, threads) > 48 * 1024)
        threads /= 2;
    const long long smem = extract_smem(e, threads);
    const long long most = (long long)kExtractBlocksPerSm * sm_count();
    if (most == 0) return (int)cudaErrorInvalidDevice;
    long long blocks = (R1 + threads - 1) / threads;
    if (blocks > most) blocks = most;
    const auto kernel = e.U == 16 ? lane_extract_kernel<16>
                                  : lane_extract_kernel<4>;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    kernel<<<(unsigned)blocks, threads, (size_t)smem, s>>>(
        (const uint8_t*)fp, (const uint8_t*)accp, (const int32_t*)words,
        (const uint8_t*)sel, (uint8_t*)out, R1, e);
    return (int)cudaGetLastError();
}

int ell_lane_clear(void* fp, void* accp, const void* keep, int64_t R1,
                   int64_t W, void* stream) {
    if (R1 <= 0 || W <= 0 || W % 4 != 0) return -1;
    const int W4 = (int)(W / 4);
    const long long total = R1 * (long long)W4;
    lane_clear_kernel<<<grid_for(total), kThreads, 0,
                        (cudaStream_t)stream>>>(
        (uint32_t*)fp, (uint32_t*)accp, (const uint32_t*)keep, total, W4);
    return (int)cudaGetLastError();
}

}  // extern "C"
