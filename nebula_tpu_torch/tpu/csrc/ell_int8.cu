// Int8 lane kernels for Hopper (sm_90a), behind a plain C interface that
// nebula_tpu_torch/tpu/ell_ops.py loads with ctypes: the packing-off
// route (tpu_packed_frontier=false) of the windowed dense GO and the
// batched BFS.  K12 the start-lane upload, K13 the hop (its last advance
// of a row-packed GO writes the packed result itself), K14 the row pack
// of a GO result that had no advance, K15 the BFS level pass.
//
// Layout shared by every kernel: a frontier is int8 [n_rows + 1, B]
// row-major, one byte per query lane (lane b of row r at r * B + b);
// row n_rows is the pad row, which every sentinel slot points at.  When
// B % 4 == 0 a thread owns one 32-bit word of four lanes and works on it
// with the per-byte SIMD intrinsics (__vmaxs4, __vcmpgts4); otherwise a
// thread owns one byte (the same code, instantiated for uint8_t).  K13's
// gather takes a row as 16-byte columns when B % 16 ==
// 0, 4-byte ones when B % 4 == 0, and byte columns otherwise.  Flags
// off the 128/1024 ladder can set any B >= 1.  Offsets are 64-bit.
// A lane bitmap (K15's reached lanes and targets) is uint8 [n_rows + 1,
// ceil(B / 8)]: bit j of byte w is lane 8w + j, the bits past B zero.
// A row-packed result is uint8 [ceil((n_rows + 1) / 8), B]: bit k of
// byte (g, b) is row 8g + k of lane b.
//
// The kernels compute what the reference computes on the whole int8
// domain, not only on 0/1 lanes: the hop's max is a signed per-byte max
// starting from 0 (a bitwise OR is not exact on negative values), and
// "live" is a signed > 0.
//
// Every kernel runs on the caller's stream, allocates nothing and does
// not synchronise; each entry point returns cudaGetLastError() after its
// launches (0 = launched) or -1 for arguments it refuses.  Nothing here
// needs a matrix unit: every kernel is bound by device-memory traffic.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hop_plan.cuh"
#include "sm_count.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1LL << 20;   // grid-stride beyond this
constexpr int16_t kInt16Inf = 0x7FFF;          // ell.py:51 INT16_INF
// the row-packed advance's slices at most (B bytes a row: the ladder's
// 1024 takes 8 KB a block of 8 rows, B = 8192 64 KB)
constexpr size_t kMaxPackSmem = 160 * 1024;

inline unsigned grid_for(long long total) {
    long long blocks = (total + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    if (blocks < 1) blocks = 1;
    return (unsigned)blocks;
}

// ------------------------------------------------ per-element lane ops
// An element is a uint32_t of four lanes or a uint8_t of one.
template <typename T> struct Lanes;

template <> struct Lanes<uint32_t> {
    // 1 in each byte whose signed value is > 0, else 0
    static __device__ __forceinline__ uint32_t pos(uint32_t v) {
        return __vcmpgts4(v, 0u) & 0x01010101u;
    }
    // In place: *p = the signed per-byte max of *p and v.  Owners repeat and there is no byte
    // atomicMax, so a 32-bit compare-and-swap loop.
    static __device__ __forceinline__ void atomic_vmax(uint32_t* p,
                                                       uint32_t v) {
        uint32_t old = *p, assumed;
        do {
            assumed = old;
            const uint32_t nv = __vmaxs4(assumed, v);
            if (nv == assumed) return;
            old = atomicCAS(p, assumed, nv);
        } while (old != assumed);
    }
};

template <> struct Lanes<uint8_t> {
    static __device__ __forceinline__ uint8_t pos(uint8_t v) {
        return (int8_t)v > 0 ? 1 : 0;
    }
    // A 16-bit compare-and-swap on the aligned half-word holding the
    // byte (sm_70 and later).  The half-word never leaves the carrier:
    // owners are real rows, below the pad row, and the carrier is
    // 4-byte aligned.
    static __device__ __forceinline__ void atomic_vmax(uint8_t* p,
                                                       uint8_t v) {
        const uintptr_t a = reinterpret_cast<uintptr_t>(p);
        unsigned short* h = reinterpret_cast<unsigned short*>(a & ~(uintptr_t)1);
        const int sh = (int)(a & 1) * 8;
        unsigned short old = *h, assumed;
        do {
            assumed = old;
            const int8_t cur = (int8_t)((assumed >> sh) & 0xFF);
            if (cur >= (int8_t)v) return;
            const unsigned short nv = (unsigned short)(
                (assumed & ~(0xFF << sh)) | ((unsigned)v << sh));
            old = atomicCAS(h, assumed, nv);
        } while (old != assumed);
    }
};

// ------------------------------------------------------------ lane bits
// the lanes > 0 (signed) of four int8 lanes as bits 0-3 (bit j: lane j;
// the multiply gathers the four 0/1 bytes into the top nibble, no carry)
__device__ __forceinline__ uint32_t pos_bits4(uint32_t v) {
    return ((__vcmpgts4(v, 0u) & 0x01010101u) * 0x10204080u) >> 28;
}
__device__ __forceinline__ uint32_t pos_bits16(uint4 v) {
    return pos_bits4(v.x) | pos_bits4(v.y) << 4 | pos_bits4(v.z) << 8 |
           pos_bits4(v.w) << 12;
}
// bits 0-3 of x as four 0/1 bytes (the multiply spreads them, no carry)
__device__ __forceinline__ uint32_t ones4(uint32_t x) {
    return ((x & 0xFu) * 0x00204081u) & 0x01010101u;
}
__device__ __forceinline__ uint4 ones16(uint32_t x) {
    return make_uint4(ones4(x), ones4(x >> 4), ones4(x >> 8),
                      ones4(x >> 12));
}
// each lane of an element 1 when it is > 0 (signed), else 0
__device__ __forceinline__ uint32_t pos01(uint32_t v) {
    return __vcmpgts4(v, 0u) & 0x01010101u;
}
__device__ __forceinline__ uint8_t pos01(uint8_t v) {
    return (int8_t)v > 0 ? 1 : 0;
}
// element helpers of the row-packed advance: each lane 1 when > 0
// (signed), shifted to bit sh (< 8: no lane overflows), ORed, tested
__device__ __forceinline__ uint4 pos_at(uint4 v, int sh) {
    return make_uint4(pos01(v.x) << sh, pos01(v.y) << sh, pos01(v.z) << sh,
                      pos01(v.w) << sh);
}
__device__ __forceinline__ uint32_t pos_at(uint32_t v, int sh) {
    return pos01(v) << sh;
}
__device__ __forceinline__ uint8_t pos_at(uint8_t v, int sh) {
    return (uint8_t)(pos01(v) << sh);
}
__device__ __forceinline__ uint4 or_v(uint4 a, uint4 b) {
    return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
}
__device__ __forceinline__ uint32_t or_v(uint32_t a, uint32_t b) {
    return a | b;
}
__device__ __forceinline__ uint8_t or_v(uint8_t a, uint8_t b) {
    return a | b;
}
__device__ __forceinline__ bool nz(uint4 v) {
    return (v.x | v.y | v.z | v.w) != 0u;
}
__device__ __forceinline__ bool nz(uint32_t v) { return v != 0u; }
__device__ __forceinline__ bool nz(uint8_t v) { return v != 0; }
// OR an element into memory by 32-bit atomics (a zero word skipped; a
// byte ORs the word holding it, which the wrapper keeps in the buffer)
__device__ __forceinline__ void atomic_or_v(uint4* p, uint4 v) {
    uint32_t* w = reinterpret_cast<uint32_t*>(p);
    if (v.x) atomicOr(w, v.x);
    if (v.y) atomicOr(w + 1, v.y);
    if (v.z) atomicOr(w + 2, v.z);
    if (v.w) atomicOr(w + 3, v.w);
}
__device__ __forceinline__ void atomic_or_v(uint32_t* p, uint32_t v) {
    if (v) atomicOr(p, v);
}
__device__ __forceinline__ void atomic_or_v(uint8_t* p, uint8_t v) {
    if (!v) return;
    const uintptr_t a = reinterpret_cast<uintptr_t>(p);
    atomicOr(reinterpret_cast<uint32_t*>(a & ~(uintptr_t)3),
             (uint32_t)v << 8 * (a & 3));
}

// ------------------------------------------------------ K12 upload
// Replaces nebula_tpu/tpu/runtime.py:3228 _upload_frontier's device
// half: zeros (a cudaMemsetAsync in the entry point), then a scatter-max
// of 1 at each of the first S entries (row, col); entries S .. Sp - 1
// are the padding, value 0, aimed at the pad row, and max(0, 0) leaves
// it zero.  Every written value is 1, so duplicate entries race
// harmlessly to the same store.  Entries out of range are dropped, as
// the reference's scatter drops them.  Bound: bytes — the (n_rows + 1)
// * B zero fill, then 8 bytes an entry read and one byte stored.
__global__ void upload_i8_kernel(int8_t* __restrict__ out,
                                 const int32_t* __restrict__ rows,
                                 const int32_t* __restrict__ cols,
                                 long long S, long long R1, long long B) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= S) return;
    const long long r = rows[i];
    const long long c = cols[i];
    if (r < 0 || r >= R1 || c < 0 || c >= B) return;
    out[r * B + c] = 1;
}

// ---------------------------------------------------------- K13 hop
// Replaces one advance of nebula_tpu/tpu/ell.py:1140
// make_batched_go_kernel (body _hop_body :386, _bucket_expand :368):
// per bucket row, the max over its D in-slots of f[nbr] masked by the
// OVER etype set, starting from 0, and with an accumulator acc = max(acc,
// out) (the UPTO running max, fused).  Up to three launches: the
// row-live pass (a program's first hop only), the gather, the hub pass.
//
// The live arrays (bitmaps, uint32 [ceil((n_rows + 1) / 32)], bit r % 32
// of word r / 32 for row r) let the gather skip source rows that hold no
// byte > 0: such a row cannot raise a max that starts from 0, so skipping
// it is exact whenever live_in is a SUPERSET of the rows with a byte > 0.
// A bitmap of the serve graph's 524,780 rows is 64 KB, which an SM's L1
// can hold (a byte array would be 512 KB), so the scan's random bit loads
// mostly stay on the SM.  The entry zeroes live_out, the gather sets the
// bit of each of its rows that has a byte > 0 (an atomicOr: rows of a
// word span blocks), the hub pass sets the bit of every owner it raises,
// and the pad row's bit stays 0.  A program passes each hop's live_out to
// the next hop as live_in.  The BFS level pass (K15) only lowers lanes
// between two hops, so the array it leaves behind stays a superset.
// Every value the gather writes is >= 0 (a max from 0).
//
// The gather runs ell_ops.hop_plan's plan (hop_plan.cuh) in three steps
// a round of slots, so that a frontier with few live rows costs the slot
// tables and the written carrier, not a latency chain a slot:
//   * scan: the row's G lanes split its slots, kChunk a lane (16-byte
//     units where the tables allow), and keep those that are not pad,
//     whose etype is in OVER and whose source row is live (its live_in
//     entry loaded after the slot, all of a lane's together);
//   * compact: the kept sources go to the row's list in shared memory
//     (a scan of the lanes' counts by shuffles);
//   * gather: lane (part, columns) takes list entries part, part + P,
//     ..., kChunk loads in flight, into a signed per-byte max; a row
//     with an empty list gathers and joins nothing (a signed byte max
//     costs several instructions a word).  On 16-byte columns a lane
//     takes kCols (the plan's `cols`: up to four), so one scan serves
//     them all and a warp holds more rows.
// The parts' maxima meet by __shfl_xor_sync and part 0 writes out (and
// acc) once.  Bound on this card: bytes — the slot tables, the live
// array, each live source row once, the written carrier (acc read and
// written).  Block 0 zeroes out's pad row, maxes 0 into acc's and clears
// live_out's.
//
// With kPack (a row-packed GO's last advance: ell.py:439 pack_bits,
// fused into the program as ell.py:1176 fuses it) part 0 writes no
// carrier: it stores the row's lanes > 0 (with acc: (acc > 0) | (out >
// 0), acc read, not written) as bit r % 8 of each lane's byte into the
// row's B-byte slice in shared memory (zeros for a row that holds
// none, or a place that is no row), and writes out only at the extra
// rows (r >= n), which the hub pass reads.  The entry zeroes the packed
// result first.  The plan starts each bucket's blocks at the 8-row
// group holding its first row (its row0 % 8 leading places are not
// live), so a block's groups are whole.  A block whose rows hold no
// bit leaves its groups zero and ends at the barrier; any other ORs
// each element of its groups from the 8 rows' slices and stores it,
// plainly where the group is its alone, by atomicOr where it holds a
// bucket boundary.  The pad row gathers nothing: its bit is acc's > 0
// (0 without acc), stored by its place where a block spans it and by
// block 0 where it starts a group of its own; the bits past n_rows + 1
// stay 0.
template <typename V, bool Q, int kMinBlocks, int kCols, bool kPack>
__global__ void __launch_bounds__(hop::kThreads, kMinBlocks)
hop_i8_kernel(const V* __restrict__ f, V* __restrict__ out,
              V* __restrict__ acc, const uint32_t* __restrict__ live_in,
              uint32_t* __restrict__ live_out, uint8_t* __restrict__ pk,
              const int32_t* __restrict__ nbr,
              const int32_t* __restrict__ et, hop::Plan pl,
              hop::OverSet ov, long long n, long long n_rows, int C,
              int lgc) {
    using hop::kChunk;
    // kPack: the block's rows' lanes, a B-byte slice a row
    extern __shared__ __align__(16) uint8_t pk_s[];
    const int blk = (int)blockIdx.x;
    if (!kPack && blk == 0) {
        for (int t = threadIdx.x; t < C; t += blockDim.x) {
            V z;
            hop::zero_v(z);
            out[n_rows * C + t] = z;
            if (acc) acc[n_rows * C + t] = hop::max_v(acc[n_rows * C + t], z);
        }
    }
    if (kPack && blk == 0 && acc && (n_rows & 7) == 0)
        for (int t = threadIdx.x; t < C; t += blockDim.x)
            reinterpret_cast<V*>(pk)[(n_rows >> 3) * C + t] =
                pos_at(acc[n_rows * C + t], 0);
    int b = 0;                          // uniform over the block
    for (int k = 1; k < pl.n; ++k)
        if (pl.blk0[k] <= blk) b = k;
    const int lg = pl.lg[b];
    const int G = 1 << lg;
    const int lane = threadIdx.x & (G - 1);   // lane in the row's group
    const int per = hop::kThreads >> lg;      // rows a block
    const int lead = kPack ? (int)(pl.row0[b] & 7) : 0;
    const long long lr = (long long)(blk - pl.blk0[b]) * per
                         + (threadIdx.x >> lg) - lead;
    const bool live = (!kPack || lr >= 0) && lr < pl.rows[b];
    // kPack: the block's first row (a multiple of 8), this row's slice
    const long long rowA = pl.row0[b] - lead
                           + (long long)(blk - pl.blk0[b]) * per;
    V* const slice = reinterpret_cast<V*>(pk_s) + (threadIdx.x >> lg) * C;
    bool bits_any = false;              // kPack: a bit in this lane's slice
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
    const long long r = pl.row0[b] + lr;
    bool pos = false;                   // a byte > 0 in the row
    __shared__ int rows_kept[hop::kThreads * kChunk];
    int* const list = rows_kept + (threadIdx.x & ~(G - 1)) * kChunk;
    constexpr int kIn = kChunk / kCols;    // list entries in flight
    // every lane runs the same trip counts in the scan (C, NU, G are the
    // block's), so the whole warp reaches each shuffle; a lane takes
    // kCols columns a pass, Cg apart, so one scan serves them all
    for (int cb = 0; cb < C; cb += Cg * kCols) {
        int c[kCols];
        bool act[kCols];
        V a[kCols];
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
            c[k] = cb + col0 + k * Cg;
            act[k] = live && c[k] < C;
            hop::zero_v(a[k]);
        }
        for (int u0 = 0; u0 < NU; u0 += G * UC) {
            // ---- scan: the row's lanes split the round's slots
            int nb[kChunk];
            unsigned ok = 0u;
#pragma unroll
            for (int q = 0; q < UC; ++q) {
                const int u = u0 + lane + q * G;
                if constexpr (Q) {
                    int4 s = make_int4(pad, pad, pad, pad);
                    int4 e = make_int4(0, 0, 0, 0);
                    if (live && u < NU) {
                        s = __ldcs(reinterpret_cast<const int4*>(nbr + base)
                                   + u);
                        e = __ldcs(reinterpret_cast<const int4*>(et + base)
                                   + u);
                    }
                    nb[4 * q] = s.x;
                    nb[4 * q + 1] = s.y;
                    nb[4 * q + 2] = s.z;
                    nb[4 * q + 3] = s.w;
                    ok |= (unsigned)(s.x != pad && hop::in_over(e.x, ov))
                          << 4 * q;
                    ok |= (unsigned)(s.y != pad && hop::in_over(e.y, ov))
                          << (4 * q + 1);
                    ok |= (unsigned)(s.z != pad && hop::in_over(e.z, ov))
                          << (4 * q + 2);
                    ok |= (unsigned)(s.w != pad && hop::in_over(e.w, ov))
                          << (4 * q + 3);
                } else {
                    int s = pad, e = 0;
                    if (live && u < NU) {
                        s = __ldcs(nbr + base + u);
                        e = __ldcs(et + base + u);
                    }
                    nb[q] = s;
                    ok |= (unsigned)(s != pad && hop::in_over(e, ov)) << q;
                }
            }
            unsigned kept = 0u;
#pragma unroll
            for (int j = 0; j < kChunk; ++j)
                if ((ok >> j) & 1u)
                    kept |= ((live_in[nb[j] >> 5] >> (nb[j] & 31)) & 1u) << j;
            // ---- compact: the row's kept sources into its shared list
            // (the group's G * kChunk entries), in lane order
            const unsigned cnt = __popc(kept);
            unsigned incl = cnt;
            for (int o = 1; o < G; o <<= 1) {
                const unsigned t = __shfl_up_sync(0xffffffffu, incl, o, G);
                if (lane >= o) incl += t;
            }
            const int total = (int)__shfl_sync(0xffffffffu, incl, G - 1, G);
            int k = (int)(incl - cnt);
#pragma unroll
            for (int j = 0; j < kChunk; ++j)
                if ((kept >> j) & 1u) list[k++] = nb[j];
            __syncwarp();
            // ---- gather: lane (part, columns) takes entries part, part
            // + P, ..., kIn of them (kChunk loads) in flight
            for (int e0 = part; e0 < total; e0 += kIn * P) {
                V g[kIn][kCols];
#pragma unroll
                for (int t = 0; t < kIn; ++t) {
                    const int e = e0 + t * P;
                    const long long src = e < total ? list[e] : 0;
#pragma unroll
                    for (int k = 0; k < kCols; ++k) {
                        hop::zero_v(g[t][k]);
                        if (act[k] && e < total)
                            g[t][k] = f[src * C + c[k]];
                    }
                }
#pragma unroll
                for (int t = 0; t < kIn; ++t)
#pragma unroll
                    for (int k = 0; k < kCols; ++k)
                        a[k] = hop::max_v(a[k], g[t][k]);
            }
            __syncwarp();          // the list is rewritten next round
        }
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
            for (int o = Cg; o < G; o <<= 1)
                a[k] = hop::max_v(a[k], hop::shfl_x(a[k], o));
            pos |= act[k] && hop::any_pos(a[k]);
            if constexpr (kPack) {
                if (part == 0 && c[k] < C) {    // every place its slice
                    V bits;
                    hop::zero_v(bits);
                    const long long i = r * C + c[k];
                    if (act[k] && nz(a[k])) bits = pos_at(a[k], (int)(r & 7));
                    if (acc && (act[k] || r == n_rows))
                        bits = or_v(bits, pos_at(acc[i], (int)(r & 7)));
                    bits_any |= nz(bits);
                    slice[c[k]] = bits;
                    if (act[k] && r >= n) out[i] = a[k];
                }
            } else if (act[k] && part == 0) {
                const long long i = r * C + c[k];
                out[i] = a[k];
                if (acc) acc[i] = hop::max_v(acc[i], a[k]);
            }
        }
    }
    if constexpr (kPack) {
        // a group overlapping the bucket's rows is the block's alone
        // unless it holds a bucket boundary (rows before row0, or after
        // the bucket's end below n_rows)
        if (__syncthreads_or(bits_any)) {
            const long long r0 = pl.row0[b];
            const long long r1 = r0 + pl.rows[b];
            const V* sv = reinterpret_cast<const V*>(pk_s);
            V* pv = reinterpret_cast<V*>(pk);
            for (int j = threadIdx.x; j < per * C / 8; j += blockDim.x) {
                const int gi = j / C;
                const int e = j - gi * C;
                const long long lo = rowA + 8 * gi;
                if (lo + 8 <= r0 || lo >= r1) continue;
                V v = sv[8 * gi * C + e];
#pragma unroll
                for (int k = 1; k < 8; ++k)
                    v = or_v(v, sv[(8 * gi + k) * C + e]);
                V* const at = pv + ((rowA >> 3) + gi) * C + e;
                if (lo >= r0 && (lo + 8 <= r1 || r1 == n_rows)) *at = v;
                else atomic_or_v(at, v);
            }
        }
    }
    if (live_out) {
        // the row's columns meet in its first lane (uniform: the
        // pointer is the kernel's, lgc the block's)
        for (int o = 1; o < Cg; o <<= 1)
            pos |= __shfl_xor_sync(0xffffffffu, (int)pos, o) != 0;
        if (live && lane == 0 && pos)
            atomicOr(live_out + (r >> 5), 1u << (r & 31));
    }
}

// Bit r of the zeroed bitmap live set when row r < n_rows of f has a
// byte > 0 (signed); the pad row's bit stays 0.  Cg = 2^lgc lanes read a
// row's C elements and meet by shuffles.  Bound: bytes, (n_rows + 1) * B
// read.
template <typename V>
__global__ void row_live_kernel(const V* __restrict__ f,
                                uint32_t* __restrict__ live,
                                long long n_rows, int C, int lgc) {
    const int Cg = 1 << lgc;
    const int lane = threadIdx.x & (Cg - 1);
    const long long per = kThreads >> lgc;         // rows a block
    // block-uniform trip count: the whole warp reaches each shuffle
    for (long long r0 = (long long)blockIdx.x * per; r0 <= n_rows;
         r0 += (long long)gridDim.x * per) {
        const long long r = r0 + (threadIdx.x >> lgc);
        bool pos = false;
        if (r < n_rows)
            for (int c = lane; c < C; c += Cg) pos |= hop::any_pos(f[r * C + c]);
        for (int o = 1; o < Cg; o <<= 1)
            pos |= __shfl_xor_sync(0xffffffffu, (int)pos, o) != 0;
        if (lane == 0 && r < n_rows && pos)
            atomicOr(live + (r >> 5), 1u << (r & 31));
    }
}

// Hub fix-up, after the gather (the reference's
// nxt.at[extra_owner].max(nxt[n:])): max each extra row n + e into its
// owner hrows[eslot[e]] in out and, when given, in acc (the fused UPTO
// max: an extra row's out is final after the gather, since extra rows
// are never owners), one thread per (extra, element), and set the
// owner's live_out bit.  Owners repeat and an owner's extras need not
// be contiguous (a growth spare claimed by ell_absorb sits at the
// table's end), so the update is atomic.  Owners >= n_rows are
// unclaimed growth spares: the reference's scatter drops them (one past
// its n_rows-row operand), so they are skipped and never reach the pad
// row.  Extra rows keep their values, as in the reference.  Extras and
// owners never overlap (owners are real rows < n), so reads see the
// gather's values.  Every value here is >= 0, so a zero element changes
// nothing and is skipped.  Bound: bytes, O(n_extras * B).
template <typename T>
__global__ void hub_max_kernel(T* __restrict__ out, T* __restrict__ acc,
                               uint32_t* __restrict__ live_out,
                               const int32_t* __restrict__ eslot,
                               const int32_t* __restrict__ hrows,
                               long long n, long long n_rows,
                               long long n_extras, long long E) {
    const long long total = n_extras * E;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < total; i += stride) {
        const long long e = i / E;
        const long long w = i - e * E;
        const long long owner = hrows[eslot[e]];
        if (owner < 0 || owner >= n_rows) continue;
        const T v = out[(n + e) * E + w];
        if (!v) continue;
        Lanes<T>::atomic_vmax(out + owner * E + w, v);
        if (acc) Lanes<T>::atomic_vmax(acc + owner * E + w, v);
        if (live_out) atomicOr(live_out + (owner >> 5), 1u << (owner & 31));
    }
}

// The hub pass of a row-packed last advance: bit owner % 8 of the owner's
// group ORed where an extra row's gathered lane is > 0 (its int8 row,
// which the gather wrote for this pass), one thread per (extra, element);
// the extra rows' own bits stay as gathered.  Several extras share an
// owner, and an owner's group may hold the first extra rows, so the OR
// is an atomicOr on the 32-bit word (the wrapper pads pk to whole
// words).  Owners >= n_rows drop, as in hub_max_kernel.  Bound: bytes,
// O(n_extras * B).
template <typename T>
__global__ void hub_pack_kernel(const T* __restrict__ out,
                                uint8_t* __restrict__ pk,
                                const int32_t* __restrict__ eslot,
                                const int32_t* __restrict__ hrows,
                                long long n, long long n_rows,
                                long long n_extras, long long E) {
    const long long total = n_extras * E;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < total; i += stride) {
        const long long e = i / E;
        const long long w = i - e * E;
        const long long owner = hrows[eslot[e]];
        if (owner < 0 || owner >= n_rows) continue;
        const uint32_t v = (uint32_t)pos01(out[(n + e) * E + w])
                           << (owner & 7);
        if (!v) continue;
        const uintptr_t a = reinterpret_cast<uintptr_t>(
            pk + ((owner >> 3) * E + w) * (long long)sizeof(T));
        atomicOr(reinterpret_cast<uint32_t*>(a & ~(uintptr_t)3),
                 v << 8 * (a & 3));
    }
}

// ----------------------------------------------------- K14 pack rows
// Replaces nebula_tpu/tpu/ell.py:439 pack_bits (fused into the
// reference's GO when pack=True): bit k of out[g, b] is x[8g + k, b] > 0
// (signed), rows past R1 are zero; out is uint8 [ceil(R1 / 8), B].  One
// thread per output element (a run of four lane columns when B % 4 ==
// 0): it reads the group's eight row elements, coalesced across the
// threads of the row, and writes one.  Bound: bytes, (R1 + R1 / 8) * B.
template <typename T>
__global__ void pack_rows_kernel(const T* __restrict__ x,
                                 T* __restrict__ out, long long R1,
                                 long long E) {
    const long long G = (R1 + 7) / 8;
    const long long total = G * E;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < total; i += stride) {
        const long long g = i / E;
        const long long w = i - g * E;
        T acc = 0;
        for (int k = 0; k < 8; ++k) {
            const long long r = 8 * g + k;
            if (r < R1) acc |= (T)(Lanes<T>::pos(x[r * E + w]) << k);
        }
        out[i] = acc;
    }
}

// ---------------------------------------------------- K15 BFS level
// Replaces the level body and the loop condition's reductions of
// nebula_tpu/tpu/ell.py:1616 make_batched_bfs_kernel, on K3's design
// (ell_lanes.cu bfs_level_kernel) with the int8 carrier's frontier.  The
// loop's state: `seen`, a lane bitmap of the lanes reached so far (the
// reference's d != INF), and d in the BFS result's form (int8, -1
// unreached, when max_steps <= 120; else int16, INF = 0x7FFF), written
// at newly reached lanes only and never read.  The targets are a lane
// bitmap tp (uploaded packed, or packed from an int8 carrier t8 by the
// first pass).  A level, after the hop wrote nxt: newly = (nxt > 0) &
// ~seen; seen |= newly; d = step + 1 at the newly lanes; nxt = newly
// (0/1) where that changes it; flags[0] when any lane was newly reached,
// flags[1] (stop) when any target bit is still unreached.  The first
// pass: seen = (f0 > 0) (values, not bits: the reference's first hop
// reads f0 itself, and f0 stays as it is), d written whole, flags[0]
// when any start, flags[1] (stop) when any target is not a start.
// Flags by a warp vote and at most one store a block to each.
//
// Where B % 16 == 0 and the carrier and d are 16-byte aligned a thread
// takes 16 lanes a step (a 16-byte nxt unit, a 16-bit seen and target
// unit, d as whole 16-byte units: stored from the unreached value where
// seen had none of their lanes, else read, merged and stored), U steps
// loaded before any is stored; otherwise a thread takes one seen byte (8
// lanes, fewer at a row's end), nxt read as 4-byte words when B % 4 ==
// 0, else as bytes.  Bound: bytes — a level reads nxt, seen and the
// targets' bits and writes the changed seen units, the changed nxt
// units and the newly lanes' d; the first pass reads f0 (and t8) and
// writes seen (and tp) and d whole.

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

// d's lanes of a 32-bit word (4 int8 or 2 int16): the lane mask of the
// lanes whose bits are x's low bits, every lane `v`, every lane unreached
template <typename D> __device__ __forceinline__ uint32_t d_mask(uint32_t x);
template <> __device__ __forceinline__ uint32_t d_mask<uint8_t>(uint32_t x) {
    return ones4(x) * 0xFFu;
}
template <> __device__ __forceinline__ uint32_t d_mask<uint16_t>(uint32_t x) {
    return (((x & 3u) * 0x8001u) & 0x00010001u) * 0xFFFFu;
}
template <typename D> __device__ __forceinline__ uint32_t d_lanes(uint32_t v) {
    return sizeof(D) == 1 ? (v & 0xFFu) * 0x01010101u
                          : (v & 0xFFFFu) * 0x00010001u;
}
template <typename D> __device__ __forceinline__ uint32_t d_unreached() {
    return sizeof(D) == 1 ? 0xFFFFFFFFu : d_lanes<uint16_t>(kInt16Inf);
}

// The first pass's d of 16 lanes (bits p): 0 at p, unreached elsewhere,
// as sizeof(D) whole 16-byte units.
template <typename D>
__device__ __forceinline__ void first_depths(uint4* du, uint32_t p) {
    constexpr int kUL = 16 / (int)sizeof(D);     // lanes a unit
    constexpr int kLW = 4 / (int)sizeof(D);      // lanes a word
#pragma unroll
    for (int c = 0; c < 16 / kUL; ++c) {
        uint32_t o[4];
#pragma unroll
        for (int h = 0; h < 4; ++h)
            o[h] = d_unreached<D>() & ~d_mask<D>(p >> (c * kUL + h * kLW));
        du[c] = make_uint4(o[0], o[1], o[2], o[3]);
    }
}

// A level's d of 16 lanes: `depth` at the newly lanes, each unit that
// holds one stored whole (read and merged only where seen had a lane).
template <typename D>
__device__ __forceinline__ void level_depths(uint4* du, uint32_t newly,
                                             uint32_t s, uint32_t depth) {
    constexpr int kUL = 16 / (int)sizeof(D);
    constexpr int kLW = 4 / (int)sizeof(D);
    constexpr uint32_t kUnit = kUL == 16 ? 0xFFFFu : 0xFFu;
#pragma unroll
    for (int c = 0; c < 16 / kUL; ++c) {
        const uint32_t nb = (newly >> (c * kUL)) & kUnit;
        if (!nb) continue;
        const uint32_t u = d_unreached<D>();
        uint4 o = ((s >> (c * kUL)) & kUnit) ? du[c] : make_uint4(u, u, u, u);
        uint32_t* ow = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
        for (int h = 0; h < 4; ++h) {
            const uint32_t m = d_mask<D>(nb >> (h * kLW));
            ow[h] = (ow[h] & ~m) | (d_lanes<D>(depth) & m);
        }
        du[c] = o;
    }
}

// 16 lanes a step: the first pass (First) or a level.
template <typename D, int U, bool First>
__global__ void __launch_bounds__(kThreads)
level16_kernel(uint4* __restrict__ nxt, const uint4* __restrict__ t8,
               uint16_t* __restrict__ tp, uint16_t* __restrict__ seen,
               D* __restrict__ d, int32_t* __restrict__ flags,
               uint32_t depth, int stop, long long units) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    bool f = false, r = false;
    for (long long i0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i0 < units; i0 += U * stride) {
        uint4 v[U], w[U];
        uint32_t s[U], t[U];
#pragma unroll
        for (int k = 0; k < U; ++k) {
            const long long i = i0 + k * stride;
            const bool in = i < units;
            v[k] = in ? nxt[i] : make_uint4(0u, 0u, 0u, 0u);
            w[k] = in && First && t8 ? t8[i] : make_uint4(0u, 0u, 0u, 0u);
            s[k] = in && !First ? seen[i] : 0u;
            t[k] = in && stop && !(First && t8) ? tp[i] : 0u;
        }
#pragma unroll
        for (int k = 0; k < U; ++k) {
            const long long i = i0 + k * stride;
            if (i >= units) break;
            uint4* du = reinterpret_cast<uint4*>(d + 16 * i);
            const uint32_t p = pos_bits16(v[k]);
            if (First) {
                seen[i] = (uint16_t)p;
                first_depths<D>(du, p);
                if (t8 && stop) {
                    t[k] = pos_bits16(w[k]);
                    tp[i] = (uint16_t)t[k];
                }
                f |= p != 0u;
                r |= (t[k] & ~p) != 0u;
            } else {
                const uint32_t newly = p & ~s[k];
                if (newly) {
                    seen[i] = (uint16_t)(s[k] | newly);
                    level_depths<D>(du, newly, s[k], depth);
                }
                const uint4 o = ones16(newly);
                if (o.x != v[k].x || o.y != v[k].y || o.z != v[k].z ||
                    o.w != v[k].w)
                    nxt[i] = o;
                f |= newly != 0u;
                r |= (t[k] & ~(s[k] | newly)) != 0u;
            }
        }
    }
    raise_flags(f, r, flags);
}

// A seen byte a step (8 lanes, fewer at a row's end): any B.  V is how nxt
// (and t8) are read: 4-byte words (B % 4 == 0) or bytes.
template <typename D, typename V>
__global__ void __launch_bounds__(kThreads)
level8_kernel(int8_t* __restrict__ nxt, const int8_t* __restrict__ t8,
              uint8_t* __restrict__ tp, uint8_t* __restrict__ seen,
              D* __restrict__ d, int32_t* __restrict__ flags, int first,
              D depth, D unreached, int stop, long long R1, long long B) {
    const long long Wb = (B + 7) >> 3;
    const long long units = R1 * Wb;
    const long long stride = (long long)gridDim.x * blockDim.x;
    bool f = false, r = false;
    for (long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         u < units; u += stride) {
        const long long row = u / Wb;
        const long long wb = u - row * Wb;
        const long long base = row * B + 8 * wb;
        const int L = (int)(B - 8 * wb < 8 ? B - 8 * wb : 8);
        uint32_t p = 0u, tb = 0u;
        if (sizeof(V) == 4) {
            const uint32_t* nw = reinterpret_cast<const uint32_t*>(nxt + base);
            for (int q = 0; q < L / 4; ++q) p |= pos_bits4(nw[q]) << 4 * q;
        } else {
            for (int j = 0; j < L; ++j) p |= (uint32_t)(nxt[base + j] > 0) << j;
        }
        if (first) {
            seen[u] = (uint8_t)p;
            for (int j = 0; j < L; ++j)
                d[base + j] = (p >> j) & 1u ? (D)0 : unreached;
            if (stop && t8) {
                if (sizeof(V) == 4) {
                    const uint32_t* tw =
                        reinterpret_cast<const uint32_t*>(t8 + base);
                    for (int q = 0; q < L / 4; ++q)
                        tb |= pos_bits4(tw[q]) << 4 * q;
                } else {
                    for (int j = 0; j < L; ++j)
                        tb |= (uint32_t)(t8[base + j] > 0) << j;
                }
                tp[u] = (uint8_t)tb;
            } else if (stop) {
                tb = tp[u];
            }
            f |= p != 0u;
            r |= (tb & ~p) != 0u;
        } else {
            const uint32_t s = seen[u];
            const uint32_t newly = p & ~s;
            if (newly) {
                seen[u] = (uint8_t)(s | newly);
                for (int j = 0; j < L; ++j)
                    if ((newly >> j) & 1u) d[base + j] = depth;
            }
            if (sizeof(V) == 4) {
                uint32_t* nw = reinterpret_cast<uint32_t*>(nxt + base);
                for (int q = 0; q < L / 4; ++q) {
                    const uint32_t o = ones4(newly >> 4 * q);
                    if (nw[q] != o) nw[q] = o;
                }
            } else {
                for (int j = 0; j < L; ++j) {
                    const int8_t o = (int8_t)((newly >> j) & 1u);
                    if (nxt[base + j] != o) nxt[base + j] = o;
                }
            }
            f |= newly != 0u;
            if (stop) r |= (tp[u] & ~(s | newly)) != 0u;
        }
    }
    raise_flags(f, r, flags);
}

}  // namespace

extern "C" {

// out: int8 [R1, B], overwritten; rows/cols: int32 [Sp], the first S
// entries live (value 1), the rest padding (value 0).
int i8_frontier_upload(void* out, const void* rows, const void* cols,
                       int64_t Sp, int64_t S, int64_t R1, int64_t B,
                       void* stream) {
    if (R1 <= 0 || B <= 0 || Sp < 0 || S < 0 || S > Sp) return -1;
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err = cudaMemsetAsync(out, 0, (size_t)(R1 * B), s);
    if (err != cudaSuccess) return (int)err;
    if (S > 0) {
        upload_i8_kernel<<<(unsigned)((S + kThreads - 1) / kThreads),
                           kThreads, 0, s>>>(
            (int8_t*)out, (const int32_t*)rows, (const int32_t*)cols, S,
            R1, B);
    }
    return (int)cudaGetLastError();
}

// The row-live pass: the bitmap live uint32 [ceil((n_rows + 1) / 32)]
// from f int8 [n_rows + 1, B] (zeroed, then row_live_kernel; 16-byte
// elements when B % 16 == 0 and f is 16-byte aligned, else 4-byte ones
// when B % 4 == 0, else bytes).
int i8_row_live(const void* f, void* live, int64_t n_rows, int64_t B,
                void* stream) {
    if (n_rows < 0 || B <= 0) return -1;
    const bool wide = B % 16 == 0 && ((uintptr_t)f & 15) == 0;
    const bool words = B % 4 == 0 && ((uintptr_t)f & 3) == 0;
    const int C = (int)(wide ? B / 16 : words ? B / 4 : B);
    int lgc = 0;
    while (lgc < 5 && (1 << lgc) < C) ++lgc;
    const long long per = kThreads >> lgc;
    long long blocks = (n_rows + 1 + per - 1) / per;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    cudaStream_t s = (cudaStream_t)stream;
    const cudaError_t err = cudaMemsetAsync(
        live, 0, (size_t)((n_rows + 32) / 32) * 4, s);
    if (err != cudaSuccess) return (int)err;
    if (wide)
        row_live_kernel<uint4><<<(unsigned)blocks, kThreads, 0, s>>>(
            (const uint4*)f, (uint32_t*)live, n_rows, C, lgc);
    else if (words)
        row_live_kernel<uint32_t><<<(unsigned)blocks, kThreads, 0, s>>>(
            (const uint32_t*)f, (uint32_t*)live, n_rows, C, lgc);
    else
        row_live_kernel<uint8_t><<<(unsigned)blocks, kThreads, 0, s>>>(
            (const uint8_t*)f, (uint32_t*)live, n_rows, C, lgc);
    return (int)cudaGetLastError();
}

// f, out, acc (acc may be null): int8 [n_rows + 1, B]; live_in (not
// null) and live_out (may be null): uint32 [ceil((n_rows + 1) / 32)]
// bitmaps, live_out zeroed here.  plan, blocks, lgc: ell_ops.hop_plan's
// launch plan for `unit`-byte columns (16: B % 16 == 0 and f, out, acc
// 16-byte aligned; 4: B % 4 == 0 and 4-byte aligned; 1: any B), `cols`
// of them a lane (1, 2 or 4; more than 1 only on 16-byte columns), as
// ell_go_hop takes it; the entry checks only that it is safe to run.
// pk (may be null): the row-packed result uint8 [ceil((n_rows + 1) / 8),
// B], 4-byte aligned and padded to whole words, overwritten — the plan
// then counts each bucket's row0 % 8 leading places (hop_plan's
// `lead`), live_out is null, out gets only the extra rows and acc is
// read, not written.  over: host int32 [n_over].  Returns 0, a
// cudaError_t, or -1 for an argument the kernels cannot take.
int i8_go_hop(const void* f, void* acc, void* out, const void* live_in,
              void* live_out, void* pk, const void* nbr, const void* et,
              const int64_t* plan, int n_buckets, int64_t blocks, int lgc,
              int unit, int cols, const void* eslot, const void* hrows,
              int64_t n_extras, const int32_t* over, int n_over, int64_t n,
              int64_t n_rows, int64_t B, void* stream) {
    if (B <= 0 || n_rows < 0 || n_extras < 0 || live_in == nullptr ||
        (unit != 1 && unit != 4 && unit != 16) || B % unit != 0 ||
        (cols != 1 && cols != 2 && cols != 4) || (cols > 1 && unit != 16) ||
        (pk && (live_out || ((uintptr_t)pk & 3))))
        return -1;
    const uintptr_t rows_at = (uintptr_t)f | (uintptr_t)out |
                              (uintptr_t)acc;
    if (((rows_at | (uintptr_t)pk) & (uintptr_t)(unit - 1)) != 0) return -1;
    bool quads = (((uintptr_t)nbr | (uintptr_t)et) & 15) == 0;
    hop::Plan pl;
    hop::OverSet ov;
    if (!hop::read_plan(plan, n_buckets, blocks, lgc, &pl, &quads) ||
        !hop::read_over(over, n_over, &ov))
        return -1;
    cudaStream_t s = (cudaStream_t)stream;
    const unsigned grid = (unsigned)blocks;
    const int C = (int)(B / unit);
    const uint32_t* li = (const uint32_t*)live_in;
    uint32_t* lo = (uint32_t*)live_out;
    if (lo) {
        const cudaError_t e = cudaMemsetAsync(
            lo, 0, (size_t)((n_rows + 32) / 32) * 4, s);
        if (e != cudaSuccess) return (int)e;
    }
    // with pk: a B-byte slice a row of the block with the most rows
    // (kThreads >> lg); the result zeroed first
    size_t smem = 0;
    if (pk) {
        int lg_min = 5;
        for (int b = 0; b < pl.n; ++b)
            if (pl.lg[b] < lg_min) lg_min = pl.lg[b];
        smem = ((size_t)(hop::kThreads >> lg_min) * B + 15) & ~(size_t)15;
        if (smem > kMaxPackSmem) return -1;
        const cudaError_t e = cudaMemsetAsync(
            pk, 0, (size_t)((n_rows + 8) / 8 * B), s);
        if (e != cudaSuccess) return (int)e;
    }
    const int32_t* nb = (const int32_t*)nbr;
    const int32_t* ev = (const int32_t*)et;
#define HOP_I8_ONE(V, Qv, MB, NC, P)                                       \
    do {                                                                   \
        if (smem > 40 * 1024)                                              \
            cudaFuncSetAttribute(hop_i8_kernel<V, Qv, MB, NC, P>,          \
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, \
                                 (int)smem);                               \
        hop_i8_kernel<V, Qv, MB, NC, P><<<grid, hop::kThreads, smem, s>>>( \
            (const V*)f, (V*)out, (V*)acc, li, lo, (uint8_t*)pk, nb, ev,   \
            pl, ov, n, n_rows, C, lgc);                                    \
    } while (0)
#define HOP_I8(V, Qv, MB, NC)                                              \
    do {                                                                   \
        if (pk) HOP_I8_ONE(V, Qv, MB, NC, true);                           \
        else HOP_I8_ONE(V, Qv, MB, NC, false);                             \
    } while (0)
    // 16-byte columns: 86-89 registers uncapped; 4 blocks an SM (64
    // registers) hide more of the scan's latency.
    if (unit == 16 && quads && cols == 4) HOP_I8(uint4, true, 4, 4);
    else if (unit == 16 && quads && cols == 2) HOP_I8(uint4, true, 4, 2);
    else if (unit == 16 && quads) HOP_I8(uint4, true, 4, 1);
    else if (unit == 16 && cols == 4) HOP_I8(uint4, false, 4, 4);
    else if (unit == 16 && cols == 2) HOP_I8(uint4, false, 4, 2);
    else if (unit == 16) HOP_I8(uint4, false, 4, 1);
    else if (unit == 4 && quads) HOP_I8(uint32_t, true, 1, 1);
    else if (unit == 4) HOP_I8(uint32_t, false, 1, 1);
    else if (quads) HOP_I8(uint8_t, true, 1, 1);
    else HOP_I8(uint8_t, false, 1, 1);
#undef HOP_I8
#undef HOP_I8_ONE
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || n_extras == 0) return (int)err;
    const bool words = B % 4 == 0 && (rows_at & 3) == 0;
    if (pk && words)
        hub_pack_kernel<uint32_t><<<grid_for(n_extras * (B / 4)), kThreads,
                                    0, s>>>(
            (const uint32_t*)out, (uint8_t*)pk, (const int32_t*)eslot,
            (const int32_t*)hrows, n, n_rows, n_extras, B / 4);
    else if (pk)
        hub_pack_kernel<uint8_t><<<grid_for(n_extras * B), kThreads, 0, s>>>(
            (const uint8_t*)out, (uint8_t*)pk, (const int32_t*)eslot,
            (const int32_t*)hrows, n, n_rows, n_extras, B);
    else if (words)
        hub_max_kernel<uint32_t><<<grid_for(n_extras * (B / 4)), kThreads,
                                   0, s>>>(
            (uint32_t*)out, (uint32_t*)acc, lo,
            (const int32_t*)eslot, (const int32_t*)hrows, n, n_rows,
            n_extras, B / 4);
    else
        hub_max_kernel<uint8_t><<<grid_for(n_extras * B), kThreads, 0, s>>>(
            (uint8_t*)out, (uint8_t*)acc, lo,
            (const int32_t*)eslot, (const int32_t*)hrows, n, n_rows,
            n_extras, B);
    return (int)cudaGetLastError();
}

// x: int8 [R1, B]; out: uint8 [ceil(R1 / 8), B], overwritten; both
// 4-byte aligned.
int i8_pack_rows(const void* x, void* out, int64_t R1, int64_t B,
                 void* stream) {
    if (R1 <= 0 || B <= 0) return -1;
    cudaStream_t s = (cudaStream_t)stream;
    const long long G = (R1 + 7) / 8;
    if (B % 4 == 0)
        pack_rows_kernel<uint32_t><<<grid_for(G * (B / 4)), kThreads, 0,
                                     s>>>(
            (const uint32_t*)x, (uint32_t*)out, R1, B / 4);
    else
        pack_rows_kernel<uint8_t><<<grid_for(G * B), kThreads, 0, s>>>(
            (const uint8_t*)x, (uint8_t*)out, R1, B);
    return (int)cudaGetLastError();
}

// K15.  nxt: int8 [R1, B]; tp, seen: uint8 [R1, ceil(B / 8)] lane
// bitmaps; d: [R1, B] of dbytes (1: int8, -1 unreached; 2: int16,
// INF); flags: int32 [2], this level's slot (zero before the launch).
// first: the first pass, which packs t8 (int8 [R1, B], may be null)
// into tp when stop; otherwise tp is read as it is.  The 16-lane path
// needs B % 16 == 0, nxt, t8 and d 16-byte aligned and seen and tp
// 2-byte aligned; the 4-byte words of the 8-lane path B % 4 == 0 and
// nxt and t8 4-byte aligned.  The grid is a few blocks an SM, striding.
int i8_bfs_level(void* nxt, void* tp, void* seen, void* d, int dbytes,
                 void* flags, const void* t8, int step, int first, int stop,
                 int64_t R1, int64_t B, void* stream) {
    if (R1 <= 0 || B <= 0 || step < 0 || (dbytes != 1 && dbytes != 2) ||
        step >= (dbytes == 1 ? 0x7E : 0x7FFE) || (t8 && !first))
        return -1;
    const long long most = (long long)sm_count() * (2048 / kThreads);
    if (most == 0) return (int)cudaErrorInvalidDevice;
    cudaStream_t s = (cudaStream_t)stream;
    int32_t* fl = (int32_t*)flags;
    const uintptr_t lanes_at = (uintptr_t)nxt | (uintptr_t)t8 | (uintptr_t)d;
    const bool wide = B % 16 == 0 && (lanes_at & 15) == 0 &&
                      (((uintptr_t)tp | (uintptr_t)seen) & 1) == 0;
    const uint32_t depth = (uint32_t)(step + 1);
    if (wide) {
        const long long units = R1 * (B / 16);
        const unsigned grid = (unsigned)(grid_for(units) < most
                                         ? grid_for(units) : most);
#define LEVEL16(D, U, F)                                                   \
        level16_kernel<D, U, F><<<grid, kThreads, 0, s>>>(                 \
            (uint4*)nxt, (const uint4*)t8, (uint16_t*)tp, (uint16_t*)seen, \
            (D*)d, fl, depth, stop, units)
        if (dbytes == 1 && first) LEVEL16(uint8_t, 4, true);
        else if (dbytes == 1) LEVEL16(uint8_t, 4, false);
        else if (first) LEVEL16(uint16_t, 2, true);
        else LEVEL16(uint16_t, 2, false);
#undef LEVEL16
        return (int)cudaGetLastError();
    }
    const bool words = B % 4 == 0 &&
                       (((uintptr_t)nxt | (uintptr_t)t8) & 3) == 0;
    const long long units = R1 * ((B + 7) / 8);
    const unsigned grid = (unsigned)(grid_for(units) < most
                                     ? grid_for(units) : most);
#define LEVEL8(D, V, UNREACHED)                                            \
    level8_kernel<D, V><<<grid, kThreads, 0, s>>>(                         \
        (int8_t*)nxt, (const int8_t*)t8, (uint8_t*)tp, (uint8_t*)seen,     \
        (D*)d, fl, first, (D)depth, (D)(UNREACHED), stop, R1, B)
    if (dbytes == 1 && words) LEVEL8(uint8_t, uint32_t, 0xFF);
    else if (dbytes == 1) LEVEL8(uint8_t, uint8_t, 0xFF);
    else if (words) LEVEL8(uint16_t, uint32_t, kInt16Inf);
    else LEVEL8(uint16_t, uint8_t, kInt16Inf);
#undef LEVEL8
    return (int)cudaGetLastError();
}

}  // extern "C"
