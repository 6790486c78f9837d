// Int8 lane kernels for Hopper (sm_90a), behind a plain C interface that
// nebula_tpu_torch/tpu/ell_ops.py loads with ctypes: the packing-off
// route (tpu_packed_frontier=false) of the windowed dense GO and the
// batched BFS.  K12 the start-lane upload, K13 the hop, K14 the row
// pack of the GO result, K15 the BFS level pass.
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

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1LL << 20;   // grid-stride beyond this
constexpr int16_t kInt16Inf = 0x7FFF;          // ell.py:51 INT16_INF

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
    static constexpr int kN = 4;
    // 1 in each byte whose signed value is > 0, else 0
    static __device__ __forceinline__ uint32_t pos(uint32_t v) {
        return __vcmpgts4(v, 0u) & 0x01010101u;
    }
    static __device__ __forceinline__ int8_t lane(uint32_t v, int j) {
        return (int8_t)((v >> (8 * j)) & 0xFFu);
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
    static constexpr int kN = 1;
    static __device__ __forceinline__ uint8_t pos(uint8_t v) {
        return (int8_t)v > 0 ? 1 : 0;
    }
    static __device__ __forceinline__ int8_t lane(uint8_t v, int) {
        return (int8_t)v;
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
template <typename V, bool Q, int kMinBlocks, int kCols>
__global__ void __launch_bounds__(hop::kThreads, kMinBlocks)
hop_i8_kernel(const V* __restrict__ f, V* __restrict__ out,
              V* __restrict__ acc, const uint32_t* __restrict__ live_in,
              uint32_t* __restrict__ live_out,
              const int32_t* __restrict__ nbr,
              const int32_t* __restrict__ et, hop::Plan pl,
              hop::OverSet ov, long long n_rows, int C, int lgc) {
    using hop::kChunk;
    const int blk = (int)blockIdx.x;
    if (blk == 0) {
        for (int t = threadIdx.x; t < C; t += blockDim.x) {
            V z;
            hop::zero_v(z);
            out[n_rows * C + t] = z;
            if (acc) acc[n_rows * C + t] = hop::max_v(acc[n_rows * C + t], z);
        }
    }
    int b = 0;                          // uniform over the block
    for (int k = 1; k < pl.n; ++k)
        if (pl.blk0[k] <= blk) b = k;
    const int lg = pl.lg[b];
    const int G = 1 << lg;
    const int lane = threadIdx.x & (G - 1);   // lane in the row's group
    const long long lr = (long long)(blk - pl.blk0[b]) * (hop::kThreads >> lg)
                         + (threadIdx.x >> lg);
    const bool live = lr < pl.rows[b];
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
            if (act[k] && part == 0) {
                const long long i = r * C + c[k];
                out[i] = a[k];
                if (acc) acc[i] = hop::max_v(acc[i], a[k]);
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
// nebula_tpu/tpu/ell.py:1616 make_batched_bfs_kernel.  Depths are int16
// [n_rows + 1, B], INF = 0x7FFF.  After the hop wrote nxt, one thread
// per (row, element) takes newly = (nxt > 0) & (d == INF), sets d =
// step + 1 on those lanes, writes newly (0/1) back into nxt (the next
// level's frontier) and raises this level's flags: flags[0] when any
// lane was newly reached, flags[1] when any target lane (tp > 0) still
// sits at INF (targets read only with stop).  With first, the pass
// builds the loop's initial state from the start frontier in nxt: d = 0
// where nxt > 0 and INF elsewhere (every d entry written), nxt left as
// it is (the reference's first hop reads f0 itself).  Lanes of one
// element belong to one thread, so no two threads touch one d entry;
// the flags only ever go 0 -> 1.  Bound: bytes — nxt and the targets
// read, d read at live lanes and written where it changes (all of d on
// the first pass), nxt written where it changes.
template <typename T>
__global__ void bfs_level_i8_kernel(T* __restrict__ nxt,
                                    const T* __restrict__ tp,
                                    int16_t* __restrict__ d,
                                    int32_t* __restrict__ flags, int step,
                                    int first, int stop, long long R1,
                                    long long E) {
    constexpr int L = Lanes<T>::kN;
    const long long total = R1 * E;
    const long long stride = (long long)gridDim.x * blockDim.x;
    const int16_t depth = (int16_t)(step + 1);
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < total; i += stride) {
        int16_t* dl = d + i * L;        // lanes L*i .. L*i + L-1 of d
        const T v = nxt[i];
        const T t = stop ? tp[i] : (T)0;
        bool newly = false, rem = false;
        if (first) {
            const T p = Lanes<T>::pos(v);
            for (int j = 0; j < L; ++j) {
                const bool live = Lanes<T>::lane(p, j) != 0;
                dl[j] = live ? (int16_t)0 : kInt16Inf;
                rem |= !live && Lanes<T>::lane(t, j) > 0;
            }
            newly = p != 0;
        } else {
            T nw = 0;
            for (int j = 0; j < L; ++j) {
                if (Lanes<T>::lane(v, j) > 0 && dl[j] == kInt16Inf) {
                    dl[j] = depth;
                    nw |= (T)((T)1 << (8 * j));
                }
            }
            if (nw != v) nxt[i] = nw;
            newly = nw != 0;
            if (stop)
                for (int j = 0; j < L; ++j)
                    rem |= Lanes<T>::lane(t, j) > 0 && dl[j] == kInt16Inf;
        }
        if (newly) flags[0] = 1;
        if (rem) flags[1] = 1;
    }
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
// over: host int32 [n_over].  Returns 0, a cudaError_t, or -1 for an
// argument the kernels cannot take.
int i8_go_hop(const void* f, void* acc, void* out, const void* live_in,
              void* live_out, const void* nbr, const void* et,
              const int64_t* plan, int n_buckets, int64_t blocks, int lgc,
              int unit, int cols, const void* eslot, const void* hrows,
              int64_t n_extras, const int32_t* over, int n_over, int64_t n,
              int64_t n_rows, int64_t B, void* stream) {
    if (B <= 0 || n_rows < 0 || n_extras < 0 || live_in == nullptr ||
        (unit != 1 && unit != 4 && unit != 16) || B % unit != 0 ||
        (cols != 1 && cols != 2 && cols != 4) || (cols > 1 && unit != 16))
        return -1;
    const uintptr_t rows_at = (uintptr_t)f | (uintptr_t)out |
                              (uintptr_t)acc;
    if ((rows_at & (uintptr_t)(unit - 1)) != 0) return -1;
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
    const int32_t* nb = (const int32_t*)nbr;
    const int32_t* ev = (const int32_t*)et;
#define HOP_I8(V, Qv, MB, NC)                                              \
    hop_i8_kernel<V, Qv, MB, NC><<<grid, hop::kThreads, 0, s>>>(           \
        (const V*)f, (V*)out, (V*)acc, li, lo, nb, ev, pl, ov, n_rows, C,  \
        lgc)
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
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || n_extras == 0) return (int)err;
    if (B % 4 == 0 && (rows_at & 3) == 0)
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

// nxt, tp: int8 [R1, B], 4-byte aligned; d: int16 [R1, B]; flags: int32
// [2], this level's slot (zero before the launch).
int i8_bfs_level(void* nxt, const void* tp, void* d, void* flags, int step,
                 int first, int stop, int64_t R1, int64_t B, void* stream) {
    if (R1 <= 0 || B <= 0 || step < 0 || step >= 0x7FFE) return -1;
    cudaStream_t s = (cudaStream_t)stream;
    if (B % 4 == 0)
        bfs_level_i8_kernel<uint32_t><<<grid_for(R1 * (B / 4)), kThreads,
                                        0, s>>>(
            (uint32_t*)nxt, (const uint32_t*)tp, (int16_t*)d,
            (int32_t*)flags, step, first, stop, R1, B / 4);
    else
        bfs_level_i8_kernel<uint8_t><<<grid_for(R1 * B), kThreads, 0, s>>>(
            (uint8_t*)nxt, (const uint8_t*)tp, (int16_t*)d,
            (int32_t*)flags, step, first, stop, R1, B);
    return (int)cudaGetLastError();
}

}  // extern "C"
