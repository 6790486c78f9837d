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
// thread owns one byte (the same code, instantiated for uint8_t).  Flags
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

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1LL << 20;   // grid-stride beyond this
constexpr int kMaxBuckets = 32;
constexpr int kMaxOver = 32;
constexpr int16_t kInt16Inf = 0x7FFF;          // ell.py:51 INT16_INF

// Per-bucket geometry of the flat slot tables, passed by value.
struct Buckets {
    long long row0[kMaxBuckets];    // first frontier row of bucket b
    long long slot0[kMaxBuckets];   // first slot of bucket b in nbr/et
    int D[kMaxBuckets];             // slots per row of bucket b
    int n;
};

// The OVER set as signed etypes (negative = REVERSELY), by value.
struct OverSet {
    int et[kMaxOver];
    int n;
};

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
    // signed per-byte max
    static __device__ __forceinline__ uint32_t vmax(uint32_t a,
                                                    uint32_t b) {
        return __vmaxs4(a, b);
    }
    // 1 in each byte whose signed value is > 0, else 0
    static __device__ __forceinline__ uint32_t pos(uint32_t v) {
        return __vcmpgts4(v, 0u) & 0x01010101u;
    }
    static __device__ __forceinline__ int8_t lane(uint32_t v, int j) {
        return (int8_t)((v >> (8 * j)) & 0xFFu);
    }
    // In place: *p = vmax(*p, v).  Owners repeat and there is no byte
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
    static __device__ __forceinline__ uint8_t vmax(uint8_t a, uint8_t b) {
        return (int8_t)a > (int8_t)b ? a : b;
    }
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
// OVER etype set, starting from 0.  One thread owns one (row, element),
// as hop_gather_kernel (ell_lanes.cu) does for packed words: threads of
// one row share its slot and etype loads (a broadcast), and consecutive
// threads gather consecutive elements of each source row.  Bound on
// this card: bytes — per row D slot reads of nbr + et (8 bytes each)
// and D gathers of the source row's element, then one store.  The pad
// row of the output is written zero; every gather reads the previous
// generation, so the output is a separate buffer.
template <typename T>
__global__ void hop_i8_kernel(const T* __restrict__ f, T* __restrict__ out,
                              const int32_t* __restrict__ nbr,
                              const int32_t* __restrict__ et, Buckets bk,
                              OverSet ov, long long n_rows, long long E) {
    const long long total = (n_rows + 1) * E;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < total; i += stride) {
        const long long r = i / E;
        const long long w = i - r * E;
        if (r == n_rows) {              // pad row: pinned to zero
            out[i] = 0;
            continue;
        }
        int b = 0;
        for (int k = 1; k < bk.n; ++k)
            if (bk.row0[k] <= r) b = k;
        const int D = bk.D[b];
        const long long base = bk.slot0[b] + (r - bk.row0[b]) * D;
        T acc = 0;
        for (int j = 0; j < D; ++j) {
            const int e = et[base + j];
            bool ok = false;
            for (int k = 0; k < ov.n; ++k) ok |= (e == ov.et[k]);
            if (ok) acc = Lanes<T>::vmax(acc, f[(long long)nbr[base + j] * E + w]);
        }
        out[i] = acc;
    }
}

// Hub fix-up, after the gather (the reference's
// nxt.at[extra_owner].max(nxt[n:])): max each extra row n + e into its
// owner hrows[eslot[e]], one thread per (extra, element).  Owners repeat
// and an owner's extras need not be contiguous (a growth spare claimed
// by ell_absorb sits at the table's end), so the update is atomic.
// Owners >= n_rows are unclaimed growth spares: the reference's scatter
// drops them (one past its n_rows-row operand), so they are skipped and
// never reach the pad row.  Extra rows keep their values, as in the
// reference.  Extras and owners never overlap (owners are real rows <
// n), so reads see the gather's values.  Every value here is >= 0, so a
// zero element changes nothing and is skipped.  Bound: bytes,
// O(n_extras * B).
template <typename T>
__global__ void hub_max_kernel(T* __restrict__ out,
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
        if (v) Lanes<T>::atomic_vmax(out + owner * E + w, v);
    }
}

// acc = max(acc, nxt) elementwise over the whole carrier: the UPTO
// running max, which must read nxt after the hub pass (enqueued after
// it).  Bound: bytes, 3 * (n_rows + 1) * B.
template <typename T>
__global__ void max_into_kernel(const T* __restrict__ src,
                                T* __restrict__ dst, long long total) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < total; i += stride)
        dst[i] = Lanes<T>::vmax(dst[i], src[i]);
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

// f, out, acc (acc may be null): int8 [n_rows + 1, B], 4-byte aligned;
// bucket_desc: host int64 [n_buckets * 3] = (row0, slot0, D) per bucket;
// over: host int32 [n_over].
int i8_go_hop(const void* f, void* acc, void* out, const void* nbr,
              const void* et, const int64_t* bucket_desc, int n_buckets,
              const void* eslot, const void* hrows, int64_t n_extras,
              const int32_t* over, int n_over, int64_t n, int64_t n_rows,
              int64_t B, void* stream) {
    if (n_buckets < 1 || n_buckets > kMaxBuckets || n_over < 0 ||
        n_over > kMaxOver || B <= 0 || n_rows < 0 || n_extras < 0)
        return -1;
    Buckets bk;
    bk.n = n_buckets;
    for (int b = 0; b < n_buckets; ++b) {
        bk.row0[b] = bucket_desc[3 * b];
        bk.slot0[b] = bucket_desc[3 * b + 1];
        bk.D[b] = (int)bucket_desc[3 * b + 2];
    }
    OverSet ov;
    ov.n = n_over;
    for (int k = 0; k < n_over; ++k) ov.et[k] = over[k];
    cudaStream_t s = (cudaStream_t)stream;
    const bool words = B % 4 == 0;
    const long long E = words ? B / 4 : B;
    const long long total = (n_rows + 1) * E;
    if (words)
        hop_i8_kernel<uint32_t><<<grid_for(total), kThreads, 0, s>>>(
            (const uint32_t*)f, (uint32_t*)out, (const int32_t*)nbr,
            (const int32_t*)et, bk, ov, n_rows, E);
    else
        hop_i8_kernel<uint8_t><<<grid_for(total), kThreads, 0, s>>>(
            (const uint8_t*)f, (uint8_t*)out, (const int32_t*)nbr,
            (const int32_t*)et, bk, ov, n_rows, E);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (n_extras > 0) {
        if (words)
            hub_max_kernel<uint32_t><<<grid_for(n_extras * E), kThreads, 0,
                                       s>>>(
                (uint32_t*)out, (const int32_t*)eslot,
                (const int32_t*)hrows, n, n_rows, n_extras, E);
        else
            hub_max_kernel<uint8_t><<<grid_for(n_extras * E), kThreads, 0,
                                      s>>>(
                (uint8_t*)out, (const int32_t*)eslot,
                (const int32_t*)hrows, n, n_rows, n_extras, E);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    if (acc == nullptr) return 0;
    if (words)
        max_into_kernel<uint32_t><<<grid_for(total), kThreads, 0, s>>>(
            (const uint32_t*)out, (uint32_t*)acc, total);
    else
        max_into_kernel<uint8_t><<<grid_for(total), kThreads, 0, s>>>(
            (const uint8_t*)out, (uint8_t*)acc, total);
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
