// Continuous-GO lane kernels for Hopper (sm_90a), behind a plain C
// interface that nebula_tpu_torch/tpu/ell_ops.py loads with ctypes.
//
// Layout shared by every kernel: the resident frontier pair fp / accp is
// uint8 [n_rows + 1, W] row-major, 8 query lanes per byte (bit k of byte
// j is lane 8j + k), W % 4 == 0, so each row is a whole number of 32-bit
// words and the kernels work on uint32 words.  Row n_rows is the pad row:
// every sentinel slot points at it and it stays zero.  Byte and word
// offsets are 64-bit (rows * W passes 2^31 at 2^24 rows and W = 128).
//
// Every kernel runs on the caller's stream, allocates nothing and does
// not synchronise; each entry point returns cudaGetLastError() after its
// launches (0 = launched).  Nothing here needs a matrix unit: all four
// kernels are bound by device-memory traffic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1LL << 20;   // grid-stride beyond this
constexpr int kMaxBuckets = 32;
constexpr int kMaxOver = 32;

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

// ---------------------------------------------------------------- hop
// Replaces nebula_tpu/tpu/ell.py:665 make_continuous_hop_kernel (body
// _hop_body_packed :556, _bucket_expand_packed :541, _etype_ok :361).
// One thread owns one (row, 32-bit word): it walks the row's D slots,
// ORing the gathered source word when the slot's etype is in the OVER
// set.  Bound on this card: bytes — per row D slot reads of nbr + et
// (8 bytes each) and D word gathers, each of which moves a 32-byte
// sector; threads of one row share the slot loads (a broadcast), and at
// W = 128 a warp reads one row's whole 128-byte word run per slot.  The
// output is a separate buffer: every gather must read the previous
// generation, so the caller ping-pongs two buffers.  The pad row of the
// output is written zero here.
__global__ void hop_gather_kernel(const uint32_t* __restrict__ fp,
                                  uint32_t* __restrict__ out,
                                  const int32_t* __restrict__ nbr,
                                  const int32_t* __restrict__ et,
                                  Buckets bk, OverSet ov,
                                  long long n_rows, int W4) {
    const long long total = (n_rows + 1) * (long long)W4;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < total; i += stride) {
        const long long r = i / W4;
        const int w = (int)(i - r * W4);
        if (r == n_rows) {              // pad row: pinned to zero
            out[i] = 0u;
            continue;
        }
        int b = 0;
        for (int k = 1; k < bk.n; ++k)
            if (bk.row0[k] <= r) b = k;
        const int D = bk.D[b];
        const long long base = bk.slot0[b] + (r - bk.row0[b]) * D;
        uint32_t acc = 0u;
        for (int j = 0; j < D; ++j) {
            const int e = et[base + j];
            bool ok = false;
            for (int k = 0; k < ov.n; ++k) ok |= (e == ov.et[k]);
            if (ok) acc |= fp[(long long)nbr[base + j] * W4 + w];
        }
        out[i] = acc;
    }
}

// Hub fix-up: OR each extra row n + e into its owner hrows[eslot[e]].
// Replaces the bit-plane max of _scatter_or_rows (ell.py:519), which
// exists only because XLA has no OR-scatter; a 32-bit atomicOr is exact
// for duplicate owners.  Owners >= n_rows are unclaimed growth spares
// and merge nowhere.  Extra rows keep their partial values (they are
// never gather sources and are re-derived next hop), as in the
// reference.  Bound: bytes, O(n_extras * W).
__global__ void hop_merge_kernel(uint32_t* __restrict__ out,
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
        if (v) atomicOr(out + owner * W4 + w, v);
    }
}

// accp |= out over the whole pair (the UPTO union; the pad rows of both
// are zero).  Bound: bytes, 3 * (n_rows + 1) * W.
__global__ void or_into_kernel(const uint32_t* __restrict__ src,
                               uint32_t* __restrict__ dst,
                               long long total) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < total; i += stride)
        dst[i] |= src[i];
}

// --------------------------------------------------------------- join
// Replaces ell.py:691 make_lane_join_kernel (a scatter-ADD of single
// lane bits).  Under the clear contract (the host dedups each
// (row, lane) and a freed lane's bits are zero) add IS or, so a 32-bit
// atomicOr of val << 8 * (byte & 3) into the containing word is exact
// and needs no ordering between entries.  Entries aimed at the pad row
// (the padding) or out of range are skipped, and the pad row is zeroed
// by the first W4 threads — no entry writes it, so there is no race.
// Bound: bytes, a read-modify-write per entry in each carrier.
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
        accp[n_rows * W4 + i] = 0u;
    }
    if (i >= S) return;
    const long long r = rows[i];
    const int w = words[i];
    const uint32_t v = vals[i];
    if (r < 0 || r >= n_rows || w < 0 || w >= W || v == 0u) return;
    const long long byte = r * W + w;
    const uint32_t bits = v << (8u * (uint32_t)(byte & 3));
    atomicOr(fp + (byte >> 2), bits);
    atomicOr(accp + (byte >> 2), bits);
}

// ------------------------------------------------------------ extract
// Replaces ell.py:726 make_lane_extract_kernel: out[:, j] = sel[j] ?
// accp[:, words[j]] : fp[:, words[j]] as uint8 [n_rows + 1, P].  One
// thread per output byte, consecutive threads on consecutive output
// bytes.  Bound: bytes — each output byte pulls one 32-byte sector of
// its row, so the gather side dominates; a later PR can stage rows
// through shared memory.
__global__ void lane_extract_kernel(const uint8_t* __restrict__ fp,
                                    const uint8_t* __restrict__ accp,
                                    const int32_t* __restrict__ words,
                                    const uint8_t* __restrict__ sel,
                                    uint8_t* __restrict__ out,
                                    long long R1, int P, int W) {
    const long long total = R1 * (long long)P;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < total; i += stride) {
        const long long r = i / P;
        const int j = (int)(i - r * P);
        const int w = words[j];
        uint8_t v = 0;
        if (w >= 0 && w < W)
            v = (sel[j] ? accp : fp)[r * W + w];
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

}  // namespace

extern "C" {

// bucket_desc: host int64 [n_buckets * 3] = (row0, slot0, D) per bucket.
// over: host int32 [n_over].  Returns 0, a cudaError_t, or -1 for an
// argument the kernels cannot take.
int ell_go_hop(const void* fp, void* accp, void* out, const void* nbr,
               const void* et, const int64_t* bucket_desc, int n_buckets,
               const void* eslot, const void* hrows, int64_t n_extras,
               const int32_t* over, int n_over, int64_t n, int64_t n_rows,
               int64_t W, void* stream) {
    if (n_buckets < 1 || n_buckets > kMaxBuckets || n_over < 0 ||
        n_over > kMaxOver || W <= 0 || W % 4 != 0)
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
    const int W4 = (int)(W / 4);
    const long long words = (n_rows + 1) * (long long)W4;
    hop_gather_kernel<<<grid_for(words), kThreads, 0, s>>>(
        (const uint32_t*)fp, (uint32_t*)out, (const int32_t*)nbr,
        (const int32_t*)et, bk, ov, n_rows, W4);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (n_extras > 0) {
        hop_merge_kernel<<<grid_for(n_extras * W4), kThreads, 0, s>>>(
            (uint32_t*)out, (const int32_t*)eslot, (const int32_t*)hrows,
            n, n_rows, n_extras, W4);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    or_into_kernel<<<grid_for(words), kThreads, 0, s>>>(
        (const uint32_t*)out, (uint32_t*)accp, words);
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

int ell_lane_extract(const void* fp, const void* accp, const void* words,
                     const void* sel, void* out, int64_t P, int64_t R1,
                     int64_t W, void* stream) {
    if (P <= 0 || R1 <= 0 || W <= 0) return -1;
    lane_extract_kernel<<<grid_for(R1 * P), kThreads, 0,
                          (cudaStream_t)stream>>>(
        (const uint8_t*)fp, (const uint8_t*)accp, (const int32_t*)words,
        (const uint8_t*)sel, (uint8_t*)out, R1, (int)P, (int)W);
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
