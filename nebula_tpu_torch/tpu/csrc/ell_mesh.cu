// The replicated-frontier mesh's per-shard kernels for Hopper (sm_90a),
// behind a plain C interface that nebula_tpu_torch/tpu/ell_ops.py loads
// with ctypes.
//
// A mesh of k shards holds the ELL tables row-sharded (ell.shard_ell):
// every degree bucket b is padded to padded_b = k * chunk_b rows, and
// shard s owns the bucket-local rows [s * chunk_b, (s + 1) * chunk_b),
// of which those below the bucket's real row count are frontier rows.
// A shard's tables are its chunks flattened bucket after bucket (local
// row lrow0[b] + i of the shard is chunk row i of bucket b, its slots
// at slot0[b] + i * D_b).  The frontier is replicated: every shard holds
// the whole packed [n_rows + 1, W] frontier in its own buffer, and the
// mesh layer (mesh.py) copies each shard's owned rows into the others'
// buffers after every hop.
//
// The per-shard hop (M1, nebula_tpu/tpu/ell.py:1740
// _make_sharded_hop_packed) is the single-card hop's gather
// (ell_lanes.cu ell_go_hop) run on the shard's plan.  Here:
// M2 shard_absorb_scatter replaces nebula_tpu/tpu/ell.py:1036
// make_sharded_ell_absorb_kernel's per-shard scatter;
// M3 replicate_rows replaces the re-replication of the hop's owned rows
// (ell.py:1789, the sharded output gathered back to every shard) where
// the shards share one card: one launch a source shard.
//
// Every entry point runs on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() after its launches
// (0 = launched) or -1 for arguments it refuses.  Nothing here needs a
// matrix unit: both kernels are bound by device-memory traffic.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kMeshMaxBuckets = 32;

// One source shard's replication, passed by value: its buffer's owned
// byte ranges [lo[i], lo[i] + len[i]) in `unit`-byte units, each range's
// first block blk0[i] (the last range's end is the grid), and the
// receivers' buffers (same shape, same card).  Global scope, as below.
constexpr int kCopyMaxDst = 15;
constexpr int kCopyMaxRanges = 32;
struct RowCopy {
    void* dst[kCopyMaxDst];
    long long lo[kCopyMaxRanges];
    long long len[kCopyMaxRanges];
    int blk0[kCopyMaxRanges];
    int n_dst;
    int n;
};

// One shard's replacement rows, passed by value: per bucket b the
// reference's padded arguments (rows int32[kp] bucket-local row
// indices, un / ue int32[kp, D_b] full row contents), the shard's first
// bucket-local row lo[b] = s * chunk_b and its chunk.
struct ShardAbsorb {
    const int32_t* rows[kMeshMaxBuckets];
    const int32_t* un[kMeshMaxBuckets];
    const int32_t* ue[kMeshMaxBuckets];
    long long slot0[kMeshMaxBuckets];
    long long lo[kMeshMaxBuckets];
    long long chunk[kMeshMaxBuckets];
    int D[kMeshMaxBuckets];
    int n;
    int kp;
};

// csrc/ell_absorb.cu: the copy-on-write table copy (absorb_copy_kernel).
extern "C" int ell_table_copy(const void* nbr, const void* et,
                              void* out_nbr, void* out_et, int64_t n_slots,
                              void* stream);

namespace {

constexpr int kThreads = 256;

// ------------------------------------------------------------------ M2
// One warp per replacement row g = b * kp + i: loc = rows[b][i] - lo[b]
// is the row's index in this shard's chunk; the row is kept only when
// 0 <= loc < chunk[b].  A row of another shard gives a negative loc or
// one past the chunk, and is dropped — a negative loc is never wrapped
// into a neighbour's row (ell.py:1065-1070).  The kept row's D_b slots
// of nbr and et are written by the warp's lanes (coalesced runs).  Rows
// of one absorption are distinct, so writes never conflict.  Bound:
// bytes, the replacement rows only; the copy before it moves the
// shard's tables.
__global__ void shard_absorb_scatter_kernel(int32_t* __restrict__ nbr,
                                            int32_t* __restrict__ et,
                                            ShardAbsorb bk) {
    const long long warp = ((long long)blockIdx.x * blockDim.x
                            + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (warp >= (long long)bk.n * bk.kp) return;
    const int b = (int)(warp / bk.kp);
    const int i = (int)(warp - (long long)b * bk.kp);
    const long long loc = (long long)bk.rows[b][i] - bk.lo[b];
    if (loc < 0 || loc >= bk.chunk[b]) return;    // not this shard's
    const int D = bk.D[b];
    const long long dst = bk.slot0[b] + loc * D;
    const long long src = (long long)i * D;
    for (int j = lane; j < D; j += 32) {
        nbr[dst + j] = bk.un[b][src + j];
        et[dst + j] = bk.ue[b][src + j];
    }
}

// ------------------------------------------------------------------ M3
// A block copies kCopyUnits * kThreads consecutive units of ONE range
// (the entry's plan), so it finds its range once: each thread loads its
// kCopyUnits units together, then stores them into every receiver.  The
// source is read once whatever the receiver count.  Bound: bytes —
// (1 + n_dst) times the owned bytes.
constexpr int kCopyUnits = 4;

template <typename V>
__global__ void replicate_rows_kernel(const V* __restrict__ src,
                                      RowCopy rc) {
    const int blk = (int)blockIdx.x;
    int b = 0;                          // uniform over the block
    for (int k = 1; k < rc.n; ++k)
        if (rc.blk0[k] <= blk) b = k;
    const long long end = rc.lo[b] + rc.len[b];
    const long long u0 = rc.lo[b] + (long long)(blk - rc.blk0[b])
                         * kCopyUnits * kThreads + threadIdx.x;
    V v[kCopyUnits];
#pragma unroll
    for (int j = 0; j < kCopyUnits; ++j) {
        const long long u = u0 + (long long)j * kThreads;
        if (u < end) v[j] = __ldcs(src + u);
    }
    for (int d = 0; d < rc.n_dst; ++d) {
        V* dst = reinterpret_cast<V*>(rc.dst[d]);
#pragma unroll
        for (int j = 0; j < kCopyUnits; ++j) {
            const long long u = u0 + (long long)j * kThreads;
            if (u < end) dst[u] = v[j];
        }
    }
}

}  // namespace

extern "C" {

// nbr, et: the shard's int32[n_slots] resident tables (read only);
// out_nbr, out_et: fresh int32[n_slots] outputs (all 16-byte aligned).
int ell_shard_absorb(const void* nbr, const void* et, void* out_nbr,
                     void* out_et, int64_t n_slots, ShardAbsorb bk,
                     void* stream) {
    if (n_slots < 0 || bk.n < 1 || bk.n > kMeshMaxBuckets || bk.kp < 1)
        return -1;
    int rc = ell_table_copy(nbr, et, out_nbr, out_et, n_slots, stream);
    if (rc != 0) return rc;
    // not grid-stride: one warp per replacement row, every row launched
    const long long threads = (long long)bk.n * bk.kp * 32;
    shard_absorb_scatter_kernel<<<(unsigned)((threads + kThreads - 1) /
                                             kThreads),
                                  kThreads, 0, (cudaStream_t)stream>>>(
        (int32_t*)out_nbr, (int32_t*)out_et, bk);
    return (int)cudaGetLastError();
}

// src: one shard's buffer; dsts: host array of n_dst receiver buffers
// of the same bytes on the same card; ranges: host int64 [n_ranges * 2]
// byte ranges (lo, hi) of src, copied to the same bytes of every
// receiver.  16-byte units when every pointer and bound is 16-byte
// aligned, else 4-byte ones (the mesh's packed rows are W % 4 == 0
// bytes); -1 for anything less aligned.  Returns without a launch when
// there is nothing to copy.
int mesh_replicate_rows(const void* src, void* const* dsts, int n_dst,
                        const int64_t* ranges, int n_ranges, void* stream) {
    if (n_dst < 1 || n_dst > kCopyMaxDst || n_ranges < 0 ||
        n_ranges > kCopyMaxRanges)
        return -1;
    uintptr_t at = (uintptr_t)src;
    for (int d = 0; d < n_dst; ++d) at |= (uintptr_t)dsts[d];
    for (int i = 0; i < n_ranges; ++i) {
        if (ranges[2 * i] < 0 || ranges[2 * i + 1] < ranges[2 * i])
            return -1;
        at |= (uintptr_t)ranges[2 * i] | (uintptr_t)ranges[2 * i + 1];
    }
    if ((at & 3) != 0) return -1;
    const int unit = (at & 15) == 0 ? 16 : 4;
    RowCopy rc;
    rc.n_dst = n_dst;
    for (int d = 0; d < n_dst; ++d) rc.dst[d] = dsts[d];
    const long long per = (long long)kCopyUnits * kThreads;
    long long blocks = 0;
    rc.n = 0;
    for (int i = 0; i < n_ranges; ++i) {
        const long long len = (ranges[2 * i + 1] - ranges[2 * i]) / unit;
        if (len == 0) continue;
        rc.lo[rc.n] = ranges[2 * i] / unit;
        rc.len[rc.n] = len;
        rc.blk0[rc.n] = (int)blocks;
        blocks += (len + per - 1) / per;
        ++rc.n;
    }
    if (blocks == 0) return 0;
    if (blocks > 0x7FFFFFFFLL) return -1;
    cudaStream_t s = (cudaStream_t)stream;
    if (unit == 16)
        replicate_rows_kernel<uint4><<<(unsigned)blocks, kThreads, 0, s>>>(
            (const uint4*)src, rc);
    else
        replicate_rows_kernel<uint32_t><<<(unsigned)blocks, kThreads, 0,
                                          s>>>((const uint32_t*)src, rc);
    return (int)cudaGetLastError();
}

}  // extern "C"
