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
// M1 shard_hop_gather replaces the per-shard body of
// nebula_tpu/tpu/ell.py:1740 _make_sharded_hop_packed
// (_bucket_expand_packed over the shard's blocks, then the trim at
// real_rows and the concatenation at the blocks' frontier rows).
// M2 shard_absorb_scatter replaces nebula_tpu/tpu/ell.py:1036
// make_sharded_ell_absorb_kernel's per-shard scatter.
//
// Every entry point runs on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() after its launches
// (0 = launched) or -1 for arguments it refuses.  Nothing here needs a
// matrix unit: both kernels are bound by device-memory traffic.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kMeshMaxBuckets = 32;
constexpr int kMeshMaxOver = 32;

// One shard's bucket geometry, passed by value.  Global scope: an
// extern "C" entry point taking a struct from an anonymous namespace
// would get internal linkage under nvcc.
struct ShardBuckets {
    long long grow0[kMeshMaxBuckets];  // frontier row of chunk row 0
    long long lrow0[kMeshMaxBuckets];  // shard-local row of chunk row 0
    long long slot0[kMeshMaxBuckets];  // first slot of the chunk
    long long live[kMeshMaxBuckets];   // chunk rows below real_rows
    int D[kMeshMaxBuckets];            // slots per row
    int n;                             // buckets
};

// The OVER set as signed etypes (negative = REVERSELY), by value.
struct MeshOverSet {
    int et[kMeshMaxOver];
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
constexpr long long kMaxBlocks = 1LL << 20;   // grid-stride beyond this

inline unsigned grid_for(long long total) {
    long long blocks = (total + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    if (blocks < 1) blocks = 1;
    return (unsigned)blocks;
}

// ------------------------------------------------------------------ M1
// One thread owns one (shard-local row, 32-bit word): it walks the row's
// D slots, ORing the gathered word of the shard's frontier replica when
// the slot's etype is in the OVER set, and writes the result at the
// row's frontier row.  Chunk rows at or past the bucket's real row count
// (the shard_ell padding) are written nowhere: the reference trims them
// (o[:r], ell.py:1784).  The last W4 threads zero the output's pad row,
// which no owned row covers.  Rows of other shards are left as they are;
// the replication copies them in.  Bound on this card: bytes — per row
// D slot reads of nbr + et (8 bytes each) and D word gathers, each
// moving a 32-byte sector; the W4 threads of a row share its slot loads
// (a broadcast).  The same work as the single-card hop_gather_kernel
// (ell_lanes.cu), cut by shard: k shards together gather each row once.
__global__ void shard_hop_gather_kernel(const uint32_t* __restrict__ fp,
                                        uint32_t* __restrict__ out,
                                        const int32_t* __restrict__ nbr,
                                        const int32_t* __restrict__ et,
                                        ShardBuckets bk, MeshOverSet ov,
                                        long long local_rows,
                                        long long n_rows, int W4) {
    const long long total = (local_rows + 1) * (long long)W4;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < total; i += stride) {
        const long long lr = i / W4;
        const int w = (int)(i - lr * W4);
        if (lr == local_rows) {         // the pad row: pinned to zero
            out[n_rows * W4 + w] = 0u;
            continue;
        }
        int b = 0;
        for (int k = 1; k < bk.n; ++k)
            if (bk.lrow0[k] <= lr) b = k;
        const long long li = lr - bk.lrow0[b];
        if (li >= bk.live[b]) continue;  // padding: trimmed
        const int D = bk.D[b];
        const long long base = bk.slot0[b] + li * D;
        uint32_t acc = 0u;
        for (int j = 0; j < D; ++j) {
            const int e = et[base + j];
            bool ok = false;
            for (int k = 0; k < ov.n; ++k) ok |= (e == ov.et[k]);
            if (ok) acc |= fp[(long long)nbr[base + j] * W4 + w];
        }
        out[(bk.grow0[b] + li) * W4 + w] = acc;
    }
}

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

}  // namespace

extern "C" {

// fp, out: uint8 [n_rows + 1, W] replicas on this shard (out separate);
// nbr, et: the shard's flat int32 tables of local_rows rows.
int ell_shard_hop(const void* fp, void* out, const void* nbr,
                  const void* et, ShardBuckets bk, const int32_t* over,
                  int n_over, int64_t local_rows, int64_t n_rows,
                  int64_t W, void* stream) {
    if (bk.n < 1 || bk.n > kMeshMaxBuckets || n_over < 1 ||
        n_over > kMeshMaxOver || W <= 0 || W % 4 != 0 || local_rows < 0 ||
        n_rows < 0)
        return -1;
    MeshOverSet ov;
    ov.n = n_over;
    for (int k = 0; k < n_over; ++k) ov.et[k] = over[k];
    const int W4 = (int)(W / 4);
    shard_hop_gather_kernel<<<grid_for((local_rows + 1) * W4), kThreads,
                              0, (cudaStream_t)stream>>>(
        (const uint32_t*)fp, (uint32_t*)out, (const int32_t*)nbr,
        (const int32_t*)et, bk, ov, local_rows, n_rows, W4);
    return (int)cudaGetLastError();
}

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

}  // extern "C"
