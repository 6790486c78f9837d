// The replicated-frontier mesh's kernels for Hopper (sm_90a),
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
// A hop of the mesh is one call of ell_mesh_hop for the shards that
// share a card (a card group): M1, the gather (ell_lanes.cu
// mesh_gather_kernel: the single-card hop's rows on each shard's chunk,
// nebula_tpu/tpu/ell.py:1740 _make_sharded_hop_packed), then M3, the
// re-replication of the hop's owned rows (ell.py:1789, the sharded
// output gathered back to every shard), then the hub merge on every
// replica (ell_lanes.cu mesh_merge_kernel) — one launch each over every
// shard of the card, whose replicas are one [members, n_rows + 1, W]
// slab.  The batched BFS adds its level pass as a fourth stage of the
// same call (ell_lanes.cu bfs_level_kernel over the slab: the hop's
// frontier read once from the first replica, one reached bitmap, one
// depth matrix and one flags pair a card group, the new frontier
// written into every replica;
// nebula_tpu/tpu/ell.py:1799-1840's update, once a card instead of once
// a shard), so a BFS level is one call a card and its first pass the
// stage alone.  Here also M2 shard_absorb_scatter, which replaces
// nebula_tpu/tpu/ell.py:1036 make_sharded_ell_absorb_kernel's per-shard
// scatter.
//
// Every entry point runs on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() after its launches
// (0 = launched) or -1 for arguments it refuses.  Nothing here needs a
// matrix unit: every kernel is bound by device-memory traffic.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hop_plan.cuh"

constexpr int kMeshMaxBuckets = 32;

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
// csrc/ell_lanes.cu: the mesh hop's gather and merge over a card.
extern "C" int ell_mesh_gather(const void* fp, void* out, int64_t stride,
                               hop::MeshHop mh, const int64_t* plan,
                               int n_buckets, int64_t blocks, int lgc,
                               int wide, const int32_t* over, int n_over,
                               int64_t n_rows, int64_t W, void* stream);
extern "C" int ell_mesh_merge(void* out, int64_t stride, int members,
                              const void* eslot, const void* hrows,
                              int64_t n, int64_t n_rows, int64_t W,
                              void* stream);
// csrc/ell_lanes.cu: the BFS level pass over a card's replica slab.
extern "C" int ell_mesh_level(void* slab, int64_t stride, int members,
                              const void* tp, void* seen, void* d,
                              int dbytes, void* flags, int step, int first,
                              int stop, int64_t R1, int64_t W,
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
// Every member y of a card (blockIdx.y) sends its owned rows — per
// bucket its chunk's frontier rows, as M1 wrote them — from its replica
// to every other member's, in `unit`-byte units.  A block copies
// kCopyUnits * kThreads consecutive units of ONE bucket's range (the
// plan: each bucket's first block, sized for the member with the most
// rows), so it finds its range once: each thread loads its kCopyUnits
// units together, then stores them into every receiver.  The source is
// read once whatever the receiver count; a receiver gets exactly the
// bytes a mesh of cards would send it.  Bound: bytes — members times
// the owned bytes.
constexpr int kCopyUnits = 4;

struct CopyPlan {
    long long row0[kMeshMaxBuckets];   // shard 0's chunk's first row
    int blk0[kMeshMaxBuckets];
    int n;
};

template <typename V>
__global__ void mesh_copy_kernel(V* __restrict__ slab, long long stride,
                                 long long row_units, hop::MeshHop mh,
                                 CopyPlan cp) {
    const int y = (int)blockIdx.y;
    const int blk = (int)blockIdx.x;
    int b = 0;                          // uniform over the block
    for (int k = 1; k < cp.n; ++k)
        if (cp.blk0[k] <= blk) b = k;
    const long long lo = (cp.row0[b] + mh.shard[y] * mh.chunk[b])
                         * row_units;
    const long long end = lo + hop::mesh_rows(mh, y, b, mh.chunk[b])
                               * row_units;
    const long long u0 = lo + (long long)(blk - cp.blk0[b])
                         * kCopyUnits * kThreads + threadIdx.x;
    const V* src = slab + y * stride;
    V v[kCopyUnits];
#pragma unroll
    for (int j = 0; j < kCopyUnits; ++j) {
        const long long u = u0 + (long long)j * kThreads;
        if (u < end) v[j] = __ldcs(src + u);
    }
    for (int d = 0; d < mh.n; ++d) {
        if (d == y) continue;
        V* dst = slab + d * stride;
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

// One hop of the replicated-frontier mesh for the members of a card:
// stages & 1 M1 (fp -> out), & 2 M3 (out's owned rows to every other
// member's out), & 4 the hub merge on every member's out, & 8 the BFS
// level pass on out (its first replica read, the card group's reached
// bitmap seen uint8 [n_rows + 1, W], depth matrix d [n_rows + 1, 8 * W]
// of dbytes-byte entries and flags int32 [2] updated against its targets
// tp uint8 [n_rows + 1, W], the new frontier written into every replica;
// `first`: seen and d built from out, which stays as it is; `stop`: the
// targets' flag raised).  fp, out: the
// card's [members, n_rows + 1, W] slabs, a replica every `stride`
// bytes; mh: the members' tables and chunk geometry; plan, n_buckets,
// blocks, lgc, wide: shard 0's hop plan as ell_go_hop takes it; over:
// host int32 [n_over]; eslot / hrows: the hub merge's arrays on this
// card.  One launch a stage; M3 launches nothing for a lone member or
// when no member owns a row, the merge nothing without hub extra rows.
// launched: host int32 [4], the launches made of M1, M3, the merge and
// the level pass (each 0 or 1), written however the call ends.
int ell_mesh_hop(int stages, const void* fp, void* out, int64_t stride,
                 hop::MeshHop mh, const int64_t* plan, int n_buckets,
                 int64_t blocks, int lgc, int wide, const int32_t* over,
                 int n_over, const void* eslot, const void* hrows,
                 int64_t n, int64_t n_rows, int64_t W, const void* tp,
                 void* seen, void* d, int dbytes, void* flags, int step,
                 int first, int stop, void* stream, int32_t* launched) {
    launched[0] = launched[1] = launched[2] = launched[3] = 0;
    if (stages < 1 || stages > 15 || mh.n < 1 || mh.n > hop::kCardShards ||
        n_buckets < 1 || n_buckets > kMeshMaxBuckets || W <= 0 ||
        W % 4 != 0 || stride % 4 != 0 || stride < (n_rows + 1) * W)
        return -1;
    if (stages & 1) {
        const int rc = ell_mesh_gather(fp, out, stride, mh, plan, n_buckets,
                                       blocks, lgc, wide, over, n_over,
                                       n_rows, W, stream);
        if (rc != 0) return rc;
        launched[0] = 1;
    }
    if ((stages & 2) && mh.n > 1) {
        const uintptr_t at = (uintptr_t)out | (uintptr_t)stride;
        const int unit = (W % 16 == 0 && (at & 15) == 0) ? 16 : 4;
        if (at & 3) return -1;
        const long long row_units = W / unit;
        const long long per = (long long)kCopyUnits * kThreads;
        CopyPlan cp;
        cp.n = n_buckets;
        long long blocks_m3 = 0;
        for (int b = 0; b < n_buckets; ++b) {
            cp.row0[b] = plan[6 * b];
            cp.blk0[b] = (int)blocks_m3;
            long long most = 0;
            for (int y = 0; y < mh.n; ++y) {
                const long long r = hop::mesh_rows(mh, y, b, mh.chunk[b]);
                most = r > most ? r : most;
            }
            blocks_m3 += (most * row_units + per - 1) / per;
        }
        if (blocks_m3 > 0x7FFFFFFFLL) return -1;
        if (blocks_m3 > 0) {
            const dim3 grid((unsigned)blocks_m3, (unsigned)mh.n);
            cudaStream_t s = (cudaStream_t)stream;
            if (unit == 16)
                mesh_copy_kernel<uint4><<<grid, kThreads, 0, s>>>(
                    (uint4*)out, stride / 16, row_units, mh, cp);
            else
                mesh_copy_kernel<uint32_t><<<grid, kThreads, 0, s>>>(
                    (uint32_t*)out, stride / 4, row_units, mh, cp);
            const cudaError_t err = cudaGetLastError();
            if (err != cudaSuccess) return (int)err;
            launched[1] = 1;
        }
    }
    if (stages & 4) {
        const int rc = ell_mesh_merge(out, stride, mh.n, eslot, hrows, n,
                                      n_rows, W, stream);
        if (rc != 0) return rc;
        launched[2] = n_rows > n;      // ell_mesh_merge's launch
    }
    if (stages & 8) {
        if (tp == nullptr || seen == nullptr || d == nullptr ||
            flags == nullptr)
            return -1;
        const int rc = ell_mesh_level(out, stride, mh.n, tp, seen, d, dbytes,
                                      flags, step, first, stop, n_rows + 1,
                                      W, stream);
        if (rc != 0) return rc;
        launched[3] = 1;
    }
    return 0;
}

}  // extern "C"
