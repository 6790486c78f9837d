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
// stage alone.  Here also the mesh's absorb, M2 (ell_mesh_absorb), which
// replaces nebula_tpu/tpu/ell.py:1036 make_sharded_ell_absorb_kernel:
// one call a card group, a copy of every member's tables and one walk
// over the update set.
//
// Every entry point runs on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() after its launches
// (0 = launched) or -1 for arguments it refuses.  Nothing here needs a
// matrix unit: every kernel is bound by device-memory traffic.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hop_plan.cuh"

constexpr int kMeshMaxBuckets = 32;

// A card group's absorb, passed by value: per member y its shard index
// and its resident tables nbr / et (int32 [n_slots], read only) with
// their fresh copies out_nbr / out_et; per bucket b the update set as
// the reference's padded arguments (ell.py:970 absorb_update_arrays:
// rows int32[kp] bucket-local rows, un / ue int32[kp, D_b] full row
// contents; a pad entry carries the row real[b]), read in place, of
// which the first live[b] entries are walked (the plan's real rows come
// first), the chunk chunk[b] every shard holds, and the slots' offset
// slot0[b] (the same in every shard).  first[] is the entry's own: each
// bucket's first warp of the scatter.  Global scope: an extern "C"
// entry taking a struct from an anonymous namespace would get internal
// linkage under nvcc.
struct MeshAbsorb {
    const int32_t* nbr[hop::kCardShards];
    const int32_t* et[hop::kCardShards];
    int32_t* out_nbr[hop::kCardShards];
    int32_t* out_et[hop::kCardShards];
    long long shard[hop::kCardShards];
    const int32_t* rows[kMeshMaxBuckets];
    const int32_t* un[kMeshMaxBuckets];
    const int32_t* ue[kMeshMaxBuckets];
    long long slot0[kMeshMaxBuckets];
    long long chunk[kMeshMaxBuckets];
    long long real[kMeshMaxBuckets];
    long long live[kMeshMaxBuckets];
    long long first[kMeshMaxBuckets];
    int D[kMeshMaxBuckets];
    int n_buckets;
    int members;
};

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
// The copy: member y = blockIdx.y's out_nbr / out_et = nbr / et, n4
// int4 words of each table, then the n % 4 tail elements (csrc/
// ell_absorb.cu absorb_copy_kernel's loop, a grid row a member).
constexpr long long kMaxCopyBlocks = 4096;   // a member's; grid-stride

__global__ void mesh_absorb_copy_kernel(MeshAbsorb ma, long long n4,
                                        long long n) {
    const int y = (int)blockIdx.y;
    const int4* __restrict__ a = reinterpret_cast<const int4*>(ma.nbr[y]);
    const int4* __restrict__ b = reinterpret_cast<const int4*>(ma.et[y]);
    int4* __restrict__ out_a = reinterpret_cast<int4*>(ma.out_nbr[y]);
    int4* __restrict__ out_b = reinterpret_cast<int4*>(ma.out_et[y]);
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    for (long long i = tid; i < 2 * n4; i += stride) {
        if (i < n4) out_a[i] = __ldg(a + i);
        else out_b[i - n4] = __ldg(b + (i - n4));
    }
    const long long tail = n - 4 * n4;
    if (tid < 2 * tail) {
        const long long j = 4 * n4 + (tid % tail);
        if (tid < tail) ma.out_nbr[y][j] = ma.nbr[y][j];
        else ma.out_et[y][j] = ma.et[y][j];
    }
}

// The scatter: one warp per walked update row, every bucket's live
// entries laid end to end (warp w is entry i = w - first[b] of the
// bucket b holding it), the update set walked once for the whole card
// group.  A pad entry (row >= real[b]) is dropped before any member is
// looked at; otherwise the row's owner is s = row / chunk[b] at
// loc = row - s * chunk[b] < chunk[b], so a row never wraps into a
// neighbour's chunk (ell.py:1065-1070), and its D_b slots of nbr and et
// go into that member's outputs when the owner is on this card; a row
// owned on another card is dropped.  Rows of one absorption are
// distinct, so writes never conflict.  Bound: bytes, the walked rows;
// the copy before it moves the tables.  A warp's time is its chain of
// round trips, and the widest rows (D_b up to the cap) set the
// kernel's: each lane loads all its units of the row (16 bytes each
// where the row and the update sit on 16-byte boundaries, else 4)
// before it stores any, so a row of up to 32 * kRowUnits units costs
// one round trip, not one a 32 units.
constexpr int kRowUnits = 4;

template <typename V>
__device__ __forceinline__ void copy_row(V* __restrict__ dn,
                                         V* __restrict__ de,
                                         const V* __restrict__ sn,
                                         const V* __restrict__ se,
                                         int units, int lane) {
    for (int u0 = 0; u0 < units; u0 += 32 * kRowUnits) {
        V a[kRowUnits], e[kRowUnits];
#pragma unroll
        for (int k = 0; k < kRowUnits; ++k) {
            const int u = u0 + k * 32 + lane;
            if (u < units) {
                a[k] = __ldg(sn + u);
                e[k] = __ldg(se + u);
            }
        }
#pragma unroll
        for (int k = 0; k < kRowUnits; ++k) {
            const int u = u0 + k * 32 + lane;
            if (u < units) {
                dn[u] = a[k];
                de[u] = e[k];
            }
        }
    }
}

__global__ void mesh_absorb_scatter_kernel(MeshAbsorb ma, long long warps) {
    const long long warp = ((long long)blockIdx.x * blockDim.x
                            + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (warp >= warps) return;
    int b = 0;                                   // uniform over the warp
    for (int j = 1; j < ma.n_buckets; ++j)
        if (ma.first[j] <= warp) b = j;
    const long long i = warp - ma.first[b];
    const long long row = ma.rows[b][i];
    if (row < 0 || row >= ma.real[b]) return;    // a pad entry
    const long long s = row / ma.chunk[b];
    int y = -1;
    for (int j = 0; j < ma.members; ++j)
        if (ma.shard[j] == s) y = j;
    if (y < 0) return;                           // owned on another card
    const int D = ma.D[b];
    const long long dst = ma.slot0[b] + (row - s * ma.chunk[b]) * D;
    int32_t* dn = ma.out_nbr[y] + dst;
    int32_t* de = ma.out_et[y] + dst;
    const int32_t* sn = ma.un[b] + i * D;
    const int32_t* se = ma.ue[b] + i * D;
    const uintptr_t at = (uintptr_t)dn | (uintptr_t)de | (uintptr_t)sn |
                         (uintptr_t)se;
    if ((D & 3) == 0 && (at & 15) == 0)
        copy_row(reinterpret_cast<int4*>(dn), reinterpret_cast<int4*>(de),
                 reinterpret_cast<const int4*>(sn),
                 reinterpret_cast<const int4*>(se), D >> 2, lane);
    else
        copy_row(dn, de, sn, se, D, lane);
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

// M2, the absorb of a card group's members (ma: their tables and the
// update set, by value; n_slots: every member's table length, all
// pointers 16-byte aligned): the copy, one launch over every member,
// then the scatter, one launch over the walked update rows (none when
// no row is walked).
int ell_mesh_absorb(MeshAbsorb ma, int64_t n_slots, void* stream) {
    if (n_slots < 0 || ma.members < 1 || ma.members > hop::kCardShards ||
        ma.n_buckets < 1 || ma.n_buckets > kMeshMaxBuckets)
        return -1;
    for (int y = 0; y < ma.members; ++y) {
        const uintptr_t at = (uintptr_t)ma.nbr[y] | (uintptr_t)ma.et[y] |
                             (uintptr_t)ma.out_nbr[y] |
                             (uintptr_t)ma.out_et[y];
        if (at & 15) return -1;
    }
    long long warps = 0;
    for (int b = 0; b < ma.n_buckets; ++b) {
        if (ma.live[b] < 0 || ma.chunk[b] < 1 || ma.real[b] < 0 ||
            ma.D[b] < 0)
            return -1;
        ma.first[b] = warps;
        warps += ma.live[b];
    }
    cudaStream_t s = (cudaStream_t)stream;
    if (n_slots > 0) {
        const long long n4 = n_slots / 4;
        long long blocks = (2 * n4 + 8 + kThreads - 1) / kThreads;
        if (blocks > kMaxCopyBlocks) blocks = kMaxCopyBlocks;
        mesh_absorb_copy_kernel<<<dim3((unsigned)blocks,
                                       (unsigned)ma.members),
                                  kThreads, 0, s>>>(ma, n4, n_slots);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    if (warps > 0) {
        const long long blocks = (warps * 32 + kThreads - 1) / kThreads;
        if (blocks > 0x7FFFFFFFLL) return -1;
        mesh_absorb_scatter_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
            ma, warps);
    }
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
