// The hop's launch plan and OVER set for Hopper (sm_90a), shared by the
// packed hop's gather (ell_lanes.cu hop_gather_kernel: go_hop; and
// mesh_gather_kernel: the mesh's M1 over every shard of a card on shard
// 0's plan), the mesh's row replication (ell_mesh.cu: M3) and the int8
// hop's gather (ell_int8.cu hop_i8_kernel: K13), with the element
// helpers the gathers use.  Included by those sources; the extern "C"
// entries that take MeshHop by value need it at namespace scope.
//
// Every gather runs ell_ops.hop_plan's plan: a block takes kThreads / G
// consecutive rows of ONE bucket, so it finds its bucket once and every
// lane of a warp runs the same trip counts (the warp reaches each
// shuffle whole); a row belongs to G = Cg * P lanes, Cg of them
// splitting its C columns (16, 4 or 1 bytes each) and P its slots.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hop {

constexpr int kThreads = 256;
constexpr int kMaxBuckets = 32;
constexpr int kMaxOver = 32;
constexpr int kChunk = 8;                      // slots a lane holds

// The launch plan (ell_ops.hop_plan), by value: bucket b's rows are
// frontier rows row0[b] .. row0[b] + rows[b], its slots start at
// slot0[b], D[b] a row; 2^lg[b] lanes own one row, and its blocks are
// blk0[b] .. blk0[b + 1] (the last bucket's end is the grid).
struct Plan {
    long long row0[kMaxBuckets];
    long long slot0[kMaxBuckets];
    long long rows[kMaxBuckets];
    int blk0[kMaxBuckets];
    int D[kMaxBuckets];
    int lg[kMaxBuckets];
    int n;
};

// A card group of the replicated-frontier mesh (ell_ops.mesh_hop), by
// value: each member's shard-local tables and its index s in the mesh,
// and per bucket b the shards' chunk: shard s's chunk rows start at
// frontier row plan.row0[b] + s * chunk[b] (plan.row0 is shard 0's),
// and those below real[b] - s * chunk[b] are frontier rows (the rest
// pad the bucket to k chunks).  Every member's slots sit at the same
// shard-local offsets (plan.slot0), since every chunk of a bucket has
// the same rows.
constexpr int kCardShards = 16;
struct MeshHop {
    const int32_t* nbr[kCardShards];
    const int32_t* et[kCardShards];
    long long shard[kCardShards];
    long long chunk[kMaxBuckets];
    long long real[kMaxBuckets];
    int n;
};

// member y's frontier rows of bucket b, at most cap
__host__ __device__ __forceinline__ long long mesh_rows(const MeshHop& mh,
                                                        int y, int b,
                                                        long long cap) {
    const long long r = mh.real[b] - mh.shard[y] * mh.chunk[b];
    return r < 0 ? 0 : (r > cap ? cap : r);
}

// The OVER set as signed etypes (negative = REVERSELY), by value, with
// a bitmask of etype + 32 when every member lies in [-32, 31].
struct OverSet {
    int et[kMaxOver];
    int n;
    int use_mask;
    unsigned long long mask;
};

// Reads the host plan (int64 [n_buckets * 6] = (row0, slot0, rows, D,
// lg, blk0) per bucket) into *pl; false when it is not safe to run:
// every block must then read and write inside its own bucket's rows.
// *quads is cleared when a bucket's slots do not start 16-byte aligned.
inline bool read_plan(const int64_t* plan, int n_buckets, int64_t blocks,
                      int lgc, Plan* pl, bool* quads) {
    if (n_buckets < 1 || n_buckets > kMaxBuckets || blocks < 1 ||
        blocks > 0x7FFFFFFFLL || lgc < 0 || lgc > 5)
        return false;
    pl->n = n_buckets;
    for (int b = 0; b < n_buckets; ++b) {
        const int64_t* d = plan + 6 * b;
        if (d[2] < 0 || d[3] < 1 || d[4] < lgc || d[4] > 5 ||
            d[5] < (b ? pl->blk0[b - 1] : 0) || (!b && d[5] != 0) ||
            d[5] > blocks)
            return false;
        pl->row0[b] = d[0];
        pl->slot0[b] = d[1];
        pl->rows[b] = d[2];
        pl->D[b] = (int)d[3];
        pl->lg[b] = (int)d[4];
        pl->blk0[b] = (int)d[5];
        *quads = *quads && d[1] % 4 == 0 && d[3] % 4 == 0;
    }
    return true;
}

// false when n_over is out of range
inline bool read_over(const int32_t* over, int n_over, OverSet* ov) {
    if (n_over < 1 || n_over > kMaxOver) return false;
    ov->n = n_over;
    ov->use_mask = 1;
    ov->mask = 0ull;
    for (int k = 0; k < n_over; ++k) {
        ov->et[k] = over[k];
        if (over[k] < -32 || over[k] > 31) ov->use_mask = 0;
        else ov->mask |= 1ull << (over[k] + 32);
    }
    return true;
}

__device__ __forceinline__ bool in_over(int e, const OverSet& ov) {
    if (ov.use_mask) {
        const unsigned k = (unsigned)(e + 32);
        return k < 64u && ((ov.mask >> k) & 1ull);
    }
    bool ok = false;
    for (int k = 0; k < ov.n; ++k) ok |= (e == ov.et[k]);
    return ok;
}

// ----------------------------------------------------- element values
__device__ __forceinline__ void zero_v(uint4& v) {
    v = make_uint4(0u, 0u, 0u, 0u);
}
__device__ __forceinline__ void zero_v(uint32_t& v) { v = 0u; }
__device__ __forceinline__ void zero_v(uint8_t& v) { v = 0; }

// the value of lane (this lane ^ o), every lane of the warp taking part
__device__ __forceinline__ uint4 shfl_x(uint4 v, int o) {
    uint4 t;
    t.x = __shfl_xor_sync(0xffffffffu, v.x, o);
    t.y = __shfl_xor_sync(0xffffffffu, v.y, o);
    t.z = __shfl_xor_sync(0xffffffffu, v.z, o);
    t.w = __shfl_xor_sync(0xffffffffu, v.w, o);
    return t;
}
__device__ __forceinline__ uint32_t shfl_x(uint32_t v, int o) {
    return __shfl_xor_sync(0xffffffffu, v, o);
}
__device__ __forceinline__ uint8_t shfl_x(uint8_t v, int o) {
    return (uint8_t)__shfl_xor_sync(0xffffffffu, (unsigned)v, o);
}

// true when a byte of v is > 0 as a signed value
__device__ __forceinline__ bool any_pos(uint32_t v) {
    return __vcmpgts4(v, 0u) != 0u;
}
__device__ __forceinline__ bool any_pos(uint4 v) {
    return (__vcmpgts4(v.x, 0u) | __vcmpgts4(v.y, 0u) |
            __vcmpgts4(v.z, 0u) | __vcmpgts4(v.w, 0u)) != 0u;
}
__device__ __forceinline__ bool any_pos(uint8_t v) {
    return (int8_t)v > 0;
}

// signed per-byte max: the int8 carrier's lanes (a bitwise OR is not
// exact on negative bytes)
__device__ __forceinline__ uint4 max_v(uint4 a, uint4 b) {
    return make_uint4(__vmaxs4(a.x, b.x), __vmaxs4(a.y, b.y),
                      __vmaxs4(a.z, b.z), __vmaxs4(a.w, b.w));
}
__device__ __forceinline__ uint32_t max_v(uint32_t a, uint32_t b) {
    return __vmaxs4(a, b);
}
__device__ __forceinline__ uint8_t max_v(uint8_t a, uint8_t b) {
    return (int8_t)a > (int8_t)b ? a : b;
}

}  // namespace hop
