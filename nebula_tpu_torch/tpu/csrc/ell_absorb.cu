// ell_absorb for Hopper (sm_90a), behind a plain C interface that
// nebula_tpu_torch/tpu/ell_ops.py loads with ctypes.
//
// Replaces nebula_tpu/tpu/ell.py:1011 make_ell_absorb_kernel: derive the
// next mirror generation's ELL slot tables from the resident ones by a
// whole-row scatter of replacement rows, bucket by bucket.  The inputs
// are NOT donated: the resident tables are the published generation that
// in-flight queries still read, so the outputs are fresh buffers.
//
// Layout: the tables are one flat int32 nbr and one flat int32 et
// (DeviceTables): bucket b's row r is slots slot0[b] + r * D[b] ..
// + D[b] - 1.  Per bucket the caller passes the reference's padded
// arguments (ell.py:970 absorb_update_arrays): rows int32[kp] (local row
// indices), un / ue int32[kp, D_b] (the rows' full new content).  A pad
// entry carries the index rows_b (the bucket's row count): in the flat
// layout that index is row 0 of bucket b + 1, so the scatter tests
// local < rows_b per bucket and drops the row otherwise, as the
// reference's mode="drop" does.  Rows of one absorption are distinct
// (the plan rewrites each owner's rows once), so the scatter has no
// write conflicts.
//
// Bound on this card: bytes.  The copy reads and writes both tables
// once (16 bytes a slot); the scatter adds the replacement rows (a few
// thousand rows of at most 512 slots).  Design: a grid-stride copy with
// 16-byte vector loads and stores (int4), then, enqueued after it on
// the same stream, one warp per update row whose lanes write the row's
// D_b slots of nbr and et (coalesced 128-byte runs).  Nothing needs a
// matrix unit; the copy is the whole cost.
//
// The entry point runs on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() after its launches
// (0 = launched) or -1 for arguments it refuses.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kAbsorbMaxBuckets = 32;

// Per-bucket geometry and replacement rows, passed by value.  Global
// scope: an extern "C" entry point taking a struct from an anonymous
// namespace would get internal linkage under nvcc.
struct AbsorbBuckets {
    const int32_t* rows[kAbsorbMaxBuckets];   // int32[kp] local rows
    const int32_t* un[kAbsorbMaxBuckets];     // int32[kp, D_b]
    const int32_t* ue[kAbsorbMaxBuckets];     // int32[kp, D_b]
    long long slot0[kAbsorbMaxBuckets];       // first slot of bucket b
    long long nrows[kAbsorbMaxBuckets];       // rows of bucket b
    int D[kAbsorbMaxBuckets];                 // slots per row
    int n;                                    // buckets
    int kp;                                   // update rows per bucket
};

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxCopyBlocks = 4096;   // grid-stride beyond this

// out_a[i] = a[i], out_b[i] = b[i] for i < n4 int4 words of each table,
// then the n % 4 tail elements.
__global__ void absorb_copy_kernel(const int4* __restrict__ a,
                                   const int4* __restrict__ b,
                                   int4* __restrict__ out_a,
                                   int4* __restrict__ out_b,
                                   long long n4, long long n) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    for (long long i = tid; i < 2 * n4; i += stride) {
        if (i < n4) {
            out_a[i] = __ldg(a + i);
        } else {
            out_b[i - n4] = __ldg(b + (i - n4));
        }
    }
    const long long tail = n - 4 * n4;
    if (tid < 2 * tail) {
        const int32_t* sa = reinterpret_cast<const int32_t*>(a);
        const int32_t* sb = reinterpret_cast<const int32_t*>(b);
        int32_t* da = reinterpret_cast<int32_t*>(out_a);
        int32_t* db = reinterpret_cast<int32_t*>(out_b);
        const long long j = 4 * n4 + (tid % tail);
        if (tid < tail) da[j] = sa[j]; else db[j] = sb[j];
    }
}

// One warp per update row g = b * kp + i: drop the row when its local
// index is out of its bucket, else write its D_b slots in both tables.
__global__ void absorb_scatter_kernel(int32_t* __restrict__ nbr,
                                      int32_t* __restrict__ et,
                                      AbsorbBuckets bk) {
    const long long warp = ((long long)blockIdx.x * blockDim.x
                            + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (warp >= (long long)bk.n * bk.kp) return;
    const int b = (int)(warp / bk.kp);
    const int i = (int)(warp - (long long)b * bk.kp);
    const long long local = bk.rows[b][i];
    if (local < 0 || local >= bk.nrows[b]) return;   // a pad entry
    const int D = bk.D[b];
    const long long dst = bk.slot0[b] + local * D;
    const long long src = (long long)i * D;
    for (int j = lane; j < D; j += 32) {
        nbr[dst + j] = bk.un[b][src + j];
        et[dst + j] = bk.ue[b][src + j];
    }
}

inline unsigned blocks_for(long long total, long long cap) {
    long long blocks = (total + kThreads - 1) / kThreads;
    if (blocks > cap) blocks = cap;
    if (blocks < 1) blocks = 1;
    return (unsigned)blocks;
}

}  // namespace

extern "C" {

// nbr, et: int32[n_slots] resident tables (16-byte aligned, read only);
// out_nbr, out_et: int32[n_slots] fresh outputs (16-byte aligned).
int ell_absorb(const void* nbr, const void* et, void* out_nbr, void* out_et,
               int64_t n_slots, AbsorbBuckets bk, void* stream) {
    if (n_slots < 0 || bk.n < 1 || bk.n > kAbsorbMaxBuckets || bk.kp < 1)
        return -1;
    cudaStream_t s = (cudaStream_t)stream;
    const long long n4 = n_slots / 4;
    if (n_slots > 0) {
        absorb_copy_kernel<<<blocks_for(2 * n4 + 8, kMaxCopyBlocks),
                             kThreads, 0, s>>>(
            (const int4*)nbr, (const int4*)et, (int4*)out_nbr,
            (int4*)out_et, n4, n_slots);
    }
    const long long warps = (long long)bk.n * bk.kp;
    absorb_scatter_kernel<<<blocks_for(warps * 32, 1LL << 30), kThreads, 0,
                            s>>>((int32_t*)out_nbr, (int32_t*)out_et, bk);
    return (int)cudaGetLastError();
}

}  // extern "C"
