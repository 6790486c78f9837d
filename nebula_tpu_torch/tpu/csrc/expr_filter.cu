// The compiled-WHERE mask for Hopper (sm_90a), behind a plain C
// interface that nebula_tpu_torch/tpu/edge_ops.py loads with ctypes.
//
// Replaces the `expr_filter` family of nebula_tpu/tpu/expr_compile.py
// (:468 audit_filter_entry, :512 its registry entry): the CVal
// closures that nebula_tpu/tpu/runtime.py:2750-2790 (_run_go_kernel's
// filter_fn) traces into the fused GO program with jax.numpy.  Here the
// same closures are lowered once per (space, mirror, mode, WHERE) into
// an ExprProgram (tpu/expr_program.py), which the interpreter of
// expr_core.cuh runs: the semantics, the register file and the cost of
// an instruction are written there.  This entry evaluates the WHERE on
// every edge into a bool [m] mask: the registry family's counterpart,
// held against its plain version by chip_smoke.py.  No runtime path
// launches it: go_filtered's final pass (edge_go.cu) runs the same core
// only on the edges that pass K9's test.
//
// Bound on this card: bytes.  Each edge reads its used columns (4 B an
// int32 or float32 column, 1 B a bool or validity byte; a vertex column
// also its 4 B src or dst index and a gathered word) and writes 1 B;
// for two int32 edge columns at the serve graph's 8,385,118 edge rows
// that is 75.5 MB, 22.5 us at 3.35 TB/s.  Design: one thread an edge,
// grid-stride; the block copies the program into shared memory once and
// keeps its threads' registers there (expr_core.cuh).  The
// interpretation costs instructions, not bytes: at a few dozen an edge
// it stays below the bytes bound only for short programs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "expr_core.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1LL << 16;

inline unsigned grid_for(long long total) {
    long long blocks = (total + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    if (blocks < 1) blocks = 1;
    return (unsigned)blocks;
}

__global__ void expr_filter_kernel(const int32_t* __restrict__ ins,
                                   int n_ins, int out_reg, ExprSlots slots,
                                   const int32_t* __restrict__ src,
                                   const int32_t* __restrict__ dst,
                                   long long m, uint8_t* __restrict__ out) {
    extern __shared__ uint32_t smem[];
    int32_t* prog = reinterpret_cast<int32_t*>(smem);
    uint32_t* regs = smem + n_ins * 5 + threadIdx.x;
    expr::load_program(prog, ins, n_ins);
    __syncthreads();
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         e < m; e += stride)
        out[e] = expr::eval(prog, n_ins, out_reg, regs, slots, src, dst, e)
                     ? 1 : 0;
}

}  // namespace

extern "C" {

// ins: int32 [n_ins, 5] on the card; n_regs: the program's registers
// (every register it names is below it).
int expr_filter(const void* ins, int n_ins, int n_regs, int out_reg,
                ExprSlots slots, const void* src, const void* dst,
                int64_t m, void* out, void* stream) {
    if (!expr::program_ok(n_ins, n_regs, out_reg, slots) || m < 0)
        return -1;
    if (m == 0) return (int)cudaGetLastError();
    expr_filter_kernel<<<grid_for(m), kThreads,
                         expr::smem_bytes(n_ins, n_regs, kThreads),
                         (cudaStream_t)stream>>>(
        (const int32_t*)ins, n_ins, out_reg, slots, (const int32_t*)src,
        (const int32_t*)dst, m, (uint8_t*)out);
    return (int)cudaGetLastError();
}

}  // extern "C"
