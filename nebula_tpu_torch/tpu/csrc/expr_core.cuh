// The compiled-WHERE interpreter's core for Hopper (sm_90a): one
// __device__ routine that runs an ExprProgram (tpu/expr_program.py) for
// one edge.  Included by expr_filter.cu (the standalone mask, the
// registry family's counterpart) and edge_go.cu (go_filtered's final
// pass, which runs it only on the edges that pass K9's test), so the
// two cannot drift apart.  One interpreter, built once from the repo's
// sources, runs every WHERE; nothing is generated per expression.
//
// Instruction: int32 x 5 = (opcode, dst, a, b, c).  CONST carries its
// 32-bit pattern in a; LOAD its slot in a.  Registers hold bool (0/1),
// int32 or float32 bits.  Slots are column pointers with a kind (read at
// e, at src[e] or at dst[e]) and a type (bool byte, int32, float32).
// The last instruction's register `out` is the edge's mask bit.
//
// Semantics are XLA's on the CPU, which the reference runs: int32 ops
// wrap; x / 0 = -1, x % 0 = x, INT32_MIN / -1 = INT32_MIN; a float ->
// int32 conversion truncates, saturates and maps NaN to 0; every float
// operation flushes denormal inputs and outputs to signed zero (DAZ and
// FTZ done by hand, so the build needs no -ftz flag); add, sub, mul,
// div, sqrt and fma use the _rn intrinsics, so nvcc contracts nothing
// the program did not ask for (the lowering places XLA's fused
// multiply-adds as FMA instructions).  floor, ceil, rintf (half to even,
// jnp.round), roundf (half away, lax.round) and fmodf are exact, as in
// XLA.  The transcendentals (rsqrtf, cbrtf, expf, exp2f, logf, sinf,
// cosf, tanf, asinf, acosf, atanf, powf, atan2f) are CUDA's libm without
// --use_fast_math: within 1-4 ulp of the correctly rounded result (the
// CUDA C Programming Guide's table), as XLA's own approximations are
// within a few ulp; they are the one place the card, the plain version
// and XLA may disagree.  Every operation is total (no input traps), so
// the value of the WHERE at an edge depends on that edge alone, and
// evaluating it only where the final mask can hold gives the same mask.
//
// The register file: a thread's registers are one column of a shared
// memory array, register k of thread t at regs[k * blockDim.x + t], so
// the 32 lanes of a warp touch 32 consecutive words (32 banks, no
// conflict) whatever register the program names.  An array indexed by
// the program (uint32_t r[32]) cannot live in registers and goes to
// local memory; the shared file keeps every access on the SM.  The
// program itself sits in shared memory too, so every lane's instruction
// fetch is a broadcast read, and the opcode switch is the same on every
// lane of a warp (no divergence).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// The slot table, passed by value (at global scope, so the extern "C"
// entries that take it keep external linkage).
struct ExprSlots {
    const void* ptr[16];
    int kind[16];
    int type[16];
    int n;
};

namespace expr {

constexpr int kMaxRegs = 32;
constexpr int kMaxIns = 256;
constexpr int kMaxSlots = 16;
constexpr float kFltMin = 1.17549435e-38f;     // smallest normal float32

static_assert(sizeof(ExprSlots::kind) / sizeof(int) == kMaxSlots,
              "slot table size");

enum Kind { EDGE = 0, VSRC = 1, VDST = 2 };
enum Type { T_BOOL = 0, T_INT = 1, T_FLOAT = 2 };

// expr_program.py _OPS, in order
enum Op {
    OP_LOAD = 0, OP_CONST = 1, OP_CVT_BI = 2, OP_CVT_BF = 3, OP_CVT_IF = 4,
    OP_CVT_FI = 5, OP_NEG_I = 6, OP_ABS_I = 7, OP_SIGN_I = 8, OP_ADD_I = 9,
    OP_SUB_I = 10, OP_MUL_I = 11, OP_DIV_I = 12, OP_REM_I = 13,
    OP_MAX_I = 14, OP_XOR_I = 15, OP_AND_I = 16, OP_SHRL_I = 17,
    OP_NEG_F = 18, OP_ABS_F = 19, OP_SIGN_F = 20, OP_ADD_F = 21,
    OP_SUB_F = 22, OP_MUL_F = 23, OP_DIV_F = 24, OP_REM_F = 25,
    OP_MAX_F = 26, OP_MIN_F = 27, OP_FMA = 28, OP_FMA_NP = 29,
    OP_FMA_NC = 30, OP_FMA_NPC = 31, OP_FLOOR = 32, OP_CEIL = 33,
    OP_RINT = 34, OP_ROUND = 35, OP_SQRT = 36, OP_RSQRT = 37, OP_CBRT = 38,
    OP_EXP = 39, OP_EXP2 = 40, OP_LOG = 41, OP_SIN = 42, OP_COS = 43,
    OP_TAN = 44, OP_ASIN = 45, OP_ACOS = 46, OP_ATAN = 47, OP_POW = 48,
    OP_ATAN2 = 49, OP_EQ_B = 50, OP_NE_B = 51, OP_LT_I = 52, OP_LE_I = 53,
    OP_GT_I = 54, OP_GE_I = 55, OP_EQ_I = 56, OP_NE_I = 57, OP_LT_F = 58,
    OP_LE_F = 59, OP_GT_F = 60, OP_GE_F = 61, OP_EQ_F = 62, OP_NE_F = 63,
    OP_NOT = 64, OP_AND = 65, OP_OR = 66, OP_SEL_I = 67, OP_SEL_F = 68,
};

__device__ __forceinline__ float daz(float x) {
    return fabsf(x) < kFltMin ? copysignf(0.0f, x) : x;
}
__device__ __forceinline__ float fv(uint32_t u) { return daz(__uint_as_float(u)); }
__device__ __forceinline__ uint32_t fu(float x) { return __float_as_uint(daz(x)); }
__device__ __forceinline__ int32_t iv(uint32_t u) { return (int32_t)u; }
__device__ __forceinline__ uint32_t bu(bool b) { return b ? 1u : 0u; }

__device__ __forceinline__ uint32_t cvt_fi(float x) {
    x = daz(x);
    if (isnan(x)) return 0u;
    if (x >= 2147483648.0f) return 0x7FFFFFFFu;
    if (x < -2147483648.0f) return 0x80000000u;
    return (uint32_t)(int32_t)truncf(x);
}

__device__ __forceinline__ float sign_f(float x) {
    x = daz(x);
    if (isnan(x) || x == 0.0f) return x;
    return copysignf(1.0f, x);
}

__device__ __forceinline__ float max_f(float x, float y) {
    x = daz(x);
    y = daz(y);
    if (isnan(x) || isnan(y)) return __int_as_float(0x7FC00000);
    return x > y ? x : y;
}

__device__ __forceinline__ float min_f(float x, float y) {
    x = daz(x);
    y = daz(y);
    if (isnan(x) || isnan(y)) return __int_as_float(0x7FC00000);
    return x < y ? x : y;
}

// Copies the program (n_ins rows of 5) into the block's shared copy;
// every thread of the block calls it, then __syncthreads().
__device__ __forceinline__ void load_program(int32_t* prog,
                                             const int32_t* ins,
                                             int n_ins) {
    for (int i = threadIdx.x; i < n_ins * 5; i += blockDim.x)
        prog[i] = ins[i];
}

// Runs the program `prog` (shared memory, n_ins instructions) for edge
// e; `regs` is this thread's register column (register k at regs[k *
// blockDim.x]).  Returns the out register as the edge's mask bit.
__device__ __forceinline__ bool eval(const int32_t* prog, int n_ins,
                                     int out_reg, uint32_t* regs,
                                     const ExprSlots& slots,
                                     const int32_t* __restrict__ src,
                                     const int32_t* __restrict__ dst,
                                     long long e) {
    const int step = blockDim.x;
    for (int k = 0; k < n_ins; ++k) {
        const int32_t* p = prog + 5 * k;
        const int op = p[0];
        const int d = p[1];
        uint32_t a = 0, b = 0, c = 0;
        if (op >= OP_CVT_BI) {
            a = regs[p[2] * step];
            b = regs[p[3] * step];
            c = regs[p[4] * step];
        }
        uint32_t v = 0;
        switch (op) {
        case OP_LOAD: {
            const int s = p[2];
            long long at = e;
            if (slots.kind[s] == VSRC) at = src[e];
            else if (slots.kind[s] == VDST) at = dst[e];
            if (slots.type[s] == T_BOOL)
                v = ((const uint8_t*)slots.ptr[s])[at] ? 1u : 0u;
            else
                v = ((const uint32_t*)slots.ptr[s])[at];
            break;
        }
        case OP_CONST: v = (uint32_t)p[2]; break;
        case OP_CVT_BI: v = a; break;
        case OP_CVT_BF: v = __float_as_uint(a ? 1.0f : 0.0f); break;
        case OP_CVT_IF: v = __float_as_uint(__int2float_rn(iv(a))); break;
        case OP_CVT_FI: v = cvt_fi(__uint_as_float(a)); break;
        case OP_NEG_I: v = 0u - a; break;
        case OP_ABS_I: v = iv(a) < 0 ? 0u - a : a; break;
        case OP_SIGN_I: v = (uint32_t)((iv(a) > 0) - (iv(a) < 0)); break;
        case OP_ADD_I: v = a + b; break;
        case OP_SUB_I: v = a - b; break;
        case OP_MUL_I: v = a * b; break;
        case OP_DIV_I:
            if (b == 0u) v = 0xFFFFFFFFu;
            else if (a == 0x80000000u && b == 0xFFFFFFFFu) v = a;
            else v = (uint32_t)(iv(a) / iv(b));
            break;
        case OP_REM_I:
            if (b == 0u) v = a;
            else if (a == 0x80000000u && b == 0xFFFFFFFFu) v = 0u;
            else v = (uint32_t)(iv(a) % iv(b));
            break;
        case OP_MAX_I: v = iv(a) > iv(b) ? a : b; break;
        case OP_XOR_I: v = a ^ b; break;
        case OP_AND_I: v = a & b; break;
        case OP_SHRL_I: v = (iv(b) < 0 || iv(b) >= 32) ? 0u : a >> b; break;
        case OP_NEG_F: v = a ^ 0x80000000u; break;
        case OP_ABS_F: v = a & 0x7FFFFFFFu; break;
        case OP_SIGN_F: v = __float_as_uint(sign_f(__uint_as_float(a))); break;
        case OP_ADD_F: v = fu(__fadd_rn(fv(a), fv(b))); break;
        case OP_SUB_F: v = fu(__fsub_rn(fv(a), fv(b))); break;
        case OP_MUL_F: v = fu(__fmul_rn(fv(a), fv(b))); break;
        case OP_DIV_F: v = fu(__fdiv_rn(fv(a), fv(b))); break;
        case OP_REM_F: v = fu(fmodf(fv(a), fv(b))); break;
        case OP_MAX_F: v = fu(max_f(__uint_as_float(a), __uint_as_float(b))); break;
        case OP_MIN_F: v = fu(min_f(__uint_as_float(a), __uint_as_float(b))); break;
        case OP_FMA: v = fu(__fmaf_rn(fv(a), fv(b), fv(c))); break;
        case OP_FMA_NP: v = fu(__fmaf_rn(-fv(a), fv(b), fv(c))); break;
        case OP_FMA_NC: v = fu(__fmaf_rn(fv(a), fv(b), -fv(c))); break;
        case OP_FMA_NPC: v = fu(__fmaf_rn(-fv(a), fv(b), -fv(c))); break;
        case OP_FLOOR: v = fu(floorf(fv(a))); break;
        case OP_CEIL: v = fu(ceilf(fv(a))); break;
        case OP_RINT: v = fu(rintf(fv(a))); break;
        case OP_ROUND: v = fu(roundf(fv(a))); break;
        case OP_SQRT: v = fu(__fsqrt_rn(fv(a))); break;
        case OP_RSQRT: v = fu(rsqrtf(fv(a))); break;
        case OP_CBRT: v = fu(cbrtf(fv(a))); break;
        case OP_EXP: v = fu(expf(fv(a))); break;
        case OP_EXP2: v = fu(exp2f(fv(a))); break;
        case OP_LOG: v = fu(logf(fv(a))); break;
        case OP_SIN: v = fu(sinf(fv(a))); break;
        case OP_COS: v = fu(cosf(fv(a))); break;
        case OP_TAN: v = fu(tanf(fv(a))); break;
        case OP_ASIN: v = fu(asinf(fv(a))); break;
        case OP_ACOS: v = fu(acosf(fv(a))); break;
        case OP_ATAN: v = fu(atanf(fv(a))); break;
        case OP_POW: v = fu(powf(fv(a), fv(b))); break;
        case OP_ATAN2: v = fu(atan2f(fv(a), fv(b))); break;
        case OP_EQ_B: v = bu(a == b); break;
        case OP_NE_B: v = bu(a != b); break;
        case OP_LT_I: v = bu(iv(a) < iv(b)); break;
        case OP_LE_I: v = bu(iv(a) <= iv(b)); break;
        case OP_GT_I: v = bu(iv(a) > iv(b)); break;
        case OP_GE_I: v = bu(iv(a) >= iv(b)); break;
        case OP_EQ_I: v = bu(a == b); break;
        case OP_NE_I: v = bu(a != b); break;
        case OP_LT_F: v = bu(fv(a) < fv(b)); break;
        case OP_LE_F: v = bu(fv(a) <= fv(b)); break;
        case OP_GT_F: v = bu(fv(a) > fv(b)); break;
        case OP_GE_F: v = bu(fv(a) >= fv(b)); break;
        case OP_EQ_F: v = bu(fv(a) == fv(b)); break;
        case OP_NE_F: v = bu(fv(a) != fv(b)); break;
        case OP_NOT: v = a ^ 1u; break;
        case OP_AND: v = a & b; break;
        case OP_OR: v = a | b; break;
        case OP_SEL_I:
        case OP_SEL_F: v = a ? b : c; break;
        default: v = 0u; break;
        }
        regs[d * step] = v;
    }
    return regs[out_reg * step] != 0u;
}

// Dynamic shared memory bytes of a block of `threads` running a program
// of n_ins instructions over n_regs registers: the program, then the
// register file.
inline size_t smem_bytes(int n_ins, int n_regs, int threads) {
    return (size_t)(n_ins * 5 + n_regs * threads) * sizeof(uint32_t);
}

// true when the program fits the interpreter
inline bool program_ok(int n_ins, int n_regs, int out_reg,
                       const ExprSlots& slots) {
    return n_ins > 0 && n_ins <= kMaxIns && n_regs > 0 &&
           n_regs <= kMaxRegs && out_reg >= 0 && out_reg < n_regs &&
           slots.n >= 0 && slots.n <= kMaxSlots;
}

}  // namespace expr
