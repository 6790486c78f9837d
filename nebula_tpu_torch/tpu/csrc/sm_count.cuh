// The current device's SM count, for the launches whose grid is a few
// blocks an SM (ell_lanes.cu's gated hop, sparse_go.cu's gated layout
// change and K4, edge_go.cu's fused final pass, mesh_sparse.cu's X1 and
// X3, ell_int8.cu's K15).  Included by those sources.
#pragma once

#include <atomic>

#include <cuda_runtime.h>

// Read from the device once a process and kept; 0 when the device
// cannot be queried, which every caller returns as
// cudaErrorInvalidDevice.
inline int sm_count() {
    static std::atomic<int> sms{0};
    int v = sms.load(std::memory_order_relaxed);
    if (v > 0) return v;
    int d = 0;
    if (cudaGetDevice(&d) != cudaSuccess ||
        cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, d) !=
            cudaSuccess || v < 1)
        return 0;
    sms.store(v, std::memory_order_relaxed);
    return v;
}
