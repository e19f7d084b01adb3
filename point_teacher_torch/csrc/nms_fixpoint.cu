// The tail of the greedy-NMS fixpoint (point_teacher_torch/ops/nms.py
// _greedy_suppress) on the device, so that NMS needs no host read.
//
// _greedy_suppress runs a fixed number of parallel rounds; a suppression
// chain deeper than that leaves boxes alive (undecided). This kernel runs
// the same rounds until no box is alive: one block a problem (the leading
// dimensions flattened), the alive flags and each round's newly kept boxes
// in shared memory, a warp a row of the conflict matrix. A round:
//   newly[i] = alive[i] && no alive j with conflict[i][j]   (nothing alive outranks i)
//   dead[i]  = alive[i] && !newly[i] && some newly j with conflict[i][j]
//   keep |= newly;  alive &= !newly && !dead
// which is the Python round exactly. A block with no box alive (the common
// case) reads its flags and returns: one launch, no work.
//
// conflict [P, N, N] bool (row i: the boxes that outrank i and overlap it
// above the threshold), alive and keep [P, N] bool, updated in place.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
nms_fixpoint_kernel(const unsigned char* __restrict__ conflict, unsigned char* __restrict__ alive_g,
                    unsigned char* __restrict__ keep_g, int n) {
    extern __shared__ unsigned char smem[];
    unsigned char* alive = smem;       // [n]
    unsigned char* newly = smem + n;   // [n]
    const size_t base = static_cast<size_t>(blockIdx.x) * n;
    const unsigned char* conf = conflict + base * n;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;

    int any = 0;
    for (int i = threadIdx.x; i < n; i += kThreads) {
        const unsigned char a = alive_g[base + i];
        alive[i] = a;
        any |= a;
    }
    any = __syncthreads_or(any);
    if (!any) return;

    while (any) {
        // newly kept: alive rows that no alive box suppresses
        for (int i = warp; i < n; i += kWarps) {
            bool hit = false;
            if (alive[i]) {  // uniform across the warp
                const unsigned char* row = conf + static_cast<size_t>(i) * n;
                for (int j0 = 0; j0 < n && !hit; j0 += 32) {
                    const int j = j0 + lane;
                    hit = __any_sync(0xffffffffu, j < n && row[j] && alive[j]);
                }
            }
            if (lane == 0) newly[i] = alive[i] && !hit;
        }
        __syncthreads();
        // keep the newly kept; drop the rows a newly kept box suppresses
        for (int i = warp; i < n; i += kWarps) {
            if (!alive[i]) continue;  // uniform across the warp
            if (newly[i]) {
                if (lane == 0) {
                    keep_g[base + i] = 1;
                    alive[i] = 0;
                }
                continue;
            }
            const unsigned char* row = conf + static_cast<size_t>(i) * n;
            bool hit = false;
            for (int j0 = 0; j0 < n && !hit; j0 += 32) {
                const int j = j0 + lane;
                hit = __any_sync(0xffffffffu, j < n && row[j] && newly[j]);
            }
            if (lane == 0 && hit) alive[i] = 0;
        }
        any = 0;
        for (int i = threadIdx.x; i < n; i += kThreads) any |= alive[i];
        any = __syncthreads_or(any);
    }
    for (int i = threadIdx.x; i < n; i += kThreads) alive_g[base + i] = 0;
}

}  // namespace

extern "C" {

// The largest N a block's shared memory holds (two flags a box).
int pt_nms_fixpoint_max_n(void) {
    int dev = 0, optin = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return 0;
    if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
        cudaSuccess)
        return 0;
    return optin / 2;
}

// conflict [problems, n, n], alive and keep [problems, n], all bool (one
// byte), contiguous, on the device of `stream`. Returns a CUDA error code.
int pt_nms_fixpoint(const void* conflict, void* alive, void* keep, int problems, int n,
                    void* stream) {
    if (problems <= 0 || n <= 0) return 0;
    const size_t smem = 2 * static_cast<size_t>(n);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            nms_fixpoint_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    nms_fixpoint_kernel<<<problems, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const unsigned char*>(conflict), static_cast<unsigned char*>(alive),
        static_cast<unsigned char*>(keep), n);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
