// 16-byte channel vectors for the forward RoIAlign kernels: a lane reads,
// sums and writes kVec<T> consecutive channels of one cell as one uint4
// (8 channels in bf16, 4 in f32), accumulating in f32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace vec16 {

template <typename T> constexpr int kVec = 16 / static_cast<int>(sizeof(T));

__device__ __forceinline__ uint4 load(const void* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
}

// acc[0..kVec) += w * v, channel by channel.
__device__ __forceinline__ void madd(float* acc, uint4 v, float w, float) {
    acc[0] = fmaf(w, __uint_as_float(v.x), acc[0]);
    acc[1] = fmaf(w, __uint_as_float(v.y), acc[1]);
    acc[2] = fmaf(w, __uint_as_float(v.z), acc[2]);
    acc[3] = fmaf(w, __uint_as_float(v.w), acc[3]);
}

__device__ __forceinline__ void fma_pair(float* acc, unsigned u, float w) {
    // a bf16 is the high half of the f32 with the same bits
    acc[0] = fmaf(w, __uint_as_float(u << 16), acc[0]);
    acc[1] = fmaf(w, __uint_as_float(u & 0xffff0000u), acc[1]);
}

__device__ __forceinline__ void madd(float* acc, uint4 v, float w, __nv_bfloat16) {
    fma_pair(acc + 0, v.x, w);
    fma_pair(acc + 2, v.y, w);
    fma_pair(acc + 4, v.z, w);
    fma_pair(acc + 6, v.w, w);
}

template <typename T>
__device__ __forceinline__ void madd(float* acc, uint4 v, float w) { madd(acc, v, w, T()); }

__device__ __forceinline__ uint4 pack(const float* acc, float) {
    return make_uint4(__float_as_uint(acc[0]), __float_as_uint(acc[1]),
                      __float_as_uint(acc[2]), __float_as_uint(acc[3]));
}

__device__ __forceinline__ unsigned pack_pair(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);    // round to nearest even
    return *reinterpret_cast<const unsigned*>(&h);
}

__device__ __forceinline__ uint4 pack(const float* acc, __nv_bfloat16) {
    return make_uint4(pack_pair(acc[0], acc[1]), pack_pair(acc[2], acc[3]),
                      pack_pair(acc[4], acc[5]), pack_pair(acc[6], acc[7]));
}

template <typename T>
__device__ __forceinline__ void store(T* p, const float* acc) {
    // a streaming store: the output is written once and not read again here
    __stcs(reinterpret_cast<uint4*>(p), pack(acc, T()));
}

// A forward kernel's layout: info[0..5] = rois (warps) per block, threads
// per block, static shared memory bytes, registers per thread, local memory
// bytes per thread (spills), resident blocks per SM on the current device.
template <typename Kernel>
inline int fwd_info(Kernel kernel, int rois, int threads, int* info) {
    cudaFuncAttributes a{};
    cudaError_t err = cudaFuncGetAttributes(&a, kernel);
    int per_sm = 0;
    if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
    }
    info[0] = rois;
    info[1] = threads;
    info[2] = static_cast<int>(a.sharedSizeBytes);
    info[3] = a.numRegs;
    info[4] = static_cast<int>(a.localSizeBytes);
    info[5] = per_sm;
    return static_cast<int>(err);
}

}  // namespace vec16
