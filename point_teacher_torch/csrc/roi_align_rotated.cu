// Rotated RoIAlign, forward and d/dfeat backward, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of point_teacher_tpu/ops/rroi_pallas.py:
//   K3  _make_fwd_kernel  (launched by _pooled_fwd, weights from
//                          rotated_window_weights, wrapped by roi_align_rotated_pallas)
//   K4  _make_bwd_kernel  (launched by _pooled_bwd)
// and, through per-roi clamp bounds, the XLA functions the JAX MIL stage
// actually pools with (point_teacher_tpu/ops/roi_align.py):
// roi_align_rotated_matmul (per-roi window), extract_group_windows +
// roi_align_rotated_grouped_from_windows (group window) and roi_align_rotated
// (exact gather, whole map).
//
// Semantics (mmcv RoIAlignRotated, clockwise, aligned, 7x7 output,
// sampling_ratio 2): a roi (cx, cy, w, h, a) in image px is scaled by 1/8 to
// feature cells; sample (iy, ix), iy, ix in [0, 14), sits at box-frame
// fractions f(i) = (i / 2 + ((i % 2) + 0.5) / 2) / 7 - 0.5 and at
//   bx = f(ix) * w,  by = f(iy) * h
//   sx = cos * bx - sin * by + cx - 0.5,  sy = sin * bx + cos * by + cy - 0.5.
// A sample with sx or sy outside [-1, size] contributes 0 (the border rule,
// always checked against the true map); otherwise it is clamped into the
// roi's bounds [lo, hi] and read bilinearly from cells floor(c) and
// min(floor(c) + 1, hi). Bin (ph, pw) is the mean of its 2 x 2 samples.
// The clamp bounds [y_lo, y_hi, x_lo, x_hi] say which window the reference
// contracts against; without them the bounds are the whole map.
//
// Why this equals the TPU / XLA weight tensors: the reference builds per
// sample hy[k] = valid * max(0, 1 - |ry - k|) and hx[k] = max(0, 1 - |rx - k|)
// over the window's cells, with ry, rx the window-relative clamped
// coordinates, and contracts hy (x) hx against the window. The hat is
// nonzero only at k = floor(r) (weight 1 - frac) and floor(r) + 1 (weight
// frac), the two bilinear taps; at the clamp bound frac = 0. Relative and
// absolute coordinates differ by an integer origin, which f32 subtracts
// exactly in the range that survives the clamp. So the kernel's sum of 4
// taps x 4 samples is the reference's contraction in another order.
//
// cos and sin come from the caller ([B, N, 2] f32, computed once with
// torch.cos / torch.sin), not from cosf / sinf here: the two can differ by
// an ulp, which would move sample positions against the plain version. The
// coordinate arithmetic uses _rn intrinsics so nvcc cannot contract it into
// fused multiply-adds.
//
// Design and bound. One block per (image, roi). Its threads first fill a
// shared table of the roi's 196 samples: four tap offsets and four tap
// weights (validity folded in). Then threads run along channels, so reads
// of feat[b, y, x, :] and writes of out[b, n, bin, :] are coalesced, and
// each thread sums 4 samples x 4 taps per bin in f32. Weights and the sum
// stay in f32 whatever the feature dtype (the Pallas kernel builds its
// weights in f32 as well, rroi_pallas.py:232-234, then casts them to the
// feature dtype; the shipped XLA path builds them in the feature dtype).
// At the SODA-A MIL shapes (150x150x256 map, 2500-2700 rois per image) the
// pooled output is 5-6x the feature map: the function is bound by bytes
// written, and within a few percent equally by its multiply-adds.
// The backward scatters dout * weight / 4 with atomicAdd into a zeroed f32
// [B, H, W, C] buffer. The order of those additions varies from run to run,
// so unlike the TPU kernel (whose grid runs in order) the backward is NOT
// deterministic: results differ by f32 rounding between runs.
//
// Left for later work: tiling the members of one group per block with the
// group window in shared memory; a deterministic segmented backward; bf16x2
// vector loads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kOut = 7;                   // pooled size per axis
constexpr int kRatio = 2;                 // sampling_ratio
constexpr int kAxis = kOut * kRatio;      // samples per axis (14)
constexpr int kSamples = kAxis * kAxis;   // samples per roi (196)
constexpr int kThreads = 128;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

struct SampleTable {
    int off[kSamples][4];     // tap cell index y * W + x
    float w[kSamples][4];     // tap weight, validity folded in
};

// Box-frame fraction of sample i along one axis, rounded as the reference
// rounds ((bin + (k + 0.5) / 2) / 7 - 0.5).
__device__ __forceinline__ float frac_of(int i) {
    const float offs = __fdiv_rn(__fadd_rn(static_cast<float>(i % kRatio), 0.5f),
                                 static_cast<float>(kRatio));
    const float f = __fdiv_rn(__fadd_rn(static_cast<float>(i / kRatio), offs),
                              static_cast<float>(kOut));
    return __fsub_rn(f, 0.5f);
}

// Fills the block's shared sample table for roi (b, n); call from every thread.
__device__ __forceinline__ void build_table(SampleTable& t, const float* __restrict__ rrois,
                                            const float* __restrict__ cos_sin,
                                            const int* __restrict__ clamp, int b, int n,
                                            int N, int H, int W, float scale) {
    const size_t r = static_cast<size_t>(b) * N + n;
    const float cx = __fmul_rn(rrois[r * 5 + 0], scale);
    const float cy = __fmul_rn(rrois[r * 5 + 1], scale);
    const float bw = __fmul_rn(rrois[r * 5 + 2], scale);
    const float bh = __fmul_rn(rrois[r * 5 + 3], scale);
    const float cs = cos_sin[r * 2 + 0];
    const float sn = cos_sin[r * 2 + 1];
    int y_lo = 0, y_hi = H - 1, x_lo = 0, x_hi = W - 1;
    if (clamp != nullptr) {
        y_lo = clamp[r * 4 + 0]; y_hi = clamp[r * 4 + 1];
        x_lo = clamp[r * 4 + 2]; x_hi = clamp[r * 4 + 3];
    }
    for (int s = threadIdx.x; s < kSamples; s += blockDim.x) {
        const float bx = __fmul_rn(frac_of(s % kAxis), bw);
        const float by = __fmul_rn(frac_of(s / kAxis), bh);
        const float sx = __fsub_rn(__fadd_rn(__fsub_rn(__fmul_rn(cs, bx), __fmul_rn(sn, by)), cx),
                                   0.5f);
        const float sy = __fsub_rn(__fadd_rn(__fadd_rn(__fmul_rn(sn, bx), __fmul_rn(cs, by)), cy),
                                   0.5f);
        const bool valid = (sx >= -1.f) && (sx <= static_cast<float>(W))
                        && (sy >= -1.f) && (sy <= static_cast<float>(H));
        const float yy = fminf(fmaxf(sy, static_cast<float>(y_lo)), static_cast<float>(y_hi));
        const float xx = fminf(fmaxf(sx, static_cast<float>(x_lo)), static_cast<float>(x_hi));
        const float fy = floorf(yy);
        const float fx = floorf(xx);
        const float ly = __fsub_rn(yy, fy);
        const float lx = __fsub_rn(xx, fx);
        const int y0 = static_cast<int>(fy), x0 = static_cast<int>(fx);
        const int y1 = min(y0 + 1, y_hi), x1 = min(x0 + 1, x_hi);
        const float wy0 = valid ? __fsub_rn(1.f, ly) : 0.f;
        const float wy1 = valid ? ly : 0.f;
        const float wx0 = __fsub_rn(1.f, lx);
        const float wx1 = lx;
        t.off[s][0] = y0 * W + x0; t.w[s][0] = __fmul_rn(wy0, wx0);
        t.off[s][1] = y0 * W + x1; t.w[s][1] = __fmul_rn(wy0, wx1);
        t.off[s][2] = y1 * W + x0; t.w[s][2] = __fmul_rn(wy1, wx0);
        t.off[s][3] = y1 * W + x1; t.w[s][3] = __fmul_rn(wy1, wx1);
    }
    __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
roi_align_rotated_fwd_kernel(const T* __restrict__ feat, const float* __restrict__ rrois,
                             const float* __restrict__ cos_sin, const int* __restrict__ clamp,
                             T* __restrict__ out, int H, int W, int C, int N, float scale) {
    __shared__ SampleTable t;
    const int n = blockIdx.x;
    const int b = blockIdx.y;
    build_table(t, rrois, cos_sin, clamp, b, n, N, H, W, scale);
    const T* fb = feat + static_cast<size_t>(b) * H * W * C;
    T* ob = out + (static_cast<size_t>(b) * N + n) * (kOut * kOut) * C;

    for (int c = threadIdx.x; c < C; c += blockDim.x) {
        for (int ph = 0; ph < kOut; ++ph) {
            for (int pw = 0; pw < kOut; ++pw) {
                float acc = 0.f;
                for (int sy = 0; sy < kRatio; ++sy) {
                    for (int sx = 0; sx < kRatio; ++sx) {
                        const int s = (ph * kRatio + sy) * kAxis + pw * kRatio + sx;
                        #pragma unroll
                        for (int k = 0; k < 4; ++k) {
                            acc += t.w[s][k] * load_f32(fb + static_cast<size_t>(t.off[s][k]) * C + c);
                        }
                    }
                }
                store_f32(ob + (ph * kOut + pw) * C + c, acc * 0.25f);
            }
        }
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
roi_align_rotated_bwd_kernel(const T* __restrict__ dout, const float* __restrict__ rrois,
                             const float* __restrict__ cos_sin, const int* __restrict__ clamp,
                             float* __restrict__ dfeat, int H, int W, int C, int N, float scale) {
    __shared__ SampleTable t;
    const int n = blockIdx.x;
    const int b = blockIdx.y;
    build_table(t, rrois, cos_sin, clamp, b, n, N, H, W, scale);
    float* db = dfeat + static_cast<size_t>(b) * H * W * C;
    const T* gb = dout + (static_cast<size_t>(b) * N + n) * (kOut * kOut) * C;

    for (int c = threadIdx.x; c < C; c += blockDim.x) {
        for (int ph = 0; ph < kOut; ++ph) {
            for (int pw = 0; pw < kOut; ++pw) {
                const float g = load_f32(gb + (ph * kOut + pw) * C + c) * 0.25f;
                if (g == 0.f) continue;
                for (int sy = 0; sy < kRatio; ++sy) {
                    for (int sx = 0; sx < kRatio; ++sx) {
                        const int s = (ph * kRatio + sy) * kAxis + pw * kRatio + sx;
                        #pragma unroll
                        for (int k = 0; k < 4; ++k) {
                            const float v = g * t.w[s][k];
                            if (v != 0.f) {
                                atomicAdd(db + static_cast<size_t>(t.off[s][k]) * C + c, v);
                            }
                        }
                    }
                }
            }
        }
    }
}

}  // namespace

// Plain C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16
// (feature / pooled values; rrois [B, N, 5] and cos_sin [B, N, 2] are always
// f32, clamp [B, N, 4] int32 or null, dfeat f32). Launches on `stream`,
// allocates nothing, does not synchronise, and returns cudaGetLastError()
// after the launch (0 = success).
extern "C" int pt_roi_align_rotated_fwd(const void* feat, const float* rrois,
                                        const float* cos_sin, const int* clamp, void* out,
                                        int dtype, int B, int H, int W, int C, int N,
                                        float scale, void* stream) {
    if (N == 0 || B == 0) return 0;
    const dim3 grid(N, B);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) {
        roi_align_rotated_fwd_kernel<float><<<grid, kThreads, 0, s>>>(
            static_cast<const float*>(feat), rrois, cos_sin, clamp, static_cast<float*>(out),
            H, W, C, N, scale);
    } else if (dtype == 1) {
        roi_align_rotated_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
            static_cast<const __nv_bfloat16*>(feat), rrois, cos_sin, clamp,
            static_cast<__nv_bfloat16*>(out), H, W, C, N, scale);
    } else {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}

extern "C" int pt_roi_align_rotated_bwd(const void* dout, const float* rrois,
                                        const float* cos_sin, const int* clamp, float* dfeat,
                                        int dtype, int B, int H, int W, int C, int N,
                                        float scale, void* stream) {
    if (N == 0 || B == 0) return 0;
    const dim3 grid(N, B);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) {
        roi_align_rotated_bwd_kernel<float><<<grid, kThreads, 0, s>>>(
            static_cast<const float*>(dout), rrois, cos_sin, clamp, dfeat, H, W, C, N, scale);
    } else if (dtype == 1) {
        roi_align_rotated_bwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
            static_cast<const __nv_bfloat16*>(dout), rrois, cos_sin, clamp, dfeat,
            H, W, C, N, scale);
    } else {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
