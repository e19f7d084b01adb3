// Horizontal RoIAlign, forward and d/dfeat backward, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of point_teacher_tpu/ops/roi_align_pallas.py:
//   K1  _fwd_kernel       (launched by _run_fwd, wrapped by roi_align_batched_pallas)
//   K2  _make_bwd_kernel  (launched by _pooled_bwd)
// and, through the optional per-roi clamp bounds, the XLA grouped window pool
// roi_align_grouped_from_windows of point_teacher_tpu/ops/roi_align.py.
//
// Semantics (mmcv RoIAlign, aligned=True, sampling_ratio=0, 7x7 output):
//   bin = max(x2 - x1, 1e-6) / 7 in feature cells, sn = clamp(ceil(bin), 1, 4)
//   samples per axis; sample k of bin i sits at
//     c = start + (i + (k + 0.5) / sn) * bin - 0.5
//   a sample with c < -1 or c > size contributes 0 (the border rule, always
//   checked against the true map); otherwise c is clamped to [lo, hi] and
//   read bilinearly from cells floor(c) and min(floor(c) + 1, hi).
//   Without clamp bounds lo = 0, hi = size - 1 (roi_align_matmul). With the
//   bounds of a group window of origin w0 and size win, lo = w0 and
//   hi = w0 + win - 1 (_axis_rel_weights, ops/roi_align.py:297-300).
//
// Why this equals the TPU weight matrices term for term: _axis_weights builds
//   Wy[i, k] = (1/sn_y) sum_sy valid(c_sy) * max(0, 1 - |clamp(c_sy) - k|)
// and the TPU kernel computes out[i, j] = sum_k sum_l Wy[i, k] Wx[j, l] F[k, l].
// The hat max(0, 1 - |c - k|) is nonzero only at k = floor(c) (weight
// 1 - frac) and k = floor(c) + 1 (weight frac), which are exactly the two
// bilinear taps; when floor(c) + 1 passes the clamp bound, c sits on the
// bound, frac = 0 and the second tap has weight 0. The validity mask is a
// product of per-axis masks. Expanding the double sum therefore gives
//   out[i, j] = 1/(sn_y sn_x) sum_sy sum_sx wy(sy) wx(sx) F[y(sy), x(sx)]
// summed over the four taps: the same products, added in another order. In
// f32 the two agree up to the order of summation. In bf16 the TPU path (and
// the plain PyTorch version) rounds the weights to bf16; this kernel keeps
// them, and the accumulation, in f32.
//
// Design and bound. One block per (image, roi); threads run along channels,
// so the reads of feat[b, y, x, :] and the writes of out[b, n, i, j, :] are
// coalesced. At the MIL shapes (100x100x256 map, 2500-2700 rois per image,
// boxes a few cells wide) the pooled output dominates the bytes: the kernel
// is bound by memory traffic, not by its few multiply-adds per output.
// The backward scatters with atomicAdd into a zeroed f32 [B, H, W, C]
// buffer. The order of those additions varies from run to run, so unlike
// the TPU kernel (whose grid runs in order) the backward is NOT
// deterministic: results differ by f32 rounding between runs.
//
// Left for later work: tiling several rois of one group per block so the
// shared group window sits in shared memory (one read of the window per
// group instead of per roi), and a deterministic segmented backward
// (per-group partial sums in shared memory, then one ordered reduction).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kOut = 7;                // pooled size per axis
constexpr int kSmax = 4;               // ADAPTIVE_SMAX of ops/roi_align.py
constexpr int kRows = kOut * kSmax;    // sample rows per axis
constexpr int kThreads = 128;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

struct RoiTable {
    int y0[kRows], y1[kRows], x0[kRows], x1[kRows];
    float wy0[kRows], wy1[kRows], wx0[kRows], wx1[kRows];
    int sn_y, sn_x;
};

// One sample row of one axis. The coordinate arithmetic uses the _rn
// intrinsics so nvcc does not contract it into fused multiply-adds: the
// sample positions then round exactly as in the plain PyTorch version.
__device__ __forceinline__ void axis_sample(float start, float bin, int sn, int size,
                                            int lo, int hi, int row, int* i0, int* i1,
                                            float* w0, float* w1) {
    const int bin_idx = row / kSmax;
    const int k = row % kSmax;
    if (k >= sn) {  // masked sample (k >= sn): never read by the loops below
        i0[row] = lo; i1[row] = lo; w0[row] = 0.f; w1[row] = 0.f;
        return;
    }
    const float off = __fdiv_rn(__fadd_rn(static_cast<float>(k), 0.5f), static_cast<float>(sn));
    const float frac = __fadd_rn(static_cast<float>(bin_idx), off);
    const float c = __fsub_rn(__fadd_rn(start, __fmul_rn(frac, bin)), 0.5f);
    const bool valid = (c >= -1.f) && (c <= static_cast<float>(size));
    const float cc = fminf(fmaxf(c, static_cast<float>(lo)), static_cast<float>(hi));
    const float f = floorf(cc);
    const float l = __fsub_rn(cc, f);
    const int a = static_cast<int>(f);
    i0[row] = a;
    i1[row] = min(a + 1, hi);
    w0[row] = valid ? __fsub_rn(1.f, l) : 0.f;
    w1[row] = valid ? l : 0.f;
}

// Fills the block's shared sample table for roi (b, n); call from every thread.
__device__ __forceinline__ void build_table(RoiTable& t, const float* __restrict__ rois,
                                            const int* __restrict__ clamp, int b, int n,
                                            int N, int H, int W, float scale) {
    const size_t r = (static_cast<size_t>(b) * N + n) * 4;
    const float x1 = __fmul_rn(rois[r + 0], scale);
    const float y1 = __fmul_rn(rois[r + 1], scale);
    const float x2 = __fmul_rn(rois[r + 2], scale);
    const float y2 = __fmul_rn(rois[r + 3], scale);
    const float bin_w = __fdiv_rn(fmaxf(__fsub_rn(x2, x1), 1e-6f), static_cast<float>(kOut));
    const float bin_h = __fdiv_rn(fmaxf(__fsub_rn(y2, y1), 1e-6f), static_cast<float>(kOut));
    const int sn_x = static_cast<int>(fminf(fmaxf(ceilf(bin_w), 1.f), static_cast<float>(kSmax)));
    const int sn_y = static_cast<int>(fminf(fmaxf(ceilf(bin_h), 1.f), static_cast<float>(kSmax)));
    int y_lo = 0, y_hi = H - 1, x_lo = 0, x_hi = W - 1;
    if (clamp != nullptr) {
        y_lo = clamp[r + 0]; y_hi = clamp[r + 1]; x_lo = clamp[r + 2]; x_hi = clamp[r + 3];
    }
    const int tid = threadIdx.x;
    if (tid == 0) { t.sn_y = sn_y; t.sn_x = sn_x; }
    if (tid < kRows) {
        axis_sample(y1, bin_h, sn_y, H, y_lo, y_hi, tid, t.y0, t.y1, t.wy0, t.wy1);
    } else if (tid < 2 * kRows) {
        axis_sample(x1, bin_w, sn_x, W, x_lo, x_hi, tid - kRows, t.x0, t.x1, t.wx0, t.wx1);
    }
    __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
roi_align_fwd_kernel(const T* __restrict__ feat, const float* __restrict__ rois,
                     const int* __restrict__ clamp, T* __restrict__ out,
                     int H, int W, int C, int N, float scale) {
    __shared__ RoiTable t;
    const int n = blockIdx.x;
    const int b = blockIdx.y;
    build_table(t, rois, clamp, b, n, N, H, W, scale);
    const int sn_y = t.sn_y, sn_x = t.sn_x;
    const float inv = 1.f / static_cast<float>(sn_y * sn_x);
    const size_t row_stride = static_cast<size_t>(W) * C;
    const T* fb = feat + static_cast<size_t>(b) * H * row_stride;
    T* ob = out + (static_cast<size_t>(b) * N + n) * (kOut * kOut) * C;

    for (int c = threadIdx.x; c < C; c += blockDim.x) {
        for (int ph = 0; ph < kOut; ++ph) {
            for (int pw = 0; pw < kOut; ++pw) {
                float acc = 0.f;
                for (int sy = 0; sy < sn_y; ++sy) {
                    const int ry = ph * kSmax + sy;
                    const T* r0 = fb + t.y0[ry] * row_stride + c;
                    const T* r1 = fb + t.y1[ry] * row_stride + c;
                    const float a0 = t.wy0[ry], a1 = t.wy1[ry];
                    for (int sx = 0; sx < sn_x; ++sx) {
                        const int rx = pw * kSmax + sx;
                        const size_t o0 = static_cast<size_t>(t.x0[rx]) * C;
                        const size_t o1 = static_cast<size_t>(t.x1[rx]) * C;
                        const float b0 = t.wx0[rx], b1 = t.wx1[rx];
                        acc += a0 * (b0 * load_f32(r0 + o0) + b1 * load_f32(r0 + o1))
                             + a1 * (b0 * load_f32(r1 + o0) + b1 * load_f32(r1 + o1));
                    }
                }
                store_f32(ob + (ph * kOut + pw) * C + c, acc * inv);
            }
        }
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
roi_align_bwd_kernel(const T* __restrict__ dout, const float* __restrict__ rois,
                     const int* __restrict__ clamp, float* __restrict__ dfeat,
                     int H, int W, int C, int N, float scale) {
    __shared__ RoiTable t;
    const int n = blockIdx.x;
    const int b = blockIdx.y;
    build_table(t, rois, clamp, b, n, N, H, W, scale);
    const int sn_y = t.sn_y, sn_x = t.sn_x;
    const float inv = 1.f / static_cast<float>(sn_y * sn_x);
    const size_t row_stride = static_cast<size_t>(W) * C;
    float* db = dfeat + static_cast<size_t>(b) * H * row_stride;
    const T* gb = dout + (static_cast<size_t>(b) * N + n) * (kOut * kOut) * C;

    for (int c = threadIdx.x; c < C; c += blockDim.x) {
        for (int ph = 0; ph < kOut; ++ph) {
            for (int pw = 0; pw < kOut; ++pw) {
                const float g = load_f32(gb + (ph * kOut + pw) * C + c) * inv;
                if (g == 0.f) continue;
                for (int sy = 0; sy < sn_y; ++sy) {
                    const int ry = ph * kSmax + sy;
                    float* r0 = db + t.y0[ry] * row_stride + c;
                    float* r1 = db + t.y1[ry] * row_stride + c;
                    const float a0 = g * t.wy0[ry], a1 = g * t.wy1[ry];
                    if (a0 == 0.f && a1 == 0.f) continue;
                    for (int sx = 0; sx < sn_x; ++sx) {
                        const int rx = pw * kSmax + sx;
                        const size_t o0 = static_cast<size_t>(t.x0[rx]) * C;
                        const size_t o1 = static_cast<size_t>(t.x1[rx]) * C;
                        const float b0 = t.wx0[rx], b1 = t.wx1[rx];
                        if (a0 * b0 != 0.f) atomicAdd(r0 + o0, a0 * b0);
                        if (a0 * b1 != 0.f) atomicAdd(r0 + o1, a0 * b1);
                        if (a1 * b0 != 0.f) atomicAdd(r1 + o0, a1 * b0);
                        if (a1 * b1 != 0.f) atomicAdd(r1 + o1, a1 * b1);
                    }
                }
            }
        }
    }
}

}  // namespace

// Plain C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16
// (feature / pooled values; rois are always f32, clamp int32 or null, dfeat
// f32). Launches on `stream`, allocates nothing, does not synchronise, and
// returns cudaGetLastError() after the launch (0 = success).
extern "C" int pt_roi_align_fwd(const void* feat, const float* rois, const int* clamp,
                                void* out, int dtype, int B, int H, int W, int C, int N,
                                float scale, void* stream) {
    if (N == 0 || B == 0) return 0;
    const dim3 grid(N, B);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) {
        roi_align_fwd_kernel<float><<<grid, kThreads, 0, s>>>(
            static_cast<const float*>(feat), rois, clamp, static_cast<float*>(out),
            H, W, C, N, scale);
    } else if (dtype == 1) {
        roi_align_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
            static_cast<const __nv_bfloat16*>(feat), rois, clamp,
            static_cast<__nv_bfloat16*>(out), H, W, C, N, scale);
    } else {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}

extern "C" int pt_roi_align_bwd(const void* dout, const float* rois, const int* clamp,
                                float* dfeat, int dtype, int B, int H, int W, int C, int N,
                                float scale, void* stream) {
    if (N == 0 || B == 0) return 0;
    const dim3 grid(N, B);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) {
        roi_align_bwd_kernel<float><<<grid, kThreads, 0, s>>>(
            static_cast<const float*>(dout), rois, clamp, dfeat, H, W, C, N, scale);
    } else if (dtype == 1) {
        roi_align_bwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
            static_cast<const __nv_bfloat16*>(dout), rois, clamp, dfeat, H, W, C, N, scale);
    } else {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
