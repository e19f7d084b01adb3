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
// Design and bound. Both kernels are bound by bytes at the SODA-A MIL shapes
// (150x150x256 map, 2500-2700 rois per image): the pooled output (or its
// gradient) is 5-6x the map, and the 4 bilinear multiply-adds of a sample
// and channel take about 2/3 of the bytes' time at the FP32 rate.
//
// Forward (K3): one block per (image, roi). Its threads first fill a shared
// table of the roi's 196 samples: four tap offsets and four tap weights
// (validity folded in). Then threads run along channels, so reads of
// feat[b, y, x, :] and writes of out[b, n, bin, :] are coalesced, and each
// thread sums 4 samples x 4 taps per bin in f32. Weights and the sum stay in
// f32 whatever the feature dtype (the Pallas kernel builds its weights in
// f32 as well, rroi_pallas.py:232-234, then casts them to the feature dtype;
// the shipped XLA path builds them in the feature dtype).
//
// Backward (K4), roi_align_rotated_bwd_windowed_kernel: the TPU kernel adds
// each roi's window gradient W^T @ dout into a resident d/dfeat map; here
// blocks run in parallel, and one global atomicAdd per tap and channel
// (1.0e9 a launch, colliding on the few cells the 25 members of a bag share)
// is what kept the first kernel far above its bound. So the backward works
// on chunks of rois that share one window. One block per (8 consecutive
// rois, image, 32-channel slice) splits its rois where the clamp bounds
// change: a chunk is a bag on its group window (or the part of a bag in the
// block's rois), or one negative on its own window; padded or coincident
// GTs, whose runs reach 1000+ rois, are cut like everything else, so every
// block carries 8 rois and no torch op or host sync finds the chunks. The
// block keeps an f32 tile [window cells <= 256][32 channels] in dynamic
// shared memory, adds every tap of every roi of the chunk into it, and
// flushes the chunk's touched rectangle with one global atomicAdd per
// nonzero (cell, channel), zeroing it again: at most 256 x 32 atomics per
// chunk and slice instead of 196 x 4 x 32 per roi. Its four warps split the
// taps by the parity of the tap's cell (row parity, column parity): the
// 2 x 2 taps of a sample with nonzero weight always lie on distinct cells of
// distinct parity (a tap on the clamp bound has weight 0 and is dropped), so
// each thread owns its (cells, channel) column of the tile: no shared
// atomics, and a fixed order inside a chunk.
// On the card a block-roi is bound by latency and instruction count, not by
// shared-memory bandwidth, so each roi's taps are prepared once per block
// into four lists (build_class_lists): the sample arithmetic
// is the forward's (sample_at), the taps of a bin's four samples that share
// a cell are merged, and each list is in bin order with the end of every
// run of one cell marked. The add loop is then one table read, one dout read
// and one FMA into a register per entry, and one read-modify-write of the
// tile per run (a MIL roi's bin is a fraction of a cell, so runs are long).
// The next roi's dout slice (read as bf16x2 or float2), box and bounds are
// loaded a roi ahead. A chunk whose window exceeds the tile (the Pallas
// window, the whole map) runs the same loop with atomicAdd straight into
// d/dfeat.
// The order of the flush's atomics, where the windows of two chunks overlap,
// varies from run to run, so unlike the TPU kernel the backward is NOT
// deterministic: results differ by f32 rounding between runs.
//
// roi_align_rotated_bwd_kernel, the first backward, stays: one block per
// roi and one atomicAdd per tap and channel into d/dfeat. The wrapper runs
// it for clamp=None (the exact gather over the whole map, which the main path
// never takes), and chip_smoke.py times it beside the windowed kernel.
//
// Left for later work: a tensor-core W^T @ dout, or more channels per
// thread, instead of the list walk (about 10 instructions per entry and 32
// channels, built and walked again by each channel slice); a deterministic
// segmented backward; the same designs for K1-K3.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kOut = 7;                   // pooled size per axis
constexpr int kBins = kOut * kOut;        // bins per roi (49)
constexpr int kRatio = 2;                 // sampling_ratio
constexpr int kAxis = kOut * kRatio;      // samples per axis (14)
constexpr int kSamples = kAxis * kAxis;   // samples per roi (196)
constexpr int kThreads = 128;

// The windowed backward: a block takes kChunk consecutive rois, a tile of
// kTileCells window cells x kSlice channels (one channel per lane), and four
// warps (one per tap parity class).
constexpr int kChunk = 8;
constexpr int kTileCells = 256;
constexpr int kSlice = 32;
constexpr int kWinThreads = 4 * kSlice;
constexpr int kTileBytes = kTileCells * kSlice * 4;
constexpr int kListBytes = 4 * kSamples * 8;
constexpr int kStageBytes = kBins * kSlice * 4;
constexpr int kWinSmem = kTileBytes + kListBytes + kStageBytes;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// One roi in feature cells, its (cos, sin) and its clamp bounds.
struct Roi {
    float cx, cy, bw, bh, cs, sn;
    int y_lo, y_hi, x_lo, x_hi;
};

// One sample's bilinear taps (y0, x0), (y0, x1), (y1, x0), (y1, x1) and
// their weights, validity folded in.
struct Sample {
    int y0, x0, y1, x1;
    float w[4];
};

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

__device__ __forceinline__ Roi load_roi(const float* __restrict__ rrois,
                                        const float* __restrict__ cos_sin,
                                        const int* __restrict__ clamp, size_t r, int H, int W,
                                        float scale) {
    Roi q;
    q.cx = __fmul_rn(rrois[r * 5 + 0], scale);
    q.cy = __fmul_rn(rrois[r * 5 + 1], scale);
    q.bw = __fmul_rn(rrois[r * 5 + 2], scale);
    q.bh = __fmul_rn(rrois[r * 5 + 3], scale);
    q.cs = cos_sin[r * 2 + 0];
    q.sn = cos_sin[r * 2 + 1];
    q.y_lo = 0; q.y_hi = H - 1; q.x_lo = 0; q.x_hi = W - 1;
    if (clamp != nullptr) {
        q.y_lo = clamp[r * 4 + 0]; q.y_hi = clamp[r * 4 + 1];
        q.x_lo = clamp[r * 4 + 2]; q.x_hi = clamp[r * 4 + 3];
    }
    return q;
}

// The sample of roi q at box-frame fractions (u, v) on an H x W map; sample s
// has u = frac_of(s % 14), v = frac_of(s / 14).
__device__ __forceinline__ Sample sample_at(const Roi& q, float u, float v, int H, int W) {
    const float bx = __fmul_rn(u, q.bw);
    const float by = __fmul_rn(v, q.bh);
    const float sx = __fsub_rn(__fadd_rn(__fsub_rn(__fmul_rn(q.cs, bx), __fmul_rn(q.sn, by)),
                                         q.cx), 0.5f);
    const float sy = __fsub_rn(__fadd_rn(__fadd_rn(__fmul_rn(q.sn, bx), __fmul_rn(q.cs, by)),
                                         q.cy), 0.5f);
    const bool valid = (sx >= -1.f) && (sx <= static_cast<float>(W))
                    && (sy >= -1.f) && (sy <= static_cast<float>(H));
    const float yy = fminf(fmaxf(sy, static_cast<float>(q.y_lo)), static_cast<float>(q.y_hi));
    const float xx = fminf(fmaxf(sx, static_cast<float>(q.x_lo)), static_cast<float>(q.x_hi));
    const float fy = floorf(yy);
    const float fx = floorf(xx);
    const float ly = __fsub_rn(yy, fy);
    const float lx = __fsub_rn(xx, fx);
    Sample p;
    p.y0 = static_cast<int>(fy);
    p.x0 = static_cast<int>(fx);
    p.y1 = min(p.y0 + 1, q.y_hi);
    p.x1 = min(p.x0 + 1, q.x_hi);
    const float wy0 = valid ? __fsub_rn(1.f, ly) : 0.f;
    const float wy1 = valid ? ly : 0.f;
    const float wx0 = __fsub_rn(1.f, lx);
    const float wx1 = lx;
    p.w[0] = __fmul_rn(wy0, wx0);
    p.w[1] = __fmul_rn(wy0, wx1);
    p.w[2] = __fmul_rn(wy1, wx0);
    p.w[3] = __fmul_rn(wy1, wx1);
    return p;
}

// Fills the block's shared sample table for roi (b, n); call from every thread.
__device__ __forceinline__ void build_table(SampleTable& t, const float* __restrict__ rrois,
                                            const float* __restrict__ cos_sin,
                                            const int* __restrict__ clamp, int b, int n,
                                            int N, int H, int W, float scale) {
    const Roi q = load_roi(rrois, cos_sin, clamp, static_cast<size_t>(b) * N + n, H, W, scale);
    for (int s = threadIdx.x; s < kSamples; s += blockDim.x) {
        const Sample p = sample_at(q, frac_of(s % kAxis), frac_of(s / kAxis), H, W);
        t.off[s][0] = p.y0 * W + p.x0; t.w[s][0] = p.w[0];
        t.off[s][1] = p.y0 * W + p.x1; t.w[s][1] = p.w[1];
        t.off[s][2] = p.y1 * W + p.x0; t.w[s][2] = p.w[2];
        t.off[s][3] = p.y1 * W + p.x1; t.w[s][3] = p.w[3];
    }
    __syncthreads();
}

// A tap list entry: (cell offset | bin * kSlice << 20, weight bits | end of
// run << 31). The weight is positive, so its sign bit carries the flag.
constexpr unsigned kOffMask = (1u << 20) - 1;
constexpr unsigned kRunEnd = 1u << 31;

// The touched cells of a chunk, window-relative: y0, y1, x0, x1 inclusive.
struct Box {
    int y0, y1, x0, x1;
};

// Builds roi q's tap lists, one per parity class of the tap's cell (row
// parity k >> 1, column parity k & 1): list[k][0..count[k]) in bin order,
// cell offsets (y - oy) * stride + (x - ox), weights / 4 (the bin mean).
// fr[14] holds frac_of(0..13). Grows `box` by the window-relative cells of
// this thread's taps. Call from every thread of the block; the lists are
// complete after the caller's next barrier.
// Pass 1, one thread per sample: list[k][s] = the tap of sample s in class k,
// weight 0 where it has none. Taps of nonzero weight lie on distinct cells
// of a 2 x 2 square (a tap on y1 = y0, the clamp bound, has ly = 0 and
// weight 0, and so has one on x1 = x0), so no two of them share a class.
// Pass 2, warp k for class k, a lane per bin: the bin's four samples s00,
// s00 + 1, s00 + 14, s00 + 15 (s00 = 28 ph + 2 pw) are merged where their
// taps share a cell (weights summed), then the warp compacts all bins'
// entries into the list (a warp scan of the counts) and marks each entry
// whose successor lies on another cell as the end of a run.
__device__ __forceinline__ void build_class_lists(int2 (*list)[kSamples], int* count,
                                                  const float* fr, const Roi& q, int H, int W,
                                                  int oy, int ox, int stride, Box& box) {
    for (int s = threadIdx.x; s < kSamples; s += blockDim.x) {
        const Sample p = sample_at(q, fr[s % kAxis], fr[s / kAxis], H, W);
        #pragma unroll
        for (int k = 0; k < 4; ++k) list[k][s] = make_int2(0, 0);
        #pragma unroll
        for (int k = 0; k < 4; ++k) {
            const int y = (k < 2) ? p.y0 : p.y1;
            const int x = (k & 1) ? p.x1 : p.x0;
            if (p.w[k] != 0.f) {
                list[((y & 1) << 1) | (x & 1)][s] =
                    make_int2((y - oy) * stride + (x - ox), __float_as_int(p.w[k]));
                box.y0 = min(box.y0, y - oy); box.y1 = max(box.y1, y - oy);
                box.x0 = min(box.x0, x - ox); box.x1 = max(box.x1, x - ox);
            }
        }
    }
    __syncthreads();
    const int k = threadIdx.x / 32, lane = threadIdx.x % 32;
    int2* lk = list[k];
    int o[2][4], n[2];
    float w[2][4];
    #pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int bin = lane + 32 * h;
        n[h] = 0;
        #pragma unroll
        for (int j = 0; j < 4; ++j) { o[h][j] = 0; w[h][j] = 0.f; }
        if (bin < kBins) {
            const int s00 = (bin / kOut) * kRatio * kAxis + (bin % kOut) * kRatio;
            const int4 a = *reinterpret_cast<const int4*>(lk + s00);
            const int4 c = *reinterpret_cast<const int4*>(lk + s00 + kAxis);
            o[h][0] = a.x; o[h][1] = a.z; o[h][2] = c.x; o[h][3] = c.z;
            w[h][0] = __int_as_float(a.y); w[h][1] = __int_as_float(a.w);
            w[h][2] = __int_as_float(c.y); w[h][3] = __int_as_float(c.w);
            #pragma unroll
            for (int m = 1; m < 4; ++m) {
                #pragma unroll
                for (int j = 0; j < m; ++j) {
                    if (w[h][m] != 0.f && w[h][j] != 0.f && o[h][m] == o[h][j]) {
                        w[h][j] = __fadd_rn(w[h][j], w[h][m]);
                        w[h][m] = 0.f;
                    }
                }
            }
            #pragma unroll
            for (int pass = 0; pass < 3; ++pass) {
                #pragma unroll
                for (int j = 0; j < 3; ++j) {
                    if (w[h][j] == 0.f && w[h][j + 1] != 0.f) {
                        const int ot = o[h][j]; o[h][j] = o[h][j + 1]; o[h][j + 1] = ot;
                        const float wt = w[h][j]; w[h][j] = w[h][j + 1]; w[h][j + 1] = wt;
                    }
                }
            }
            #pragma unroll
            for (int j = 0; j < 4; ++j) n[h] += w[h][j] != 0.f;
        }
    }
    // positions: bins 0..31 (h = 0) then 32..48 (h = 1), in order
    int pos[2], total = 0;
    #pragma unroll
    for (int h = 0; h < 2; ++h) {
        int incl = n[h];
        #pragma unroll
        for (int d = 1; d < 32; d *= 2) {
            const int v = __shfl_up_sync(0xffffffffu, incl, d);
            if (lane >= d) incl += v;
        }
        pos[h] = total + incl - n[h];
        total += __shfl_sync(0xffffffffu, incl, 31);
    }
    __syncwarp();           // every lane has read its raw entries
    int last_off[2] = {0, 0};
    #pragma unroll
    for (int h = 0; h < 2; ++h) {
        #pragma unroll
        for (int j = 0; j < 4; ++j) {
            if (j < n[h]) {
                last_off[h] = o[h][j];
                const unsigned bin = lane + 32 * h;
                // entries of one bin lie on distinct cells: all but its last end a run
                const unsigned end = (j + 1 < n[h]) ? kRunEnd : 0u;
                lk[pos[h] + j] = make_int2(
                    static_cast<int>(static_cast<unsigned>(o[h][j]) | ((bin * kSlice) << 20)),
                    static_cast<int>(__float_as_uint(__fmul_rn(w[h][j], 0.25f)) | end));
            }
        }
    }
    __syncwarp();
    // the last entry of a bin ends a run unless the next entry is on its cell
    bool ends[2];
    #pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int last = pos[h] + n[h] - 1;
        ends[h] = n[h] > 0 && (last + 1 >= total
            || ((static_cast<unsigned>(lk[last + 1].x) ^ static_cast<unsigned>(last_off[h]))
                & kOffMask) != 0);
    }
    __syncwarp();
    #pragma unroll
    for (int h = 0; h < 2; ++h) {
        if (ends[h]) {
            int2& e = lk[pos[h] + n[h] - 1];
            e.y = static_cast<int>(static_cast<unsigned>(e.y) | kRunEnd);
        }
    }
    if (lane == 0) count[k] = total;
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

// Adds one roi's tap list of one parity class (m entries) times its staged
// dout (column `lane`) into acc[offset * stride]: the block's tile (kTiled: a
// plain read-modify-write, since this thread owns the column) or d/dfeat
// (atomics). A run of entries on one cell is summed in a register and meets
// the memory once, at its end.
template <bool kTiled>
__device__ __forceinline__ void add_list(float* __restrict__ acc, int stride,
                                         const int2* __restrict__ lk, int m,
                                         const float* __restrict__ stage, int lane) {
    float val = 0.f;
    #pragma unroll 4
    for (int i = 0; i < m; ++i) {
        const int2 e = lk[i];
        const unsigned x = static_cast<unsigned>(e.x);
        val = fmaf(stage[(x >> 20) + lane], fabsf(__int_as_float(e.y)), val);
        if (e.y < 0) {              // the end of a run
            float* p = acc + static_cast<size_t>(x & kOffMask) * stride;
            if constexpr (kTiled) *p += val;
            else atomicAdd(p, val);
            val = 0.f;
        }
    }
}

template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<__nv_bfloat16> { using type = __nv_bfloat162; };
__device__ __forceinline__ float2 to_f32x2(float2 v) { return v; }
__device__ __forceinline__ float2 to_f32x2(__nv_bfloat162 v) { return __bfloat1622float2(v); }

// What a thread loads ahead for the next roi: its share of the roi's dout
// slice [49 bins][kSlice channels] as raw pairs (kept unconverted, so the
// loads stay in flight), the box, (cos, sin) and clamp bounds.
constexpr int kPairs = kBins * kSlice / 2;
constexpr int kPairsPerThread = (kPairs + kWinThreads - 1) / kWinThreads;

template <typename T>
struct Ahead {
    typename Pair<T>::type g[kPairsPerThread];
    float box[4], cs, sn;
    int4 bounds;
};

template <typename T>
__device__ __forceinline__ void load_ahead(Ahead<T>& a, const T* __restrict__ dout,
                                           const float* __restrict__ rrois,
                                           const float* __restrict__ cos_sin,
                                           const int4* __restrict__ bounds, size_t r, int C,
                                           int c0) {
    const T* gb = dout + r * kBins * C;
    #pragma unroll
    for (int k = 0; k < kPairsPerThread; ++k) {
        const int i = threadIdx.x + k * kWinThreads;
        const int bin = i / (kSlice / 2), c = c0 + 2 * (i % (kSlice / 2));
        a.g[k] = typename Pair<T>::type{};
        if (i < kPairs && c < C) {
            const T* p = gb + bin * C + c;
            if ((C & 1) == 0) {
                a.g[k] = *reinterpret_cast<const typename Pair<T>::type*>(p);
            } else {
                a.g[k].x = p[0];
                if (c + 1 < C) a.g[k].y = p[1];
            }
        }
    }
    #pragma unroll
    for (int k = 0; k < 4; ++k) a.box[k] = rrois[r * 5 + k];
    a.cs = cos_sin[r * 2 + 0];
    a.sn = cos_sin[r * 2 + 1];
    a.bounds = bounds[r];
}

// d/dfeat by chunks of rois that share one window (the header's design).
// Grid (ceil(N / kChunk), B, channel slices): a block takes kChunk
// consecutive rois of image blockIdx.y and splits them into chunks where the
// clamp bounds change. Blocks are issued in blockIdx.x order and the MIL
// stage appends its negatives (large boxes, one window each: the slowest
// blocks), so block x takes the x-th group of rois from the end. Each roi's
// dout, box and bounds are loaded one roi ahead.
template <typename T>
__global__ void __launch_bounds__(kWinThreads)
roi_align_rotated_bwd_windowed_kernel(const T* __restrict__ dout,
                                      const float* __restrict__ rrois,
                                      const float* __restrict__ cos_sin,
                                      const int* __restrict__ clamp,
                                      float* __restrict__ dfeat, int H, int W, int C, int N,
                                      float scale) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ float fr[kAxis];
    __shared__ int count[4];
    __shared__ Box boxes[4];
    float* tile = reinterpret_cast<float*>(smem);
    int2 (*list)[kSamples] = reinterpret_cast<int2 (*)[kSamples]>(smem + kTileBytes);
    float* stage = reinterpret_cast<float*>(smem + kTileBytes + kListBytes);

    if (threadIdx.x < kAxis) fr[threadIdx.x] = frac_of(threadIdx.x);
    for (int i = threadIdx.x; i < kTileCells * kSlice / 4; i += blockDim.x) {
        reinterpret_cast<float4*>(tile)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    const int b = blockIdx.y;
    const int c0 = blockIdx.z * kSlice;
    const int lane = threadIdx.x % kSlice;
    const int cls = threadIdx.x / kSlice;
    const bool live = c0 + lane < C;
    const int4* bounds = reinterpret_cast<const int4*>(clamp);
    const size_t rb = static_cast<size_t>(b) * N;
    float* db = dfeat + static_cast<size_t>(b) * H * W * C + c0;

    int n = (gridDim.x - 1 - blockIdx.x) * kChunk;
    const int n_end = min(n + kChunk, N);
    Ahead<T> ahead;
    load_ahead(ahead, dout, rrois, cos_sin, bounds, rb + n, C, c0);
    while (n < n_end) {
        const int4 win = ahead.bounds;      // (y_lo, y_hi, x_lo, x_hi) of the chunk
        const int wh = win.y - win.x + 1, ww = win.w - win.z + 1;
        const bool tiled = wh >= 1 && ww >= 1 && wh * ww <= kTileCells;
        Box box = {kTileCells, -1, kTileCells, -1};
        bool same;
        do {
            __syncthreads();    // the tile is flushed; the last roi's lists and dout are used
            #pragma unroll
            for (int k = 0; k < kPairsPerThread; ++k) {
                const int i = threadIdx.x + k * kWinThreads;
                if (i < kPairs) {
                    *reinterpret_cast<float2*>(stage + 2 * i) = to_f32x2(ahead.g[k]);
                }
            }
            Roi q;
            q.cx = __fmul_rn(ahead.box[0], scale);
            q.cy = __fmul_rn(ahead.box[1], scale);
            q.bw = __fmul_rn(ahead.box[2], scale);
            q.bh = __fmul_rn(ahead.box[3], scale);
            q.cs = ahead.cs;
            q.sn = ahead.sn;
            q.y_lo = win.x; q.y_hi = win.y; q.x_lo = win.z; q.x_hi = win.w;
            ++n;
            if (n < n_end) load_ahead(ahead, dout, rrois, cos_sin, bounds, rb + n, C, c0);
            if (tiled) build_class_lists(list, count, fr, q, H, W, win.x, win.z, ww, box);
            else build_class_lists(list, count, fr, q, H, W, 0, 0, W, box);
            __syncthreads();
            if (live) {
                if (tiled) add_list<true>(tile + lane, kSlice, list[cls], count[cls], stage, lane);
                else add_list<false>(db + lane, C, list[cls], count[cls], stage, lane);
            }
            same = n < n_end && ahead.bounds.x == win.x && ahead.bounds.y == win.y
                && ahead.bounds.z == win.z && ahead.bounds.w == win.w;
        } while (same);
        if (!tiled) continue;
        // the chunk's touched cells: reduce the threads' boxes
        box.y0 = __reduce_min_sync(0xffffffffu, box.y0);
        box.y1 = __reduce_max_sync(0xffffffffu, box.y1);
        box.x0 = __reduce_min_sync(0xffffffffu, box.x0);
        box.x1 = __reduce_max_sync(0xffffffffu, box.x1);
        if (lane == 0) boxes[cls] = box;
        __syncthreads();        // every roi of the chunk is in the tile
        #pragma unroll
        for (int k = 0; k < 4; ++k) {
            box.y0 = min(box.y0, boxes[k].y0); box.y1 = max(box.y1, boxes[k].y1);
            box.x0 = min(box.x0, boxes[k].x0); box.x1 = max(box.x1, boxes[k].x1);
        }
        // warp `cls` flushes rows y0 + cls, y0 + cls + 4, ... and zeroes them again
        for (int y = box.y0 + cls; y <= box.y1; y += 4) {
            float* row = tile + y * ww * kSlice + lane;
            float* grow = db + (static_cast<size_t>(win.x + y) * W + win.z) * C + lane;
            #pragma unroll 4
            for (int x = box.x0; x <= box.x1; ++x) {
                const float v = row[x * kSlice];
                row[x * kSlice] = 0.f;
                if (v != 0.f && live) atomicAdd(grow + static_cast<size_t>(x) * C, v);
            }
        }
    }
}

template <typename T>
int launch_bwd_windowed(const void* dout, const float* rrois, const float* cos_sin,
                        const int* clamp, float* dfeat, int B, int H, int W, int C, int N,
                        float scale, cudaStream_t s) {
    auto kernel = roi_align_rotated_bwd_windowed_kernel<T>;
    // Needed above 48 KB of dynamic shared memory; harmless below.
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWinSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((N + kChunk - 1) / kChunk, B, (C + kSlice - 1) / kSlice);
    kernel<<<grid, kWinThreads, kWinSmem, s>>>(static_cast<const T*>(dout), rrois, cos_sin,
                                               clamp, dfeat, H, W, C, N, scale);
    return static_cast<int>(cudaGetLastError());
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

// The atomic backward (clamp may be null: the whole map).
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

// The windowed backward: clamp [B, N, 4] is required.
extern "C" int pt_roi_align_rotated_bwd_windowed(const void* dout, const float* rrois,
                                                 const float* cos_sin, const int* clamp,
                                                 float* dfeat, int dtype, int B, int H, int W,
                                                 int C, int N, float scale, void* stream) {
    if (N == 0 || B == 0) return 0;
    // clamp is required; list entries keep a cell offset in 20 bits
    if (clamp == nullptr || static_cast<long>(H) * W > static_cast<long>(kOffMask)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) {
        return launch_bwd_windowed<float>(dout, rrois, cos_sin, clamp, dfeat, B, H, W, C, N,
                                          scale, s);
    }
    if (dtype == 1) {
        return launch_bwd_windowed<__nv_bfloat16>(dout, rrois, cos_sin, clamp, dfeat, B, H, W,
                                                  C, N, scale, s);
    }
    return static_cast<int>(cudaErrorInvalidValue);
}

// The windowed backward's layout: info[0..5] = rois per block, tile cells,
// channels per block, threads per block, dynamic shared memory bytes,
// resident blocks per SM (bf16, on the current device). Returns a CUDA
// error code.
extern "C" int pt_roi_align_rotated_bwd_windowed_info(int* info) {
    int per_sm = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, roi_align_rotated_bwd_windowed_kernel<__nv_bfloat16>, kWinThreads, kWinSmem);
    info[0] = kChunk;
    info[1] = kTileCells;
    info[2] = kSlice;
    info[3] = kWinThreads;
    info[4] = kWinSmem;
    info[5] = per_sm;
    return static_cast<int>(err);
}
