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
// Design and bound. At the MIL shapes (100x100x256 map, 2500-2700 rois per
// image, boxes a few cells wide) the pooled output (or its gradient) is 6x
// the map: both kernels are bound by memory traffic, not by their few
// multiply-adds per output.
//
// Forward (K1), roi_align_fwd_kernel. Its bound is the pooled write: 125 MB
// a launch in bf16, 0.04 ms at 3.35 TB/s. The first kernel (a block per roi
// and a barrier, one channel a thread, 2-byte loads and stores, run-time
// sampling loops with 4 loads in flight) ran 9-10x above it, bound by the
// latency of its dependent loads. This one:
// - takes a warp per roi and 8 consecutive rois (mostly members of one bag,
//   which share their cells) a block, with no block barrier;
// - gives each lane 8 channels in bf16 (4 in f32), read and written as one
//   16-byte vector, so one warp covers 256 channels in one pass; the stores
//   are streaming stores (evict first: the output is written once and not
//   read again here), which alone halved the time of the writes;
// - uses the separable weights as the TPU kernel does (out = Wy F Wx^T):
//   14 lanes list each bin's distinct cells along one axis with the
//   samples' weights summed and divided by sn (walk_bin, shared with the
//   windowed backward's tables), and bin (i, j) is the sum over its y list
//   and x list of Wy Wx F: 4 terms for a bag member (sn = 1), at most 64;
// - streams each roi's terms bin after bin (stream_sum), the loads
//   of the next 2-4 terms in flight while the current ones are added, so a
//   bin's latency is hidden behind its neighbours';
// - starts with the last roi groups, the MIL stage's negatives (large boxes,
//   the most terms a bin).
// C must be a multiple of 8 (the wrapper raises otherwise).
//
// Backward (K2), roi_align_bwd_windowed_kernel: the TPU kernel contracts
// d/dfeat = sum_n Wy_n^T dout_n Wx_n with two matmuls per roi chunk into a
// resident d/dfeat map; here blocks run in parallel, and the first kernel's
// one global atomicAdd per tap and channel (the 25 members of a bag pile
// theirs on the same dozen cells) kept it 18-20x above its bound. So the
// backward works on chunks of rois that share one window.
// - Work: an item is 8 consecutive rois of one image and a 32-channel
//   slice, split where the clamp bounds change: a chunk is a bag on its
//   group window (or the part of a bag in the item); runs of padded or
//   coincident GTs, which share one window, are cut like everything else,
//   so no torch op or host sync finds the chunks. A persistent grid, 2
//   blocks an SM, walks the items, the last roi groups first (the
//   negatives, the largest boxes, come last).
// - Tile: a block keeps an f32 tile of the window (up to 24 x 24 cells, the
//   HBB group window, x 32 channels) in dynamic shared memory, zeroed once:
//   every chunk's flush zeroes what it wrote.
// - Tables: per item, a half warp per roi builds the roi's two axis tables
//   (from a box and bounds loaded while the previous item was added): Wy
//   (Wx) restricted to the cells the roi's samples touch (at most 7 bins x
//   8 taps), one row of 7 bin weights per cell, sample weights summed and
//   divided by sn as _axis_weights does.
// - Add: per roi and channel, x and then y, the separable form of the TPU
//   kernel:
//     tmp[i][x] = sum_j Wx[j][x] dout[i][j],  tile[y][x] += sum_i Wy[i][y] tmp[i][x]
//   (a bag member's support is ~4 x 4 cells: ~150 multiply-adds and <= 16
//   tile read-modify-writes per channel, against 196 global atomics). Warp
//   k takes the table's x cells k, k + 4, ...; the lanes own channels, so
//   every thread owns its (cells, channel) words of the tile: no shared
//   atomics. Each roi's dout slice is copied with cp.async into a ring of
//   stages one or two rois ahead (across items), so a roi's turn is its add
//   and one barrier.
// - Flush: at the end of a chunk the block adds the touched rectangle into
//   d/dfeat with one global atomicAdd per nonzero (cell, channel). A chunk
//   whose window exceeds the tile (the negatives' whole-map bounds, a
//   32-cell window) adds straight into d/dfeat with atomics instead.
// On the card the kernel is bound by the latency of each block's serial
// steps (the tables' build, each roi's add and barrier) at 2 blocks of 4
// warps an SM (the 72 KB tile), not by the 125 MB of dout. The order of the
// flush's atomics, where the windows of two chunks overlap, varies from run
// to run, so unlike the TPU kernel the backward is NOT deterministic:
// results differ by f32 rounding between runs.
//
// roi_align_bwd_kernel, the first backward, stays: one block per roi and
// one atomicAdd per tap and channel into d/dfeat. The wrapper runs it for
// clamp=None (roi_align_matmul over the whole map, which the main path never
// takes), and chip_smoke.py times it beside the windowed kernel.
//
// Left for later work, for the windowed backward: warp-specialised stages
// without a barrier per roi (each warp owning tile columns, mbarriers on the
// dout ring) and a deterministic segmented pass.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstddef>

#include "vec16.cuh"

namespace {

constexpr int kOut = 7;                // pooled size per axis
constexpr int kSmax = 4;               // ADAPTIVE_SMAX of ops/roi_align.py
constexpr int kRows = kOut * kSmax;    // sample rows per axis
constexpr int kThreads = 128;

// The windowed backward: a work item is kChunk consecutive rois and kSlice
// channels (one channel per lane); a block has kWarps warps and a tile of
// kTileSide x kTileSide window cells. An axis table has a row per distinct
// cell the roi's samples touch: at most 7 bins x 2 taps x ADAPTIVE_SMAX
// samples. The tables of an item's rois take 8 x 3,584 bytes.
constexpr int kChunk = 8;
constexpr int kTileSide = 24;
constexpr int kSlice = 32;
constexpr int kWarps = 4;
constexpr int kWinThreads = kWarps * 32;
constexpr int kBins = kOut * kOut;
constexpr int kTabRows = kOut * 2 * kSmax;
constexpr int kTileBytes = kTileSide * kTileSide * kSlice * 4;
constexpr int kStageElems = kBins * kSlice;              // one roi's dout slice
constexpr int kTabBytes = 2 * kTabRows * 8 * 4;          // both axes, 8 words a row
// dout slices in flight: 3 stages in bf16, 2 in f32 (2 blocks fit an SM)
template <typename T> constexpr int kStages = sizeof(T) == 2 ? 3 : 2;
template <typename T>
constexpr int kWinSmem = kTileBytes + kStages<T> * kStageElems * sizeof(T) + kChunk * kTabBytes;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }

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

// ---------------------------------------------------------------------------
// The windowed backward (the header's design).
// ---------------------------------------------------------------------------

// Copies roi r's dout slice [49 bins][kSlice channels] into a stage of raw
// T values with cp.async (16 bytes a copy, zero-filled past C, in flight
// while the block works), or, where rows of dout are not 16-byte aligned,
// with plain loads and stores.
template <typename T>
__device__ __forceinline__ void copy_slice(T* __restrict__ stage, const T* __restrict__ dout,
                                           size_t r, int C, int c0) {
    constexpr int kVec = 16 / sizeof(T);                 // values a copy
    constexpr int kCopies = kBins * kSlice / kVec;
    const T* gb = dout + r * kBins * C + c0;
    if (C % kVec == 0 && reinterpret_cast<size_t>(dout) % 16 == 0) {
        for (int i = threadIdx.x; i < kCopies; i += kWinThreads) {
            const int bin = i / (kSlice / kVec), c = (i % (kSlice / kVec)) * kVec;
            const T* src = gb + bin * C + c;
            const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(stage + i * kVec));
            const int bytes = c0 + c < C ? 16 : 0;
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                         :: "r"(dst), "l"(bytes ? src : gb), "r"(bytes));
        }
    } else {
        for (int i = threadIdx.x; i < kBins * kSlice; i += kWinThreads) {
            const int bin = i / kSlice, c = i % kSlice;
            stage[i] = c0 + c < C ? gb[bin * C + c] : T(0.f);
        }
    }
}

__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int kPending>
__device__ __forceinline__ void copy_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending));
}

// A window (y_lo, y_hi, x_lo, x_hi) fits the tile.
__device__ __forceinline__ bool fits_tile(int4 w) {
    const int wh = w.y - w.x + 1, ww = w.w - w.z + 1;
    return wh >= 1 && ww >= 1 && wh <= kTileSide && ww <= kTileSide;
}

__device__ __forceinline__ bool same_bounds(int4 a, int4 b) {
    return a.x == b.x && a.y == b.y && a.z == b.z && a.w == b.w;
}

// One axis table: row p = (bin weights w[0..6], cell), 8 words.
using AxisTable = float4[kTabRows][2];

// The taps of one bin's samples, k < sn: floor cell a[k], second cell
// a2[k] = min(a[k] + 1, hi), weights w0[k], w1[k] (validity folded in).
struct BinTaps {
    int a[kSmax], a2[kSmax];
    float w0[kSmax], w1[kSmax];
    int sn;
};

// One axis of a roi: start, bin size, sn and the clamp bounds; sample
// (bin j, k) as axis_sample computes it: floor cell, second cell, weights.
struct Axis {
    float start, bin;
    int sn, size, lo, hi;

    __device__ __forceinline__ void sample(int j, int k, int& a, int& a2, float& w0,
                                           float& w1) const {
        const float off = __fdiv_rn(__fadd_rn(static_cast<float>(k), 0.5f),
                                    static_cast<float>(sn));
        const float frac = __fadd_rn(static_cast<float>(j), off);
        const float c = __fsub_rn(__fadd_rn(start, __fmul_rn(frac, bin)), 0.5f);
        const bool valid = (c >= -1.f) && (c <= static_cast<float>(size)) && j < kOut;
        const float cc = fminf(fmaxf(c, static_cast<float>(lo)), static_cast<float>(hi));
        const float f = floorf(cc);
        const float l = __fsub_rn(cc, f);
        a = static_cast<int>(f);
        a2 = min(a + 1, hi);
        w0 = valid ? __fsub_rn(1.f, l) : 0.f;
        w1 = valid ? l : 0.f;
    }
};

// Axis a (0: y, 1: x) of a roi: box (x1, y1, x2, y2) in image px, bounds w
// (y_lo, y_hi, x_lo, x_hi) in cells.
__device__ __forceinline__ Axis make_axis(int a, float4 box, int4 w, int H, int W, float scale) {
    Axis ax;
    ax.start = __fmul_rn(a == 0 ? box.y : box.x, scale);
    const float end = __fmul_rn(a == 0 ? box.w : box.z, scale);
    ax.bin = __fdiv_rn(fmaxf(__fsub_rn(end, ax.start), 1e-6f), static_cast<float>(kOut));
    ax.sn = static_cast<int>(fminf(fmaxf(ceilf(ax.bin), 1.f), static_cast<float>(kSmax)));
    ax.size = a == 0 ? H : W;
    ax.lo = a == 0 ? w.x : w.z;
    ax.hi = a == 0 ? w.y : w.w;
    return ax;
}

// Calls emit(cell, weight) for each distinct cell of the bin's taps, in
// increasing cell order, weights summed in sample order. Sample floors never
// decrease and step by at most one cell, or jump past the last cell, so
// two accumulators (the current floor cell and the one above) suffice.
template <typename Emit>
__device__ __forceinline__ void walk_bin(const BinTaps& t, Emit emit) {
    int lc = t.a[0], hc = t.a2[0];
    float lw = t.w0[0], hw = t.w1[0];
    bool has_h = hc != lc;
    if (!has_h) lw = __fadd_rn(lw, hw);
    #pragma unroll
    for (int k = 1; k < kSmax; ++k) {
        if (k < t.sn) {
            const int a = t.a[k], a2 = t.a2[k];
            const float w0 = t.w0[k], w1 = t.w1[k];
            if (a == lc) {                      // the same floor cell
                lw = __fadd_rn(lw, w0);
                if (a2 == a) lw = __fadd_rn(lw, w1);
                else if (has_h) hw = __fadd_rn(hw, w1);
                else { hc = a2; hw = w1; has_h = true; }
            } else {
                emit(lc, lw);
                if (has_h && a == hc) {         // one cell up
                    lc = hc; lw = __fadd_rn(hw, w0);
                } else {                        // past the last cell
                    if (has_h) emit(hc, hw);
                    lc = a; lw = w0;
                }
                has_h = a2 != a;
                if (has_h) { hc = a2; hw = w1; }
                else lw = __fadd_rn(lw, w1);
            }
        }
    }
    emit(lc, lw);
    if (has_h) emit(hc, hw);
}

// Builds one axis table (rows at tb) for lane j (bin j; j = 7 idles) of an
// 8-lane segment (mask `seg`) and returns its row count: a row per distinct
// cell of the roi's taps. Sample cells never decrease along an axis (c grows
// with the sample index and clamping keeps the order), so a cell of bin j
// that an earlier bin has is one of bin j-1's last two cells (its last floor
// L-1 and its last cell L). A bin counts its cells above L as new rows; a
// segmented scan over the bins gives each bin its first new row. Each bin
// then writes its column of the rows (zero outside its cells) and the cell
// of each row it adds.
__device__ __forceinline__ int build_axis(float* tb, const Axis& ax, int j, int origin,
                                          unsigned seg) {
    BinTaps t;
    t.sn = ax.sn;
    #pragma unroll
    for (int k = 0; k < kSmax; ++k) ax.sample(j, k, t.a[k], t.a2[k], t.w0[k], t.w1[k]);
    int last = t.a2[0];
    #pragma unroll
    for (int k = 1; k < kSmax; ++k) {
        if (k < t.sn) last = t.a2[k];
    }
    int prev_last = __shfl_up_sync(seg, last, 1, 8);
    if (j == 0) prev_last = INT_MIN;
    int fresh = 0;
    walk_bin(t, [&](int x, float) { fresh += x > prev_last; });
    if (j == kOut) fresh = 0;
    int incl = fresh;
    #pragma unroll
    for (int d = 1; d < 8; d *= 2) {
        const int v = __shfl_up_sync(seg, incl, d, 8);
        if (j >= d) incl += v;
    }
    const int first_new = incl - fresh;
    const int rows = __shfl_sync(seg, incl, kOut - 1, 8);
    if (j < kOut) {
        int next = first_new, first = -1, end = 0;
        walk_bin(t, [&](int x, float wsum) {
            int p;
            if (x <= prev_last) {
                p = first_new - 1 - (prev_last - x);     // a cell of bin j-1
            } else {
                p = next++;
                tb[p * 8 + 7] = __int_as_float(x - origin);
            }
            tb[p * 8 + j] = __fdiv_rn(wsum, static_cast<float>(ax.sn));   // as _axis_weights
            if (first < 0) first = p;
            end = p;
        });
        for (int p = 0; p < rows; ++p) {
            if (p < first || p > end) tb[p * 8 + j] = 0.f;
        }
    }
    return rows;
}

// Builds a roi's two axis tables (tab[0]: y, tab[1]: x) and their row counts
// (cnt[0], cnt[1]): one row per cell the roi's samples touch, holding the
// cell's weight in each of the 7 bins (Wy or Wx restricted to those cells)
// and the cell, window-relative for a tiled window, absolute otherwise.
// Call from the 16 lanes of one half warp: lane 16h + 8a + j takes bin j
// (j = 7 idles) of axis a.
__device__ __forceinline__ void build_tables(AxisTable* tab, int* cnt, float4 box, int4 w,
                                             bool tiled, int H, int W, float scale, int lane) {
    const int a = (lane >> 3) & 1, j = lane & 7;
    const Axis ax = make_axis(a, box, w, H, W, scale);
    float* tb = reinterpret_cast<float*>(tab[a]);
    const int origin = tiled ? ax.lo : 0;
    const int rows = build_axis(tb, ax, j, origin, 0xffu << (lane & ~7));
    if (j == 0) cnt[a] = rows;
}

// Adds stream_sum's group of kDepth loaded terms, storing each output whose
// last term it adds.
template <typename T, int kDepth>
__device__ __forceinline__ void consume(float* acc, T*& out, int stride,
                                        const uint4 (&v)[kDepth], const float (&w)[kDepth],
                                        const bool (&end)[kDepth], const bool (&has)[kDepth]) {
    #pragma unroll
    for (int u = 0; u < kDepth; ++u) {
        if (has[u]) {
            vec16::madd<T>(acc, v[u], w[u]);
            if (end[u]) {
                vec16::store(out, acc);
                out += stride;
                #pragma unroll
                for (int k = 0; k < vec16::kVec<T>; ++k) acc[k] = 0.f;
            }
        }
    }
}

// Sums a stream of terms (a cell's vector times a weight) into consecutive
// outputs, each stored to out, out + stride, ... as its last term is added.
// fetch(v, w, end) starts the load of the next term and returns false past
// the last one; `end` marks the last term of an output. The loads run
// kDepth to 2 kDepth terms ahead of their multiply-adds, across outputs, so
// a warp keeps loads in flight whatever the number of terms an output has.
template <typename T, int kDepth, typename Fetch>
__device__ __forceinline__ void stream_sum(Fetch&& fetch, T* out, int stride) {
    uint4 va[kDepth], vb[kDepth];
    float wa[kDepth], wb[kDepth];
    bool ea[kDepth], eb[kDepth], ha[kDepth], hb[kDepth];
    float acc[vec16::kVec<T>];
    #pragma unroll
    for (int k = 0; k < vec16::kVec<T>; ++k) acc[k] = 0.f;
    #pragma unroll
    for (int u = 0; u < kDepth; ++u) ha[u] = fetch(va[u], wa[u], ea[u]);
    while (ha[0]) {
        #pragma unroll
        for (int u = 0; u < kDepth; ++u) hb[u] = fetch(vb[u], wb[u], eb[u]);
        consume<T, kDepth>(acc, out, stride, va, wa, ea, ha);
        if (!hb[0]) break;
        #pragma unroll
        for (int u = 0; u < kDepth; ++u) ha[u] = fetch(va[u], wa[u], ea[u]);
        consume<T, kDepth>(acc, out, stride, vb, wb, eb, hb);
    }
}

// Horizontal RoIAlign forward (the header's design): a warp per roi,
// kFwdWarps consecutive rois of one image a block, no block barrier. Lane
// 7a + j (a < 2) lists bin j's taps along axis a: each distinct cell of its
// samples with the weights summed (walk_bin, as the windowed backward's
// tables) and divided by sn, the cells as element offsets y * W * C and
// x * C. The warp then streams, bin by bin, the terms Wy[i][y] Wx[j][x]
// F[y][x] over the two lists (stream_sum), each lane kVec<T> channels as one
// 16-byte vector per cell, loads kDepth to 2 kDepth terms ahead of their
// multiply-adds across bins. Blocks take the groups of rois from the end
// (the MIL stage appends its negatives, the largest boxes with the most
// terms a bin).
constexpr int kFwdWarps = 8;
constexpr int kFwdThreads = kFwdWarps * 32;
constexpr int kDepth = 2;
constexpr int kAxisTaps = 2 * kSmax;     // distinct cells of a bin's samples, one axis

template <typename T>
__global__ void __launch_bounds__(kFwdThreads)
roi_align_fwd_kernel(const T* __restrict__ feat, const float* __restrict__ rois,
                     const int* __restrict__ clamp, T* __restrict__ out,
                     int H, int W, int C, int N, float scale) {
    constexpr int kVec = vec16::kVec<T>;
    __shared__ int2 taps[kFwdWarps][2][kOut][kAxisTaps];     // (y W C or x C, weight bits)
    __shared__ int counts[kFwdWarps][2][kOut];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int b = blockIdx.y;
    const int n = (gridDim.x - 1 - blockIdx.x) * kFwdWarps + warp;
    if (n >= N) return;
    const size_t r = static_cast<size_t>(b) * N + n;
    if (lane < 2 * kOut) {
        const int a = lane / kOut, j = lane % kOut;
        const float4 box = make_float4(rois[r * 4 + 0], rois[r * 4 + 1], rois[r * 4 + 2],
                                       rois[r * 4 + 3]);
        int4 bnd = make_int4(0, H - 1, 0, W - 1);
        if (clamp != nullptr) {
            bnd = make_int4(clamp[r * 4 + 0], clamp[r * 4 + 1], clamp[r * 4 + 2],
                            clamp[r * 4 + 3]);
        }
        const Axis ax = make_axis(a, box, bnd, H, W, scale);
        BinTaps t;
        t.sn = ax.sn;
        #pragma unroll
        for (int k = 0; k < kSmax; ++k) ax.sample(j, k, t.a[k], t.a2[k], t.w0[k], t.w1[k]);
        int2* list = taps[warp][a][j];
        int m = 0;
        walk_bin(t, [&](int cell, float wsum) {
            list[m++] = make_int2((a == 0 ? cell * W : cell) * C,     // weight as _axis_weights
                                  __float_as_int(__fdiv_rn(wsum, static_cast<float>(ax.sn))));
        });
        counts[warp][a][j] = m;
    }
    __syncwarp();
    const T* fb = feat + static_cast<size_t>(b) * H * W * C;
    T* ob = out + r * kBins * C;
    const int2 (*ty)[kAxisTaps] = taps[warp][0];
    const int2 (*tx)[kAxisTaps] = taps[warp][1];
    const int* ny = counts[warp][0];
    const int* nx = counts[warp][1];
    for (int g = lane * kVec; g < C; g += 32 * kVec) {
        const T* fg = fb + g;
        // the next term: bin (i, j), its yy-th y tap and xx-th x tap
        int i = 0, j = 0, yy = 0, xx = 0, my = ny[0], mx = nx[0];
        int2 ey = ty[0][0];
        stream_sum<T, kDepth>([&](uint4& v, float& w, bool& end) {
            if (i >= kOut) return false;
            const int2 ex = tx[j][xx];
            w = __int_as_float(ey.y) * __int_as_float(ex.y);
            v = vec16::load(fg + (ey.x + ex.x));
            end = false;
            if (++xx == mx) {
                xx = 0;
                if (++yy == my) {
                    yy = 0;
                    end = true;
                    if (++j == kOut) {
                        j = 0;
                        ++i;
                        my = ny[min(i, kOut - 1)];
                    }
                    mx = nx[j];
                }
                ey = ty[min(i, kOut - 1)][yy];
            }
            return true;
        }, ob + g, C);
    }
}

// Adds one roi into acc: warp `warp` takes the x rows warp, warp + kWarps,
// ...; per x row and channel (lane) it contracts the roi's staged dout with
// the row's bin weights (tmp[i], 7 values), then adds sum_i Wy[i][y] tmp[i]
// at every y row, four rows at a time (their loads before their stores: the
// rows are distinct cells): into the tile (kTiled: a plain read-modify-write,
// since this thread owns the words of its x cells and channel) or into
// d/dfeat (atomics).
template <bool kTiled, typename T>
__device__ __forceinline__ void add_roi(const T* __restrict__ st, const AxisTable& ty,
                                        const AxisTable& tx, int ny, int nx,
                                        float* __restrict__ acc, int W, int C, int warp,
                                        int lane, bool live) {
    constexpr int kRowBatch = 4;
    for (int p = warp; p < nx; p += kWarps) {
        const float4 xa = tx[p][0], xb = tx[p][1];
        const float wx[kOut] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z};
        const int x = __float_as_int(xb.w);
        float tmp[kOut];
        #pragma unroll
        for (int i = 0; i < kOut; ++i) {
            float v = 0.f;
            #pragma unroll
            for (int jj = 0; jj < kOut; ++jj) {
                v = fmaf(wx[jj], load_f32(st + (i * kOut + jj) * kSlice + lane), v);
            }
            tmp[i] = v;
        }
        for (int q0 = 0; q0 < ny; q0 += kRowBatch) {
            float v[kRowBatch];
            float* dst[kRowBatch];
            #pragma unroll
            for (int u = 0; u < kRowBatch; ++u) {
                const int q = min(q0 + u, ny - 1);
                const float4 ya = ty[q][0], yb = ty[q][1];
                float s = ya.x * tmp[0];
                s = fmaf(ya.y, tmp[1], s);
                s = fmaf(ya.z, tmp[2], s);
                s = fmaf(ya.w, tmp[3], s);
                s = fmaf(yb.x, tmp[4], s);
                s = fmaf(yb.y, tmp[5], s);
                v[u] = fmaf(yb.z, tmp[6], s);
                const int y = __float_as_int(yb.w);
                dst[u] = kTiled ? acc + (y * kTileSide + x) * kSlice + lane
                                : acc + (static_cast<size_t>(y) * W + x) * C + lane;
            }
            if constexpr (kTiled) {
                float old[kRowBatch];
                #pragma unroll
                for (int u = 0; u < kRowBatch; ++u) old[u] = *dst[u];
                #pragma unroll
                for (int u = 0; u < kRowBatch; ++u) {
                    if (q0 + u < ny) *dst[u] = old[u] + v[u];
                }
            } else {
                #pragma unroll
                for (int u = 0; u < kRowBatch; ++u) {
                    if (q0 + u < ny && live && v[u] != 0.f) atomicAdd(dst[u], v[u]);
                }
            }
        }
    }
}

// One work item of the windowed backward: kChunk consecutive rois of one
// image and one channel slice. Items are numbered with the roi groups of an
// (image, slice) from the last to the first (the MIL stage appends its
// negatives, large boxes on their own windows, so they come first), then
// by image, then by slice.
struct Item {
    int b, c0, n0, m;
};

__device__ __forceinline__ Item item_at(int t, int groups, int B, int N) {
    Item it;
    const int yz = t / groups;
    it.b = yz % B;
    it.c0 = (yz / B) * kSlice;
    it.n0 = (groups - 1 - t % groups) * kChunk;
    it.m = min(kChunk, N - it.n0);
    return it;
}

// d/dfeat by chunks of rois that share one window (the header's design).
// A persistent grid (as many blocks as fit the card) walks the items: block
// k takes items k, k + gridDim.x, ... and splits each item's rois into
// chunks where the clamp bounds change. Per item, a half warp per roi builds
// the roi's axis tables from its box and bounds, which were loaded while the
// previous item was added; then each roi's turn is its add and one barrier.
// The rois' dout slices are copied with cp.async into a ring of kStages<T>
// stages, kStages<T> - 1 rois ahead, by a cursor that runs on into the next
// item. The tile is zeroed once: every chunk's flush zeroes what it wrote.
template <typename T>
__global__ void __launch_bounds__(kWinThreads)
roi_align_bwd_windowed_kernel(const T* __restrict__ dout, const float* __restrict__ rois,
                              const int* __restrict__ clamp, float* __restrict__ dfeat,
                              int B, int H, int W, int C, int N, float scale) {
    constexpr int kAhead = kStages<T> - 1;
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int cnt[kChunk][2];
    __shared__ int4 sbnd[kChunk];
    float* tile = reinterpret_cast<float*>(smem);
    T* stage = reinterpret_cast<T*>(smem + kTileBytes);
    AxisTable (*tabs)[2] = reinterpret_cast<AxisTable (*)[2]>(
        smem + kTileBytes + kStages<T> * kStageElems * sizeof(T));

    const int lane = threadIdx.x % 32;
    const int warp = threadIdx.x / 32;
    const int groups = (N + kChunk - 1) / kChunk;
    const int items = groups * B * ((C + kSlice - 1) / kSlice);
    const int4* bounds = reinterpret_cast<const int4*>(clamp);
    const float4* boxes = reinterpret_cast<const float4*>(rois);

    for (int i = threadIdx.x; i < kTileBytes / 16; i += kWinThreads) {
        reinterpret_cast<float4*>(tile)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    // the copy cursor: roi `ci` of item `ct` goes into stage `slot`
    int ct = blockIdx.x, ci = 0, slot = 0;
    Item cit = item_at(ct, groups, B, N);
    auto copy_next = [&]() {
        if (ct < items) {
            copy_slice(stage + slot * kStageElems, dout,
                       static_cast<size_t>(cit.b) * N + cit.n0 + ci, C, cit.c0);
            if (++ci == cit.m) {
                ct += gridDim.x;
                ci = 0;
                if (ct < items) cit = item_at(ct, groups, B, N);
            }
        }
        copy_commit();
        slot = slot + 1 == kStages<T> ? 0 : slot + 1;
    };
    #pragma unroll
    for (int k = 0; k < kAhead; ++k) copy_next();
    // the box and bounds of the roi this half warp builds tables for
    const int hr = 2 * warp + lane / 16;
    static_assert(kChunk <= 2 * kWarps, "a half warp builds each roi's tables");
    float4 box = make_float4(0.f, 0.f, 0.f, 0.f);
    int4 bnd = make_int4(0, -1, 0, -1);
    if (blockIdx.x < items) {
        const Item it = item_at(blockIdx.x, groups, B, N);
        if (hr < it.m) {
            const size_t r = static_cast<size_t>(it.b) * N + it.n0 + hr;
            box = boxes[r];
            bnd = bounds[r];
        }
    }

    int rs = 0;     // the stage of the roi being added
    for (int t = blockIdx.x; t < items; t += gridDim.x) {
        const Item it = item_at(t, groups, B, N);
        const bool live = it.c0 + lane < C;
        float* db = dfeat + static_cast<size_t>(it.b) * H * W * C + it.c0;
        if (hr < it.m) {
            build_tables(tabs[hr], cnt[hr], box, bnd, fits_tile(bnd), H, W, scale, lane);
            if (lane % 16 == 0) sbnd[hr] = bnd;
        }
        // the next item's boxes and bounds, in flight while this one is added
        if (t + gridDim.x < items) {
            const Item nx = item_at(t + gridDim.x, groups, B, N);
            if (hr < nx.m) {
                const size_t r = static_cast<size_t>(nx.b) * N + nx.n0 + hr;
                box = boxes[r];
                bnd = bounds[r];
            }
        }
        copy_wait<kAhead - 1>();    // the item's first slice is in
        __syncthreads();            // tables and bounds are built

        int4 touched = make_int4(kTileSide, -1, kTileSide, -1);   // the chunk's cells
        for (int i = 0; i < it.m; ++i) {
            copy_next();
            const int4 w = sbnd[i];
            const bool tiled = fits_tile(w);
            const int ny = cnt[i][0], nx = cnt[i][1];
            const T* st = stage + rs * kStageElems;
            rs = rs + 1 == kStages<T> ? 0 : rs + 1;
            if (tiled) {
                add_roi<true>(st, tabs[i][0], tabs[i][1], ny, nx, tile, W, C, warp, lane, live);
                touched.x = min(touched.x, __float_as_int(tabs[i][0][0][1].w));
                touched.y = max(touched.y, __float_as_int(tabs[i][0][ny - 1][1].w));
                touched.z = min(touched.z, __float_as_int(tabs[i][1][0][1].w));
                touched.w = max(touched.w, __float_as_int(tabs[i][1][nx - 1][1].w));
            } else {
                add_roi<false>(st, tabs[i][0], tabs[i][1], ny, nx, db, W, C, warp, lane, live);
            }
            copy_wait<kAhead - 1>();    // the next roi's slice is in
            __syncthreads();            // roi i is added; its stage is free
            const bool chunk_end = i + 1 == it.m || !same_bounds(sbnd[i + 1], w);
            if (chunk_end && tiled) {
                // warp k flushes rows y0 + k, y0 + k + kWarps, ... and zeroes them
                for (int y = touched.x + warp; y <= touched.y; y += kWarps) {
                    float* row = tile + y * kTileSide * kSlice + lane;
                    float* grow = db + (static_cast<size_t>(w.x + y) * W + w.z) * C + lane;
                    #pragma unroll 4
                    for (int x = touched.z; x <= touched.w; ++x) {
                        const float v = row[x * kSlice];
                        row[x * kSlice] = 0.f;
                        if (v != 0.f && live) atomicAdd(grow + static_cast<size_t>(x) * C, v);
                    }
                }
                __syncthreads();
            }
            if (chunk_end) touched = make_int4(kTileSide, -1, kTileSide, -1);
        }
    }
}

// Blocks of the persistent windowed backward on the current device (the
// SMs times the blocks that fit one), found once per device.
template <typename T>
int windowed_blocks(int* blocks) {
    constexpr int kDevices = 64;
    static int known[kDevices] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kDevices && known[dev] > 0) {
        *blocks = known[dev];
        return 0;
    }
    auto kernel = roi_align_bwd_windowed_kernel<T>;
    // Needed above 48 KB of dynamic shared memory.
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kWinSmem<T>);
    int sms = 0, per_sm = 0;
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWinThreads,
                                                            kWinSmem<T>);
    }
    *blocks = sms * per_sm;
    if (err == cudaSuccess && *blocks == 0) err = cudaErrorInvalidConfiguration;
    if (err == cudaSuccess && dev < kDevices) known[dev] = *blocks;
    return static_cast<int>(err);
}

template <typename T>
int launch_bwd_windowed(const void* dout, const float* rois, const int* clamp, float* dfeat,
                        int B, int H, int W, int C, int N, float scale, cudaStream_t s) {
    int blocks = 0;
    const int err = windowed_blocks<T>(&blocks);
    if (err != 0) return err;
    const long items = static_cast<long>((N + kChunk - 1) / kChunk) * B *
                       ((C + kSlice - 1) / kSlice);
    if (items > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    const int grid = static_cast<int>(std::min<long>(items, blocks));
    roi_align_bwd_windowed_kernel<T><<<grid, kWinThreads, kWinSmem<T>, s>>>(
        static_cast<const T*>(dout), rois, clamp, dfeat, B, H, W, C, N, scale);
    return static_cast<int>(cudaGetLastError());
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
    // 16-byte channel vectors: C a multiple of 8; element offsets in an int
    if (C % 8 != 0 || static_cast<long>(H) * W * C > INT_MAX) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const dim3 grid((N + kFwdWarps - 1) / kFwdWarps, B);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) {
        roi_align_fwd_kernel<float><<<grid, kFwdThreads, 0, s>>>(
            static_cast<const float*>(feat), rois, clamp, static_cast<float*>(out),
            H, W, C, N, scale);
    } else if (dtype == 1) {
        roi_align_fwd_kernel<__nv_bfloat16><<<grid, kFwdThreads, 0, s>>>(
            static_cast<const __nv_bfloat16*>(feat), rois, clamp,
            static_cast<__nv_bfloat16*>(out), H, W, C, N, scale);
    } else {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}

// The forward's layout: info[0..5] = rois (warps) per block, threads per
// block, static shared memory bytes, registers per thread, local memory
// bytes per thread (spills), resident blocks per SM (bf16, on the current
// device). Returns a CUDA error code.
extern "C" int pt_roi_align_fwd_info(int* info) {
    return vec16::fwd_info(roi_align_fwd_kernel<__nv_bfloat16>, kFwdWarps, kFwdThreads, info);
}

// The atomic backward (clamp may be null: the whole map).
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

// The windowed backward: clamp [B, N, 4] is required.
extern "C" int pt_roi_align_bwd_windowed(const void* dout, const float* rois, const int* clamp,
                                         float* dfeat, int dtype, int B, int H, int W, int C,
                                         int N, float scale, void* stream) {
    if (N == 0 || B == 0) return 0;
    if (clamp == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) {
        return launch_bwd_windowed<float>(dout, rois, clamp, dfeat, B, H, W, C, N, scale, s);
    }
    if (dtype == 1) {
        return launch_bwd_windowed<__nv_bfloat16>(dout, rois, clamp, dfeat, B, H, W, C, N,
                                                  scale, s);
    }
    return static_cast<int>(cudaErrorInvalidValue);
}

// The windowed backward's layout: info[0..6] = rois per work item, tile
// cells, channels per block, threads per block, dynamic shared memory bytes,
// resident blocks per SM and the persistent grid's blocks (bf16, on the
// current device). Returns a CUDA error code.
extern "C" int pt_roi_align_bwd_windowed_info(int* info) {
    int blocks = 0, dev = 0, sms = 1;
    int err = windowed_blocks<__nv_bfloat16>(&blocks);
    if (err == 0) err = static_cast<int>(cudaGetDevice(&dev));
    if (err == 0) {
        err = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
    }
    info[0] = kChunk;
    info[1] = kTileSide * kTileSide;
    info[2] = kSlice;
    info[3] = kWinThreads;
    info[4] = kWinSmem<__nv_bfloat16>;
    info[5] = blocks / (sms > 0 ? sms : 1);
    info[6] = blocks;
    return err;
}
