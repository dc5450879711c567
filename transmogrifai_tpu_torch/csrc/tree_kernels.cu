// Hand-written Hopper (sm_90a) kernels for the gradient-boosted-tree sweep.
//
// One kernel family for each Pallas kernel of transmogrifai_tpu/ops/pallas_hist.py:
//
//   hist_fm_kernel<ROUTE=false>, hist_kernel  <- _kernel            (hist_folds)
//   hist_fm_kernel<ROUTE=true>, route_hist_kernel, sort_count_kernel +
//   sort_scan_kernel + sort_scatter_kernel + sorted_hist_kernel
//                                             <- _route_hist_kernel (route_hist)
//   route_staged_kernel, route_kernel         <- _route_kernel      (route)
//   lookup_kernel                             <- _lookup_kernel     (table_lookup)
//
// The TPU kernels build one-hot tiles and contract them on the MXU because
// the TPU serialises scatters and gathers. On Hopper both are cheap, so the
// histograms here are shared-memory scatter-adds and routing is a per-row
// gather. Layouts at the C interface are the JAX package's: the binned
// matrix is [F, N] (feature-major), lane planes are [Fo, N], and the
// histogram output is [Fo * S * Co, F * B] f32 with row (k * S + s) * Co + c
// and column f * B + b.
//
// The histograms have four paths, chosen per shape by plan_hist in
// ops/tree_kernels.py:
//   private, owned (hist_fm_kernel): threads map to features over a row
//     tile staged in shared memory, with a histogram copy per warp (a
//     tree's root) or copies whose slots the warps own (its deeper levels);
//     the main path (F = 64, 33 bins) takes them;
//   sorted (route_hist only: sort_*_kernel, sorted_hist_kernel): each
//     lane's left rows listed by slot once, then counted by warps that map
//     threads to features and hold one slot's histogram at a time; the
//     levels below the root of wide trees (F = 164, 650, 257 bins), whose
//     histograms take the features path too many passes over the rows;
//   rows (hist_kernel, route_hist_kernel): threads map to rows and scatter
//     with shared atomics; kept for narrow F (the rank-metric counts have
//     F = 1), where mapping threads to features would idle most of a warp.
// Routing has two paths, chosen per shape by plan_route: staged
// (route_staged_kernel: every lane of a row tile in one block, the tile's
// bins of the features the tables use copied into shared memory) where
// that copy reads fewer bytes than the gathers, and rows (route_kernel: the
// row-mapped kernel, a grid row per lane). The leaf lookup is row-mapped
// (lookup_kernel).
//
// Every entry point launches on the stream it is given, allocates nothing
// and returns cudaGetLastError() (0 on success). The Python wrappers in
// ops/tree_kernels.py check shapes, dtypes and devices, zero the histogram
// outputs and choose the tiling.
#include <cuda_runtime.h>

#include <type_traits>

namespace {

// C payload channels + the derived count of one lane; the Python wrappers
// launch a wider lane (a K-class forest's K + 2) as groups of lanes of at
// most this many channels (channel_groups in ops/tree_kernels.py)
constexpr int kMaxChannels = 4;
constexpr int kRowThreads = 512;  // block of the rows path

// Paths of the histogram entry points (plan_hist's HistTiling.path).
constexpr int kPathRows = 0;
constexpr int kPathPrivate = 1;   // features, one histogram per warp
constexpr int kPathOwned = 2;     // features, warps own slots of a copy

// Features path geometry. A staged row tile holds kTileBytes of each
// feature's bins (256 rows of int8/uint8, 64 of int32) in rows of
// kXsStride words: the stride is odd, so the 32 threads of a warp reading
// one row across 32 features hit 32 different banks.
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileBytes = 256;
constexpr int kRowWords = kTileBytes / 4;
constexpr int kXsStride = kRowWords + 1;
constexpr int kMaxFTile = 64;                       // two features a thread
constexpr int kXw = kMaxFTile * kRowWords / kThreads;  // prefetch words a thread

// Payload channels of row i for one lane; with `derive` the unit-count
// channel (last channel > 0) is appended, as the Pallas kernels' derive_count.
__device__ __forceinline__ void load_payload(const float* __restrict__ pay_k,
                                             long long N, long long i, int C,
                                             int derive, float* v) {
  for (int c = 0; c < C; ++c) v[c] = pay_k[(long long)c * N + i];
  if (derive) v[C] = v[C - 1] > 0.f ? 1.f : 0.f;
}

// Scatter one row's payload into the block's private histogram
// [s_tile][Co][f_tile][B]; `base` is the row's slot offset. Bins outside
// [0, B) contribute nothing, like the Pallas one-hot. Zero payloads are
// skipped: adding 0 changes no sum.
template <typename XT>
__device__ __forceinline__ void add_row(float* sh, const XT* __restrict__ xb,
                                        long long N, long long i, int f0,
                                        int nf, int f_tile, int B, int Co,
                                        const float* v, int base) {
  for (int f = 0; f < nf; ++f) {
    const int b = (int)xb[(long long)(f0 + f) * N + i];
    if (b < 0 || b >= B) continue;
    float* cell = sh + base + f * B + b;
    for (int c = 0; c < Co; ++c)
      if (v[c] != 0.f) atomicAdd(cell + c * f_tile * B, v[c]);
  }
}

__device__ __forceinline__ void zero_shared(float* sh, int n) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) sh[j] = 0.f;
}

// Add the block's private histogram into the global [Fo*S*Co, F*B] output.
__device__ __forceinline__ void flush(const float* sh, float* out, int k,
                                      int S, int s0, int ns, int Co, int F,
                                      int f0, int nf, int f_tile, int B) {
  const int per_c = nf * B;
  const int per_s = Co * per_c;
  const long long FB = (long long)F * B;
  for (int j = threadIdx.x; j < ns * per_s; j += blockDim.x) {
    const int sl = j / per_s;
    int r = j - sl * per_s;
    const int c = r / per_c;
    r -= c * per_c;
    const int f = r / B;
    const int b = r - f * B;
    const float val = sh[((sl * Co + c) * f_tile + f) * B + b];
    if (val != 0.f) {
      const long long row = ((long long)k * S + s0 + sl) * Co + c;
      atomicAdd(out + row * FB + (long long)(f0 + f) * B + b, val);
    }
  }
}

// Routing decision of one row: right = bin > thresh, or the missing bin 0
// with the node's learned missing direction. Node ids outside the table
// route as feature 0 / thresh 0 / miss 0, as in the Pallas kernels.
template <typename XT>
__device__ __forceinline__ int go_right(const XT* __restrict__ xb, long long N,
                                        long long i, int F, float nd_f,
                                        int n_nodes, const int* tf,
                                        const int* tt, const int* tm) {
  int fs = 0, t = 0, m = 0;
  if (nd_f >= 0.f && nd_f < (float)n_nodes) {
    const int nd = (int)nd_f;
    fs = tf[nd];
    t = tt[nd];
    m = tm[nd];
  }
  if (fs < 0 || fs >= F) fs = 0;
  const int x = (int)xb[(long long)fs * N + i];
  return (x > t) || (x == 0 && m > 0);
}

// B1, rows path. Replaces _kernel (pallas_hist.py:395) for narrow F, the
// fold-fused gradient histogram: out[k*S*Co + s*Co + c, f*B + b] = sum_i
// [slot[k,i] = s] * pay[k,c,i] * [Xb[f,i] = b]. One block takes one lane
// (blockIdx.z), one (feature tile, slot tile) pair (blockIdx.y) and one row
// range (blockIdx.x); each thread takes one row and scatters it with shared
// atomics. Bound on this card: the shared-memory atomics — an f32 atomicAdd
// on shared memory is a compare-and-swap loop on sm_90, and rows of a warp
// that share a bin retry — which is why wide F takes the features path.
// With F = 1 and thousands of bins (the rank-metric counts) the rows of a
// warp rarely share a bin.
template <typename XT>
__global__ void hist_kernel(const XT* __restrict__ xb,
                            const float* __restrict__ pay,
                            const float* __restrict__ slot,
                            float* __restrict__ out, int F, long long N,
                            int C, int derive, int S, int B, int f_tile,
                            int s_tile, int n_ftiles,
                            long long rows_per_block) {
  extern __shared__ float sh[];
  const int k = blockIdx.z;
  const int ft = blockIdx.y % n_ftiles, st = blockIdx.y / n_ftiles;
  const int f0 = ft * f_tile, nf = min(f_tile, F - f0);
  const int s0 = st * s_tile, ns = min(s_tile, S - s0);
  const int Co = C + derive;
  zero_shared(sh, s_tile * Co * f_tile * B);
  __syncthreads();
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min(N, r0 + rows_per_block);
  const float* slot_k = slot + (long long)k * N;
  const float* pay_k = pay + (long long)k * C * N;
  float v[kMaxChannels];
  for (long long i = r0 + threadIdx.x; i < r1; i += blockDim.x) {
    const float sf = slot_k[i];
    // slot >= S (dropped rows), negative or NaN slots match no slot
    if (!(sf >= (float)s0 && sf < (float)(s0 + ns))) continue;
    load_payload(pay_k, N, i, C, derive, v);
    add_row(sh, xb, N, i, f0, nf, f_tile, B, Co, v,
            ((int)sf - s0) * Co * f_tile * B);
  }
  __syncthreads();
  flush(sh, out, k, S, s0, ns, Co, F, f0, nf, f_tile, B);
}

// B2, rows path. Replaces _route_hist_kernel (pallas_hist.py:713) for narrow
// F: route one level and histogram the next level's LEFT children in the
// same pass. A left row's slot is its old node id; right rows are dropped
// (sibling subtraction derives them). Same tiling and bound as hist_kernel,
// plus one gather of the selected feature's bin per row; the split tables
// sit in shared memory behind the histogram. Blocks of feature/slot tile 0
// write the new node ids (2 * node + right).
template <typename XT>
__global__ void route_hist_kernel(const XT* __restrict__ xb,
                                  const float* __restrict__ pay,
                                  const float* __restrict__ node,
                                  const int* __restrict__ tf,
                                  const int* __restrict__ tt,
                                  const int* __restrict__ tm,
                                  float* __restrict__ out,
                                  float* __restrict__ node_out, int F,
                                  long long N, int C, int derive, int n_nodes,
                                  int B, int f_tile, int s_tile, int n_ftiles,
                                  long long rows_per_block) {
  extern __shared__ float sh[];
  const int k = blockIdx.z;
  const int ft = blockIdx.y % n_ftiles, st = blockIdx.y / n_ftiles;
  const int f0 = ft * f_tile, nf = min(f_tile, F - f0);
  const int s0 = st * s_tile, ns = min(s_tile, n_nodes - s0);
  const int Co = C + derive;
  const int hist_cells = s_tile * Co * f_tile * B;
  int* tbl = reinterpret_cast<int*>(sh + hist_cells);
  for (int j = threadIdx.x; j < n_nodes; j += blockDim.x) {
    tbl[j] = tf[(long long)k * n_nodes + j];
    tbl[n_nodes + j] = tt[(long long)k * n_nodes + j];
    tbl[2 * n_nodes + j] = tm[(long long)k * n_nodes + j];
  }
  zero_shared(sh, hist_cells);
  __syncthreads();
  const bool write_node = blockIdx.y == 0;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min(N, r0 + rows_per_block);
  const float* node_k = node + (long long)k * N;
  const float* pay_k = pay + (long long)k * C * N;
  float v[kMaxChannels];
  for (long long i = r0 + threadIdx.x; i < r1; i += blockDim.x) {
    const float nd_f = node_k[i];
    const int right = go_right(xb, N, i, F, nd_f, n_nodes, tbl,
                               tbl + n_nodes, tbl + 2 * n_nodes);
    if (write_node) node_out[(long long)k * N + i] = 2.f * nd_f + (float)right;
    if (right || !(nd_f >= (float)s0 && nd_f < (float)(s0 + ns))) continue;
    load_payload(pay_k, N, i, C, derive, v);
    add_row(sh, xb, N, i, f0, nf, f_tile, B, Co, v,
            ((int)nd_f - s0) * Co * f_tile * B);
  }
  __syncthreads();
  flush(sh, out, k, n_nodes, s0, ns, Co, F, f0, nf, f_tile, B);
}

// -- features path -----------------------------------------------------------

// Shared memory of hist_fm_kernel, in layout order: `copies` histograms
// [s_tile][f_tile / 32][B][Co][32], the staged tile's payload (float4 a row),
// then for PRIVATE the row slots (int a row), else kWarps row lists of R
// entries and their kWarps counts, then the staged bins and the split
// tables. plan_hist mirrors this sum.
__host__ __device__ inline long long fm_smem_bytes(int itemsize, int f_tile,
                                                   int s_tile, int Co, int B,
                                                   int copies, bool priv,
                                                   int n_tbl) {
  const long long G = (f_tile + 31) / 32;
  const long long R = kTileBytes / itemsize;
  return 4LL * copies * s_tile * G * B * Co * 32 + 16LL * R +
         (priv ? 4LL * R : 4LL * kWarps * R + 4LL * kWarps) +
         4LL * kXsStride * f_tile + 12LL * n_tbl;
}

struct FmArgs {
  const void* xb;          // [F, N] bins
  const float* pay;        // [lanes * C, N] payload channels
  const float* key;        // [lanes, N] slot ids (hist) or node ids (route)
  const int* tf;           // [lanes, S] split tables (route)
  const int* tt;
  const int* tm;
  float* out;              // [lanes * S * Co, F * B]
  float* node_out;         // [lanes, N] next node ids (route)
  long long N;
  int F, C, derive, S, B;
  int lanes, f_tile, s_tile, n_ftiles, n_stiles, copies;
};

// Bins of this thread's share of a row tile: word j of the tile is feature
// j / kRowWords, bytes 4 * (j % kRowWords) of its row. Words past N read 0.
template <typename XT>
__device__ __forceinline__ void load_bins(const XT* __restrict__ xb,
                                          long long N, int f0, int nf,
                                          long long r0, bool aligned,
                                          unsigned (&xw)[kXw]) {
  constexpr int EPW = 4 / (int)sizeof(XT);
  constexpr int R = kTileBytes / (int)sizeof(XT);
  using UT = std::make_unsigned_t<XT>;
  const int lim = nf * kRowWords;
  if (aligned && r0 + R <= N) {
#pragma unroll
    for (int j = 0; j < kXw; ++j) {
      const int w = threadIdx.x + j * kThreads;
      xw[j] = w < lim ? __ldg(reinterpret_cast<const unsigned*>(
                            xb + (long long)(f0 + w / kRowWords) * N + r0 +
                            (w % kRowWords) * EPW))
                      : 0u;
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < kXw; ++j) {
    const int w = threadIdx.x + j * kThreads;
    unsigned word = 0u;
    if (w < lim) {
      const long long i = r0 + (long long)(w % kRowWords) * EPW;
      const XT* src = xb + (long long)(f0 + w / kRowWords) * N + i;
#pragma unroll
      for (int e = 0; e < EPW; ++e)
        if (i + e < N) word |= (unsigned)(UT)src[e] << (8 * (int)sizeof(XT) * e);
    }
    xw[j] = word;
  }
}

// Payload channels of row i for this thread (the derived count is added
// at the staging, so that no instruction waits on these loads before).
__device__ __forceinline__ void load_row_payload(const float* __restrict__ pay,
                                                 long long N, int C,
                                                 long long i, bool valid,
                                                 float (&pv)[kMaxChannels]) {
#pragma unroll
  for (int c = 0; c < kMaxChannels; ++c)
    pv[c] = (valid && c < C) ? __ldg(pay + (long long)c * N + i) : 0.f;
}

// The bin of row i in its node's split feature (feature 0 for node ids
// outside the table or split features outside [0, F), as go_right).
template <typename XT>
__device__ __forceinline__ int split_bin(const XT* __restrict__ xb,
                                         long long N, int F, int S,
                                         const int* tf, float nd, long long i,
                                         bool valid) {
  if (!valid) return 0;
  int fs = (nd >= 0.f && nd < (float)S) ? tf[(int)nd] : 0;
  if (fs < 0 || fs >= F) fs = 0;
  return (int)__ldg(xb + (long long)fs * N + i);
}

// Bins of staged rows r .. r + 3 (r a multiple of 4) of tile feature row f,
// or of row r alone (ONE): -1 where the thread has no feature (`has`), so
// the row adds nothing there. Feature row 0 is read in that case, so the
// load stays inside the staged tile.
template <typename XT>
__device__ __forceinline__ void staged_bins4(const unsigned* xs, int f,
                                             unsigned r, bool has,
                                             int (&bn)[4]) {
  const unsigned* row = xs + (has ? f : 0) * kXsStride;
  if constexpr (sizeof(XT) == 1) {
    const unsigned wd = row[r >> 2];
#pragma unroll
    for (int e = 0; e < 4; ++e) bn[e] = has ? (int)(XT)(wd >> (8 * e)) : -1;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) bn[e] = has ? (int)(XT)row[r + e] : -1;
  }
}

template <typename XT>
__device__ __forceinline__ int staged_bin(const unsigned* xs, int f,
                                          unsigned r, bool has) {
  const unsigned* row = xs + (has ? f : 0) * kXsStride;
  if constexpr (sizeof(XT) == 1)
    return has ? (int)(XT)(row[r >> 2] >> (8 * (r & 3))) : -1;
  else
    return has ? (int)(XT)row[r] : -1;
}

// Add one row's payload v into this thread's cells of one slot's histogram:
// the thread's features lane and lane + 32 have bins b[0], b[1]; a cell's
// Co channels are 32 words apart (Co = CO when CO > 0, else co). Only this
// thread ever touches these cells in this copy, so the add is plain loads,
// then stores. Bins outside [0, B) add nothing, like the Pallas one-hot.
template <int CO>
__device__ __forceinline__ void add_cells(float* slot_hist, int b0, int b1,
                                          const float4& v, int B, int co) {
  const int Co = CO > 0 ? CO : co;
  const float vv[kMaxChannels] = {v.x, v.y, v.z, v.w};
  const int b[2] = {b0, b1};
  bool ok[2];
  float* cell[2];
  float x[2][kMaxChannels];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    ok[j] = (unsigned)b[j] < (unsigned)B;
    cell[j] = slot_hist + (j * B + b[j]) * Co * 32;
#pragma unroll
    for (int c = 0; c < kMaxChannels; ++c)
      if (ok[j] && c < Co) x[j][c] = cell[j][c * 32];
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int c = 0; c < kMaxChannels; ++c)
      if (ok[j] && c < Co) cell[j][c * 32] = x[j][c] + vv[c];
}

// B1 and B2, features path. Replaces _kernel (pallas_hist.py:395) with
// ROUTE = false and _route_hist_kernel (pallas_hist.py:713) with ROUTE =
// true: out[k*S*Co + s*Co + c, f*B + b] = sum_i [slot(k,i) = s] * pay[k,c,i]
// * [Xb[f,i] = b], where with ROUTE the slot of a row is its node id if it
// goes left and none if it goes right (sibling subtraction derives the right
// children), and the blocks of feature/slot tile 0 write the new node ids
// 2 * node + right.
//
// Bound on this card: one shared-memory read-modify-write per (row,
// feature, lane, channel), 32 a clock on each SM at best, well above the
// bytes (each row's F bins, payload and slot or node once). An f32
// atomicAdd on shared memory is a compare-and-swap loop on sm_90, and
// retries whenever two threads hit one cell, so the design has no shared
// atomics in its inner loop:
// - threads map to features and a warp takes one row at a time, so no two
//   threads of a warp ever add into one cell, whatever the bin skew; the
//   histogram layout [slot][feature / 32][bin][channel][feature % 32] gives
//   each thread its own bank, and a dropped row (outside the slot tile, or
//   a right row) is skipped by the whole warp at once;
// - PRIVATE (the root, where eight copies fit): each warp has its own
//   histogram copy and takes groups of 4 staged rows, so counting is plain
//   shared loads and stores; the copies are summed once at the flush;
// - otherwise `copies` histograms each serve kWarps / copies warps, and a
//   warp owns the slots s with s % (kWarps / copies) equal to its index in
//   the group: the staging sorts the tile's counted rows into per-warp lists
//   (rows alternate over the copies), so every cell still has one writer;
// - a block stages one lane's row tile — bins of its feature tile in rows
//   of odd word stride, payload with the derived count, and each row's
//   local slot or -1 — from registers loaded while the previous tile was
//   counted; with ROUTE each row's split bin is gathered and its route
//   decided once in the staging, its node id read two tiles ahead;
// - the grid is persistent, one block per SM: blockIdx.x % (lanes x feature
//   tiles x slot tiles) picks the block's work, and blocks launched together
//   stride over the same row tiles, so a lane's payload and the shared bins
//   are re-read from L2. Each block adds its histogram into the output
//   once, with one global atomicAdd per nonzero cell.
// CO is the channel count where it is fixed at compile time (3: the trees'
// g, h and derived count), 0 where it is read from the arguments.
template <typename XT, bool ROUTE, bool PRIVATE, int CO>
__global__ void __launch_bounds__(kThreads, 1) hist_fm_kernel(const FmArgs a) {
  constexpr int R = kTileBytes / (int)sizeof(XT);   // rows of a staged tile
  extern __shared__ __align__(16) unsigned char fm_smem[];
  const int Co = CO > 0 ? CO : a.C + a.derive;
  const int G = (a.f_tile + 31) >> 5;   // feature groups of 32
  const int SS = G * a.B * Co * 32;     // slot stride of a histogram
  const int hcells = a.s_tile * SS;
  const int copies = PRIVATE ? kWarps : a.copies;
  const int wpc = kWarps / copies;      // warps sharing one copy
  float* hist = reinterpret_cast<float*>(fm_smem);
  float4* rp = reinterpret_cast<float4*>(hist + copies * hcells);
  int* rs = reinterpret_cast<int*>(rp + R);     // PRIVATE: row slots
  int* lists = rs;                              // else: kWarps row lists
  int* cnt = lists + kWarps * R;                //   and their lengths
  unsigned* xs = reinterpret_cast<unsigned*>(PRIVATE ? rs + R : cnt + kWarps);
  int* tbl = reinterpret_cast<int*>(xs + kXsStride * a.f_tile);

  const int n_other = a.lanes * a.n_ftiles * a.n_stiles;
  const int o = blockIdx.x % n_other;
  const long long chunk = blockIdx.x / n_other;
  const long long n_chunks = gridDim.x / n_other;
  const int ft = o % a.n_ftiles;
  const int st = (o / a.n_ftiles) % a.n_stiles;
  const int k = o / (a.n_ftiles * a.n_stiles);
  const int f0 = ft * a.f_tile, nf = min(a.f_tile, a.F - f0);
  const int s0 = st * a.s_tile, ns = min(a.s_tile, a.S - s0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long N = a.N;
  const XT* xb = static_cast<const XT*>(a.xb);
  const bool aligned = reinterpret_cast<unsigned long long>(xb) % 4 == 0 &&
                       (N * (long long)sizeof(XT)) % 4 == 0;
  const float* key = a.key + (long long)k * N;
  const float* pay = a.pay + (long long)k * a.C * N;
  const bool write_node = ROUTE && ft == 0 && st == 0;
  const bool has0 = lane < nf, has1 = G > 1 && lane + 32 < nf;

  {
    float4* h4 = reinterpret_cast<float4*>(hist);
    const int n4 = copies * hcells / 4;
    for (int j = tid; j < n4; j += kThreads)
      h4[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (!PRIVATE && tid < kWarps) cnt[tid] = 0;
  if (ROUTE) {
    for (int j = tid; j < a.S; j += kThreads) {
      tbl[j] = a.tf[(long long)k * a.S + j];
      tbl[a.S + j] = a.tt[(long long)k * a.S + j];
      tbl[2 * a.S + j] = a.tm[(long long)k * a.S + j];
    }
  }
  __syncthreads();

  const long long n_tiles = (N + R - 1) / R;
  long long t = chunk;
  if (t < n_tiles) {
    unsigned xw[kXw];
    float pv[kMaxChannels];
    float kc, kn = 0.f;   // key of this thread's row: this tile, two ahead
    int xsel = 0;         // its split bin (ROUTE)
    const bool has_row = tid < R;
    load_bins<XT>(xb, N, f0, nf, t * R, aligned, xw);
    load_row_payload(pay, N, a.C, t * R + tid, has_row && t * R + tid < N,
                     pv);
    kc = has_row && t * R + tid < N ? __ldg(key + t * R + tid) : 0.f;
    if (ROUTE) {
      const long long i2 = (t + n_chunks) * R + tid;
      if (has_row && i2 < N) kn = __ldg(key + i2);
      xsel = split_bin<XT>(xb, N, a.F, a.S, tbl, kc, t * R + tid,
                           has_row && t * R + tid < N);
    }
    for (;;) {
      __syncthreads();   // every warp is done counting the last tile
#pragma unroll
      for (int j = 0; j < kXw; ++j) {
        const int w = tid + j * kThreads;
        if (w < nf * kRowWords)
          xs[(w / kRowWords) * kXsStride + w % kRowWords] = xw[j];
      }
      if (has_row) {
        const long long i = t * R + tid;
        int ls = -1;
        if (i < N) {
          if (ROUTE) {
            int th = 0, m = 0;
            if (kc >= 0.f && kc < (float)a.S) {
              th = tbl[a.S + (int)kc];
              m = tbl[2 * a.S + (int)kc];
            }
            const int right = (xsel > th) || (xsel == 0 && m > 0);
            if (write_node) a.node_out[(long long)k * N + i] = 2.f * kc + (float)right;
            if (!right && kc >= (float)s0 && kc < (float)(s0 + ns))
              ls = (int)kc - s0;
          } else if (kc >= (float)s0 && kc < (float)(s0 + ns)) {
            ls = (int)kc - s0;   // slot >= S, negative or NaN: no slot
          }
        }
        if (a.derive) {   // the unit count: last payload channel > 0
#pragma unroll
          for (int c = 1; c < kMaxChannels; ++c)
            if (c == a.C) pv[c] = pv[c - 1] > 0.f ? 1.f : 0.f;
        }
        rp[tid] = make_float4(pv[0], pv[1], pv[2], pv[3]);
        if (PRIVATE) {
          rs[tid] = ls;
        } else {
          // append the row to its owner's list: one shared atomic per
          // (staging warp, owner), the rows' places by rank among peers
          const unsigned counted = __ballot_sync(0xffffffffu, ls >= 0);
          if (ls >= 0) {
            const int owner = (tid % copies) * wpc + ls % wpc;
            const unsigned peers = __match_any_sync(counted, owner);
            const int leader = __ffs(peers) - 1;
            int base = 0;
            if (lane == leader) base = atomicAdd(cnt + owner, __popc(peers));
            base = __shfl_sync(peers, base, leader);
            lists[owner * R + base + __popc(peers & ((1u << lane) - 1u))] =
                ls << 8 | tid;
          }
        }
      }
      __syncthreads();

      // load the next tile into registers while this one is counted
      const long long tn = t + n_chunks;
      const bool more = tn < n_tiles;
      if (more) {
        const long long i = tn * R + tid;
        load_bins<XT>(xb, N, f0, nf, tn * R, aligned, xw);
        load_row_payload(pay, N, a.C, i, has_row && i < N, pv);
        if (ROUTE) {
          kc = kn;
          const long long i2 = (tn + n_chunks) * R + tid;
          if (has_row && i2 < N) kn = __ldg(key + i2);
          xsel = split_bin<XT>(xb, N, a.F, a.S, tbl, kc, i, has_row && i < N);
        } else {
          kc = has_row && i < N ? __ldg(key + i) : 0.f;
        }
      }

      if (PRIVATE) {
        // warp w counts groups of 4 rows w, w + kWarps, ... into its copy
        float* mine = hist + warp * hcells + lane;
#pragma unroll 1
        for (int g4 = warp; g4 < R / 4; g4 += kWarps) {
          const int4 sl = reinterpret_cast<const int4*>(rs)[g4];
          if ((sl.x & sl.y & sl.z & sl.w) < 0) continue;   // all dropped
          const int sv[4] = {sl.x, sl.y, sl.z, sl.w};
          float4 v[4];
          int bn0[4], bn1[4];
          staged_bins4<XT>(xs, lane, 4u * g4, has0, bn0);
          staged_bins4<XT>(xs, lane + 32, 4u * g4, has1, bn1);
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] = rp[4 * g4 + e];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (sv[e] >= 0)
              add_cells<CO>(mine + sv[e] * SS, bn0[e], bn1[e], v[e], a.B, Co);
        }
      } else {
        // warp w counts its list, 4 rows at a time, into its group's copy
        float* mine = hist + (warp / wpc) * hcells + lane;
        const int n = cnt[warp];
        const int* lst = lists + warp * R;
#pragma unroll 1
        for (int q = 0; q < n; q += 4) {
          const int4 en = *reinterpret_cast<const int4*>(lst + q);
          const int ent[4] = {en.x, q + 1 < n ? en.y : -1,
                              q + 2 < n ? en.z : -1, q + 3 < n ? en.w : -1};
          float4 v[4];
          int bn0[4], bn1[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const unsigned r = ent[e] >= 0 ? ent[e] & 255 : 0;
            v[e] = rp[r];
            bn0[e] = staged_bin<XT>(xs, lane, r, has0);
            bn1[e] = staged_bin<XT>(xs, lane + 32, r, has1);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (ent[e] >= 0)
              add_cells<CO>(mine + (ent[e] >> 8) * SS, bn0[e], bn1[e], v[e],
                            a.B, Co);
        }
        __syncwarp();
        if (lane == 0) cnt[warp] = 0;   // ordered before the next staging
      }
      if (!more) break;
      t = tn;
    }
  }
  __syncthreads();

  // flush: sum the copies, one global atomicAdd per nonzero cell
  const long long FB = (long long)a.F * a.B;
  for (int j = tid; j < hcells; j += kThreads) {
    float val = hist[j];
    for (int w = 1; w < copies; ++w) val += hist[w * hcells + j];
    if (val == 0.f) continue;
    int r = j >> 5;
    const int c = r % Co;
    r /= Co;
    const int b = r % a.B;
    r /= a.B;
    const int g = r % G;
    const int s = r / G;
    const int f = g * 32 + (j & 31);
    if (f < nf && s < ns)
      atomicAdd(a.out + (((long long)k * a.S + s0 + s) * Co + c) * FB +
                    (long long)(f0 + f) * a.B + b,
                val);
  }
}

// B3, rows path. Replaces _route_kernel (pallas_hist.py:598): out[k, i] =
// 2 * node[k, i] + right (go_right), one lane per blockIdx.y, one row per
// thread. Bound on this card: bytes — each lane's node plane read and
// written once and the selected bins. What holds it back: a gathered bin
// costs a 32-byte sector (the rows of a warp sit at different nodes, so on
// different feature rows), a row's bins are gathered anew for each lane,
// and each row runs the dependent chain node -> split tables -> bin.
// plan_route takes it where the staged copy below would read more bytes
// than those sectors (wide bins under many split features) or does not fit
// in shared memory.
template <typename XT>
__global__ void route_kernel(const XT* __restrict__ xb,
                             const float* __restrict__ node,
                             const int* __restrict__ tf,
                             const int* __restrict__ tt,
                             const int* __restrict__ tm,
                             float* __restrict__ out, int F, long long N,
                             int n_nodes) {
  const int k = blockIdx.y;
  const long long off = (long long)k * N;
  const long long tbl = (long long)k * n_nodes;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < N;
       i += (long long)gridDim.x * blockDim.x) {
    const float nd_f = node[off + i];
    const int right =
        go_right(xb, N, i, F, nd_f, n_nodes, tf + tbl, tt + tbl, tm + tbl);
    out[off + i] = 2.f * nd_f + (float)right;
  }
}

// B4. Replaces _lookup_kernel (pallas_hist.py:866): out[k, i] = tbl[k,
// idx[k, i]], 0 for ids outside [0, M) (compared in f32 before the cast, so
// NaN gives 0); one lane per blockIdx.y, one row per thread. Bound on this
// card: bytes — one id read and one value written a lane and row, the
// traffic of a copy. It streams at about 81% of a device copy of the same
// plane at 10M rows (PERF.md); the table stays in L1. Every lane's table in
// shared memory, all lanes in one block, 16-byte id vectors, unrolled
// persistent grids and a ring of TMA bulk copies were each measured against
// it on the H100 and none was faster beyond the spread between turns, so
// this simple form is the one kept.
__global__ void lookup_kernel(const float* __restrict__ tbl,
                              const float* __restrict__ idx,
                              float* __restrict__ out, int M, long long N) {
  const int k = blockIdx.y;
  const long long off = (long long)k * N;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < N;
       i += (long long)gridDim.x * blockDim.x) {
    const float x = idx[off + i];
    out[off + i] = (x >= 0.f && x < (float)M)
                       ? tbl[(long long)k * M + (int)x] : 0.f;
  }
}

// -- staged path of route -----------------------------------------------------

// Paths of the routing entry point (plan_route).
constexpr int kRoutePathRows = 0;     // row-mapped: grid (blocks, lanes)
constexpr int kRoutePathStaged = 1;   // every lane of a row tile in a block
constexpr int kLaneRows = 4;          // rows a thread (one float4 a lane)
constexpr int kLaneGroup = 4;         // lanes whose node loads are in flight
constexpr int kStagedThreads = 128;   // staged path block
constexpr int kStagedRows = kLaneRows * kStagedThreads;   // a staged tile

// Row values i .. i + 3 of one lane plane: one 16-byte load where the plane
// is 16-byte aligned and N % 4 == 0 (VEC), else scalar loads; rows past N
// read 0 and are never stored.
template <bool VEC>
__device__ __forceinline__ void load_rows(const float* __restrict__ p,
                                          long long i, long long N,
                                          float (&v)[kLaneRows]) {
  if (VEC) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p + i));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int e = 0; e < kLaneRows; ++e) v[e] = i + e < N ? __ldg(p + i + e) : 0.f;
  }
}

template <bool VEC>
__device__ __forceinline__ void store_rows(float* __restrict__ p, long long i,
                                           long long N,
                                           const float (&v)[kLaneRows]) {
  if (VEC) {
    *reinterpret_cast<float4*>(p + i) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < kLaneRows; ++e)
      if (i + e < N) p[i + e] = v[e];
  }
}

// One node's split as the staged path keeps it: x = the feature, clamped to
// 0 outside [0, F), with the missing direction (m > 0) in bit 31; y = the
// threshold. Node ids outside the table (`in` false) route as feature 0,
// threshold 0, missing direction 0, as go_right.
__device__ __forceinline__ int2 pack_split(const int* __restrict__ tf,
                                           const int* __restrict__ tt,
                                           const int* __restrict__ tm,
                                           long long at, bool in, int F) {
  int fs = 0, t = 0, m = 0;
  if (in) {
    fs = __ldg(tf + at);
    t = __ldg(tt + at);
    m = __ldg(tm + at);
  }
  if (fs < 0 || fs >= F) fs = 0;
  return make_int2(fs | (m > 0 ? (int)0x80000000u : 0), t);
}

// Bytes of the packed split tables in shared memory: lanes x (n_nodes + 1)
// int2 (entry n_nodes is the out-of-range split), rounded up to 16 so the
// staged bins behind them stay 16-byte aligned. plan_route mirrors it.
__host__ __device__ inline long long route_table_bytes(int lanes,
                                                       int n_nodes) {
  return (8LL * lanes * (n_nodes + 1) + 15) / 16 * 16;
}

// Bytes of one feature's row in the staged tile: kStagedRows bins and 16
// more, because a feature's row of bins need not start on 16 bytes and the
// copy keeps each 16-byte chunk at its offset. plan_route mirrors it.
__host__ __device__ constexpr int staged_row_bytes(int itemsize) {
  return kStagedRows * itemsize + 16;
}

// Shared memory of route_staged_kernel: the packed tables, the feature ->
// staged-row map and the list of staged features (F ints each), and a
// kStagedRows-row tile of at most min(F, lanes x n_nodes) features' bins —
// the features some lane's table splits on. plan_route mirrors it.
__host__ __device__ inline long long route_staged_bytes(int F, int lanes,
                                                        int n_nodes,
                                                        int itemsize) {
  const long long used = F < (long long)lanes * n_nodes
                             ? F : (long long)lanes * n_nodes;
  return route_table_bytes(lanes, n_nodes) + (8LL * F + 15) / 16 * 16 +
         used * staged_row_bytes(itemsize);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

struct RouteArgs {
  const void* xb;          // [F, N] bins
  const float* node;       // [lanes, N] node ids
  const int* tf;           // [lanes, n_nodes] split tables
  const int* tt;
  const int* tm;
  float* out;              // [lanes, N] next node ids
  long long N;
  int F, lanes, n_nodes;
};

// Route rows i .. i + 3 of every lane of the staged tile, kLaneGroup lanes
// at a time: the node loads of a group are issued first (the first group's
// while the tile's copy lands), then its split lookups in the packed tables
// `tbl` and its bin reads from the tile `xs` (a split's x is the byte of its
// feature's row 0 in `xs` + 1; 0 reads feature 0 from global memory), and
// only then any decision; new ids go out as 4-row vectors. Rows past N are
// neither read nor stored.
template <typename XT, bool VEC>
__device__ __forceinline__ void route_rows(const RouteArgs& a, long long i,
                                           const int2* tbl,
                                           const unsigned char* xs) {
  constexpr int G = kLaneGroup;
  const long long N = a.N;
  const int n1 = a.n_nodes + 1;
  const int row = kLaneRows * threadIdx.x;   // of i in the tile
  for (int k0 = 0; k0 < a.lanes; k0 += G) {
    float nd[G][kLaneRows];
#pragma unroll
    for (int j = 0; j < G; ++j)
      if (k0 + j < a.lanes && i < N)
        load_rows<VEC>(a.node + (long long)(k0 + j) * N, i, N, nd[j]);
    if (k0 == 0) {   // the tile's bins have landed
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
    }
    int2 sp[G][kLaneRows];
    int x[G][kLaneRows];
#pragma unroll
    for (int j = 0; j < G; ++j) {
#pragma unroll
      for (int e = 0; e < kLaneRows; ++e) {
        sp[j][e] = make_int2(0, 0);
        x[j][e] = 0;
        if (k0 + j >= a.lanes || i + e >= N) continue;
        const float v = nd[j][e];
        const bool in = v >= 0.f && v < (float)a.n_nodes;
        sp[j][e] = tbl[(k0 + j) * n1 + (in ? (int)v : a.n_nodes)];
        const int at = sp[j][e].x & 0x7fffffff;
        x[j][e] = at ? (int)*reinterpret_cast<const XT*>(
                           xs + at - 1 + (row + e) * (int)sizeof(XT))
                     : (int)__ldg(static_cast<const XT*>(a.xb) + i + e);
      }
    }
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if (k0 + j >= a.lanes || i >= N) continue;
      float o[kLaneRows];
#pragma unroll
      for (int e = 0; e < kLaneRows; ++e) {
        const int right =
            (x[j][e] > sp[j][e].y) || (x[j][e] == 0 && sp[j][e].x < 0);
        o[e] = 2.f * nd[j][e] + (float)right;
      }
      store_rows<VEC>(a.out + (long long)(k0 + j) * N, i, N, o);
    }
  }
}

// B3, staged path. Replaces _route_kernel (pallas_hist.py:598), the same
// function as route_kernel. Bound on this card: bytes, as route_kernel.
// The row-mapped kernel pays a 32-byte sector for each gathered bin, once
// per lane. Here one block takes a 512-row tile for every lane: it first
// packs the split tables into shared memory (feature | missing bit,
// threshold; one entry more for node ids outside the table) and finds the
// features they use (every lane, every node: at most lanes x n_nodes of
// F); then, per tile, it copies just those features' rows of bins into
// shared memory in 16-byte chunks with coalesced cp.async (a feature's row
// need not start on 16 bytes: the chunks start at its start rounded down,
// and each lands at its own offset) while the node ids of 4 lanes load as
// 16-byte vectors, and decides 4 rows x every lane a thread from shared
// memory (a thread's 4 rows are one word of a feature row: no bank
// conflicts for 1-byte bins). A tile costs F_used rows of bins read whole, in place of
// sectors gathered for single bins. Node ids outside the table route on
// feature 0, read from global memory. The grid is persistent, several
// blocks an SM, so that one block's copy overlaps another's decisions.
template <typename XT, bool VEC>
__global__ void __launch_bounds__(kStagedThreads, 6)
    route_staged_kernel(const RouteArgs a) {
  extern __shared__ __align__(16) unsigned char lane_smem[];
  __shared__ int n_used;
  constexpr int RB = staged_row_bytes(sizeof(XT));
  constexpr int CPR = RB / 16;   // 16-byte chunks of a staged row
  const int n1 = a.n_nodes + 1, tid = threadIdx.x;
  const long long N = a.N;
  const unsigned long long base = reinterpret_cast<unsigned long long>(a.xb);
  int2* tbl = reinterpret_cast<int2*>(lane_smem);
  int* fslot = reinterpret_cast<int*>(lane_smem +
                                      route_table_bytes(a.lanes, a.n_nodes));
  int* used = fslot + a.F;
  unsigned char* xs =
      reinterpret_cast<unsigned char*>(fslot) + (8LL * a.F + 15) / 16 * 16;
  for (int f = tid; f < a.F; f += kStagedThreads) fslot[f] = -1;
  for (int j = tid; j < a.lanes * n1; j += kStagedThreads) {
    const int k = j / n1, nd = j - k * n1;
    tbl[j] = pack_split(a.tf, a.tt, a.tm, (long long)k * a.n_nodes + nd,
                        nd < a.n_nodes, a.F);
  }
  __syncthreads();
  for (int j = tid; j < a.lanes * n1; j += kStagedThreads)
    if (j % n1 != a.n_nodes) fslot[tbl[j].x & 0x7fffffff] = 1;
  __syncthreads();
  if (tid == 0) {
    int c = 0;
    for (int f = 0; f < a.F; ++f)
      if (fslot[f] > 0) {
        fslot[f] = c;
        used[c++] = f;
      }
    n_used = c;
  }
  __syncthreads();
  // the split's x: the byte of its feature's row 0 in the tile + 1 — a
  // tile starts on a multiple of 16 bytes of the feature's row, so the
  // row's offset in its first chunk is the same in every tile
  for (int j = tid; j < a.lanes * n1; j += kStagedThreads) {
    const int x = tbl[j].x, f = x & 0x7fffffff;
    const int at =
        j % n1 == a.n_nodes
            ? 0
            : 1 + fslot[f] * RB +
                  (int)((base + (unsigned long long)f * N * sizeof(XT)) & 15);
    tbl[j].x = at | (x & (int)0x80000000u);
  }
  __syncthreads();
  constexpr int R = kStagedRows;
  const int nu = n_used;
  const long long n_tiles = (N + R - 1) / R;
  const unsigned long long end =
      base + (unsigned long long)a.F * N * sizeof(XT);
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long r0 = t * R;
    const long long n_valid = N - r0 < R ? N - r0 : R;
    // the tile's bins [s, e) of each used feature, chunk by chunk from s
    // rounded down to 16 bytes, each chunk with one cp.async; only a chunk
    // that reaches outside the bin matrix (its first or its last) is copied
    // bin by bin, so no byte outside the matrix is read
    for (int c = tid; c < nu * CPR; c += kStagedThreads) {
      const int u = c / CPR, q = c - u * CPR;
      const unsigned long long s =
          base + ((unsigned long long)used[u] * N + r0) * sizeof(XT);
      const unsigned long long e = s + n_valid * sizeof(XT);
      const unsigned long long g = (s & ~15ULL) + 16ULL * q;
      unsigned char* d = xs + u * RB + 16 * q;
      if (g >= e) continue;
      if (g >= base && g + 16 <= end) {
        cp_async16(d, reinterpret_cast<const void*>(g));
      } else {
        for (int b = 0; b < 16; b += (int)sizeof(XT))
          if (g + b >= s && g + b < e)
            *reinterpret_cast<XT*>(d + b) =
                *reinterpret_cast<const XT*>(g + b);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
    route_rows<XT, VEC>(a, r0 + (long long)kLaneRows * tid, tbl, xs);
    __syncthreads();   // every thread is done with the tile
  }
}

// -- sorted path of route_hist ------------------------------------------------
//
// B2, sorted path. Replaces _route_hist_kernel (pallas_hist.py:713) at the
// deep levels of wide trees: the same function as route_hist_kernel, in
// four launches on one stream.
//   1. sort_count_kernel routes every row once (go_right), writes its new
//      node id and counts each lane's left rows by slot (the old node id),
//      one count row per unit of unit_rows rows;
//   2. sort_scan_kernel turns each lane's [slot][unit] counts into offsets
//      and each slot's start in the lane's list;
//   3. sort_scatter_kernel lists every counted row at its offset: a lane's
//      list holds its left rows ordered by slot, rows ascending inside a
//      slot (a stable partition: units in order, a unit's 256-row chunks in
//      order, a chunk's warps and lanes in order), with the row's payload
//      and derived count packed as a float4;
//   4. sorted_hist_kernel counts the lists.
// Bound on this card: the shared-memory read-modify-writes of the counting,
// as on the features path. What it repairs in the rows path: that path
// re-reads every row for each (slot tile, feature tile) pair, 984 pairs a
// lane at F = 164 and 1024 slots, and counts with f32 shared atomicAdd,
// which sm_90 runs as a compare-and-swap loop. Here each row is routed and
// listed once, and the counting reads only listed rows:
// - a warp takes 32 features of a feature tile (a thread one feature) and
//   one piece of piece_rows entries of a lane's list, and walks it in list
//   order, so it holds one slot's histogram at a time; every cell it
//   touches is its own thread's (layout [bin][channel][32 features]: the
//   thread's own bank), so counting is plain shared loads and stores, with
//   no atomics and no barriers;
// - the bins of a listed row come from the row-major copy [N, F]: the warp
//   reads its 32 features' bins of one row as one contiguous run, where the
//   [F, N] matrix would cost a 32-byte sector a bin; the 32 rows of a batch
//   are loaded before any is counted;
// - when the slot changes, the warp adds its slot's cells into the output
//   and zeroes them: a plain store where its piece holds the whole slot
//   (the one writer of those cells), else a global atomicAdd (a heavy slot,
//   split over pieces so that it keeps many SMs busy).
// Payloads sum in list order inside a piece, so a slot that lies in one
// piece sums alike on every run.

constexpr int kSortThreads = 256;    // sort_count / sort_scatter block
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kScanThreads = 1024;   // sort_scan block
constexpr int kMaxSortSlots = 4096;  // the scatter's offsets fit shared memory
constexpr int kSortedMaxThreads = 512;   // sorted_hist block: 16 warps

struct SortedArgs {
  const void* xb;        // [F, N] bins
  const void* xb_rows;   // [N, F] the same bins, row-major
  const float* pay;      // [lanes * C, N] payload channels
  const float* node;     // [lanes, N] node ids
  const int* tf;         // [lanes, S] split tables
  const int* tt;
  const int* tm;
  float* out;            // [lanes * S * Co, F * B]
  float* node_out;       // [lanes, N] next node ids
  float4* lpay;          // [lanes, N] listed payloads (workspace)
  int* lrow;             // [lanes, N] listed row ids
  int* lslot;            // [lanes, N] listed slots
  int* counts;           // [lanes, S, n_units] counts, then offsets
  int* start;            // [lanes, S + 1] each slot's first list entry
  long long N;
  int F, C, derive, S, B, lanes;
  int unit_rows, n_units;     // the sort's row units
  int piece_rows, n_pieces;   // the histogram's list pieces
  int f_tile, n_ftiles;       // features of a histogram block (32 a warp)
};

// Words (4 bytes) of the sorted path's workspace, in the order of
// SortedArgs: lpay, lrow, lslot, counts, start. plan_hist mirrors it.
__host__ __device__ inline long long sorted_work_words(int lanes, long long N,
                                                       int S, int n_units) {
  return (long long)lanes * (6 * N + (long long)S * n_units + S + 1);
}

// Shared memory of one sorted_hist_kernel block: a [B][Co][32] f32
// histogram a warp. plan_hist mirrors it.
__host__ __device__ inline long long sorted_smem_bytes(int f_tile, int B,
                                                       int Co) {
  return 4LL * f_tile * B * Co;
}

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// Step 1: route the unit's rows of lane blockIdx.y, write their new node
// ids, and count its left rows whose slot (node id) lies in [0, S); a
// warp's rows of one slot add their count once (an integer shared atomic,
// native on sm_90).
template <typename XT>
__global__ void __launch_bounds__(kSortThreads)
    sort_count_kernel(const SortedArgs a) {
  extern __shared__ int sort_smem[];
  const int S = a.S, k = blockIdx.y, u = blockIdx.x;
  const int lane = threadIdx.x & 31;
  int* cnt = sort_smem;        // [S]
  int* tbl = sort_smem + S;    // [3][S]
  for (int j = threadIdx.x; j < S; j += kSortThreads) {
    cnt[j] = 0;
    tbl[j] = a.tf[(long long)k * S + j];
    tbl[S + j] = a.tt[(long long)k * S + j];
    tbl[2 * S + j] = a.tm[(long long)k * S + j];
  }
  __syncthreads();
  const long long r0 = (long long)u * a.unit_rows;
  const long long r1 = min(a.N, r0 + a.unit_rows);
  const float* node_k = a.node + (long long)k * a.N;
  float* new_k = a.node_out + (long long)k * a.N;
  const XT* xb = static_cast<const XT*>(a.xb);
  for (long long i0 = r0; i0 < r1; i0 += kSortThreads) {
    const long long i = i0 + threadIdx.x;
    int s = -1;
    if (i < r1) {
      const float nd = node_k[i];
      const int right = go_right(xb, a.N, i, a.F, nd, S, tbl, tbl + S,
                                 tbl + 2 * S);
      new_k[i] = 2.f * nd + (float)right;
      if (!right && nd >= 0.f && nd < (float)S) s = (int)nd;
    }
    const unsigned peers = __match_any_sync(0xffffffffu, s);
    if (s >= 0 && lane == __ffs(peers) - 1) atomicAdd(cnt + s, __popc(peers));
  }
  __syncthreads();
  int* cnt_k = a.counts + (long long)k * S * a.n_units;
  for (int j = threadIdx.x; j < S; j += kSortThreads)
    cnt_k[(long long)j * a.n_units + u] = cnt[j];
}

// Step 2: lane blockIdx.x's counts [S][n_units], read in that order, become
// exclusive offsets in place; start[s] is the offset of (s, unit 0) and
// start[S] the lane's count of listed rows. Each thread scans a contiguous
// segment; one block-wide scan joins the segments.
__global__ void __launch_bounds__(kScanThreads)
    sort_scan_kernel(const SortedArgs a) {
  __shared__ int warp_sums[kScanThreads / 32];
  const int k = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long M = (long long)a.S * a.n_units;
  int* c = a.counts + (long long)k * M;
  int* st = a.start + (long long)k * (a.S + 1);
  const long long per = (M + kScanThreads - 1) / kScanThreads;
  const long long j0 = min(M, threadIdx.x * per), j1 = min(M, j0 + per);
  int sum = 0;
  for (long long j = j0; j < j1; ++j) sum += c[j];
  int x = sum;   // inclusive scan of the segments' sums, warp then block
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sums[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  int run = x - sum + (warp ? warp_sums[warp - 1] : 0);
  for (long long j = j0; j < j1; ++j) {
    const int v = c[j];
    c[j] = run;
    if (j % a.n_units == 0) st[j / a.n_units] = run;
    run += v;
  }
  if (threadIdx.x == kScanThreads - 1) st[a.S] = run;
}

// Step 3: list the unit's counted rows of lane blockIdx.y in order. A row
// counts where its node id lies in [0, S) and its new id is 2 * node (it
// went left). Per 256-row chunk: each warp ranks its rows among the warp's
// rows of the same slot (__match_any_sync), notes each slot's count in
// wcnt[warp][slot], and a row's place is the unit's running offset of its
// slot + the counts of the warps before it + its rank.
__global__ void __launch_bounds__(kSortThreads)
    sort_scatter_kernel(const SortedArgs a) {
  extern __shared__ int sort_smem[];
  const int S = a.S, k = blockIdx.y, u = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* off = sort_smem;         // [S]
  int* wcnt = sort_smem + S;    // [kSortWarps][S]
  const int* c_k = a.counts + (long long)k * S * a.n_units;
  for (int j = threadIdx.x; j < S; j += kSortThreads)
    off[j] = c_k[(long long)j * a.n_units + u];
  for (int j = threadIdx.x; j < kSortWarps * S; j += kSortThreads) wcnt[j] = 0;
  __syncthreads();
  const long long N = a.N;
  const long long r0 = (long long)u * a.unit_rows;
  const long long r1 = min(N, r0 + a.unit_rows);
  const float* node_k = a.node + (long long)k * N;
  const float* new_k = a.node_out + (long long)k * N;
  const float* pay_k = a.pay + (long long)k * a.C * N;
  float4* lp = a.lpay + (long long)k * N;
  int* lr = a.lrow + (long long)k * N;
  int* ls = a.lslot + (long long)k * N;
  const unsigned below = lanemask_lt();
  for (long long i0 = r0; i0 < r1; i0 += kSortThreads) {
    const long long i = i0 + threadIdx.x;
    int s = -1;
    if (i < r1) {
      const float nd = node_k[i];
      if (nd >= 0.f && nd < (float)S && new_k[i] == 2.f * nd) s = (int)nd;
    }
    const unsigned peers = __match_any_sync(0xffffffffu, s);
    const int rank = __popc(peers & below);
    const bool lead = s >= 0 && rank == 0;
    if (lead) wcnt[warp * S + s] = __popc(peers);
    __syncthreads();
    if (s >= 0) {
      int pos = off[s] + rank;
      for (int w = 0; w < warp; ++w) pos += wcnt[w * S + s];
      float p[kMaxChannels] = {0.f, 0.f, 0.f, 0.f};
      for (int c = 0; c < a.C; ++c) p[c] = pay_k[(long long)c * N + i];
      if (a.derive) p[a.C] = p[a.C - 1] > 0.f ? 1.f : 0.f;
      lp[pos] = make_float4(p[0], p[1], p[2], p[3]);
      lr[pos] = (int)i;
      ls[pos] = s;
    }
    __syncthreads();   // every place is taken before the offsets move on
    if (lead) {
      atomicAdd(off + s, __popc(peers));
      wcnt[warp * S + s] = 0;
    }
    __syncthreads();
  }
}

// Add this thread's cells of slot s (its feature, every bin and channel)
// into the output and zero them: a store where the piece [p0, p1) holds the
// whole slot, else an atomicAdd. Zero cells are skipped (the output starts
// at 0).
template <int CO>
__device__ __forceinline__ void flush_slot(float* h, float* out_f, int s,
                                           const int* st, long long p0,
                                           long long p1, int B, int co,
                                           long long FB, bool has) {
  const int Co = CO > 0 ? CO : co;
  const bool own = st[s] >= p0 && st[s + 1] <= p1;
  float* o = out_f + (long long)s * Co * FB;
  for (int b = 0; b < B; ++b) {
#pragma unroll
    for (int c = 0; c < kMaxChannels; ++c) {
      if (c >= Co) break;
      float* cell = h + (b * Co + c) * 32;
      const float v = *cell;
      if (v == 0.f) continue;
      *cell = 0.f;
      if (!has) continue;
      if (own)
        o[c * FB + b] = v;
      else
        atomicAdd(o + c * FB + b, v);
    }
  }
}

// Step 4: grid (n_pieces, lanes x n_ftiles), a warp per 32 features of the
// block's feature tile. Warps without features, and pieces past the lane's
// listed rows, return at once. CO as in hist_fm_kernel (3 or 4 fixed, 0
// read from the arguments).
template <typename XT, int CO>
__global__ void __launch_bounds__(kSortedMaxThreads)
    sorted_hist_kernel(const SortedArgs a) {
  extern __shared__ __align__(16) float sorted_smem[];
  const int Co = CO > 0 ? CO : a.C + a.derive;
  const int k = blockIdx.y / a.n_ftiles, ft = blockIdx.y % a.n_ftiles;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int fw = ft * a.f_tile + warp * 32;   // the warp's first feature
  if (fw >= a.F) return;
  const int f = fw + lane;
  const bool has = f < a.F;
  const long long N = a.N;
  const int* st = a.start + (long long)k * (a.S + 1);
  const long long L = st[a.S];
  const long long p0 = (long long)blockIdx.x * a.piece_rows;
  if (p0 >= L) return;
  const long long p1 = min(L, p0 + a.piece_rows);
  float* h = sorted_smem + warp * a.B * Co * 32 + lane;   // this thread's
  for (int j = 0; j < a.B * Co; ++j) h[j * 32] = 0.f;
  const XT* xr = static_cast<const XT*>(a.xb_rows) + (has ? f : 0);
  const float4* lp = a.lpay + (long long)k * N;
  const int* lr = a.lrow + (long long)k * N;
  const int* ls = a.lslot + (long long)k * N;
  const long long FB = (long long)a.F * a.B;
  float* out_f = a.out + (long long)k * a.S * Co * FB + (long long)f * a.B;
  int cur = -1;
  for (long long q0 = p0; q0 < p1; q0 += 32) {
    const long long q = q0 + lane;
    const bool in = q < p1;
    const int er = in ? __ldg(lr + q) : 0;
    const int es = in ? __ldg(ls + q) : -1;
    const float4 ep = in ? __ldg(lp + q) : make_float4(0.f, 0.f, 0.f, 0.f);
    const int n = (int)min(32LL, p1 - q0);
    int bn[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int r = __shfl_sync(0xffffffffu, er, j);
      bn[j] = (has && j < n) ? (int)__ldg(xr + (long long)r * a.F) : -1;
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      if (j >= n) break;
      const int s = __shfl_sync(0xffffffffu, es, j);
      if (s != cur) {
        if (cur >= 0)
          flush_slot<CO>(h, out_f, cur, st, p0, p1, a.B, Co, FB, has);
        cur = s;
      }
      const float v[kMaxChannels] = {__shfl_sync(0xffffffffu, ep.x, j),
                                     __shfl_sync(0xffffffffu, ep.y, j),
                                     __shfl_sync(0xffffffffu, ep.z, j),
                                     __shfl_sync(0xffffffffu, ep.w, j)};
      if ((unsigned)bn[j] < (unsigned)a.B) {
        float* cell = h + bn[j] * Co * 32;
#pragma unroll
        for (int c = 0; c < kMaxChannels; ++c)
          if (c < Co) cell[c * 32] += v[c];
      }
    }
  }
  if (cur >= 0) flush_slot<CO>(h, out_f, cur, st, p0, p1, a.B, Co, FB, has);
}

// Launch a kernel with `smem` bytes of dynamic shared memory.
template <typename Kernel, typename... Args>
int launch(Kernel kern, dim3 grid, int threads, int smem, cudaStream_t stream,
           Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// The features path: check the tiling against the kernel's own layout,
// then launch `blocks` blocks (a multiple of lanes x tiles).
template <typename XT, bool ROUTE>
int launch_fm(const FmArgs& a, int path, int blocks, int smem,
              cudaStream_t stream) {
  const bool priv = path == kPathPrivate;
  const long long need =
      fm_smem_bytes((int)sizeof(XT), a.f_tile, a.s_tile, a.C + a.derive, a.B,
                    priv ? kWarps : a.copies, priv, ROUTE ? a.S : 0);
  if (a.f_tile < 1 || a.f_tile > kMaxFTile || need != smem ||
      (!priv && (a.copies < 1 || kWarps % a.copies != 0)) ||
      blocks % (a.lanes * a.n_ftiles * a.n_stiles) != 0)
    return (int)cudaErrorInvalidValue;
  // the trees' payload (g, h and the derived count) gets its own code
  const bool co3 = a.C + a.derive == 3;
  if (priv)
    return co3 ? launch(hist_fm_kernel<XT, ROUTE, true, 3>, dim3(blocks),
                        kThreads, smem, stream, a)
               : launch(hist_fm_kernel<XT, ROUTE, true, 0>, dim3(blocks),
                        kThreads, smem, stream, a);
  return co3 ? launch(hist_fm_kernel<XT, ROUTE, false, 3>, dim3(blocks),
                      kThreads, smem, stream, a)
             : launch(hist_fm_kernel<XT, ROUTE, false, 0>, dim3(blocks),
                      kThreads, smem, stream, a);
}

template <typename XT>
int launch_hist(const void* xb, const float* pay, const float* slot,
                float* out, int F, long long N, int Fo, int C, int derive,
                int S, int B, int path, int f_tile, int s_tile, int copies,
                int blocks, long long rows_per_block, int smem,
                cudaStream_t stream) {
  const int n_ftiles = (F + f_tile - 1) / f_tile;
  const int n_stiles = (S + s_tile - 1) / s_tile;
  if (C < 1 || C + derive > kMaxChannels) return (int)cudaErrorInvalidValue;
  if (path == kPathRows) {
    if ((long long)smem != 4LL * s_tile * (C + derive) * f_tile * B)
      return (int)cudaErrorInvalidValue;
    return launch(hist_kernel<XT>, dim3(blocks, n_ftiles * n_stiles, Fo),
                  kRowThreads, smem, stream, static_cast<const XT*>(xb), pay,
                  slot, out, F, N, C, derive, S, B, f_tile, s_tile, n_ftiles,
                  rows_per_block);
  }
  if (path != kPathPrivate && path != kPathOwned)
    return (int)cudaErrorInvalidValue;
  const FmArgs a{xb, pay, slot, nullptr, nullptr, nullptr, out, nullptr, N,
                 F, C, derive, S, B, Fo, f_tile, s_tile, n_ftiles, n_stiles,
                 copies};
  return launch_fm<XT, false>(a, path, blocks, smem, stream);
}

template <typename XT>
int launch_route_hist(const void* xb, const float* pay, const float* node,
                      const int* tf, const int* tt, const int* tm, float* out,
                      float* node_out, int F, long long N, int Fo, int C,
                      int derive, int n_nodes, int B, int path, int f_tile,
                      int s_tile, int copies, int blocks,
                      long long rows_per_block, int smem,
                      cudaStream_t stream) {
  const int n_ftiles = (F + f_tile - 1) / f_tile;
  const int n_stiles = (n_nodes + s_tile - 1) / s_tile;
  if (C < 1 || C + derive > kMaxChannels) return (int)cudaErrorInvalidValue;
  if (path == kPathRows) {
    if ((long long)smem != 4LL * s_tile * (C + derive) * f_tile * B +
                               12LL * n_nodes)
      return (int)cudaErrorInvalidValue;
    return launch(route_hist_kernel<XT>,
                  dim3(blocks, n_ftiles * n_stiles, Fo), kRowThreads, smem,
                  stream, static_cast<const XT*>(xb), pay, node, tf, tt, tm,
                  out, node_out, F, N, C, derive, n_nodes, B, f_tile, s_tile,
                  n_ftiles, rows_per_block);
  }
  if (path != kPathPrivate && path != kPathOwned)
    return (int)cudaErrorInvalidValue;
  const FmArgs a{xb, pay, node, tf, tt, tm, out, node_out, N, F, C, derive,
                 n_nodes, B, Fo, f_tile, s_tile, n_ftiles, n_stiles, copies};
  return launch_fm<XT, true>(a, path, blocks, smem, stream);
}

// The sorted path: check the plan against the kernels' own layout, then
// launch the sort (count, scan, scatter) and, with `hist`, the histogram.
template <typename XT>
int launch_route_hist_sorted(SortedArgs a, void* work, int hist, int smem,
                             cudaStream_t stream) {
  const int Co = a.C + a.derive;
  if (a.C < 1 || Co > kMaxChannels || a.S < 1 || a.S > kMaxSortSlots ||
      a.unit_rows < 1 || a.piece_rows < 1 || a.f_tile < 32 ||
      a.f_tile % 32 != 0 || a.f_tile > kSortedMaxThreads ||
      smem != sorted_smem_bytes(a.f_tile, a.B, Co) ||
      reinterpret_cast<unsigned long long>(work) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  a.n_units = (int)((a.N + a.unit_rows - 1) / a.unit_rows);
  a.n_pieces = (int)((a.N + a.piece_rows - 1) / a.piece_rows);
  a.n_ftiles = (a.F + a.f_tile - 1) / a.f_tile;
  const long long LN = (long long)a.lanes * a.N;
  a.lpay = static_cast<float4*>(work);
  a.lrow = reinterpret_cast<int*>(a.lpay + LN);
  a.lslot = a.lrow + LN;
  a.counts = a.lslot + LN;
  a.start = a.counts + (long long)a.lanes * a.S * a.n_units;
  int e = launch(sort_count_kernel<XT>, dim3(a.n_units, a.lanes),
                 kSortThreads, 16 * a.S, stream, a);
  if (e) return e;
  e = launch(sort_scan_kernel, dim3(a.lanes), kScanThreads, 0, stream, a);
  if (e) return e;
  e = launch(sort_scatter_kernel, dim3(a.n_units, a.lanes), kSortThreads,
             4 * (1 + kSortWarps) * a.S, stream, a);
  if (e || !hist) return e;
  const dim3 grid(a.n_pieces, a.lanes * a.n_ftiles);
  if (Co == 3)
    return launch(sorted_hist_kernel<XT, 3>, grid, a.f_tile, smem, stream, a);
  if (Co == 4)
    return launch(sorted_hist_kernel<XT, 4>, grid, a.f_tile, smem, stream, a);
  return launch(sorted_hist_kernel<XT, 0>, grid, a.f_tile, smem, stream, a);
}

// route: the rows path on a grid (blocks, lanes) of `threads`; the staged
// path on a persistent grid of `blocks`, after checking the launch shape
// against the kernel's own layout.
template <typename XT>
int launch_route(const RouteArgs& a, int path, int blocks, int threads,
                 int smem, cudaStream_t stream) {
  if (path == kRoutePathRows)
    return launch(route_kernel<XT>, dim3(blocks, a.lanes), threads, 0, stream,
                  static_cast<const XT*>(a.xb), a.node, a.tf, a.tt, a.tm,
                  a.out, a.F, a.N, a.n_nodes);
  if (path != kRoutePathStaged || threads != kStagedThreads ||
      smem != route_staged_bytes(a.F, a.lanes, a.n_nodes, sizeof(XT)))
    return (int)cudaErrorInvalidValue;
  const bool vec = reinterpret_cast<unsigned long long>(a.node) % 16 == 0 &&
                   reinterpret_cast<unsigned long long>(a.out) % 16 == 0 &&
                   a.N % kLaneRows == 0;
  return vec ? launch(route_staged_kernel<XT, true>, dim3(blocks), threads,
                      smem, stream, a)
             : launch(route_staged_kernel<XT, false>, dim3(blocks), threads,
                      smem, stream, a);
}

// Call fn with a value of the bin type of xb_kind: 0 = int8, 1 = uint8,
// 2 = int32 (the bin_dtype widths).
template <typename Fn>
int by_kind(int xb_kind, Fn fn) {
  switch (xb_kind) {
    case 0: return fn((signed char)0);
    case 1: return fn((unsigned char)0);
    case 2: return fn(0);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// path: 0 = rows, 1 = features with a histogram per warp, 2 = features with
// `copies` histograms whose slots the warps own. blocks: the rows path's
// row ranges (its grid is blocks x tiles x Fo), the features path's whole
// grid. rows_per_block: the rows path's rows of one block (unused by the
// features path). smem: the dynamic shared memory of one block, as
// plan_hist computed it.
int tk_hist(const void* xb, int xb_kind, const float* pay, const float* slot,
            float* out, int F, long long N, int Fo, int C, int derive, int S,
            int B, int path, int f_tile, int s_tile, int copies, int blocks,
            long long rows_per_block, int smem, void* stream) {
  return by_kind(xb_kind, [&](auto tag) {
    return launch_hist<decltype(tag)>(
        xb, pay, slot, out, F, N, Fo, C, derive, S, B, path, f_tile, s_tile,
        copies, blocks, rows_per_block, smem,
        static_cast<cudaStream_t>(stream));
  });
}

int tk_route_hist(const void* xb, int xb_kind, const float* pay,
                  const float* node, const int* tf, const int* tt,
                  const int* tm, float* out, float* node_out, int F,
                  long long N, int Fo, int C, int derive, int n_nodes, int B,
                  int path, int f_tile, int s_tile, int copies, int blocks,
                  long long rows_per_block, int smem, void* stream) {
  return by_kind(xb_kind, [&](auto tag) {
    return launch_route_hist<decltype(tag)>(
        xb, pay, node, tf, tt, tm, out, node_out, F, N, Fo, C, derive,
        n_nodes, B, path, f_tile, s_tile, copies, blocks, rows_per_block,
        smem, static_cast<cudaStream_t>(stream));
  });
}

// route_hist's sorted path (plan_hist's "sorted"): xb_rows the bins
// row-major [N, F]; work a 16-byte aligned workspace of sorted_work_words
// words; f_tile the features of a histogram block (its threads); unit_rows
// the sort's rows a count unit, piece_rows the histogram's list entries a
// block; hist = 0 runs the sort alone (its time, and its lists in work).
int tk_route_hist_sorted(const void* xb, const void* xb_rows, int xb_kind,
                         const float* pay, const float* node, const int* tf,
                         const int* tt, const int* tm, float* out,
                         float* node_out, void* work, int F, long long N,
                         int Fo, int C, int derive, int n_nodes, int B,
                         int f_tile, int unit_rows, int piece_rows, int hist,
                         int smem, void* stream) {
  const SortedArgs a{xb, xb_rows, pay, node, tf, tt, tm, out, node_out,
                     nullptr, nullptr, nullptr, nullptr, nullptr, N, F, C,
                     derive, n_nodes, B, Fo, unit_rows, 0, piece_rows, 0,
                     f_tile, 0};
  return by_kind(xb_kind, [&](auto tag) {
    return launch_route_hist_sorted<decltype(tag)>(
        a, work, hist, smem, static_cast<cudaStream_t>(stream));
  });
}

// path: 0 = rows (row-mapped, grid blocks x Fo of `threads`), 1 = staged
// (persistent grid of `blocks`); smem: the dynamic shared memory of one
// block, as plan_route computed it.
int tk_route(const void* xb, int xb_kind, const float* node, const int* tf,
             const int* tt, const int* tm, float* out, int F, long long N,
             int Fo, int n_nodes, int path, int blocks, int threads, int smem,
             void* stream) {
  const RouteArgs a{xb, node, tf, tt, tm, out, N, F, Fo, n_nodes};
  return by_kind(xb_kind, [&](auto tag) {
    return launch_route<decltype(tag)>(a, path, blocks, threads, smem,
                                       static_cast<cudaStream_t>(stream));
  });
}

// A grid of blocks x Fo blocks of `threads` (plan_lookup).
int tk_lookup(const float* tbl, const float* idx, float* out, int M,
              long long N, int Fo, int blocks, int threads, void* stream) {
  return launch(lookup_kernel, dim3(blocks, Fo), threads, 0,
                static_cast<cudaStream_t>(stream), tbl, idx, out, M, N);
}

const char* tk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
