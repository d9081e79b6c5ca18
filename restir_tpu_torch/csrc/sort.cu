// Ray order for the walks: coherence keys, a one-sweep LSD radix sort
// written by hand, and a permuted gather / scatter of ray channels, with
// a plain copy of a pack as the gather's floor. Part of the main kernel
// library: B13's closest hit (the ray query, intersect.cu) sorts its rays
// with the ray key and this sort, and the stage probes (restir_tpu_torch
// /prof) call the same kernels. The C names keep the `restir_prof_`
// prefix of the probes that introduced them.
//
// Replaces the TPU probes prof/prof_take.py (the payload gather of the
// 9-channel rp pack by the wavefront permutation, and `_pin` at :140, an
// identity copy of that pack through VMEM) and prof/prof_wavefront.py
// (`jnp.argsort` of a coherence key, the payload gather, and the take by
// the inverse permutation at :213). Plain twins
// (restir_tpu_torch/ops/kernels/ray_order.py,
// restir_tpu_torch/prof/kernels.py): the torch keys, torch.sort
// (stable=True), index_select, an indexed store and clone; every result
// equals its twin bit for bit.
//
// The ray key (ray_key_kernel) groups B13's closest-hit rays by the loop
// their walk runs: its high bits are the ray's class, the MTBVH table of
// -d and the signs of the inverse direction (bvh.cuh: the table fixes
// the dominant axis's sign, so 24 classes), or one class for the rays
// that take `slab` (an infinite direction or origin component); lanes
// not cast and rays with a NaN component get the dead key, the largest.
// Its low bits order a class by the origin's Morton code in the scene's
// box, then a direction cell.
//
// Bound: bytes. The keys read a ray's two points and a flag and write 4
// bytes; the sort reads its keys and writes the sorted keys and the
// permutation once (each pass moves them again; its look-back words and
// histograms are a few per cent of that); the gather reads the
// permutation and C words at permuted columns and writes C words in
// order; the scatter the reverse; the copy reads and writes each float4
// once. The gather's and scatter's permuted accesses cost a 32-byte
// sector a word: they run a group of rows at a time (blockIdx.y), so the
// rows being read at random stay in L2. Moving all nine rows of the
// hall's 1080p [9, R] pack per column, with the permutation read once,
// took twice as long on an H100 (75 MB of rows in flight overflow the
// 50 MB L2); a row at a time beats index_select. B13's [R, 3] inputs
// move an array at a time, each ray's three words from one row.
//
// The sort, after Adinets and Merrill's one-sweep radix sort (2022):
// keys compare as unsigned with the sign bit flipped (int32's order),
// passes of 8-bit digits (four cover bit 30, which the dead key
// 0x7FFFFFFF sets; three cover a key below 2^24; three passes of 11-bit
// digits, 112 KB of shared memory a tile, took 0.157 ms against 0.083 for
// 2.07 M keys on an H100), 1 + passes launches:
//  (1) hist_kernel, a cooperative launch of a few blocks per SM, zeroes
//      the passes' tickets and first look-back buffer, waits for the
//      grid, counts the digits of every pass in one read of the keys
//      (a shared-memory histogram per block, added to the global one),
//      waits for the grid again, and block p turns pass p's counts into
//      each digit's first place;
//  (2) one onesweep_kernel per pass. A block takes its tile from an
//      atomic ticket, so every tile before it has started. Its warps
//      count the tile's digits (each warp owns 512 consecutive keys, held
//      in registers; shared atomics into the warp's own row) and it
//      publishes each digit's count flagged as the tile's aggregate. It
//      places its keys in shared memory in digit order (warps in order,
//      rounds in order, a key's rank among equal digits of its round by
//      lane, __match_any_sync: stable, as torch.sort(stable=True)), then
//      looks back over the tiles before it, adding aggregates until it
//      meets an inclusive prefix, publishes its own inclusive prefix, and
//      writes the tile out in runs of equal digits.
// A look-back word is its flag in the top two bits and a count in the low
// 30 (so r < 2^30). Two buffers of words alternate between the passes;
// each pass zeroes its tile's row of the buffer the next pass takes.
// Look-back needs no bound on the number of tiles: any r < 2^30 sorts.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bvh.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kRounds = 16;  // a warp's rounds of 32 keys
constexpr int kWarps = kThreads / 32;
constexpr int kWarpKeys = 32 * kRounds;        // 512
constexpr int kSortTile = kWarps * kWarpKeys;  // 4096 keys a block
constexpr uint32_t kDead = 0x7FFFFFFFu;        // the key of a lane not cast
constexpr uint32_t kSign = 0x80000000u;
constexpr uint32_t kAggregate = 1u << 30;  // look-back flags
constexpr uint32_t kPrefix = 2u << 30;
constexpr uint32_t kCountMask = kAggregate - 1u;
constexpr int kTickets = 32;  // ints before the look-back buffers
constexpr int kMaxSpins = 1 << 26;  // polls of one look-back word
constexpr int kLookWindow = 8;  // look-back words a thread loads at once

// ---- the coherence key ---------------------------------------------------

// floor(((p - lo) / (hi - lo)) clamped to [0, 1 - 2^-24) x 2^bits), the
// twin's float32 ops one by one (no product is contracted here).
__device__ __forceinline__ uint32_t cell(float p, float lo, float ext,
                                         int bits) {
  float u = __fdiv_rn(__fsub_rn(p, lo), ext);
  if (!(u >= 0.0f)) u = 0.0f;  // NaN too
  u = fminf(u, 0.99999994f);
  return (uint32_t)__float2int_rz(__fmul_rn(u, (float)(1 << bits)));
}

// The bits of q (< 2^10) spread to every third bit: bit b to bit 3b.
__device__ __forceinline__ uint32_t spread3(uint32_t q) {
  q = (q | (q << 16)) & 0x030000FFu;
  q = (q | (q << 8)) & 0x0300F00Fu;
  q = (q | (q << 4)) & 0x030C30C3u;
  return (q | (q << 2)) & 0x09249249u;
}

// Bit b of axis a's cell at bit 3b + a.
__device__ __forceinline__ uint32_t morton(float x, float y, float z,
                                           const float* lo,
                                           const float* ext, int bits) {
  return spread3(cell(x, lo[0], ext[0], bits)) |
         (spread3(cell(y, lo[1], ext[1], bits)) << 1) |
         (spread3(cell(z, lo[2], ext[2], bits)) << 2);
}

// 4 bits an axis of the direction x -> y over its largest component.
__device__ __forceinline__ uint32_t direction(float sx, float sy, float sz) {
  const float m = fmaxf(fmaxf(fabsf(sx), fabsf(sy)), fmaxf(fabsf(sz), 1e-30f));
  const float s[3] = {sx, sy, sz};
  uint32_t code = 0;
  for (int a = 0; a < 3; ++a) {
    float u = __fmul_rn(__fadd_rn(__fdiv_rn(s[a], m), 1.0f), 0.5f);
    if (!(u >= 0.0f)) u = 0.0f;
    u = fminf(u, 0.99999994f);
    code = (code << 4) | (uint32_t)__float2int_rz(__fmul_rn(u, 16.0f));
  }
  return code;
}

__global__ void __launch_bounds__(kThreads)
    key_kernel(const float* __restrict__ x, const float* __restrict__ y,
               const uint8_t* __restrict__ live, int r, float lox,
               float loy, float loz, float hix, float hiy, float hiz,
               int order, uint32_t* __restrict__ key) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= r) return;
  if (!live[i]) {
    key[i] = kDead;
    return;
  }
  const float lo[3] = {lox, loy, loz};
  const float ext[3] = {__fsub_rn(hix, lox), __fsub_rn(hiy, loy),
                        __fsub_rn(hiz, loz)};
  const float px = x[3 * i], py = x[3 * i + 1], pz = x[3 * i + 2];
  const float tx = y[3 * i], ty = y[3 * i + 1], tz = y[3 * i + 2];
  uint32_t k;
  if (order == 0) {  // origin: Morton code, 10 bits an axis
    k = morton(px, py, pz, lo, ext, 10);
  } else if (order == 1) {  // target cell (3 bits an axis), then origin (7)
    k = (morton(tx, ty, tz, lo, ext, 3) << 21) | morton(px, py, pz, lo, ext, 7);
  } else {  // direction (4 bits an axis), then origin (6)
    k = (direction(__fsub_rn(tx, px), __fsub_rn(ty, py), __fsub_rn(tz, pz))
         << 18) |
        morton(px, py, pz, lo, ext, 6);
  }
  key[i] = k;
}

// The ray key of B13's closest hit (ray_order.ray_key_ref), 24 bits, so
// three sort passes order it: the class in the top 5 (0-23: table t of
// -d and the inverse direction's signs on the two other axes, t * 4 +
// (the lower axis negative) + 2 (the higher axis negative); 24: the
// `slab` rays), then the origin's Morton code (5 bits an axis) and the
// direction cell of those two axes (|d_b| / |d_a| for the table's axis
// a, 2 bits each). Lanes with active 0 and rays with a NaN component get
// the dead key 2^24 - 1, the largest. The box is the root node's of the
// walk's rows [6B, 8] (row 0: lo, prim; hi, miss). On the hall's
// first-bounce rays an H100 walked them in 1.428 ms in this order, 1.488
// with the direction cells first, 1.557 with 3-bit cells and 6 Morton
// bits (29 bits, four passes) and 1.42-1.47 in other orders with the
// origin first (PERF.md).
constexpr int kRayDirBits = 2, kRayMortonBits = 5;
constexpr uint32_t kRayDead = 0xFFFFFFu;

__global__ void __launch_bounds__(kThreads)
    ray_key_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   const uint8_t* __restrict__ active,
                   const float* __restrict__ rows, int r,
                   uint32_t* __restrict__ key) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= r) return;
  const float ov[3] = {o[3 * i], o[3 * i + 1], o[3 * i + 2]};
  const float dv[3] = {d[3 * i], d[3 * i + 1], d[3 * i + 2]};
  const bool nan = isnan(ov[0]) || isnan(ov[1]) || isnan(ov[2]) ||
                   isnan(dv[0]) || isnan(dv[1]) || isnan(dv[2]);
  if (nan || (active != nullptr && !active[i])) {
    key[i] = kRayDead;
    return;
  }
  const float lo[3] = {__ldg(rows), __ldg(rows + 1), __ldg(rows + 2)};
  const float ext[3] = {__fsub_rn(__ldg(rows + 4), lo[0]),
                        __fsub_rn(__ldg(rows + 5), lo[1]),
                        __fsub_rn(__ldg(rows + 6), lo[2])};
  const int t = restir::mtbvh_id(-dv[0], -dv[1], -dv[2]);
  const int a = t >> 1, b = a == 0 ? 1 : 0, c = a == 2 ? 1 : 2;
  const bool slab = restir::safe_inv(dv[0]) == 0.0f ||
                    restir::safe_inv(dv[1]) == 0.0f ||
                    restir::safe_inv(dv[2]) == 0.0f || isinf(ov[0]) ||
                    isinf(ov[1]) || isinf(ov[2]);
  const uint32_t cls =
      slab ? 24u
           : (uint32_t)(t * 4 + (dv[b] < 0.0f ? 1 : 0) +
                        (dv[c] < 0.0f ? 2 : 0));
  const float m = fabsf(dv[a]);
  const uint32_t dir = (cell(fabsf(dv[b]), 0.0f, m, kRayDirBits)
                        << kRayDirBits) |
                       cell(fabsf(dv[c]), 0.0f, m, kRayDirBits);
  key[i] = (cls << (2 * kRayDirBits + 3 * kRayMortonBits)) |
           (morton(ov[0], ov[1], ov[2], lo, ext, kRayMortonBits)
            << (2 * kRayDirBits)) |
           dir;
}

// ---- the one-sweep radix sort ----------------------------------------------

constexpr int kBits = 8;
constexpr int kRadix = 1 << kBits;  // 256: a thread owns one digit
constexpr int kPasses = 4;  // the most passes a sort runs
constexpr int kSortBlocks = 4;  // tiles an SM holds (64 registers a thread)
static_assert(kRadix == kThreads, "a thread owns one digit");

__device__ __forceinline__ int digit_of(uint32_t key, int shift) {
  return (int)(((key ^ kSign) >> shift) & (uint32_t)(kRadix - 1));
}

// Exclusive scan over the block of one int a thread (warp shuffles, then
// the warps' totals). Ends with the block in step, so `warp_sum` may be
// used again.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  int before = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) before += w < warp ? warp_sum[w] : 0;
  __syncthreads();
  return before + x - v;
}

// The digit counts of every pass in one read of the keys. count / first
// [passes][radix]; zero: the tickets and the first look-back buffer
// (n_zero words), zeroed before any pass runs.
template <int PASSES>
__global__ void __launch_bounds__(kThreads)
    hist_kernel(const uint32_t* __restrict__ keys, int r, int vec,
                int* __restrict__ count, int* __restrict__ first,
                uint32_t* __restrict__ zero, long long n_zero) {
  constexpr int kBins = kPasses * kRadix;
  __shared__ int h[kBins];
  __shared__ int warp_sum[kWarps];
  cg::grid_group grid = cg::this_grid();
  const long long gid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long nth = (long long)gridDim.x * kThreads;
  for (long long i = gid; i < kBins; i += nth) count[i] = 0;
  for (long long i = gid; i < n_zero; i += nth) zero[i] = 0u;
  for (int i = threadIdx.x; i < kBins; i += kThreads) h[i] = 0;
  grid.sync();
  auto add = [&](uint32_t k) {
    k ^= kSign;
#pragma unroll
    for (int p = 0; p < PASSES; ++p)
      atomicAdd(&h[p * kRadix + ((k >> (kBits * p)) & (kRadix - 1))], 1);
  };
  long long done = 0;
  if (vec) {  // 16-byte aligned: four keys a load
    const long long r4 = r >> 2;
    const uint4* k4 = reinterpret_cast<const uint4*>(keys);
    for (long long i = gid; i < r4; i += nth) {
      const uint4 v = __ldg(k4 + i);
      add(v.x);
      add(v.y);
      add(v.z);
      add(v.w);
    }
    done = 4 * r4;
  }
  for (long long i = done + gid; i < r; i += nth) add(__ldg(keys + i));
  __syncthreads();
  for (int i = threadIdx.x; i < kBins; i += kThreads)
    if (h[i]) atomicAdd(count + i, h[i]);
  grid.sync();
  for (int p = blockIdx.x; p < PASSES; p += gridDim.x) {
    const int d = p * kRadix + threadIdx.x;
    first[d] = block_exclusive_scan(__ldcg(count + d), warp_sum);
  }
}

struct SortSmem {
  int cnt[kWarps][kRadix];  // per warp: counts, then places
  int lstart[kRadix];       // a digit's first place in the tile
  int gstart[kRadix];       // ... in the output
  uint32_t key[kSortTile];
  int val[kSortTile];
  int warp_sum[kWarps];
  int tile;
};

// The digit of the key a lane holds in round i (kRadix where past r).
__device__ __forceinline__ int lane_digit(uint32_t key, int k, int r,
                                          int shift) {
  return k < r ? digit_of(key, shift) : kRadix;
}

// One pass: keys and values of a tile to their places. vin null: the
// values are the keys' indices (the first pass). look: this pass's
// look-back words [tiles][radix]; next: the next pass's (null on the
// last), whose row of this tile is zeroed here.
__global__ void __launch_bounds__(kThreads, kSortBlocks)
    onesweep_kernel(const uint32_t* __restrict__ kin,
                    const int* __restrict__ vin, uint32_t* __restrict__ kout,
                    int* __restrict__ vout, int r, int shift,
                    const int* __restrict__ first, uint32_t* ticket,
                    uint32_t* look, uint32_t* __restrict__ next) {
  __shared__ SortSmem S;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  if (t == 0) S.tile = (int)atomicAdd(ticket, 1u);
  for (int i = t; i < kWarps * kRadix; i += kThreads) (&S.cnt[0][0])[i] = 0;
  __syncthreads();
  const int tile = S.tile;
  const int b0 = tile * kSortTile;
  const int k0 = b0 + warp * kWarpKeys + lane;  // the lane's key in round 0
  uint32_t key[kRounds];
  int val[kRounds];
#pragma unroll
  for (int i = 0; i < kRounds; ++i) {
    const int k = k0 + 32 * i;
    key[i] = k < r ? __ldg(kin + k) : 0u;
  }
#pragma unroll
  for (int i = 0; i < kRounds; ++i) {
    const int k = k0 + 32 * i;
    val[i] = vin ? (k < r ? __ldg(vin + k) : 0) : k;
  }
#pragma unroll
  for (int i = 0; i < kRounds; ++i) {
    const int dg = lane_digit(key[i], k0 + 32 * i, r, shift);
    if (dg < kRadix) atomicAdd(&S.cnt[warp][dg], 1);
  }
  __syncthreads();

  // thread t owns digit t: the tile's count, published at once as its
  // aggregate, and its first place in the tile
  const int d = t;
  uint32_t* mine = look + (size_t)tile * kRadix;
  int tot = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) tot += S.cnt[w][d];
  *(volatile uint32_t*)(mine + d) =
      (tile == 0 ? kPrefix : kAggregate) | (uint32_t)tot;
  S.lstart[d] = block_exclusive_scan(tot, S.warp_sum);

  // each warp's first place of each digit in the tile
  {
    int run = S.lstart[d];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = S.cnt[w][d];
      S.cnt[w][d] = run;
      run += c;
    }
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int i = 0; i < kRounds; ++i) {
    const int dg = lane_digit(key[i], k0 + 32 * i, r, shift);
    const unsigned peers = __match_any_sync(0xffffffffu, dg);
    if (dg < kRadix) {
      const int at = S.cnt[warp][dg] + __popc(peers & below);
      S.key[at] = key[i];
      S.val[at] = val[i];
    }
    __syncwarp();
    if (dg < kRadix && (peers & below) == 0) S.cnt[warp][dg] += __popc(peers);
    __syncwarp();
  }

  // look back (after the placing, so the tiles before this one have
  // mostly published their inclusive prefixes): their counts, nearest
  // first, until an inclusive prefix
  uint32_t excl = 0;
  if (tile > 0) {
    bool found = false;
    for (int p = tile - 1; !found; p -= kLookWindow) {
      uint32_t w[kLookWindow];
#pragma unroll
      for (int k = 0; k < kLookWindow; ++k)  // before tile 0: never read
        w[k] = p - k >= 0 ? *(const volatile uint32_t*)(
                                look + (size_t)(p - k) * kRadix + d)
                          : kPrefix;
#pragma unroll
      for (int k = 0; k < kLookWindow; ++k) {
        if (found) break;
        uint32_t v = w[k];
        // a tile before this one has started, so it publishes within
        // microseconds; a wait of seconds is a fault: fail the launch
        for (int spins = 0; (v & ~kCountMask) == 0;) {
          if (++spins > kMaxSpins) __trap();
          v = *(const volatile uint32_t*)(look + (size_t)(p - k) * kRadix +
                                          d);
        }
        excl += v & kCountMask;
        found = (v & kPrefix) != 0;
      }
    }
    *(volatile uint32_t*)(mine + d) = kPrefix | (excl + (uint32_t)tot);
  }
  S.gstart[d] = __ldg(first + d) + (int)excl;
  if (next) next[(size_t)tile * kRadix + d] = 0u;
  __syncthreads();

  const int n = min(kSortTile, r - b0);
  for (int j = t; j < n; j += kThreads) {
    const uint32_t k = S.key[j];
    const int dg = digit_of(k, shift);
    const int dst = S.gstart[dg] + (j - S.lstart[dg]);
    kout[dst] = k;
    vout[dst] = S.val[j];
  }
}

// The histogram's grid: two blocks an SM where they fit (enough keys in
// flight; more add global atomics) for either build, cached per device.
cudaError_t hist_grid(int* blocks) {
  static int cached[64][2];
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int* c = cached[dev & 63];
  if (c[0] == 0) {
    e = cudaDeviceGetAttribute(&c[1], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    int fit3;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit3, hist_kernel<3>,
                                                      kThreads, 0);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &c[0], hist_kernel<kPasses>, kThreads, 0);
    if (e != cudaSuccess) return e;
    c[0] = c[0] < fit3 ? c[0] : fit3;
    if (c[0] <= 0) return cudaErrorInvalidConfiguration;
  }
  *blocks = (c[0] < 2 ? c[0] : 2) * c[1];
  return cudaSuccess;
}

long long sort_tiles(int r) { return (r + kSortTile - 1) / kSortTile; }

// ---- the permuted gather / scatter and the copy ---------------------------

constexpr int kMaxChannels = 16;
constexpr int kMaxGroup = 3;  // channels a block moves

// Word channels (4 bytes) or byte channels, each with its own base and the
// elements from one column to the next, in the source and the output;
// blocks move `group` channels each.
struct Channels {
  const void* src[kMaxChannels];
  void* dst[kMaxChannels];
  long long src_step[kMaxChannels];
  long long dst_step[kMaxChannels];
  int wide[kMaxChannels];  // 1: 4-byte words, 0: bytes
  int n, group;
};

// A block moves kThreads columns of one group of channels (blockIdx.y);
// the blocks of a group run before the next group's, so the rows read
// (gather) or written (scatter) at permuted columns are one group's at a
// time, a set L2 can hold. Each thread reads its perm entry once for the
// group (a warp's 32 consecutive ones), then issues the loads of all the
// group's channels before any store; the accesses in column order (the
// gather's stores, the scatter's loads) are a warp's 32 consecutive
// columns of a channel.
template <bool SCATTER>
__global__ void __launch_bounds__(kThreads)
    permute_kernel(const __grid_constant__ Channels ch,
                   const int* __restrict__ perm, int r) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int c0 = blockIdx.y * ch.group;
  const int nc = min(ch.group, ch.n - c0);
  // -1 past r; every access below is predicated on p >= 0 (an early
  // return took the hall's B13 inputs from 0.089 to 0.119 ms on an H100)
  const long long p = i < r ? __ldg(perm + i) : -1;
  uint32_t v[kMaxGroup];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g < nc) {
      const int c = c0 + g;
      const long long step = ch.src_step[c];
      if (p >= 0) {
        const long long s = (SCATTER ? i : p) * step;
        v[g] = ch.wide[c]
                   ? __ldg(static_cast<const uint32_t*>(ch.src[c]) + s)
                   : (uint32_t)__ldg(static_cast<const uint8_t*>(ch.src[c]) +
                                     s);
      }
    }
  }
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g < nc) {
      const int c = c0 + g;
      const long long step = ch.dst_step[c];
      if (p >= 0) {
        const long long d = (SCATTER ? p : i) * step;
        if (ch.wide[c])
          static_cast<uint32_t*>(ch.dst[c])[d] = v[g];
        else
          static_cast<uint8_t*>(ch.dst[c])[d] = (uint8_t)v[g];
      }
    }
  }
}

constexpr int kCopyUnroll = 2;  // float4 loads in flight a thread

// A block copies kCopyUnroll x kThreads float4s, all loaded before any is
// stored.
__global__ void __launch_bounds__(kThreads)
    copy_kernel(const float4* __restrict__ src, float4* __restrict__ dst,
                long long n4) {
  const long long i0 =
      (long long)blockIdx.x * kThreads * kCopyUnroll + threadIdx.x;
  float4 v[kCopyUnroll];
#pragma unroll
  for (int u = 0; u < kCopyUnroll; ++u)
    if (i0 + u * kThreads < n4) v[u] = src[i0 + u * kThreads];
#pragma unroll
  for (int u = 0; u < kCopyUnroll; ++u)
    if (i0 + u * kThreads < n4) dst[i0 + u * kThreads] = v[u];
}

}  // namespace

// key uint32 [r]: the coherence key of segment x -> y (float32 [r, 3]
// each) in the box lo..hi; order 0 origin, 1 target cell then origin, 2
// direction then origin (the orders of walk_ab.py, cut to 30 bits); lanes
// with live 0 get 0x7FFFFFFF (last).
extern "C" int restir_prof_key(const float* x, const float* y,
                               const uint8_t* live, int r, float lox,
                               float loy, float loz, float hix, float hiy,
                               float hiz, int order, uint32_t* key,
                               void* stream) {
  if (r <= 0 || order < 0 || order > 2) return (int)cudaErrorInvalidValue;
  key_kernel<<<(r + kThreads - 1) / kThreads, kThreads, 0,
               (cudaStream_t)stream>>>(x, y, live, r, lox, loy, loz, hix,
                                       hiy, hiz, order, key);
  return (int)cudaGetLastError();
}

// key uint32 [r]: the ray key of ray o -> d (float32 [r, 3] each; active
// null or bool [r]; ray_key_kernel) in the box of the walk's root row
// `rows`.
extern "C" int restir_ray_key(const float* o, const float* d,
                              const uint8_t* active, const float* rows,
                              int r, uint32_t* key, void* stream) {
  if (r <= 0) return (int)cudaErrorInvalidValue;
  ray_key_kernel<<<(r + kThreads - 1) / kThreads, kThreads, 0,
                   (cudaStream_t)stream>>>(o, d, active, rows, r, key);
  return (int)cudaGetLastError();
}

// Ints of the sort's scratch for r keys (0 < r < 2^30); -1 for another
// size.
extern "C" int restir_prof_sort_scratch(int r) {
  if (r <= 0 || r > (int)kCountMask) return -1;
  return (int)(kTickets + 2 * sort_tiles(r) * kRadix + 2 * kPasses * kRadix);
}

// Kernels the sorts of this process have launched (each launch the
// runtime took), so a caller can count a sort's launches without a trace.
static int g_sort_launches = 0;

extern "C" int restir_prof_sort_launches() { return g_sort_launches; }

// Sort int32 keys [r] (not modified) into keys_a with the permutation in
// vals_a (keys_b / vals_b: scratch of r each; scratch:
// restir_prof_sort_scratch(r) ints), stable: `passes` passes of 8-bit
// digits, 4 for any key, 3 for keys in [0, 2^24).
extern "C" int restir_prof_radix_sort(const uint32_t* keys, uint32_t* keys_a,
                                      int* vals_a, uint32_t* keys_b,
                                      int* vals_b, int* scratch, int r,
                                      int passes, void* stream) {
  if (r <= 0 || r > (int)kCountMask || passes < 3 || passes > kPasses)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const long long tiles = sort_tiles(r);
  uint32_t* ticket = reinterpret_cast<uint32_t*>(scratch);
  uint32_t* look[2] = {ticket + kTickets, ticket + kTickets + tiles * kRadix};
  int* count = scratch + kTickets + 2 * tiles * kRadix;
  int* first = count + kPasses * kRadix;

  int blocks;
  cudaError_t e = hist_grid(&blocks);
  if (e != cudaSuccess) return (int)e;
  int vec = (reinterpret_cast<uintptr_t>(keys) & 15) == 0;
  long long n_zero = kTickets + tiles * kRadix;
  void* args[] = {(void*)&keys, (void*)&r,     (void*)&vec,   (void*)&count,
                  (void*)&first, (void*)&ticket, (void*)&n_zero};
  e = cudaLaunchCooperativeKernel(
      passes == 3 ? (const void*)hist_kernel<3> : (const void*)hist_kernel<4>,
      blocks, kThreads, args, 0, st);
  if (e != cudaSuccess) return (int)e;
  ++g_sort_launches;

  const uint32_t* kin = keys;
  const int* vin = nullptr;
  for (int p = 0; p < passes; ++p) {
    const bool to_a = (passes - 1 - p) % 2 == 0;  // the last pass: a
    uint32_t* kout = to_a ? keys_a : keys_b;
    int* vout = to_a ? vals_a : vals_b;
    uint32_t* next = p + 1 < passes ? look[(p + 1) % 2] : nullptr;
    onesweep_kernel<<<(int)tiles, kThreads, 0, st>>>(
        kin, vin, kout, vout, r, kBits * p, first + p * kRadix, ticket + p,
        look[p % 2], next);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    ++g_sort_launches;
    kin = kout;
    vin = vout;
  }
  return (int)cudaSuccess;
}

// n channels (n <= 16) of r columns: gather (scatter 0) writes column i
// of each output channel from column perm[i] of its source; scatter (1)
// writes column perm[i] from column i. Host arrays of n entries: the
// channels' source and output bases, their steps in elements from one
// column to the next, and wide (1: 4-byte elements, 0: bytes). Blocks
// move `group` channels each (1..3).
extern "C" int restir_prof_permute(const long long* src,
                                   const long long* src_step,
                                   const long long* dst,
                                   const long long* dst_step,
                                   const int* wide, int n, int group,
                                   const int* perm, int r, int scatter,
                                   void* stream) {
  if (r <= 0 || n <= 0 || n > kMaxChannels || group <= 0 ||
      group > kMaxGroup)
    return (int)cudaErrorInvalidValue;
  Channels ch = {};
  for (int c = 0; c < n; ++c) {
    ch.src[c] = reinterpret_cast<const void*>(src[c]);
    ch.dst[c] = reinterpret_cast<void*>(dst[c]);
    ch.src_step[c] = src_step[c];
    ch.dst_step[c] = dst_step[c];
    ch.wide[c] = wide[c];
  }
  ch.n = n;
  ch.group = group;
  const dim3 grid((r + kThreads - 1) / kThreads, (n + group - 1) / group);
  const cudaStream_t st = (cudaStream_t)stream;
  if (scatter)
    permute_kernel<true><<<grid, kThreads, 0, st>>>(ch, perm, r);
  else
    permute_kernel<false><<<grid, kThreads, 0, st>>>(ch, perm, r);
  return (int)cudaGetLastError();
}

// dst = src, n floats (n % 4 == 0, both 16-byte aligned).
extern "C" int restir_prof_copy(const float* src, float* dst, long long n,
                                void* stream) {
  if (n <= 0 || n % 4 != 0 ||
      ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) &
       15) != 0)
    return (int)cudaErrorInvalidValue;
  const long long n4 = n / 4;
  const long long per = (long long)kThreads * kCopyUnroll;
  copy_kernel<<<(int)((n4 + per - 1) / per), kThreads, 0,
                (cudaStream_t)stream>>>(reinterpret_cast<const float4*>(src),
                                        reinterpret_cast<float4*>(dst), n4);
  return (int)cudaGetLastError();
}
