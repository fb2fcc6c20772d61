// Certified refills spread over the card, shared by lens_stats_wgmma.cu and
// lens_stats_splitv.cu (each includes it inside its anonymous namespace).
//
// A refill pass of a top-k above the long list (ops/lens_kernel.py
// `certify_top_k`) lists, per (chunk, row) pair still open, the KMAX_WIDE
// keys below that pair's ceiling.  Few pairs stay open, and they cluster:
// one row whose whole top-k lies in one chunk leaves one chunk to stream.
// Run on the first pass's plan, that chunk would be streamed by the one
// block that owns it while every other SM idles.  So a refill runs on a
// fixed grid of one block per SM and deals the work out evenly:
//
// - A unit is what one block of the first pass owns: a (chunk, row tile)
//   of the wgmma kernel, a chunk of the split-V kernel (one row tile).  Its
//   items are its plan tiles: a 256-column vocab tile (wgmma), a 32-row tile
//   of E, one TMA box (split-V, which loads only the boxes of its items and
//   leaves each at its place in the 128-row step of the first pass).  Each
//   logit is the product of the same wgmma at the same place in its tile,
//   so it comes out bit-equal to the first pass's and the ceilings compare
//   like with like.
// - `plan_kernel`, one block launched just before the pass, reads the
//   ceilings and writes the work list: the open units (those with an open
//   pair) in unit order and where each one's items start in the list of
//   all their items.  Nothing is read on the host, so the grid is fixed and
//   the pass captures in a CUDA graph.
// - Block b of G takes items [b W / G, (b + 1) W / G) of the W listed,
//   possibly across several units (spans).  A span that is a whole unit
//   writes its lists where the first pass would; a piece of a unit writes
//   its lists (the KMAX_WIDE keys below the ceiling among its items) into
//   slot m + b of a scratch (m the unit's place in the list; the slots of
//   different pieces never meet), adds its items to the unit's ticket, and
//   the block whose items complete the unit merges its pieces into the
//   unit's lists (`merge_pieces`).  The L largest keys below a ceiling
//   among a unit's columns are the L largest among its pieces' lists, so
//   each pair lists exactly what the first pass's plan would.
// - The lists of the pairs left closed are not written: no reader reads a
//   pair whose ceiling is the empty key (`certify_top_k` masks them, the
//   split-V kernel's certifying block skips them), and a pass whose work
//   list is empty returns at once.

namespace refill {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kList = 32;            // a pass lists KMAX_WIDE keys per pair
constexpr int kPlanThreads = 1024;

// Where a refill's scratch lives (all null on a first pass).
struct Scratch {
  int* work;          // [work_ints(units)], written by plan_kernel
  float* piece_vals;  // [units + grid, unit rows, kList]
  int* piece_ids;     // [units + grid, unit rows, kList]
  int* tickets;       // [units], 0 at launch
};

// The work list for U units: [0] M, the open units; [1] W, their items;
// [2, 3 + U) the first item of the m-th open unit (M + 1 used, the last W);
// [3 + U, 3 + 2 U) the m-th open unit's id; [3 + 2 U, 3 + 3 U) 1 where
// unit u is open.
__host__ __device__ constexpr int work_ints(int units) { return 3 + 3 * units; }

struct Work {
  const int* p;
  int units;
  __device__ int open_units() const { return p[0]; }
  __device__ int items() const { return p[1]; }
  __device__ int start(int m) const { return p[2 + m]; }
  __device__ int unit(int m) const { return p[3 + units + m]; }
};

// A plan's units: U = chunks * row_tiles, unit u = chunk u / row_tiles,
// row tile u % row_tiles (rows [rt * tile_rows, + tile_rows) of n); chunk
// c holds the vocab tiles [c T / S, (c + 1) T / S) of the plan's T, its
// unit's items.
struct Geometry {
  int n, row_tiles, tile_rows, chunks, tiles;
  __device__ int units() const { return chunks * row_tiles; }
  __device__ int first_tile(int chunk) const {
    return (int)((long long)chunk * tiles / chunks);
  }
  __device__ int items(int u) const {
    const int c = u / row_tiles;
    return first_tile(c + 1) - first_tile(c);
  }
};

// Whether a ceiling leaves its pair anything to list: its value is not
// -inf (ops/lens_kernel.py `_keys`: the value's order-preserving bits above).
__device__ __forceinline__ bool open_key(long long key) {
  const int hi = static_cast<int>(key >> 32);
  return __int_as_float(hi >= 0 ? hi : hi ^ 0x7FFFFFFF) != -INFINITY;
}

// One warp writes the work list from the units' open flags (already in
// `work`): the open units in unit order and their items' starts, 32 units
// a round, with a carry.  Lanes of other warps do nothing here.
__device__ __forceinline__ void compact_units(const Geometry& g, int* work,
                                              int lane) {
  const int units = g.units();
  int* const starts = work + 2;
  int* const ids = work + 3 + units;
  const int* const open = work + 3 + 2 * units;
  int m = 0, at = 0;  // open units and their items before this round
  for (int base = 0; base < units; base += 32) {
    const int u = base + lane;
    const int f = u < units ? open[u] : 0;
    const int it = f ? g.items(u) : 0;
    int sf = f, si = it;  // inclusive scans over the warp
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int x = __shfl_up_sync(kFull, sf, off);
      const int y = __shfl_up_sync(kFull, si, off);
      if (lane >= off) {
        sf += x;
        si += y;
      }
    }
    if (f) {
      ids[m + sf - 1] = u;
      starts[m + sf - 1] = at + si - it;
    }
    m += __shfl_sync(kFull, sf, 31);
    at += __shfl_sync(kFull, si, 31);
  }
  if (lane == 0) {
    work[0] = m;
    work[1] = at;
    starts[m] = at;
  }
}

// One block of kPlanThreads: which units hold an open pair (a warp reads a
// unit's ceilings at a time), then warp 0 lists them.
__global__ void __launch_bounds__(kPlanThreads)
    plan_kernel(const long long* __restrict__ ceiling, Geometry g,
                int* __restrict__ work) {
  const int units = g.units();
  int* const open = work + 3 + 2 * units;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int u = warp; u < units; u += kPlanThreads / 32) {
    const int c = u / g.row_tiles;
    const int r0 = (u % g.row_tiles) * g.tile_rows;
    const int r1 = min(g.n, r0 + g.tile_rows);
    bool any = false;
    for (int r = r0 + lane; r < r1; r += 32)
      any |= open_key(ceiling[(size_t)c * g.n + r]);
    any = __any_sync(kFull, any);
    if (lane == 0) open[u] = any;
  }
  __syncthreads();
  if (warp == 0) compact_units(g, work, lane);
}

// The first of the W items that block b of G takes.
__device__ __forceinline__ int block_first(int b, int items, int grid) {
  return (int)((long long)b * items / grid);
}

// The block of G that takes item `item` of W: the last b whose first item
// is at or before it.
__device__ __forceinline__ int block_of(int item, int items, int grid) {
  return (int)(((long long)(item + 1) * grid - 1) / items);
}

// The open unit whose items hold `item`: the last m with start(m) <= item.
__device__ __forceinline__ int unit_of(const Work& w, int item) {
  int lo = 0, hi = w.open_units() - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (w.start(mid) <= item) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

// A block's spans in order: items [first, upto) of the m-th open unit
// (m -1 before the first).
struct Span {
  int m, unit, first, upto, items;  // items: the unit's, in all
  __device__ bool whole() const { return first == 0 && upto == items; }
};

struct Spans {
  Work work;
  int item, end;  // the block's next item and its end

  __device__ static Spans of_block(const Work& w, int b, int grid) {
    const int items = w.items();
    return Spans{w, block_first(b, items, grid), block_first(b + 1, items, grid)};
  }
  __device__ bool next(Span& s) {
    if (item >= end) return false;
    s.m = s.m < 0 ? unit_of(work, item) : s.m + 1;
    const int s0 = work.start(s.m), s1 = work.start(s.m + 1);
    s.unit = work.unit(s.m);
    s.items = s1 - s0;
    s.first = item - s0;
    s.upto = min(end, s1) - s0;
    item = s0 + s.upto;
    return true;
  }
};

// (a, ai) ahead of (b, bi) in the top-k order: value descending, then id
// ascending.
__device__ __forceinline__ bool ahead(float a, int ai, float b, int bi) {
  return a > b || (a == b && ai < bi);
}

// One warp merges the pieces of a unit, the lists of blocks b0 .. b0 +
// count - 1 of `grid` over `items` items (block b0 + p's at vals / ids +
// p * stride, 16-byte aligned; a block that took no item wrote none), each
// of kList entries in the top-k order, into the kList largest, written to
// out_v / out_i.  Lane p holds rank p of the merged list.  Thirty-two
// pieces at a time: their first entries are read, and if one of them is
// ahead of the merged list's last, lane p reads piece p whole (one round
// trip to L2, not one a rank) and each rank of the 32 is inserted in turn;
// a rank at which none goes above the list's last ends the group.  (A row
// whose ceiling hid every column, most of a wgmma unit's, costs one read.)
__device__ __forceinline__ void merge_pieces(const float* vals, const int* ids,
                                             size_t stride, int b0, int count,
                                             int items, int grid,
                                             float* out_v, int* out_i,
                                             int lane) {
  float lv = -INFINITY;
  int li = INT_MAX;
  for (int base = 0; base < count; base += 32) {
    const int p = base + lane;
    const bool held =
        p < count && block_first(b0 + p, items, grid) <
                         block_first(b0 + p + 1, items, grid);
    const float* const pv_at = vals + p * stride;
    const int* const pi_at = ids + p * stride;
    {
      const float hv = held ? __ldcg(pv_at) : -INFINITY;
      const int hi = held ? __ldcg(pi_at) : INT_MAX;
      const float cut = __shfl_sync(kFull, lv, kList - 1);
      const int cut_i = __shfl_sync(kFull, li, kList - 1);
      if (!__any_sync(kFull, ahead(hv, hi, cut, cut_i))) continue;
    }
    float pv[kList];
    int pi[kList];
#pragma unroll
    for (int j = 0; j < kList / 4; ++j) {
      float4 v4 = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
      int4 i4 = make_int4(INT_MAX, INT_MAX, INT_MAX, INT_MAX);
      if (held) {
        v4 = __ldcg(reinterpret_cast<const float4*>(pv_at) + j);
        i4 = __ldcg(reinterpret_cast<const int4*>(pi_at) + j);
      }
      pv[4 * j] = v4.x, pv[4 * j + 1] = v4.y, pv[4 * j + 2] = v4.z,
      pv[4 * j + 3] = v4.w;
      pi[4 * j] = i4.x, pi[4 * j + 1] = i4.y, pi[4 * j + 2] = i4.z,
      pi[4 * j + 3] = i4.w;
    }
#pragma unroll
    for (int kk = 0; kk < kList; ++kk) {
      const float cv = pv[kk];
      const int ci = pi[kk];
      float cut = __shfl_sync(kFull, lv, kList - 1);
      int cut_i = __shfl_sync(kFull, li, kList - 1);
      unsigned todo = __ballot_sync(kFull, ahead(cv, ci, cut, cut_i));
      if (todo == 0) break;
      while (todo) {
        const int from = __ffs(todo) - 1;
        const float y = __shfl_sync(kFull, cv, from);
        const int yi = __shfl_sync(kFull, ci, from);
        const int pos = __popc(__ballot_sync(kFull, ahead(lv, li, y, yi)));
        const float up_v = __shfl_up_sync(kFull, lv, 1);
        const int up_i = __shfl_up_sync(kFull, li, 1);
        if (lane > pos) {
          lv = up_v;
          li = up_i;
        }
        if (lane == pos) {
          lv = y;
          li = yi;
        }
        cut = __shfl_sync(kFull, lv, kList - 1);
        cut_i = __shfl_sync(kFull, li, kList - 1);
        todo &= __ballot_sync(kFull, ahead(cv, ci, cut, cut_i)) &
                ~((2u << from) - 1u);
      }
    }
  }
  out_v[lane] = lv;
  out_i[lane] = li;
}

// Launch plan_kernel for the ceilings of a pass on `stream`.
inline cudaError_t launch_plan(const long long* ceiling, const Geometry& g,
                               int* work, cudaStream_t stream) {
  plan_kernel<<<1, kPlanThreads, 0, stream>>>(ceiling, g, work);
  return cudaGetLastError();
}

}  // namespace refill
