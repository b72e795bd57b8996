// The combat stencil folds for Hopper (sm_90a), bound through a plain C
// interface (ops/stencil_cuda.py loads this file's shared library with
// ctypes and plans every launch).  Build:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -shared -Xcompiler -fPIC -o libnf_stencil.so stencil.cu
//
// combat_fold_kernel replaces combat_fold_pallas
// (noahgameframe_tpu/ops/stencil_pallas.py:133, body _kernel :70).
// fused_neighborhood_kernel replaces fused_neighborhood (:426, body
// _fused_kernel :306).  Both compute, for every victim slot (y, x, k) of
// the [H, W, Kv] cell grid, the nine 3x3 shifts in (dy, dx) order:
//
//   a pair counts when fma(dx, dx, dy*dy) <= r2, eff_atk != 0, the camps
//   differ, and scene and group are equal;
//   per shift: the float32 damage sum in slot order, truncated into the
//   int32 total, and the best attacker (max attack, ties to the min row),
//   merged lexicographically into the running best;
//   bestr is the best attacker's row, -1 when there is none.
//
// The fused kernel reads features from a [N, 6] bank through row-id
// tables (built here by slot_rows_kernel: 0 = empty slot, else row + 1)
// and also counts AOI neighbors: occupied, within radius, same scene and
// (group 0 or same group), not self.
//
// What bounds them on an H100.  Bytes: at the 1M-entity geometry (395 x
// 395 cells, Kv = 16, Ka = 6) the split fold must read 76 MB of payload
// columns and write 20 MB (0.029 ms at 3.35 TB/s); the fused fold reads a
// 25 MB bank and 8 MB of slot assignments and writes 30 MB.  The work the
// data needs is small: 60% of victim slots and 96% of attacker slots are
// empty, leaving 1.95 M attacker pairs (59.4 M AOI pairs for the fused
// fold), a few hundred MFLOP.
//
// Why the first design (one thread per victim slot, every candidate read
// from global memory) missed the bound by 6x and 34x: each thread walked
// all 9 x Ka attacker slots (and 9 x Kv victim slots) with dependent,
// divergent scalar loads, 29 M warp-level loads for kernel 1, re-reading
// every attacker slot 144 times through L1/L2; empty victim slots ran the
// whole loop; and the fused fold's thread chased a random 24-byte bank row
// behind every index load.  Latency and load issue bounded it, not DRAM.
//
// The design now (one block per TY x TX tile of cells; the planner in
// ops/stencil_cuda.py sizes the tile from W, Kv and Ka within 227 KB of
// shared memory):
// - The tile's halo rows are staged once with 16-byte cp.async copies
//   (4-byte copies at unaligned ends); cells beyond the grid stay empty,
//   which is the zero border.
// - Each halo cell's candidates are compacted in slot order, keeping only
//   live ones: attackers with eff_atk != 0 (kernel 1, in place, a thread
//   per cell), occupied slots (kernel 2: victims packed per halo row by a
//   warp ballot, attackers per cell; their bank rows are then gathered
//   into structure-of-arrays lists, four gathers in flight per thread).
//   Dropping an attacker that cannot be ok is exact: it contributes only
//   sa = -1, and a shift whose max is below 0 leaves the carry unchanged.
// - Kernel 1 keeps a 9-bit mask of each cell's shifts with live attackers
//   and streams the tile's victim rows from global memory (four slots'
//   loads in flight per thread), so the 60 MB of victim rows, the bulk of
//   its bytes, pass once and never through shared memory.  What is left
//   between it and its bound is the wave structure: a block stages its
//   halo, then folds, and the card's blocks do so in step.
// - Kernel 2's lanes take the tile's occupied victims in flat order (no
//   lane waits on an empty slot), and each victim's AOI count walks three
//   contiguous runs, one per halo row, counting itself and then taking
//   itself out; instruction issue in that loop is what holds it.
// - An empty victim slot folds as the all-zero row; a candidate can count
//   for it only within r of the origin, so a tile flags that while
//   staging and otherwise writes (0, -1, 0) for its empty slots outright.
// - Where even a one-cell halo does not fit, the *_chunk kernels run one
//   block per cell and stream each neighbor cell's slots through shared
//   memory in chunks, with the first design's arithmetic.
//
// Parity: the reference (the JAX package's XLA build) evaluates the
// square distance as one fused multiply-add, fma(dx, dx, dy*dy).  The
// kernels write exactly that with __fmaf_rn/__fmul_rn/__fsub_rn, and the
// build passes -fmad=false so the compiler adds no contraction of its own:
// a differently rounded sum flips pairs on the radius boundary.  The
// per-shift sum stays float32 before the int32 add, and a shift with no
// attacker (m < 0) is neutralised before the merge, exactly as the
// reference fold does.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define NF_NO_ROW 16777216  // 2^24: "no attacker"; every row id is below it
#define NF_MAX_THREADS 256
#define NF_COMBAT_MIN_BLOCKS 4  // combat_fold_kernel: at most 64 registers
#define NF_VBATCH 4             // victim rows a thread has in flight
#define NF_SMEM_LIMIT 232448
#define NF_FULL_MASK 0xffffffffu

namespace {

// -- PTX helpers ---------------------------------------------------------------

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// -- end of PTX helpers --------------------------------------------------------

__host__ __device__ __forceinline__ long long up16(long long b) { return (b + 15) & ~15LL; }

// Shared-memory carve of one combat_fold_kernel tile (bytes).  Mirrored by
// combat_tile_bytes in ops/stencil_cuda.py.
struct FoldTile {
  long long aseg, count, mask, flag, bytes;
  __host__ __device__ FoldTile(int ty, int tx, int Kv, int Ka) {
    aseg = up16((long long)(tx + 2) * Ka * 32) + 16;         // one halo row of attacker rows
    count = (ty + 2) * aseg;                                  // int [nh]: live attackers
    mask = count + up16((long long)(ty + 2) * (tx + 2) * 4);  // int [ty*tx]: live shifts
    flag = mask + up16((long long)ty * tx * 4);
    bytes = flag + 16;
  }
};

// List stride of a bucket of K slots: odd, so that lanes reading the
// same slot of neighboring cells' lists fall in different banks.
__host__ __device__ __forceinline__ int list_stride(int K) { return K | 1; }

// Shared-memory carve of one fused_neighborhood_kernel tile (bytes).
// Mirrored by fused_tile_bytes in ops/stencil_cuda.py.  Victim lists are
// packed per halo row (cstart: each cell's first entry, and the row's end);
// attacker lists hold list_stride(Ka) entries per cell.
struct FusedTile {
  long long vseg, aseg, vent4, aent4, aent2, vidx, aidx, vrow, vcamp, vslot, arow, vpos,
      cstart, acount, ostart, flag, bytes;
  __host__ __device__ FusedTile(int ty, int tx, int Kv, int Ka) {
    const long long nh = (long long)(ty + 2) * (tx + 2);
    const long long nv = nh * Kv, na = nh * list_stride(Ka);
    vseg = up16((long long)(tx + 2) * Kv * 4) + 16;
    aseg = up16((long long)(tx + 2) * Ka * 4) + 16;
    vent4 = 0;                         // float4 (x, y, scene, group) [nv]
    aent4 = vent4 + nv * 16;           // float4 (x, y, scene, group) [na]
    aent2 = aent4 + na * 16;           // float2 (camp, atk) [na]
    vidx = up16(aent2 + na * 8);       // staged victim index rows
    aidx = vidx + (ty + 2) * vseg;     // staged attacker index rows
    vrow = aidx + (ty + 2) * aseg;     // int row [nv]
    vcamp = up16(vrow + nv * 4);       // float camp [nv]
    vslot = up16(vcamp + nv * 4);      // int slot k [nv]
    arow = up16(vslot + nv * 4);       // int row [na]
    vpos = up16(arow + na * 4);        // int: tile slot occupied (1) or not (-1) [ty*tx*Kv]
    cstart = up16(vpos + (long long)ty * tx * Kv * 4);         // int [ty+2][tx+3]
    acount = up16(cstart + (long long)(ty + 2) * (tx + 3) * 4);  // int [nh]
    ostart = up16(acount + nh * 4);    // int [ty*tx + 1]: tile cells' first occupied victim
    flag = up16(ostart + ((long long)ty * tx + 1) * 4);
    bytes = flag + 16;
  }
};

// n / d and n % d for 0 <= n < 2^31 by one multiply-high: m =
// floor((2^32 - 1) / d) leaves the quotient exact or one short.
struct FastDiv {
  unsigned d, m;
  __device__ explicit FastDiv(int dd) : d((unsigned)dd), m(0xffffffffu / (unsigned)dd) {}
  __device__ __forceinline__ int div(int n, int& r) const {
    unsigned q = __umulhi((unsigned)n, m);
    unsigned rem = (unsigned)n - q * d;
    if (rem >= d) {
      ++q;
      rem -= d;
    }
    r = (int)rem;
    return (int)q;
  }
};

// dx*dx + dy*dy rounded as the reference rounds it: fma(dx, dx, dy*dy)
__device__ __forceinline__ float dist2(float vx, float vy, float cx, float cy) {
  float dx = __fsub_rn(vx, cx);
  float dy = __fsub_rn(vy, cy);
  return __fmaf_rn(dx, dx, __fmul_rn(dy, dy));
}

// Within r of the origin: the only candidates an all-zero victim can count.
__device__ __forceinline__ bool near_origin(float cx, float cy, float r2) {
  return __fmaf_rn(cx, cx, __fmul_rn(cy, cy)) <= r2;
}

// One candidate of a shift.  sa = ok ? atk : -1; m is the max of sa over
// the shift's candidates and first the min row among ok candidates with
// atk == m (only read when m >= 0, where no non-ok candidate can tie).
__device__ __forceinline__ void take(bool ok, float atk, int row, float& sum,
                                     float& m, int& first) {
  float sa = ok ? atk : -1.0f;
  if (ok) sum = __fadd_rn(sum, atk);
  if (sa > m) {
    m = sa;
    first = ok ? row : NF_NO_ROW;
  } else if (ok && sa == m && row < first) {
    first = row;
  }
}

// Lexicographic (max attack, min row) merge of one shift into the carry.
// A shift with m < 0 (no ok candidate) leaves the carry unchanged.
__device__ __forceinline__ void merge(float m, int first, float& besta, int& bestr) {
  if (!(m >= 0.0f)) first = NF_NO_ROW;
  float top = fmaxf(besta, m);
  int a = (m >= top) ? first : NF_NO_ROW;
  int b = (besta >= top) ? bestr : NF_NO_ROW;
  bestr = min(a, b);
  besta = top;
}

// Copy bytes [lo, hi) of a row segment from global to shared memory.  dst
// and src point at the segment's (virtual) start and are congruent modulo
// 16, so each 16-byte aligned source chunk lands on an aligned shared
// address; lo and hi are multiples of 4.  Lanes 0..lanes-1 share the work.
__device__ __forceinline__ void stage_bytes(char* dst, const char* src, long long lo,
                                            long long hi, int lane, int lanes) {
  if (hi <= lo) return;
  const int mis = (int)((uintptr_t)(src + lo) & 15);
  long long body_lo = lo + ((16 - mis) & 15);
  if (body_lo > hi) body_lo = hi;
  const int nbody = (int)((hi - body_lo) >> 4);
  const long long body_hi = body_lo + ((long long)nbody << 4);
  const int nhead = (int)((body_lo - lo) >> 2);
  const int nedge = nhead + (int)((hi - body_hi) >> 2);
  for (int i = lane; i < nbody; i += lanes) {
    const long long off = body_lo + 16LL * i;
    cp_async16(dst + off, src + off);
  }
  for (int i = lane; i < nedge; i += lanes) {
    const long long off = i < nhead ? lo + 4LL * i : body_hi + 4LL * (i - nhead);
    cp_async4(dst + off, src + off);
  }
}

// The global address of the (virtual) first slot of a band row: cell
// (yy, x_first) of a [H, W, K] grid of esz-byte slots; x_first may be -1.
__device__ __forceinline__ const char* band_src(const void* g, int yy, int W, int x_first,
                                                int K, int esz) {
  return (const char*)g + ((long long)yy * W + x_first) * K * esz;
}

// Stage nrows band rows (grid rows y_first..) of ncells cells from x_first
// into shared segments of seg bytes each, clipped to the grid; row r's
// cell c lands at base + r*seg + pad(r) + c*K*esz, pad(r) = src & 15.
// One warp per row.
__device__ __forceinline__ void stage_band(char* base, long long seg, const void* g, int H,
                                           int W, int K, int esz, int y_first, int nrows,
                                           int x_first, int ncells, int warp, int nwarps,
                                           int lane) {
  for (int r = warp; r < nrows; r += nwarps) {
    const int yy = y_first + r;
    if (yy < 0 || yy >= H) continue;
    const char* src = band_src(g, yy, W, x_first, K, esz);
    char* dst = base + r * seg + (int)((uintptr_t)src & 15);
    const int xlo = max(x_first, 0), xhi = min(x_first + ncells, W);
    stage_bytes(dst, src, (long long)(xlo - x_first) * K * esz,
                (long long)(xhi - x_first) * K * esz, lane, 32);
  }
}

// The shared address of band row r's first (virtual) cell, as stage_band
// placed it.
__device__ __forceinline__ char* band_row(char* base, long long seg, const void* g, int yy,
                                          int W, int x_first, int K, int esz, int r) {
  return base + r * seg + (int)((uintptr_t)band_src(g, yy, W, x_first, K, esz) & 15);
}

// The tile (y0, x0) of block b of a room: tiles of ty x tx cells in
// row-major order over a grid of ceil(W / tx) tile columns
// (ops/stencil_cuda.py FoldPlan).
__device__ __forceinline__ void tile_origin(int W, int ty, int tx, int b, int& y0, int& x0) {
  const int gx = (W + tx - 1) / tx;
  y0 = (b / gx) * ty;
  x0 = (b % gx) * tx;
}

// The room axis.  A launch covers R rooms of the same geometry, each a
// contiguous stretch of every table and output: the grid is R x the
// room's blocks, block `blockIdx.x` works on room blockIdx.x / per_room,
// and every pointer is moved to that room before the block reads or
// writes anything.  Nothing else changes: a halo cell outside the room's
// H x W grid is empty, as at a single grid's edge, so a block never reads
// another room's rows (nor its dump slot).  One world is R = 1.
__device__ __forceinline__ int room_block(int per_room, int& b) {
  const int room = (int)(blockIdx.x / (unsigned)per_room);
  b = (int)blockIdx.x - room * per_room;
  return room;
}

__global__ void __launch_bounds__(NF_MAX_THREADS, NF_COMBAT_MIN_BLOCKS)
    combat_fold_kernel(const float* __restrict__ vic, const float* __restrict__ att, int H,
                       int W, int Kv, int Ka, float r2, int ty, int tx, int per_room,
                       int* __restrict__ inc_out, int* __restrict__ bestr_out) {
  extern __shared__ __align__(16) unsigned char nf_smem[];
  char* smem = (char*)nf_smem;
  const FoldTile L(ty, tx, Kv, Ka);
  int blk;
  const long long room = room_block(per_room, blk);
  const long long cells = (long long)H * W;
  vic += room * (cells * Kv + 1) * 6;
  att += room * (cells * Ka + 1) * 8;
  inc_out += room * cells * Kv;
  bestr_out += room * cells * Kv;
  int* count = (int*)(smem + L.count);
  int* mask = (int*)(smem + L.mask);
  int* flag = (int*)(smem + L.flag);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const int hxn = tx + 2, nh = (ty + 2) * hxn, ncell = ty * tx;
  const FastDiv by_kv(Kv), by_tx(tx);
  int y0, x0;
  tile_origin(W, ty, tx, blk, y0, x0);

  // 1. stage the tile's attacker halo (8 floats a slot) with asynchronous
  // copies
  if (tid == 0) *flag = 0;
  stage_band(smem, L.aseg, att, H, W, Ka, 32, y0 - 1, ty + 2, x0 - 1, tx + 2, warp, nwarps,
             lane);
  cp_async_wait_all();
  __syncthreads();

  // 2. compact each halo cell's attackers in place, in slot order, keeping
  // those with eff_atk != 0 (one thread per cell)
  bool near = false;
  for (int c = tid; c < nh; c += nthr) {
    const int hy = c / hxn, hx = c - hy * hxn;
    const int yy = y0 - 1 + hy, xx = x0 - 1 + hx;
    int cnt = 0;
    if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
      float* cell = (float*)band_row(smem, L.aseg, att, yy, W, x0 - 1, Ka, 32, hy) + hx * Ka * 8;
      for (int j = 0; j < Ka; ++j) {
        const float* a = cell + j * 8;
        if (a[2] == 0.0f) continue;
        near |= near_origin(a[0], a[1], r2);
        if (cnt != j) {
          float* d = cell + cnt * 8;
#pragma unroll
          for (int q = 0; q < 7; ++q) d[q] = a[q];
        }
        ++cnt;
      }
    }
    count[c] = cnt;
  }
  if (near) *flag = 1;
  __syncthreads();

  // 2b. each tile cell's shifts with live attackers, one bit each in
  // stencil order
  for (int c = tid; c < ncell; c += nthr) {
    const int cy = c / tx, cx = c - cy * tx;
    int m = 0;
#pragma unroll
    for (int s = 0; s < 9; ++s)
      if (count[(cy + s / 3) * hxn + cx + s % 3] > 0) m |= 1 << s;
    mask[c] = m;
  }
  __syncthreads();

  // 3. fold each victim slot of the tile over the live shifts' lists.  The
  // victim rows stream from global memory, NF_VBATCH slots' loads in
  // flight per thread; an all-zero victim skips the lists unless the tile
  // has attackers near the origin.
  const bool origin = *flag != 0;
  const int nslots = ncell * Kv;
  for (int i0 = tid; i0 < nslots; i0 += NF_VBATCH * nthr) {
    float v[NF_VBATCH][5];
    long long slot[NF_VBATCH];
    int cell[NF_VBATCH];
#pragma unroll
    for (int u = 0; u < NF_VBATCH; ++u) {
      const int i = i0 + u * nthr;
      slot[u] = -1;
      if (i >= nslots) continue;
      int k, cx;
      const int c = by_kv.div(i, k);
      const int cy = by_tx.div(c, cx);
      if (y0 + cy >= H || x0 + cx >= W) continue;
      cell[u] = c;
      slot[u] = ((long long)(y0 + cy) * W + x0 + cx) * Kv + k;
      const float* row = vic + slot[u] * 6;
#pragma unroll
      for (int q = 0; q < 5; ++q) v[u][q] = __ldg(row + q);
    }
#pragma unroll
    for (int u = 0; u < NF_VBATCH; ++u) {
      if (slot[u] < 0) continue;
      const float vx = v[u][0], vy = v[u][1], vcamp = v[u][2], vscene = v[u][3],
                  vgroup = v[u][4];
      const bool zero = vx == 0.0f && vy == 0.0f && vcamp == 0.0f && vscene == 0.0f &&
                        vgroup == 0.0f;
      const int c = cell[u];
      int live = (zero && !origin) ? 0 : mask[c];
      int cx;
      const int cy = by_tx.div(c, cx);
      int inc = 0;
      float besta = -1.0f;
      int bestr = NF_NO_ROW;
      while (live != 0) {
        const int s = __ffs(live) - 1;
        live &= live - 1;
        const int dy = (s * 11) >> 5, dx = s - 3 * dy;  // s / 3 for s < 9
        const int hy = cy + dy, hx = cx + dx;
        const int n = count[hy * hxn + hx];
        const float* a =
            (const float*)band_row(smem, L.aseg, att, y0 - 1 + hy, W, x0 - 1, Ka, 32, hy) +
            hx * Ka * 8;
        float sum = 0.0f, m = -INFINITY;
        int first = NF_NO_ROW;
        for (int j = 0; j < n; ++j, a += 8) {
          const float atk = a[2];
          const bool ok = a[3] != vcamp && a[4] == vscene && a[5] == vgroup &&
                          dist2(vx, vy, a[0], a[1]) <= r2;
          take(ok, atk, (int)a[6], sum, m, first);
        }
        inc += __float2int_rz(sum);
        merge(m, first, besta, bestr);
      }
      inc_out[slot[u]] = inc;
      bestr_out[slot[u]] = bestr >= NF_NO_ROW ? -1 : bestr;
    }
  }
}

// One block per cell; each neighbor cell's attacker slots stream through
// shared memory in chunks of `chunk` slots (the first design's
// arithmetic, every slot visited).
__global__ void __launch_bounds__(NF_MAX_THREADS)
    combat_fold_chunk_kernel(const float* __restrict__ vic, const float* __restrict__ att,
                             int H, int W, int Kv, int Ka, float r2, int chunk,
                             int* __restrict__ inc_out, int* __restrict__ bestr_out) {
  extern __shared__ __align__(16) unsigned char nf_smem[];
  int blk;
  const long long room = room_block(H * W, blk);
  const long long cells = (long long)H * W;
  vic += room * (cells * Kv + 1) * 6;
  att += room * (cells * Ka + 1) * 8;
  inc_out += room * cells * Kv;
  bestr_out += room * cells * Kv;
  const long long cell = blk;
  const int y = (int)(cell / W), x = (int)(cell % W);
  const int tid = threadIdx.x, nthr = blockDim.x;
  for (int vb = 0; vb < Kv; vb += nthr) {
    const int k = vb + tid;
    const bool have = k < Kv;
    float vx = 0.0f, vy = 0.0f, vcamp = 0.0f, vscene = 0.0f, vgroup = 0.0f;
    if (have) {
      const float* v = vic + (cell * Kv + k) * 6;
      vx = v[0]; vy = v[1]; vcamp = v[2]; vscene = v[3]; vgroup = v[4];
    }
    int inc = 0;
    float besta = -1.0f;
    int bestr = NF_NO_ROW;
    for (int dy = -1; dy <= 1; ++dy) {
      for (int dx = -1; dx <= 1; ++dx) {
        const int yy = y + dy, xx = x + dx;
        if (yy < 0 || yy >= H || xx < 0 || xx >= W) continue;  // uniform in the block
        const float* cell_att = att + ((long long)yy * W + xx) * Ka * 8;
        float sum = 0.0f, m = -INFINITY;
        int first = NF_NO_ROW;
        for (int cb = 0; cb < Ka; cb += chunk) {
          const int nc = min(chunk, Ka - cb);
          const char* src = (const char*)(cell_att + (long long)cb * 8);
          char* dst = (char*)nf_smem + ((uintptr_t)src & 15);
          __syncthreads();  // the previous chunk is consumed
          stage_bytes(dst, src, 0, (long long)nc * 32, tid, nthr);
          cp_async_wait_all();
          __syncthreads();
          if (have) {
            const float* a = (const float*)dst;
            for (int j = 0; j < nc; ++j, a += 8) {
              const float atk = a[2];
              const bool ok = atk != 0.0f && a[3] != vcamp && a[4] == vscene &&
                              a[5] == vgroup && dist2(vx, vy, a[0], a[1]) <= r2;
              take(ok, atk, (int)a[6], sum, m, first);
            }
          }
        }
        inc += __float2int_rz(sum);
        merge(m, first, besta, bestr);
      }
    }
    if (have) {
      const long long s = cell * Kv + k;
      inc_out[s] = inc;
      bestr_out[s] = bestr >= NF_NO_ROW ? -1 : bestr;
    }
  }
}

// The shared lists of one fused_neighborhood_kernel tile.
struct FusedLists {
  const float4* vent4;
  const float4* aent4;
  const float2* aent2;
  const int* arow;
  const int* cstart;
  const int* acount;
  int hxn, rowcap, as;
};

// 1 when a listed victim f is within r of (vx, vy) and in scope.
__device__ __forceinline__ int aoi_pair(const float4 f, float vx, float vy, float vscene,
                                        float vgroup, float r2) {
  return f.z == vscene && (f.w == 0.0f || f.w == vgroup) && dist2(vx, vy, f.x, f.y) <= r2;
}

// The fused fold of one victim of tile cell (cy, cx) over its nine
// neighbor cells' lists.  The AOI count takes every listed victim of the
// three halo rows' runs and then drops the victim itself (`self`) when it
// passes its own test, which is what skipping its row gives.
__device__ __forceinline__ void fused_fold_one(const FusedLists& F, int cy, int cx, float vx,
                                               float vy, float vcamp, float vscene,
                                               float vgroup, bool self, float r2, int& inc_o,
                                               int& bestr_o, int& nbr_o) {
  int inc = 0, nbr = 0;
  float besta = -1.0f;
  int bestr = NF_NO_ROW;
  for (int dy = 0; dy < 3; ++dy) {
    const int hy = cy + dy;
    for (int dx = 0; dx < 3; ++dx) {
      const int e = hy * F.hxn + cx + dx;
      const int na = F.acount[e];
      if (na == 0) continue;
      float sum = 0.0f, m = -INFINITY;
      int first = NF_NO_ROW;
      for (int j = e * F.as, end = j + na; j < end; ++j) {
        const float4 f = F.aent4[j];
        const float2 g = F.aent2[j];
        const bool ok = g.y != 0.0f && g.x != vcamp && f.z == vscene && f.w == vgroup &&
                        dist2(vx, vy, f.x, f.y) <= r2;
        take(ok, g.y, F.arow[j], sum, m, first);
      }
      inc += __float2int_rz(sum);
      merge(m, first, besta, bestr);
    }
    // the three neighbor cells of this halo row are one run of the row's list
    const int* cs = F.cstart + hy * (F.hxn + 1);
    const int base = hy * F.rowcap;
    const int end = base + cs[cx + 3];
#pragma unroll 4
    for (int j = base + cs[cx]; j < end; ++j)
      nbr += aoi_pair(F.vent4[j], vx, vy, vscene, vgroup, r2);
  }
  if (self && vscene == vscene && (vgroup == 0.0f || vgroup == vgroup) &&
      dist2(vx, vy, vx, vy) <= r2)
    --nbr;
  inc_o = inc;
  bestr_o = bestr >= NF_NO_ROW ? -1 : bestr;
  nbr_o = nbr;
}

__global__ void __launch_bounds__(NF_MAX_THREADS)
    fused_neighborhood_kernel(const float* __restrict__ bank, const int* __restrict__ vtab,
                              const int* __restrict__ atab, int H, int W, int Kv, int Ka,
                              float r2, int ty, int tx, int per_room, int N,
                              int* __restrict__ inc_out, int* __restrict__ bestr_out,
                              int* __restrict__ nbr_out) {
  extern __shared__ __align__(16) unsigned char nf_smem[];
  char* smem = (char*)nf_smem;
  const FusedTile L(ty, tx, Kv, Ka);
  int blk;
  const long long room = room_block(per_room, blk);
  const long long cells = (long long)H * W;
  bank += room * N * 6;
  vtab += room * cells * Kv;
  atab += room * cells * Ka;
  inc_out += room * cells * Kv;
  bestr_out += room * cells * Kv;
  nbr_out += room * cells * Kv;
  float4* vent4 = (float4*)(smem + L.vent4);
  float4* aent4 = (float4*)(smem + L.aent4);
  float2* aent2 = (float2*)(smem + L.aent2);
  int* vrow = (int*)(smem + L.vrow);
  float* vcampl = (float*)(smem + L.vcamp);
  int* vslot = (int*)(smem + L.vslot);
  int* arow = (int*)(smem + L.arow);
  int* vpos = (int*)(smem + L.vpos);
  int* cstart = (int*)(smem + L.cstart);
  int* acount = (int*)(smem + L.acount);
  int* ostart = (int*)(smem + L.ostart);
  int* flag = (int*)(smem + L.flag);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  int y0, x0;
  tile_origin(W, ty, tx, blk, y0, x0);
  const int hxn = tx + 2, nh = (ty + 2) * hxn, ncell = ty * tx;
  const int rowcap = hxn * Kv, as = list_stride(Ka);

  // 1. stage the halo's index rows of both tables
  if (tid == 0) *flag = 0;
  stage_band(smem + L.vidx, L.vseg, vtab, H, W, Kv, 4, y0 - 1, ty + 2, x0 - 1, tx + 2, warp,
             nwarps, lane);
  stage_band(smem + L.aidx, L.aseg, atab, H, W, Ka, 4, y0 - 1, ty + 2, x0 - 1, tx + 2, warp,
             nwarps, lane);
  cp_async_wait_all();
  __syncthreads();

  // 2. compact the occupied slots, in slot order, into row lists: victims
  // packed per halo row by a warp ballot (a warp per row; each cell's
  // first entry in cstart, tile slots flagged in vpos), attackers per cell
  // (a thread per cell)
  {
    const FastDiv by_kv(Kv);
    for (int r = warp; r < ty + 2; r += nwarps) {
      int* cs = cstart + r * (hxn + 1);
      const int yy = y0 - 1 + r;
      int lo = 0, hi = 0, cnt = 0;  // the row's in-grid cells [lo, hi)
      if (yy >= 0 && yy < H) {
        lo = max(x0 - 1, 0) - (x0 - 1);
        hi = min(x0 + tx + 1, W) - (x0 - 1);
        const int* idx = (const int*)band_row(smem + L.vidx, L.vseg, vtab, yy, W, x0 - 1, Kv, 4, r);
        const bool inner = r >= 1 && r <= ty;
        for (int j = lo * Kv + lane, j_end = hi * Kv; j - lane < j_end; j += 32) {
          const int t = j < j_end ? idx[j] : 0;
          const unsigned mask = __ballot_sync(NF_FULL_MASK, t != 0);
          const int pos = cnt + __popc(mask & ((1u << lane) - 1u));
          if (j < j_end) {
            int k;
            const int hx = by_kv.div(j, k);
            if (k == 0) cs[hx] = pos;
            if (t != 0) {
              vrow[r * rowcap + pos] = t - 1;
              vslot[r * rowcap + pos] = k;
            }
            if (inner && hx >= 1 && hx <= tx)
              vpos[((r - 1) * tx + hx - 1) * Kv + k] = t != 0 ? 1 : -1;
          }
          cnt += __popc(mask);
        }
      }
      for (int hx = lane; hx <= hxn; hx += 32)
        if (hx < lo || hx >= hi) cs[hx] = hx < lo ? 0 : cnt;
    }
  }
  for (int e = tid; e < nh; e += nthr) {
    const int hy = e / hxn, hx = e - hy * hxn;
    const int yy = y0 - 1 + hy, xx = x0 - 1 + hx;
    int cnt = 0;
    if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
      const int* idx =
          (const int*)band_row(smem + L.aidx, L.aseg, atab, yy, W, x0 - 1, Ka, 4, hy) + hx * Ka;
      for (int j = 0; j < Ka; ++j) {
        const int t = idx[j];
        if (t != 0) arow[e * as + cnt++] = t - 1;
      }
    }
    acount[e] = cnt;
  }
  __syncthreads();

  // 2b. (warp 0) where each tile cell's occupied victims start in the
  // tile's flat order of occupied victims
  if (warp == 0) {
    int carry = 0;
    for (int base = 0; base < ncell; base += 32) {
      const int c = base + lane;
      int cnt = 0;
      if (c < ncell) {
        const int cy = c / tx, cx = c - cy * tx;
        const int* cs = cstart + (cy + 1) * (hxn + 1);
        cnt = cs[cx + 2] - cs[cx + 1];
      }
      int incl = cnt;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(NF_FULL_MASK, incl, d);
        if (lane >= d) incl += up;
      }
      if (c < ncell) ostart[c] = carry + incl - cnt;
      carry += __shfl_sync(NF_FULL_MASK, incl, 31);
    }
    if (lane == 0) ostart[ncell] = carry;
  }

  // 3. gather the listed bank rows into the structure-of-arrays lists;
  // four independent gathers in flight per thread
  bool near = false;
  {
    const FastDiv by_row(rowcap);
    const int total = (ty + 2) * rowcap;
    for (int i0 = tid; i0 < total; i0 += 4 * nthr) {
      float g[4][5];
      int at[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * nthr;
        at[u] = -1;
        if (i < total) {
          int p;
          const int r = by_row.div(i, p);
          if (p < cstart[r * (hxn + 1) + hxn]) at[u] = i;
        }
        if (at[u] >= 0) {
          const float* b = bank + (long long)vrow[at[u]] * 6;
#pragma unroll
          for (int q = 0; q < 5; ++q) g[u][q] = __ldg(b + q);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (at[u] < 0) continue;
        vent4[at[u]] = make_float4(g[u][0], g[u][1], g[u][3], g[u][4]);
        vcampl[at[u]] = g[u][2];
        near |= near_origin(g[u][0], g[u][1], r2);
      }
    }
  }
  if (Ka > 0) {
    const FastDiv by_k(Ka);
    const int total = nh * Ka;
    for (int i0 = tid; i0 < total; i0 += 4 * nthr) {
      float g[4][6];
      int at[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * nthr;
        at[u] = -1;
        if (i < total) {
          int p;
          const int e = by_k.div(i, p);
          if (p < acount[e]) at[u] = e * as + p;
        }
        if (at[u] >= 0) {
          const float* b = bank + (long long)arow[at[u]] * 6;
#pragma unroll
          for (int q = 0; q < 6; ++q) g[u][q] = __ldg(b + q);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (at[u] < 0) continue;
        aent4[at[u]] = make_float4(g[u][0], g[u][1], g[u][3], g[u][4]);
        aent2[at[u]] = make_float2(g[u][2], g[u][5]);
        near |= near_origin(g[u][0], g[u][1], r2);
      }
    }
  }
  if (near) *flag = 1;
  __syncthreads();

  // 4. fold: lanes take the tile's occupied victims in flat order, so no
  // lane idles on an empty slot; then the empty slots, which fold as the
  // all-zero row and only need the loop when the tile has entities near
  // the origin
  const FusedLists F{vent4, aent4, aent2, arow, cstart, acount, hxn, rowcap, as};
  const FastDiv by_kv(Kv), by_tx(tx);
  const bool origin = *flag != 0;
  const int nocc = ostart[ncell];
  for (int t = tid; t < nocc + ncell * Kv; t += nthr) {
    int cy, cx, k;
    float vx = 0.0f, vy = 0.0f, vcamp = 0.0f, vscene = 0.0f, vgroup = 0.0f;
    const bool occupied = t < nocc;
    if (occupied) {
      int lo = 0, hi = ncell - 1;  // the last tile cell starting at or before t
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (ostart[mid] <= t) lo = mid; else hi = mid - 1;
      }
      cy = by_tx.div(lo, cx);
      const int j = (cy + 1) * rowcap + cstart[(cy + 1) * (hxn + 1) + cx + 1] + t - ostart[lo];
      const float4 f = vent4[j];
      vx = f.x; vy = f.y; vscene = f.z; vgroup = f.w;
      vcamp = vcampl[j];
      k = vslot[j];
    } else {
      const int i = t - nocc;
      cy = by_tx.div(by_kv.div(i, k), cx);
      if (y0 + cy >= H || x0 + cx >= W || vpos[i] >= 0) continue;
    }
    int inc = 0, bestr = -1, nbr = 0;
    if (occupied || origin)
      fused_fold_one(F, cy, cx, vx, vy, vcamp, vscene, vgroup, occupied, r2, inc, bestr, nbr);
    const long long s = ((long long)(y0 + cy) * W + x0 + cx) * Kv + k;
    inc_out[s] = inc;
    bestr_out[s] = bestr;
    nbr_out[s] = nbr;
  }
}

// Stage `nc` slots of one cell's index row (rows t - 1, 0 = empty) and
// gather their bank rows: e4 = (x, y, scene, group), e2 = (camp, atk),
// er = row or -1.
__device__ __forceinline__ void gather_chunk(const float* __restrict__ bank,
                                             const int* __restrict__ idx, int nc, float4* e4,
                                             float2* e2, int* er, int tid, int nthr) {
  for (int j = tid; j < nc; j += nthr) {
    const int t = idx[j];
    er[j] = t - 1;
    if (t != 0) {
      const float* b = bank + (long long)(t - 1) * 6;
      e4[j] = make_float4(__ldg(b), __ldg(b + 1), __ldg(b + 3), __ldg(b + 4));
      e2[j] = make_float2(__ldg(b + 2), __ldg(b + 5));
    }
  }
}

// One block per cell; each neighbor cell's attacker and victim slots
// stream through shared memory in chunks of `chunk` slots (the first
// design's arithmetic, every slot visited).
__global__ void __launch_bounds__(NF_MAX_THREADS)
    fused_neighborhood_chunk_kernel(const float* __restrict__ bank,
                                    const int* __restrict__ vtab,
                                    const int* __restrict__ atab, int H, int W, int Kv,
                                    int Ka, float r2, int chunk, int N,
                                    int* __restrict__ inc_out, int* __restrict__ bestr_out,
                                    int* __restrict__ nbr_out) {
  extern __shared__ __align__(16) unsigned char nf_smem[];
  float4* e4 = (float4*)nf_smem;
  float2* e2 = (float2*)(nf_smem + (long long)chunk * 16);
  int* er = (int*)(nf_smem + (long long)chunk * 24);
  int blk;
  const long long room = room_block(H * W, blk);
  const long long cells = (long long)H * W;
  bank += room * N * 6;
  vtab += room * cells * Kv;
  atab += room * cells * Ka;
  inc_out += room * cells * Kv;
  bestr_out += room * cells * Kv;
  nbr_out += room * cells * Kv;
  const long long cell = blk;
  const int y = (int)(cell / W), x = (int)(cell % W);
  const int tid = threadIdx.x, nthr = blockDim.x;
  for (int vb = 0; vb < Kv; vb += nthr) {
    const int k = vb + tid;
    const bool have = k < Kv;
    const int vt = have ? vtab[cell * Kv + k] : 0;
    const int vr = vt - 1;  // -1: an empty slot matches no row id
    float vx = 0.0f, vy = 0.0f, vcamp = 0.0f, vscene = 0.0f, vgroup = 0.0f;
    if (vt != 0) {  // an empty slot folds as the all-zero row
      const float* b = bank + (long long)vr * 6;
      vx = b[0]; vy = b[1]; vcamp = b[2]; vscene = b[3]; vgroup = b[4];
    }
    int inc = 0, nbr = 0;
    float besta = -1.0f;
    int bestr = NF_NO_ROW;
    for (int dy = -1; dy <= 1; ++dy) {
      for (int dx = -1; dx <= 1; ++dx) {
        const int yy = y + dy, xx = x + dx;
        if (yy < 0 || yy >= H || xx < 0 || xx >= W) continue;  // uniform in the block
        const long long nb = (long long)yy * W + xx;
        float sum = 0.0f, m = -INFINITY;
        int first = NF_NO_ROW;
        for (int cb = 0; cb < Ka; cb += chunk) {
          const int nc = min(chunk, Ka - cb);
          __syncthreads();  // the previous chunk is consumed
          gather_chunk(bank, atab + nb * Ka + cb, nc, e4, e2, er, tid, nthr);
          __syncthreads();
          if (have) {
            for (int j = 0; j < nc; ++j) {
              const int r = er[j];
              if (r < 0) {
                take(false, 0.0f, 0, sum, m, first);
                continue;
              }
              const float4 f = e4[j];
              const float2 g = e2[j];
              const bool ok = g.y != 0.0f && g.x != vcamp && f.z == vscene &&
                              f.w == vgroup && dist2(vx, vy, f.x, f.y) <= r2;
              take(ok, g.y, r, sum, m, first);
            }
          }
        }
        inc += __float2int_rz(sum);
        merge(m, first, besta, bestr);
        for (int cb = 0; cb < Kv; cb += chunk) {
          const int nc = min(chunk, Kv - cb);
          __syncthreads();
          gather_chunk(bank, vtab + nb * Kv + cb, nc, e4, e2, er, tid, nthr);
          __syncthreads();
          if (have) {
            for (int j = 0; j < nc; ++j) {
              const int r = er[j];
              if (r < 0 || r == vr) continue;
              const float4 f = e4[j];
              const bool scoped = f.z == vscene && (f.w == 0.0f || f.w == vgroup);
              if (scoped && dist2(vx, vy, f.x, f.y) <= r2) ++nbr;
            }
          }
        }
      }
    }
    if (have) {
      const long long s = cell * Kv + k;
      inc_out[s] = inc;
      bestr_out[s] = bestr >= NF_NO_ROW ? -1 : bestr;
      nbr_out[s] = nbr;
    }
  }
}

// Both row tables from the slot assignments, after the caller zeroed them:
// table[slot_of[i]] = i + 1 for each placed row (slots below the dump),
// room by room: entry i of the [R, n] assignments is row i % n of room
// i / n, and writes into that room's [vdump] / [adump] table.
__global__ void slot_rows_kernel(const int* __restrict__ vslot, const int* __restrict__ aslot,
                                 long long total, int n, long long vdump, long long adump,
                                 int* __restrict__ vtab, int* __restrict__ atab) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long room = i / n;
  const int row = (int)(i - room * n);
  const int vs = vslot[i], as = aslot[i];
  if (vs >= 0 && vs < vdump) vtab[room * vdump + vs] = row + 1;
  if (as >= 0 && as < adump) atab[room * adump + as] = row + 1;
}

// Raise a kernel's dynamic shared-memory ceiling once per device.
cudaError_t allow_smem(const void* fn, int bytes, int* granted) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (granted[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) granted[dev] = bytes;
  return err;
}

int g_combat_tile_smem[64], g_combat_chunk_smem[64];
int g_fused_tile_smem[64], g_fused_chunk_smem[64];

// A launch plan: chunk == 0 runs the tile kernel on ty x tx tiles, chunk >
// 0 the chunk kernel, one block per cell.  Returns the block count, or -1
// when the plan does not fit (smem short of the carve, too many threads).
long long check_plan(int H, int W, int ty, int tx, int threads, long long smem,
                     long long need, int chunk) {
  if (threads <= 0 || threads > NF_MAX_THREADS || threads % 32 != 0) return -1;
  if (smem < need || smem > NF_SMEM_LIMIT || chunk < 0) return -1;
  if (chunk > 0) return (long long)H * W;
  if (ty <= 0 || tx <= 0) return -1;
  return (long long)((H + ty - 1) / ty) * ((W + tx - 1) / tx);
}

// The blocks of a launch over R rooms of `per_room` blocks each, or -1
// when they are more than one grid dimension holds (2^31 - 1).
long long room_blocks(int R, long long per_room) {
  if (R < 0 || per_room <= 0) return -1;
  const long long blocks = (long long)R * per_room;
  return blocks > 0x7fffffffLL ? -1 : blocks;
}

}  // namespace

// Each entry point launches on the given stream over R rooms of one
// geometry laid out back to back (R = 1: one world) and returns
// cudaGetLastError() (0 on success); it never synchronises.

extern "C" int nf_combat_fold(const float* vic, const float* att, int R, int H, int W, int Kv,
                              int Ka, float r2, int ty, int tx, int threads, int smem, int chunk,
                              int* inc, int* bestr, void* stream) {
  if ((long long)R * H * W * Kv == 0) return 0;
  const long long need = chunk > 0 ? (long long)chunk * 32 + 16 : FoldTile(ty, tx, Kv, Ka).bytes;
  const long long per_room = check_plan(H, W, ty, tx, threads, smem, need, chunk);
  const long long blocks = room_blocks(R, per_room);
  if (blocks <= 0) return (int)cudaErrorInvalidConfiguration;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (chunk > 0) {
    err = allow_smem((const void*)combat_fold_chunk_kernel, smem, g_combat_chunk_smem);
    if (err != cudaSuccess) return (int)err;
    combat_fold_chunk_kernel<<<(unsigned)blocks, threads, smem, st>>>(
        vic, att, H, W, Kv, Ka, r2, chunk, inc, bestr);
  } else {
    err = allow_smem((const void*)combat_fold_kernel, smem, g_combat_tile_smem);
    if (err != cudaSuccess) return (int)err;
    combat_fold_kernel<<<(unsigned)blocks, threads, smem, st>>>(
        vic, att, H, W, Kv, Ka, r2, ty, tx, (int)per_room, inc, bestr);
  }
  return (int)cudaGetLastError();
}

extern "C" int nf_slot_rows(const int* vslot, const int* aslot, int R, int n, long long vdump,
                            long long adump, int* vtab, int* atab, void* stream) {
  if (R < 0 || n < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(vtab, 0, (size_t)R * vdump * 4, st);
  if (err == cudaSuccess) err = cudaMemsetAsync(atab, 0, (size_t)R * adump * 4, st);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)R * n;
  if (total > 0) {
    const long long blocks = room_blocks(1, (total + 255) / 256);
    if (blocks <= 0) return (int)cudaErrorInvalidConfiguration;
    slot_rows_kernel<<<(unsigned)blocks, 256, 0, st>>>(vslot, aslot, total, n, vdump, adump,
                                                        vtab, atab);
  }
  return (int)cudaGetLastError();
}

extern "C" int nf_fused_neighborhood(const float* bank, const int* vtab, const int* atab,
                                     int R, int N, int H, int W, int Kv, int Ka, float r2,
                                     int ty, int tx, int threads, int smem, int chunk, int* inc,
                                     int* bestr, int* nbr, void* stream) {
  if ((long long)R * H * W * Kv == 0) return 0;
  const long long need = chunk > 0 ? (long long)chunk * 28 : FusedTile(ty, tx, Kv, Ka).bytes;
  const long long per_room = check_plan(H, W, ty, tx, threads, smem, need, chunk);
  const long long blocks = room_blocks(R, per_room);
  if (blocks <= 0) return (int)cudaErrorInvalidConfiguration;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (chunk > 0) {
    err = allow_smem((const void*)fused_neighborhood_chunk_kernel, smem, g_fused_chunk_smem);
    if (err != cudaSuccess) return (int)err;
    fused_neighborhood_chunk_kernel<<<(unsigned)blocks, threads, smem, st>>>(
        bank, vtab, atab, H, W, Kv, Ka, r2, chunk, N, inc, bestr, nbr);
  } else {
    err = allow_smem((const void*)fused_neighborhood_kernel, smem, g_fused_tile_smem);
    if (err != cudaSuccess) return (int)err;
    fused_neighborhood_kernel<<<(unsigned)blocks, threads, smem, st>>>(
        bank, vtab, atab, H, W, Kv, Ka, r2, ty, tx, (int)per_room, N, inc, bestr, nbr);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* nf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
