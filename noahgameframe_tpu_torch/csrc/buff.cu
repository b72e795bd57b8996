// The buff fold for Hopper (sm_90a), bound through a plain C interface
// (ops/buff_cuda.py builds this file into a shared library of its own at
// the op's first call on a card and loads it with ctypes).  Build:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -shared -Xcompiler -fPIC -o libnf_buff.so buff.cu
//
// buff_fold_kernel is the device phase of game/buff.py (the port of
// NoahGameFrame's NFCBuffModule; the JAX package's phase is XLA, with no
// Pallas kernel).  For every entity row c of a class, over the R rows of
// its BuffList record (ConfigIdx, ExpireTick and the used flag) and a
// [K, S] int32 table of each buff kind's stat deltas:
//
//   active[c, r]  = used[c, r] && ExpireTick[c, r] > tick
//   contrib[c, s] = sum over r of table[clamp(ConfigIdx[c, r], 0, K - 1)][s]
//                   * active[c, r]
//
// in int32 with wrap-around (the sum runs in uint32), so the result is
// the plain version's bits whatever the order of the sum.  Rooms batched
// under torch.func.vmap come as one launch over their rows back to back,
// each room with its own tick: row c reads tick[c / rows_per_tick].
//
// What bounds it on an H100: bytes.  At 2^20 rows, R = 8 and S = 29 it
// must read 64 B of record and 8 used flags a row and write 116 B of
// contributions and 8 flags: 205.5 MB, 0.061 ms at 3.35 TB/s.  The work
// is small (at most 8 x 29 integer adds a row) if the gathers of table
// rows are cheap.
//
// The design: one block of NF_BUFF_ROWS threads takes NF_BUFF_ROWS rows,
// a row a thread.
// - The block's record slab, [rows, R, NC] int32, and its used flags are
//   staged into shared memory with consecutive threads on consecutive
//   words (coalesced), in batches of NF_BUFF_BATCH loads a thread, every
//   load of a batch in flight before any of its stores, so a thread waits
//   for memory once a batch and not once a word.  The slab's row stride
//   is R * NC + 1 words, so a thread walking its own row hits its own
//   bank.
// - The table sits in shared memory too when it is small (K * S words
//   within NF_BUFF_TABLE_SMEM): a thread gathers its active kinds' rows
//   from there, S consecutive words each; 29 is odd, so distinct kinds
//   fall in distinct banks.  A larger table is read from global memory
//   through the read-only cache.
// - The S sums are registers (S <= NF_BUFF_MAX_STATS), written to a
//   shared [rows, S] tile and then stored with consecutive threads on
//   consecutive words, as are the active flags, which overwrite the
//   staged used flags in place.
// - The launch bounds hold a thread to 64 registers, so eight blocks
//   share an SM.
// At 2^20 rows with half of the 8 record rows used, on one H100 (700 W):
// this design 100.8 us a launch (61 % of the bound); staging one word at
// a time 110.7 us; that at 128 registers (four blocks an SM) 144.4 us; a
// warp a row with a stat a lane 217.9-225.9 us, its loads of a row's
// kinds waiting on one another.

#include <cuda_runtime.h>
#include <stdint.h>

#define NF_BUFF_ROWS 128
#define NF_BUFF_MAX_STATS 32
#define NF_BUFF_TABLE_SMEM (16 * 1024)
#define NF_BUFF_SMEM_LIMIT (227 * 1024)
#define NF_BUFF_BATCH 16  // loads in flight a thread while staging

namespace {

struct BuffSmem {
  long long table, slab, used, out, bytes;
  __host__ __device__ BuffSmem(int R, int NC, int K, int S, bool table_in_smem) {
    table = 0;
    slab = table_in_smem ? ((long long)K * S * 4 + 15) / 16 * 16 : 0;
    used = slab + (long long)NF_BUFF_ROWS * (R * NC + 1) * 4;
    out = used + ((long long)NF_BUFF_ROWS * R + 15) / 16 * 16;
    bytes = out + (long long)NF_BUFF_ROWS * S * 4;
  }
};

__global__ void __launch_bounds__(NF_BUFF_ROWS, 8)
buff_fold_kernel(const int* __restrict__ buf, const uint8_t* __restrict__ used,
                 const int* __restrict__ table, const int* __restrict__ tick, long long C,
                 long long rows_per_tick, int R, int NC, int cfg_col, int exp_col, int K,
                 int S, int table_in_smem,
                 int* __restrict__ contrib, uint8_t* __restrict__ active) {
  extern __shared__ __align__(16) unsigned char smem[];
  const BuffSmem lay(R, NC, K, S, table_in_smem != 0);
  int* s_table = reinterpret_cast<int*>(smem + lay.table);
  int* s_slab = reinterpret_cast<int*>(smem + lay.slab);
  uint8_t* s_used = smem + lay.used;
  int* s_out = reinterpret_cast<int*>(smem + lay.out);

  const int t = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * NF_BUFF_ROWS;
  const int rows = (int)min((long long)NF_BUFF_ROWS, C - row0);
  const int width = R * NC;
  const int stride = width + 1;

  if (table_in_smem) {
    for (int i = t; i < K * S; i += NF_BUFF_ROWS) s_table[i] = __ldg(table + i);
  }
  // every load of a batch is in flight before any of its stores, so a
  // thread waits for memory once a batch; consecutive threads read
  // consecutive words
  const int* src = buf + row0 * width;
  const int n = rows * width;
  {
    int row = t / width, col = t % width;
    const int drow = NF_BUFF_ROWS / width, dcol = NF_BUFF_ROWS % width;
    for (int base = t; base < n; base += NF_BUFF_ROWS * NF_BUFF_BATCH) {
      int v[NF_BUFF_BATCH];
#pragma unroll
      for (int j = 0; j < NF_BUFF_BATCH; ++j) {
        const int i = base + j * NF_BUFF_ROWS;
        v[j] = i < n ? __ldg(src + i) : 0;
      }
#pragma unroll
      for (int j = 0; j < NF_BUFF_BATCH; ++j) {
        if (base + j * NF_BUFF_ROWS < n) s_slab[row * stride + col] = v[j];
        row += drow;
        col += dcol;
        if (col >= width) {
          col -= width;
          ++row;
        }
      }
    }
  }
  const uint8_t* usrc = used + row0 * R;
  const int nu = rows * R;
  for (int base = t; base < nu; base += NF_BUFF_ROWS * NF_BUFF_BATCH) {
    uint8_t v[NF_BUFF_BATCH];
#pragma unroll
    for (int j = 0; j < NF_BUFF_BATCH; ++j) {
      const int i = base + j * NF_BUFF_ROWS;
      v[j] = i < nu ? __ldg(usrc + i) : 0;
    }
#pragma unroll
    for (int j = 0; j < NF_BUFF_BATCH; ++j) {
      const int i = base + j * NF_BUFF_ROWS;
      if (i < nu) s_used[i] = v[j];
    }
  }
  __syncthreads();

  if (t < rows) {
    const int now = __ldg(tick + (row0 + t) / rows_per_tick);
    unsigned acc[NF_BUFF_MAX_STATS];
#pragma unroll
    for (int s = 0; s < NF_BUFF_MAX_STATS; ++s) acc[s] = 0u;
    const int* mine = s_slab + t * stride;
    for (int r = 0; r < R; ++r) {
      const bool on = s_used[t * R + r] != 0 && mine[r * NC + exp_col] > now;
      s_used[t * R + r] = on ? 1 : 0;
      if (!on) continue;
      const int k = min(max(mine[r * NC + cfg_col], 0), K - 1);
      if (table_in_smem) {
        const int* tr = s_table + k * S;
#pragma unroll
        for (int s = 0; s < NF_BUFF_MAX_STATS; ++s)
          if (s < S) acc[s] += (unsigned)tr[s];
      } else {
        const int* tr = table + (long long)k * S;
#pragma unroll
        for (int s = 0; s < NF_BUFF_MAX_STATS; ++s)
          if (s < S) acc[s] += (unsigned)__ldg(tr + s);
      }
    }
#pragma unroll
    for (int s = 0; s < NF_BUFF_MAX_STATS; ++s)
      if (s < S) s_out[t * S + s] = (int)acc[s];
  }
  __syncthreads();

  int* dst = contrib + row0 * S;
  for (int i = t; i < rows * S; i += NF_BUFF_ROWS) dst[i] = s_out[i];
  uint8_t* adst = active + row0 * R;
  for (int i = t; i < rows * R; i += NF_BUFF_ROWS) adst[i] = s_used[i];
}

// the dynamic shared memory the kernel was last allowed (opt-in above 48 KB)
long long g_buff_smem = 48 * 1024;

}  // namespace

// Launches on the given stream over C rows and returns cudaGetLastError()
// (0 on success); it never synchronises.  buf is [C, R, NC] int32, used
// and active [C, R] bytes (bool), table [K, S] int32, contrib [C, S]
// int32, tick C / rows_per_tick int32 on the device (one a room).
extern "C" int nf_buff_fold(const int* buf, const uint8_t* used, const int* table,
                            const int* tick, long long C, long long rows_per_tick, int R,
                            int NC, int cfg_col, int exp_col, int K, int S, int* contrib,
                            uint8_t* active, void* stream) {
  if (C < 0 || rows_per_tick <= 0 || C % rows_per_tick != 0 || R <= 0 || NC <= 0 || K <= 0 ||
      S <= 0 || S > NF_BUFF_MAX_STATS ||
      cfg_col < 0 || cfg_col >= NC || exp_col < 0 || exp_col >= NC)
    return (int)cudaErrorInvalidValue;
  if (C == 0) return 0;
  const long long blocks = (C + NF_BUFF_ROWS - 1) / NF_BUFF_ROWS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const bool in_smem = (long long)K * S * 4 <= NF_BUFF_TABLE_SMEM;
  const BuffSmem lay(R, NC, K, S, in_smem);
  if (lay.bytes > NF_BUFF_SMEM_LIMIT) return (int)cudaErrorInvalidConfiguration;
  if (lay.bytes > g_buff_smem) {
    const cudaError_t err = cudaFuncSetAttribute(
        (const void*)buff_fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)lay.bytes);
    if (err != cudaSuccess) return (int)err;
    g_buff_smem = lay.bytes;
  }
  buff_fold_kernel<<<(unsigned)blocks, NF_BUFF_ROWS, (size_t)lay.bytes, (cudaStream_t)stream>>>(
      buf, used, table, tick, C, rows_per_tick, R, NC, cfg_col, exp_col, K, S, in_smem ? 1 : 0,
      contrib, active);
  return (int)cudaGetLastError();
}

extern "C" const char* nf_buff_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
