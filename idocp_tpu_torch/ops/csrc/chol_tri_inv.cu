// Batched small-matrix Cholesky + triangular inverse for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel idocp_tpu/ops/chol.py::chol_tri_inv (kernel
// body `_kernel(n)`): for a batch of SPD matrices A = L L^T of size n x n
// (n <= 32) it writes L^{-1}, lower triangular, strict upper triangle 0.
// Only the lower triangle of A is read. A matrix that is not positive
// definite gets NaN from the failing pivot on (rsqrt of a non-positive
// number), in that matrix only.
//
// Two entry points share the device code of the recurrence:
//   chol_tri_inv_*         L^{-1} of A as it is;
//   chol_rescue_tri_inv_*  the Levenberg rescue ladder of
//                          riccati/recursion.py::chol_rescue in front of it:
//                          scale = trace(G)/n + 1, rungs G + reg I,
//                          + 1e-4 scale I, + scale I; the inverse factor of the
//                          first rung whose factor is finite. A matrix is
//                          factored again only when its own rung failed.
//
// What bounds it on this card: bytes. Each matrix is read once and written
// once (2 n^2 elements) against about 2 n^3 / 3 floating point operations,
// a few operations per byte, far below the card's balance. The recurrence
// inside one matrix is serial and a matrix is too small to fill a warp, so, as
// the TPU kernel put the batch on its lanes, the layouts of the solver's sizes
// put several matrices into a warp:
//
//   a matrix per group of L lanes (n = 18: L = 2 in f32, L = 4 in f64; n = 12
//   in f64: L = 4), the layout of the solver's largest factorizations.
//   * Lane q of a group holds rows q, q + L, ... of the lower triangle in
//     registers (fully unrolled template: every register index is static).
//     The group factors right-looking (the same order of subtractions, k
//     ascending, as the Banachiewicz recurrence): the pivot and each entry of
//     the pivot column reach the other lanes by a shuffle inside the group,
//     1 / L[j][j] stays in the diagonal, and the inverse is built in place:
//     at step k the owner of row k sends its finished row down the group.
//     A matrix in one thread is 2 000 dependent multiply-adds behind each
//     other on a card that has 2.4 such warps for each SM at the solver's
//     batch; two lanes halve the chain and the registers (no spills) for
//     324 shuffles a lane at n = 18. A NaN cannot leave its group.
//   * A warp takes a chunk of up to 32 / L consecutive matrices, one
//     contiguous piece of device memory, through its own piece of dynamic
//     shared memory: in as one 1-D bulk copy (cp.async.bulk on an mbarrier),
//     back as one (cp.async.bulk), each started by one lane. The lanes read
//     and write their rows there two elements at a time.
//
//   a matrix per thread (n = 12 in f32: 78 values, no spills, and the chain is
//   short enough that shuffles would cost more than they save).
//   * A warp's chunk is up to 32 matrices. A matrix of 36 16-byte pieces would
//     put the 16-byte accesses of a quarter warp, each thread into its own
//     matrix, on 2 of the 8 bank groups; so in shared memory a matrix starts
//     every 37 pieces (`kStride`, odd: conflict free), the lanes bring the
//     chunk in with 16-byte cp.async, lanes on consecutive addresses, and
//     return the result with 16-byte loads and stores the same way.
//   * The thread runs the same recurrence on its 78 registers, no shuffles.
//
//   In both layouts copy, arithmetic and copy back of one chunk cannot
//   overlap, those of different chunks can, and a warp's arithmetic takes as
//   long for a quarter chunk as for a full one while its copies do not. So a
//   batch that fits one wave is spread thin over one block per SM, and the
//   warps of a block start their copies in turn: a block's chunks arrive one
//   after the other, and the first is factored while the last is still on its
//   way. A larger batch runs one-warp blocks of full chunks, and the block
//   scheduler overlaps them. Both pointers must be 16-byte aligned for these
//   layouts; for a tensor that is not, the launcher takes the layout below
//   for that call.
//
//   a matrix per warp (every other n <= 32, unaligned tensors):
//   lane r owns row r in registers, the pivot and the column are broadcast
//   with warp shuffles, the n*n elements go through a per-warp shared-memory
//   tile with an odd row stride. Sizes between the instantiated N are padded
//   with identity rows, which factor to identity and are never written back.
//
// The launcher chooses the layout and the grid from (n, type, batch,
// alignment); no caller can.
//
// Plain C interface (loaded with ctypes): the functions launch on the given
// stream, allocate nothing, do not synchronise, and return cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float rsqrt_(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_(double x) { return rsqrt(x); }

// Diagonal boost of rung 0, 1, 2 of the rescue ladder.
template <typename T>
__device__ __forceinline__ T rung_boost(int rung, T scale) {
  return rung == 0 ? T(0) : (rung == 1 ? T(1e-4) * scale : scale);
}

// 1 / L[j][j] as the factor keeps it: rsqrt of the pivot, NaN where L[j][j]
// itself is not finite (as 1 / NaN is in the plain version).
template <typename T>
__device__ __forceinline__ T pivot_inverse(T d, T ljj, bool finite) {
  return finite ? d : ljj - ljj;
}

// ---------------------------------------------------------------------------
// staging between device memory and shared memory
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem_dst)),
               "l"(gmem_src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(arrivals)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Spin until the barrier's first phase is over; a copy that never lands traps
// (an error at the next synchronisation) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar) {
  for (int spin = 0; !mbar_try_wait(bar, 0); ++spin) {
    if (spin > (1 << 20)) __trap();
  }
}

__device__ __forceinline__ void bulk_load(void* smem_dst, const void* gmem_src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(smem_dst)),
      "l"(gmem_src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* gmem_dst, const void* smem_src, unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(gmem_dst),
               "r"(smem_u32(smem_src)), "r"(bytes)
               : "memory");
}

// Shared memory may go only when the bulk store has read it.
__device__ __forceinline__ void bulk_store_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Orders a thread's writes to shared memory before a bulk copy reads them.
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Blocks, warps in a block and matrices for each warp, for a layout that puts
// at most `chunk` matrices into a warp and `max_warps` warps into a block.
struct Grid {
  long long blocks;
  int warps, per_warp;
};

// Streaming multiprocessors of the current device.
int sm_count() {
  static int cached[64] = {};
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return 1;
  if (device >= 0 && device < 64 && cached[device] > 0) return cached[device];
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
      sms < 1)
    return 1;
  if (device >= 0 && device < 64) cached[device] = sms;
  return sms;
}

// A batch too large for one wave runs one-warp blocks of full chunks, which
// the block scheduler overlaps. A smaller one is spread thin, down to a
// quarter chunk for each warp, over one block an SM: the arithmetic of a warp
// takes as long for 8 matrices as for 32, its copies do not.
Grid spread(long long batch, int chunk, int max_warps) {
  const long long sms = sm_count();
  const long long chunks = (batch + chunk - 1) / chunk;
  if (chunks > sms * max_warps) return Grid{chunks, 1, chunk};
  const int least = chunk / 4;
  const long long wanted = (batch + least - 1) / least;  // warps, each with `least`
  Grid grid{wanted < sms ? wanted : sms, 1, chunk};
  const long long warps = (wanted + grid.blocks - 1) / grid.blocks;
  grid.warps = static_cast<int>(warps < max_warps ? warps : max_warps);
  const long long all_warps = grid.blocks * grid.warps;
  grid.per_warp = static_cast<int>((batch + all_warps - 1) / all_warps);
  return grid;
}

// Launch of a kernel that takes `Cfg::kChunk` matrices for each warp through
// `Cfg::kChunkBytes` of dynamic shared memory. Above 48 KB a kernel has to opt
// in, once for each device.
template <typename Cfg, typename Kernel, typename T>
cudaError_t launch_chunks(Kernel kernel, const T* A, T* out, long long batch, int rungs, T reg,
                          cudaStream_t stream) {
  static bool opted[64] = {};
  const Grid grid = spread(batch, Cfg::kChunk, Cfg::kMaxWarps);
  const int smem = grid.warps * Cfg::kChunkBytes;
  int device = 0;
  if (smem > 48 * 1024 && (cudaGetDevice(&device) != cudaSuccess || device < 0 || device >= 64 ||
                           !opted[device])) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kMaxWarps * Cfg::kChunkBytes);
    if (err != cudaSuccess) return err;
    if (device >= 0 && device < 64) opted[device] = true;
  }
  kernel<<<static_cast<unsigned>(grid.blocks), 32 * grid.warps, smem, stream>>>(
      A, out, batch, grid.per_warp, rungs, reg);
  return cudaGetLastError();
}

// Warp w of block b takes the `per_warp` matrices from (b * warps + w) *
// per_warp; the last chunks may be short or empty, and nothing past the
// tensor is touched.
struct Chunk {
  long long first;
  int count;
};

__device__ __forceinline__ Chunk my_chunk(long long batch, int per_warp) {
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const long long first = (static_cast<long long>(blockIdx.x) * warps + warp) * per_warp;
  const long long left = batch - first;
  return {first, left <= 0 ? 0 : (left < per_warp ? static_cast<int>(left) : per_warp)};
}

// ---------------------------------------------------------------------------
// a matrix per thread
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ld16(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void ld16(const double* p, double (&v)[2]) {
  const double2 q = *reinterpret_cast<const double2*>(p);
  v[0] = q.x; v[1] = q.y;
}
__device__ __forceinline__ void st16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st16(double* p, const double (&v)[2]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}

// Index of (r, c), c <= r, in the packed lower triangle.
__host__ __device__ constexpr int tri(int r, int c) { return r * (r + 1) / 2 + c; }

template <int N, typename T>
struct PerThread {
  static_assert(N * N * sizeof(T) % 16 == 0, "a matrix must be whole 16-byte pieces");
  static constexpr int kVec = 16 / sizeof(T);   // elements in a 16-byte piece
  static constexpr int kPieces = N * N / kVec;  // pieces in a matrix
  static constexpr int kStride = kPieces | 1;   // pieces between matrices in shared memory
  static constexpr int kTri = N * (N + 1) / 2;
  static constexpr int kChunk = 32;  // matrices of a warp, at most
  static constexpr int kChunkElems = kChunk * kStride * kVec;
  static constexpr int kChunkBytes = kChunkElems * sizeof(T);
  // warps of a block: what 200 KB of shared memory hold, 5 at most (more warps
  // with fewer matrices each were slower at the solver's batch)
  static constexpr int kMaxWarps = 200 * 1024 / kChunkBytes < 5 ? 200 * 1024 / kChunkBytes : 5;
  static_assert(kPieces >= 32 && kMaxWarps >= 1, "layout assumptions");
};

template <int N, typename T>
__device__ __forceinline__ void load_lower(const T* mine, T (&a)[N * (N + 1) / 2]) {
  constexpr int kVec = PerThread<N, T>::kVec;
#pragma unroll
  for (int p = 0; p < PerThread<N, T>::kPieces; ++p) {
    T v[kVec];
    ld16(mine + p * kVec, v);  // a piece wholly above the diagonal is dead code
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int r = (p * kVec + i) / N, c = (p * kVec + i) % N;
      if (c <= r) a[tri(r, c)] = v[i];
    }
  }
}

template <int N, typename T>
__device__ __forceinline__ void store_full(T* mine, const T (&a)[N * (N + 1) / 2]) {
  constexpr int kVec = PerThread<N, T>::kVec;
#pragma unroll
  for (int p = 0; p < PerThread<N, T>::kPieces; ++p) {
    T v[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int r = (p * kVec + i) / N, c = (p * kVec + i) % N;
      v[i] = T(0);
      if (c <= r) v[i] = a[tri(r, c)];
    }
    st16(mine + p * kVec, v);
  }
}

// Right-looking Cholesky in place. On return the strict lower triangle is L,
// the diagonal holds 1 / L[j][j]. True when every entry of L is finite: a
// non-finite L[r][j] makes the later pivot L[r][r] non-finite too, so the
// diagonal tells.
template <int N, typename T>
__device__ __forceinline__ bool factor(T (&a)[N * (N + 1) / 2]) {
  bool ok = true;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const T s = a[tri(j, j)];
    const T d = rsqrt_(s);
    const T ljj = s * d;  // s * rsqrt(s) = sqrt(s)
    const bool finite = isfinite(ljj);
    ok = ok && finite;
    a[tri(j, j)] = pivot_inverse(d, ljj, finite);
#pragma unroll
    for (int r = j + 1; r < N; ++r) a[tri(r, j)] *= d;
#pragma unroll
    for (int r = j + 1; r < N; ++r) {
#pragma unroll
      for (int c = j + 1; c <= r; ++c) a[tri(r, c)] -= a[tri(r, j)] * a[tri(c, j)];
    }
  }
  return ok;
}

// Forward substitution in place, row by row, columns ascending: when X[r][c]
// = -(sum_{k=c}^{r-1} L[r][k] X[k][c]) / L[r][r] overwrites L[r][c], the rows
// above already hold X and L[r][k], k > c, is still untouched.
template <int N, typename T>
__device__ __forceinline__ void invert(T (&a)[N * (N + 1) / 2]) {
#pragma unroll
  for (int r = 1; r < N; ++r) {
    const T dr = a[tri(r, r)];
#pragma unroll
    for (int c = 0; c < r; ++c) {
      T acc = a[tri(r, c)] * a[tri(c, c)];
#pragma unroll
      for (int k = c + 1; k < r; ++k) acc += a[tri(r, k)] * a[tri(k, c)];
      a[tri(r, c)] = -acc * dr;
    }
  }
}

// Next 16-byte piece of a chunk for a lane that walks it 32 pieces at a time:
// piece p of matrix m.
template <int kPieces>
__device__ __forceinline__ void advance(int& m, int& p) {
  p += 32;
  if (p >= kPieces) {
    p -= kPieces;
    ++m;
  }
}

// rungs = 1: L^{-1} of A. rungs = 3: the rescue ladder on A + reg I.
template <int N, typename T>
__global__ void __launch_bounds__(32 * PerThread<N, T>::kMaxWarps)
per_thread_kernel(const T* __restrict__ A, T* __restrict__ out, long long batch, int per_warp,
                  int rungs, T reg) {
  using Cfg = PerThread<N, T>;
  extern __shared__ __align__(128) unsigned char smem_raw[];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  T* sm = reinterpret_cast<T*>(smem_raw) + warp * Cfg::kChunkElems;
  const Chunk chunk = my_chunk(batch, per_warp);
  const int pieces = chunk.count * Cfg::kPieces;

  // Staging in, the block's warps in turn.
  for (int turn = 0; turn < warps; ++turn) {
    if (turn == warp) {
      const T* src = A + chunk.first * (N * N);
      int m = 0, p = lane;
#pragma unroll 4
      for (int g = lane; g < pieces; g += 32) {
        cp_async16(sm + (m * Cfg::kStride + p) * Cfg::kVec, src + g * Cfg::kVec);
        advance<Cfg::kPieces>(m, p);
      }
    }
    if (warps > 1) __syncthreads();
  }
  cp_async_wait_all();
  __syncwarp();

  if (lane < chunk.count) {
    T* mine = sm + lane * (Cfg::kStride * Cfg::kVec);
    T a[Cfg::kTri];
#pragma unroll 1
    for (int rung = 0; rung < rungs; ++rung) {
      load_lower<N, T>(mine, a);
      if (rungs > 1) {
        T trace = T(0);
#pragma unroll
        for (int i = 0; i < N; ++i) trace += a[tri(i, i)];
        const T boost = rung_boost(rung, trace / T(N) + T(1));
#pragma unroll
        for (int i = 0; i < N; ++i) a[tri(i, i)] = (a[tri(i, i)] + reg) + boost;
      }
      if (factor<N, T>(a)) break;  // the last rung is taken as it comes
    }
    invert<N, T>(a);
    store_full<N, T>(mine, a);
  }
  __syncwarp();

  // Staging out.
  T* dst = out + chunk.first * (N * N);
  int m = 0, p = lane;
#pragma unroll 4
  for (int g = lane; g < pieces; g += 32) {
    T v[Cfg::kVec];
    ld16(sm + (m * Cfg::kStride + p) * Cfg::kVec, v);
    st16(dst + g * Cfg::kVec, v);
    advance<Cfg::kPieces>(m, p);
  }
}

// ---------------------------------------------------------------------------
// a matrix per group of L lanes
// ---------------------------------------------------------------------------

template <int N, int L, typename T>
struct PerGroup {
  static_assert(L >= 2 && L <= 8 && 32 % L == 0, "lane groups tile a warp");
  static_assert(N % 2 == 0, "rows are read two elements at a time");
  static_assert(N * N * sizeof(T) % 16 == 0, "a matrix must be whole 16-byte pieces");
  static constexpr int kRows = (N + L - 1) / L;  // rows of lane q: q, q + L, ...
  static constexpr int kChunk = 32 / L;          // matrices of a warp, at most
  static constexpr int kChunkBytes = kChunk * N * N * sizeof(T);
  // warps of a block: what 200 KB of shared memory hold, 8 at most
  static constexpr int kMaxWarps = 200 * 1024 / kChunkBytes < 8 ? 200 * 1024 / kChunkBytes : 8;
  // Row i of a lane is kept with L * (i + 1) entries (N at most): room for
  // row q + L * i of every q, so that all register indices are static.
  __host__ __device__ static constexpr int width(int i) { return L * (i + 1) < N ? L * (i + 1) : N; }
  // only the last row can be clipped, so the rows before it are L, 2 L, ... wide
  __host__ __device__ static constexpr int offset(int i) { return L * i * (i + 1) / 2; }
  static constexpr int kRegs = offset(kRows - 1) + width(kRows - 1);
};

template <int L, typename T>
__device__ __forceinline__ T group_bcast(unsigned mask, T v, int q_src) {
  return __shfl_sync(mask, v, q_src, L);
}

__device__ __forceinline__ void ld_pair(const float* p, float& x, float& y) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  x = v.x; y = v.y;
}
__device__ __forceinline__ void ld_pair(const double* p, double& x, double& y) {
  const double2 v = *reinterpret_cast<const double2*>(p);
  x = v.x; y = v.y;
}
__device__ __forceinline__ void st_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void st_pair(double* p, double x, double y) {
  *reinterpret_cast<double2*>(p) = make_double2(x, y);
}

template <int N, int L, typename T>
__global__ void __launch_bounds__(32 * PerGroup<N, L, T>::kMaxWarps)
per_group_kernel(const T* __restrict__ A, T* __restrict__ out, long long batch, int per_warp,
                 int rungs, T reg) {
  using Cfg = PerGroup<N, L, T>;
  constexpr unsigned kMatrixBytes = N * N * sizeof(T);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ uint64_t bars[Cfg::kMaxWarps];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int q = lane & (L - 1);  // my place in the group: rows q, q + L, ...
  const int group = lane / L;    // my matrix in the chunk
  const unsigned mask = ((1u << L) - 1u) << (lane & ~(L - 1));  // the lanes of my group
  T* sm = reinterpret_cast<T*>(smem_raw) + warp * (Cfg::kChunk * N * N);
  const Chunk chunk = my_chunk(batch, per_warp);

  // Staging in, the block's warps in turn.
  if (lane == 0) mbar_init(&bars[warp], 1);
  __syncwarp();  // no lane may poll the barrier before it exists
  for (int turn = 0; turn < warps; ++turn) {
    if (turn == warp && chunk.count > 0 && lane == 0) {
      mbar_arrive_expect_tx(&bars[warp], chunk.count * kMatrixBytes);
      bulk_load(sm, A + chunk.first * (N * N), chunk.count * kMatrixBytes, &bars[warp]);
    }
    if (warps > 1) __syncthreads();
  }
  if (chunk.count > 0) mbar_wait(&bars[warp]);

  if (group < chunk.count) {
    T* mat = sm + group * (N * N);
    T a[Cfg::kRegs];
#pragma unroll 1
    for (int rung = 0; rung < rungs; ++rung) {
      T boost = T(0);
      if (rungs > 1) {
        T trace = T(0);
        for (int i = 0; i < N; ++i) trace += mat[i * N + i];
        boost = rung_boost(rung, trace / T(N) + T(1));
      }
      // rows q, q + L, ...: entries c <= r, the rest of the row's room stays unused
#pragma unroll
      for (int i = 0; i < Cfg::kRows; ++i) {
        const int r = q + L * i;
#pragma unroll
        for (int c = 0; c < Cfg::width(i); c += 2) {
          T x = T(0), y = T(0);
          if (r < N && c <= r) ld_pair(mat + r * N + c, x, y);
          if (rungs > 1) {
            if (c == r) x = (x + reg) + boost;
            if (c + 1 == r) y = (y + reg) + boost;
          }
          a[Cfg::offset(i) + c] = x;
          a[Cfg::offset(i) + c + 1] = y;
        }
      }

      // Right-looking Cholesky; every lane of the group sees every pivot.
      bool ok = true;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const int qj = j % L, ij = j / L;
        const T s = group_bcast<L>(mask, a[Cfg::offset(ij) + j], qj);
        const T d = rsqrt_(s);
        const T ljj = s * d;
        const bool finite = isfinite(ljj);
        ok = ok && finite;
#pragma unroll
        for (int i = ij; i < Cfg::kRows; ++i) {
          if (i > ij || q > qj) a[Cfg::offset(i) + j] *= d;
        }
        if (q == qj) a[Cfg::offset(ij) + j] = pivot_inverse(d, ljj, finite);
#pragma unroll
        for (int c = j + 1; c < N; ++c) {
          const int qc = c % L, ic = c / L;
          const T lc = group_bcast<L>(mask, a[Cfg::offset(ic) + j], qc);  // L[c][j]
#pragma unroll
          for (int i = ic; i < Cfg::kRows; ++i) {
            if (i > ic || q >= qc) a[Cfg::offset(i) + c] -= a[Cfg::offset(i) + j] * lc;
          }
        }
      }
      if (ok) break;  // the last rung is taken as it comes
    }

    // Forward substitution in place: at step k row k becomes final on its owner
    // and is sent to the rows below, which add L[r][k] X[k][c] to their sums.
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int qk = k % L, ik = k / L;
      if (q == qk) {
        const T dk = -a[Cfg::offset(ik) + k];
#pragma unroll
        for (int c = 0; c < k; ++c) a[Cfg::offset(ik) + c] *= dk;
      }
      if (k < N - 1) {
        T l[Cfg::kRows];
#pragma unroll
        for (int i = ik; i < Cfg::kRows; ++i) l[i] = a[Cfg::offset(i) + k];
#pragma unroll
        for (int c = 0; c <= k; ++c) {
          const T x = group_bcast<L>(mask, a[Cfg::offset(ik) + c], qk);  // X[k][c]
#pragma unroll
          for (int i = ik; i < Cfg::kRows; ++i) {
            if (i > ik || q > qk) {
              if (c < k) a[Cfg::offset(i) + c] += l[i] * x;
              else a[Cfg::offset(i) + c] = l[i] * x;
            }
          }
        }
      }
    }

#pragma unroll
    for (int i = 0; i < Cfg::kRows; ++i) {
      const int r = q + L * i;
      if (r < N) {
#pragma unroll
        for (int c = 0; c < N; c += 2) {
          T x = T(0), y = T(0);
          if (c < Cfg::width(i)) {
            if (c <= r) x = a[Cfg::offset(i) + c];
            if (c + 1 <= r) y = a[Cfg::offset(i) + c + 1];
          }
          st_pair(mat + r * N + c, x, y);
        }
      }
    }
    fence_async_proxy();
  }
  __syncwarp();

  // Staging out.
  if (chunk.count > 0 && lane == 0) {
    bulk_store(out + chunk.first * (N * N), sm, chunk.count * kMatrixBytes);
    bulk_store_wait();
  }
}

// ---------------------------------------------------------------------------
// a matrix per warp
// ---------------------------------------------------------------------------

constexpr int kWarpsPerBlock = 4;

template <int N, typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
per_warp_kernel(const T* __restrict__ A, T* __restrict__ out, long long batch, int n,
                int rungs, T reg) {
  constexpr int LD = N | 1;  // odd row stride: conflict-free row-per-lane
  __shared__ T tile[kWarpsPerBlock][N * LD];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long m = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + warp;
  if (m >= batch) return;  // whole warps leave together; only __syncwarp below

  T* sm = tile[warp];
  const T* src = A + m * n * n;
  const int nn = n * n;
  for (int e = lane; e < nn; e += 32) {
    const int r = e / n;
    sm[r * LD + (e - r * n)] = src[e];
  }
  __syncwarp();

  T a[N];         // row `lane` of the (identity padded) lower triangle
  T dinv = T(0);  // 1 / L[lane][lane]
#pragma unroll 1
  for (int rung = 0; rung < rungs; ++rung) {
    T boost = T(0);
    if (rungs > 1) {
      T trace = T(0);
      for (int i = 0; i < n; ++i) trace += sm[i * LD + i];
      boost = rung_boost(rung, trace / T(n) + T(1));
    }
#pragma unroll
    for (int c = 0; c < N; ++c) {
      T val = (c == lane) ? T(1) : T(0);
      if (lane < n && c <= lane) {
        val = sm[lane * LD + c];
        if (rungs > 1 && c == lane) val = (val + reg) + boost;
      }
      a[c] = val;
    }

    // Right-looking Cholesky. After step j, a[j] on lane r >= j is L[r][j].
    bool finite = true;  // L[lane][lane]; the diagonal tells for all of L
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const T s = __shfl_sync(kFullMask, a[j], j);
      const T d = rsqrt_(s);
      const T l = a[j] * d;  // lane j: s * rsqrt(s) = sqrt(s)
      if (lane == j) {
        finite = isfinite(l);
        dinv = pivot_inverse(d, l, finite);
      }
      a[j] = l;
#pragma unroll
      for (int k = j + 1; k < N; ++k) {
        const T lk = __shfl_sync(kFullMask, l, k);  // L[k][j]
        if (lane >= k) a[k] -= l * lk;
      }
    }
    if (__all_sync(kFullMask, finite)) break;  // the last rung is taken as it comes
  }

  // Forward substitution, row oriented. x[c] on lane r accumulates
  // sum_{k=c}^{r-1} L[r][k] X[k][c]; X[r][c] = -x[c] / L[r][r], X[r][r] = 1/L[r][r].
  T x[N];
#pragma unroll
  for (int c = 0; c < N; ++c) x[c] = T(0);
#pragma unroll
  for (int k = 0; k < N - 1; ++k) {
    const T dk = __shfl_sync(kFullMask, dinv, k);
#pragma unroll
    for (int c = 0; c <= k; ++c) {
      const T acc = __shfl_sync(kFullMask, x[c], k);
      const T xkc = (c == k) ? dk : -acc * dk;  // X[k][c], final
      if (lane > k) x[c] += a[k] * xkc;
    }
  }

  if (lane < n) {
#pragma unroll
    for (int c = 0; c < N; ++c) {
      if (c < n) {
        T val = T(0);
        if (c < lane) val = -x[c] * dinv;
        if (c == lane) val = dinv;
        sm[lane * LD + c] = val;
      }
    }
  }
  __syncwarp();

  T* dst = out + m * n * n;
  for (int e = lane; e < nn; e += 32) {
    const int r = e / n;
    dst[e] = sm[r * LD + (e - r * n)];
  }
}

template <int N, typename T>
void launch_per_warp(const T* A, T* out, long long batch, int n, int rungs, T reg,
                     cudaStream_t stream) {
  const long long blocks = (batch + kWarpsPerBlock - 1) / kWarpsPerBlock;
  per_warp_kernel<N, T><<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0, stream>>>(
      A, out, batch, n, rungs, reg);
}

// ---------------------------------------------------------------------------
// launcher
// ---------------------------------------------------------------------------

template <typename T>
int launch(const void* A_, void* out_, long long batch, int n, int rungs, double reg_,
           void* stream_) {
  if (batch <= 0) return 0;
  if (n < 1 || n > 32 || batch > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const T* A = static_cast<const T*>(A_);
  T* out = static_cast<T*>(out_);
  const T reg = static_cast<T>(reg_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(A_) | reinterpret_cast<uintptr_t>(out_)) & 15) == 0;

  if (aligned && (n == 12 || n == 18)) {
    // one layout for each (n, type): the fastest of a matrix per thread and
    // per 2, 4 or 8 lanes, timed in turns on an H100
    constexpr bool f32 = sizeof(T) == 4;
    if (n == 18)
      return static_cast<int>(launch_chunks<PerGroup<18, f32 ? 2 : 4, T>>(
          per_group_kernel<18, f32 ? 2 : 4, T>, A, out, batch, rungs, reg, stream));
    if constexpr (f32)
      return static_cast<int>(launch_chunks<PerThread<12, T>>(per_thread_kernel<12, T>, A, out,
                                                              batch, rungs, reg, stream));
    else
      return static_cast<int>(launch_chunks<PerGroup<12, 4, T>>(per_group_kernel<12, 4, T>, A,
                                                                out, batch, rungs, reg, stream));
  }

  if (n <= 4) launch_per_warp<4, T>(A, out, batch, n, rungs, reg, stream);
  else if (n <= 8) launch_per_warp<8, T>(A, out, batch, n, rungs, reg, stream);
  else if (n <= 16) launch_per_warp<16, T>(A, out, batch, n, rungs, reg, stream);
  else if (n <= 24) launch_per_warp<24, T>(A, out, batch, n, rungs, reg, stream);
  else launch_per_warp<32, T>(A, out, batch, n, rungs, reg, stream);
  return static_cast<int>(cudaGetLastError());
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" int chol_tri_inv_f32(const void* A, void* out, long long batch, int n,
                                void* stream) {
  return launch<float>(A, out, batch, n, 1, 0.0, stream);
}

extern "C" int chol_tri_inv_f64(const void* A, void* out, long long batch, int n,
                                void* stream) {
  return launch<double>(A, out, batch, n, 1, 0.0, stream);
}

extern "C" int chol_rescue_tri_inv_f32(const void* G, void* out, long long batch, int n,
                                       double reg, void* stream) {
  return launch<float>(G, out, batch, n, 3, reg, stream);
}

extern "C" int chol_rescue_tri_inv_f64(const void* G, void* out, long long batch, int n,
                                       double reg, void* stream) {
  return launch<double>(G, out, batch, n, 3, reg, stream);
}

// One launch of a kernel that does nothing: the floor under any launch's time.
extern "C" int launch_floor_probe(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
