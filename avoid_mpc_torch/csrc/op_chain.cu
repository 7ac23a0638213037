// Long chains of one elementwise op, timed on the card with clock64().
//
// Replaces the TPU kernel of avoid_mpc_tpu/tools/vpu_microbench.py
// (_time_chain / _make_kernel), which timed chains on one (8, 128) vector
// register.  On a v5e that register is the whole vector issue path of the
// chip's one TensorCore, so the TPU tool measured the chip's issue rate at
// the solver kernel's tile.  Here the (8, 128) tile is 1024 elements, one
// per thread; each warp runs `LANES` independent chains of `n_iter`
// iterations, each iteration applying the op `UNROLL` times to every chain,
// and reads the SM clock around its loop:
//   serial (1 chain)          cycles per op = the op's dependent latency;
//   ilp8 (8 chains)           throughput with the loop's own bookkeeping;
//   ilp8x4 (8 chains, 4x)     issue-limited throughput.
// Two launches (`occupancy`):
//   0: one tile in 32 one-warp blocks, one warp on each of 32 SMs: latency,
//      and what one warp scheduler of the card's 528 (132 SMs x 4) issues;
//   1: the solver kernels' occupancy: R replicas of the tile in 64-thread
//      blocks (the SQP kernel's block, __launch_bounds__(64, 8)), 8 blocks
//      and 16 warps on every SM, R = SMs x 16 / 32.  Each block reserves
//      1/8 of the SM's shared memory (it uses none), so no SM can take a
//      ninth block and the launch is one wave of exactly 16 warps an SM;
//      the launcher checks that with CUDA's occupancy calculator.  This is
//      the counterpart of the TPU tool's number: the card's issue rate.
// Bound: issue slots.  An SM issues at most 4 warp instructions a cycle
// (one per scheduler), and its 128 f32 lanes retire 4 warp FFMAs a cycle:
// 132 x 128 x 2 x 1.98 GHz = 67e12 FLOP/s, the operations bound that
// tools/roofline.py charges.  One warp per SM can use at most a quarter of
// that; 16 warps an SM give each scheduler 4 warps, whose 8 x 4 independent
// chains hide the FFMA latency and the loop's branch, so the FMA ilp8x4
// launch at occupancy 1 runs near 4 warp FFMAs an SM cycle.
// The ops are the accurate expf / log1pf / sqrtf / tanhf and IEEE division
// that the solver kernels compile to (no --use_fast_math).  An empty
// `asm volatile` after each application keeps the compiler from folding a
// chain (max(max(y, c), c) = max(y, c)); it emits no instruction.
//
// Layout: x (R, LANES, 1024) f32 in (R = 1 at occupancy 0), out (R, 1024) =
// each thread's chains summed in order, stamps (R x 32, 3) int64 = each
// warp's SM id and its clock64() before and after its loop.  The chains
// read and write 4 (LANES + 1) R 1024 bytes.
// Geometry: this file owns the block (FULL_THREADS, FULL_BLOCKS_PER_SM,
// compiled into __launch_bounds__); tools/op_microbench.py reads the two
// defines from it and chooses R and the grid (launch_geometry).  The
// launcher only checks what it is given: one thread per tile element, and
// at occupancy 1 one wave (grid <= SMs x FULL_BLOCKS_PER_SM).

#include <cuda_runtime.h>
#include <math.h>

#define WARP 32
#define TILE 1024
#define FULL_THREADS 64       // the SQP kernel's block (csrc/sqp.cu, SQP_THREADS)
#define FULL_BLOCKS_PER_SM 8  // 16 warps an SM

enum OpId { OP_FMA, OP_MUL, OP_ADD, OP_MAX, OP_EXP, OP_LOG1P, OP_SQRT, OP_RSQRT, OP_DIV,
            OP_TANH, OP_SELECT, N_OPS };

// Each map is bounded, so a chain of any length neither overflows nor
// denormalizes (vpu_microbench.py::OPS).
template <int OP>
__device__ __forceinline__ float apply(float y) {
  if constexpr (OP == OP_FMA) return y * 0.999f + 0.0005f;
  if constexpr (OP == OP_MUL) return y * 1.0000001f;
  if constexpr (OP == OP_ADD) return y + 1e-7f;
  if constexpr (OP == OP_MAX) return fmaxf(y, 0.4999f);
  if constexpr (OP == OP_EXP) return expf(-y);
  if constexpr (OP == OP_LOG1P) return log1pf(y);
  if constexpr (OP == OP_SQRT) return sqrtf(y);
  if constexpr (OP == OP_RSQRT) return rsqrtf(y);
  if constexpr (OP == OP_DIV) return 0.36f / y;
  if constexpr (OP == OP_TANH) return tanhf(y) + 0.5f;
  if constexpr (OP == OP_SELECT) return y > 0.5f ? y * 0.999f : y * 1.001f;
  return y;
}

template <int OP, int LANES, int UNROLL, int THREADS, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
op_chain_kernel(const float* __restrict__ x, float* __restrict__ out,
                long long* __restrict__ stamps, int n_iter) {
  const int g = blockIdx.x * THREADS + threadIdx.x;
  const float* xr = x + (size_t)(g / TILE) * LANES * TILE + g % TILE;
  float y[LANES];
#pragma unroll
  for (int l = 0; l < LANES; ++l) y[l] = xr[(size_t)l * TILE];
  const long long t0 = clock64();
#pragma unroll 1
  for (int i = 0; i < n_iter; ++i) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int l = 0; l < LANES; ++l) {
        y[l] = apply<OP>(y[l]);
        asm volatile("" : "+f"(y[l]));
      }
    }
  }
  const long long t1 = clock64();
  float acc = y[0];
#pragma unroll
  for (int l = 1; l < LANES; ++l) acc = acc + y[l];
  out[g] = acc;
  if (threadIdx.x % WARP == 0) {
    unsigned smid;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
    long long* s = stamps + 3 * (size_t)(g / WARP);
    s[0] = smid;
    s[1] = t0;
    s[2] = t1;
  }
}

// Dynamic shared memory that leaves room for FULL_BLOCKS_PER_SM blocks on an
// SM and not one more.
static cudaError_t full_smem_bytes(int device, int* bytes) {
  int per_sm = 0, reserved = 0;
  cudaError_t err = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, device);
  *bytes = per_sm / FULL_BLOCKS_PER_SM - reserved - 128;
  return err;
}

template <int OP, int LANES, int UNROLL>
static cudaError_t launch_op(int occupancy, const float* x, float* out, long long* stamps,
                             int n_iter, int grid, int device, cudaStream_t s) {
  if (occupancy == 0) {
    op_chain_kernel<OP, LANES, UNROLL, WARP, 1><<<grid, WARP, 0, s>>>(x, out, stamps, n_iter);
    return cudaGetLastError();
  }
  auto kernel = op_chain_kernel<OP, LANES, UNROLL, FULL_THREADS, FULL_BLOCKS_PER_SM>;
  int smem = 0, blocks = 0;
  cudaError_t err = full_smem_bytes(device, &smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, FULL_THREADS, smem);
  if (err != cudaSuccess) return err;
  if (blocks != FULL_BLOCKS_PER_SM) return cudaErrorInvalidConfiguration;
  kernel<<<grid, FULL_THREADS, smem, s>>>(x, out, stamps, n_iter);
  return cudaGetLastError();
}

template <int LANES, int UNROLL>
static cudaError_t launch_mode(int op, int occupancy, const float* x, float* out,
                               long long* stamps, int n_iter, int grid, int device,
                               cudaStream_t s) {
  switch (op) {
#define CASE(ID) \
  case ID:       \
    return launch_op<ID, LANES, UNROLL>(occupancy, x, out, stamps, n_iter, grid, device, s);
    CASE(OP_FMA)
    CASE(OP_MUL)
    CASE(OP_ADD)
    CASE(OP_MAX)
    CASE(OP_EXP)
    CASE(OP_LOG1P)
    CASE(OP_SQRT)
    CASE(OP_RSQRT)
    CASE(OP_DIV)
    CASE(OP_TANH)
    CASE(OP_SELECT)
#undef CASE
  }
  return cudaErrorInvalidValue;
}

// ---- host launch (plain C interface, loaded with ctypes) ----

// mode: 0 = serial (1 chain), 1 = ilp8 (8 chains), 2 = ilp8x4 (8 chains, 4x unrolled).
// occupancy: 0 = one-warp blocks (replicas 1); 1 = FULL_THREADS-thread blocks,
// FULL_BLOCKS_PER_SM an SM.  grid and threads come from the caller
// (tools/op_microbench.py::launch_geometry) and must cover the replicas'
// tiles one thread an element, at occupancy 1 in one wave.
extern "C" int op_chain_launch(int op, int mode, int occupancy, const void* x, void* out,
                               void* stamps, int n_iter, int replicas, int grid, int threads,
                               int device, void* stream) {
  if (op < 0 || op >= N_OPS || mode < 0 || mode > 2 || occupancy < 0 || occupancy > 1 ||
      replicas < 1 || (occupancy == 0 && replicas != 1) || n_iter < 0)
    return (int)cudaErrorInvalidValue;
  if (threads != (occupancy == 0 ? WARP : FULL_THREADS) ||
      (long long)grid * threads != (long long)replicas * TILE)
    return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (occupancy == 1) {
    int n_sm = 0;
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    if (grid > n_sm * FULL_BLOCKS_PER_SM) return (int)cudaErrorInvalidConfiguration;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  float* of = (float*)out;
  long long* st = (long long*)stamps;
  if (mode == 0) err = launch_mode<1, 1>(op, occupancy, xf, of, st, n_iter, grid, device, s);
  if (mode == 1) err = launch_mode<8, 1>(op, occupancy, xf, of, st, n_iter, grid, device, s);
  if (mode == 2) err = launch_mode<8, 4>(op, occupancy, xf, of, st, n_iter, grid, device, s);
  return (int)err;
}
