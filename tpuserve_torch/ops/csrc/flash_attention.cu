// Kernels K1 and K2 of the port: fused (flash) attention forward for
// NVIDIA Hopper, one source and one recurrence for both.
//
// K1 replaces tpuserve/ops/flash_attention.py::_fa_kernel (the Pallas TPU
// kernel, with its per-tile step _fa_step). It computes what that kernel
// computes, softmax(q.k^T * D^-1/2 + bias) . v per (batch, head), as an
// online softmax with a float32 running max m, normalizer l and
// accumulator, and writes the normalized output in q's dtype.
//
// K2 replaces tpuserve/ops/flash_attention.py::_fa_kernel_stats, the local
// step of ring attention: the same recurrence (each kernel template with
// kStats = true), but it never divides. It stores the float32 accumulator
// unnormalized into a contiguous (B, Sq, H, D) float32 tensor and the row
// stats m and l into (B, Sq, H) float32 tensors, so a caller can merge this
// key block with others. A fully masked row keeps the reference's answer
// under a -1e9 bias (m ~ -1e9, l ~ Sk, acc = sum of v) and gives m = -1e30,
// l = 0, acc = 0 under a -inf bias; the caller's merge weighs either away.
//
// Interface (the reference's layout): q is (B, Sq, H, D), k and v are
// (B, Sk, H, D), each read through its own (batch, seq, head) strides with
// the head dim contiguous, so q/k/v sliced out of one fused projection need
// no copy and nothing is transposed. bias is an additive per-key term
// (B, Sk) in float32, or null. o is a contiguous (B, Sq, H, D) tensor in
// q's dtype. Inputs are float32, bfloat16 or float16; D is any multiple of
// 8 up to 128. Absent keys of a ragged tile score -inf and the running max
// starts at -1e30, so they add nothing to m, l or the accumulator, even in
// a row whose present keys all carry a -inf bias; no tile is skipped, so a
// row whose keys are all -1e9 padding gets the reference's finite average
// of V, never 0/0.
//
// Two designs, chosen once by the input dtype (never a fallback):
//
// bfloat16 and float16: the tensor cores (flash_fwd_wgmma). What bounds it:
// at ring attention's long-context shape (B 8, S 2048, H 12, D 64) the
// work is 4*B*H*S^2*D = 103 GFLOP on 127.5 MB, 809 operations per byte,
// above the ~295 at which the H100's bf16 tensor cores (989 TFLOP/s), not
// its 3.35 TB/s memory, set the least time; at BERT's short shapes (S 64,
// 128) it is 32-64 operations per byte, so there the bytes bound it. The
// design: one block per (64 query rows, head, batch) with one consumer
// warpgroup and one producer warp; three blocks share an SM at D <= 64,
// so one block's softmax runs while another's products do (one block of two
// consumer warpgroups per SM, or two blocks, measured slower). The producer loads Q once
// and streams K and V through a 2-stage shared-memory ring with TMA (4-D
// tensor maps over (D, H, S, B) built on the host from the strides,
// 128-byte swizzle, zero fill past Sk and past D), each stage guarded by a
// full and an empty mbarrier; it writes the stage's bias tile (times
// log2 e, -inf for absent keys) beside it. The consumers compute
// S = Q.K^T with wgmma m64n128k16 (both operands from shared memory,
// K-major, f32 accumulators in registers), take the online softmax in
// registers in log2 units (scale and log2 e folded into one multiply,
// exp2; row max by quad shuffles; l summed from the f32 probabilities),
// rescale the accumulator only when a row's max moved, round P to the
// input dtype in registers (the S accumulator's layout is the A-operand
// layout of the next product) and accumulate O += P.V with wgmma (A from
// registers, V from shared memory MN-major, f32 accumulators). P's one
// rounding is what the reference's f32 dot_general does on the TPU, one
// bf16 pass of the MXU. Each byte of q, k, v and o moves once per block;
// scores never leave registers. TMA needs 16-byte aligned bases and
// strides that are multiples of 16 bytes; the wrapper refuses other
// layouts.
//
// float32: the CUDA cores (flash_fwd_kernel, the first design, unchanged).
// The tensor cores would round float32 to TF32, which the plain float32
// version does not do, and no served path runs attention in float32. One
// block per (64 query rows, head, batch); TPR threads share one query row
// (TPR = 1, 2, 4 for D <= 32, 64, 128), each holding every TPR-th element
// of q and of the accumulator in registers; K, V and bias tiles are staged
// in shared memory as float32 (32 KB) and each row scores 8 keys per
// online-softmax update, in float32 FMA.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <atomic>

#include "sm90.cuh"

namespace {

constexpr int kRowsPerBlock = 64;   // query rows per thread block
constexpr int kKeysPerStep = 8;     // keys scored per online-softmax update
constexpr int kDimsPerThread = 32;  // head-dim elements held by one thread
constexpr float kNegInf = -1e30f;   // running-max seed (the reference's NEG_INF)

// The CUDA-core kernel is instantiated for float32 only.
__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

struct Strides {  // in elements; the head dim is contiguous
  long long b, s, h;
};

// kStats = false: K1, o is T (B, Sq, H, D), normalized; m_out and l_out
// are unused. kStats = true: K2, o is float (B, Sq, H, D), unnormalized,
// and m_out, l_out receive the row stats (B, Sq, H).
template <typename T, int TPR, bool kStats>
__global__ void __launch_bounds__(kRowsPerBlock * TPR)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 void* __restrict__ o, float* __restrict__ m_out,
                 float* __restrict__ l_out, int sq, int sk, int heads, int dim,
                 Strides qs, Strides ks, Strides vs, long long bias_sb,
                 float scale) {
  constexpr int kThreads = kRowsPerBlock * TPR;
  constexpr int kDimsPad = kDimsPerThread * TPR;  // head dim as staged
  constexpr int kKeysPerTile = 128 / TPR;         // K+V tile = 32 KB of f32
  static_assert(kKeysPerTile % kKeysPerStep == 0, "steps must tile a key tile");
  __shared__ float k_tile[kKeysPerTile][kDimsPad];
  __shared__ float v_tile[kKeysPerTile][kDimsPad];
  __shared__ float bias_tile[kKeysPerTile];

  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int part = tid % TPR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int qi = blockIdx.x * kRowsPerBlock + row;
  const bool live = qi < sq;  // rows past Sq compute along but store nothing

  // Element d of the row lives in thread part d % TPR, slot d / TPR: the
  // TPR threads of a row read neighbouring shared-memory words.
  float qr[kDimsPerThread];
  float acc[kDimsPerThread];
  const T* qrow = q + b * qs.b + static_cast<long long>(live ? qi : 0) * qs.s + h * qs.h;
#pragma unroll
  for (int i = 0; i < kDimsPerThread; ++i) {
    const int d = i * TPR + part;
    qr[i] = (live && d < dim) ? to_f32(qrow[d]) * scale : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf;
  float l = 0.f;

  const T* kbase = k + b * ks.b + h * ks.h;
  const T* vbase = v + b * vs.b + h * vs.h;
  for (int k0 = 0; k0 < sk; k0 += kKeysPerTile) {
    const int n = min(kKeysPerTile, sk - k0);  // keys present in this tile
    __syncthreads();  // every row is done with the previous tile
    for (int idx = tid; idx < kKeysPerTile * kDimsPad; idx += kThreads) {
      const int j = idx / kDimsPad;
      const int d = idx % kDimsPad;
      const bool in = j < n && d < dim;
      const long long key = k0 + j;
      k_tile[j][d] = in ? to_f32(kbase[key * ks.s + d]) : 0.f;
      v_tile[j][d] = in ? to_f32(vbase[key * vs.s + d]) : 0.f;
    }
    for (int j = tid; j < kKeysPerTile; j += kThreads) {
      bias_tile[j] = (bias != nullptr && j < n) ? bias[b * bias_sb + k0 + j] : 0.f;
    }
    __syncthreads();

    for (int j0 = 0; j0 < n; j0 += kKeysPerStep) {
      float s[kKeysPerStep];
      float m_new = m;
#pragma unroll
      for (int c = 0; c < kKeysPerStep; ++c) {
        const int j = j0 + c;
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < kDimsPerThread; ++i) {
          dot = fmaf(qr[i], k_tile[j][i * TPR + part], dot);
        }
#pragma unroll
        for (int off = 1; off < TPR; off <<= 1) {
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        }
        s[c] = j < n ? dot + bias_tile[j] : -CUDART_INF_F;
        m_new = fmaxf(m_new, s[c]);
      }
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int i = 0; i < kDimsPerThread; ++i) acc[i] *= alpha;
      m = m_new;
#pragma unroll
      for (int c = 0; c < kKeysPerStep; ++c) {
        const int j = j0 + c;
        const float p = expf(s[c] - m);  // 0 for an absent key: m >= -1e30
        l += p;
#pragma unroll
        for (int i = 0; i < kDimsPerThread; ++i) {
          acc[i] = fmaf(p, v_tile[j][i * TPR + part], acc[i]);
        }
      }
    }
  }

  if (!live) return;
  const long long row_idx = (static_cast<long long>(b) * sq + qi) * heads + h;
  if constexpr (kStats) {
    float* orow = static_cast<float*>(o) + row_idx * dim;
#pragma unroll
    for (int i = 0; i < kDimsPerThread; ++i) {
      const int d = i * TPR + part;
      if (d < dim) orow[d] = acc[i];
    }
    if (part == 0) {  // one thread of the row's TPR group
      m_out[row_idx] = m;
      l_out[row_idx] = l;
    }
  } else {
    T* orow = static_cast<T*>(o) + row_idx * dim;
#pragma unroll
    for (int i = 0; i < kDimsPerThread; ++i) {
      const int d = i * TPR + part;
      if (d < dim) orow[d] = from_f32<T>(acc[i] / l);
    }
  }
}


// -- bfloat16 / float16: the tensor-core kernel ---------------------------------

constexpr int kTcRows = 64;     // query rows per block: one warpgroup (wgmma M)
constexpr int kTcKeys = 128;    // keys per tile (wgmma N of S = Q.K^T)
constexpr int kTcStages = 2;    // K/V ring depth
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kSeed2 = kNegInf * kLog2e;  // the running-max seed in log2 units

// Shared memory of one block, in bytes from a 1024-byte aligned base. Each
// tile is held as boxes of 64 head-dim elements (128 bytes a row, the
// 128-byte swizzle's width): DP / 64 boxes for a head dim padded to DP.
template <int DP>
struct TcLayout {
  static constexpr int kBoxes = DP / 64;
  static constexpr int kQBox = kTcRows * 128;
  static constexpr int kKVBox = kTcKeys * 128;
  static constexpr int kKVBytes = kKVBox * kBoxes;              // one K or V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQBox * kBoxes;                     // + stage * kKVBytes
  static constexpr int kV = kK + kTcStages * kKVBytes;
  static constexpr int kBias = kV + kTcStages * kKVBytes;       // float [stage][key]
  static constexpr int kBars = kBias + kTcStages * kTcKeys * 4;  // full[], empty[], q
  static constexpr int kBytes = kBars + (2 * kTcStages + 1) * 8;
  static constexpr int kDynamic = kBytes + 1024;                // + alignment slack
};

template <typename T> struct Tc;
template <> struct Tc<__nv_bfloat16> {
  static constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  __device__ static void qk(float* d, uint64_t a, uint64_t b, int acc) {
    sm90::wgmma_ss_m64n128k16_bf16(d, a, b, acc);
  }
  template <int DP>
  __device__ static void pv(float* d, const uint32_t* a, uint64_t b) {
    if constexpr (DP == 64) sm90::wgmma_rs_m64n64k16_bf16(d, a, b, 1);
    else sm90::wgmma_rs_m64n128k16_bf16(d, a, b, 1);
  }
  __device__ static uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};
template <> struct Tc<__half> {
  static constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  __device__ static void qk(float* d, uint64_t a, uint64_t b, int acc) {
    sm90::wgmma_ss_m64n128k16_f16(d, a, b, acc);
  }
  template <int DP>
  __device__ static void pv(float* d, const uint32_t* a, uint64_t b) {
    if constexpr (DP == 64) sm90::wgmma_rs_m64n64k16_f16(d, a, b, 1);
    else sm90::wgmma_rs_m64n128k16_f16(d, a, b, 1);
  }
  __device__ static uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Blocks resident on one SM at a time: three at DP = 64 (ptxas holds the
// registers to 128 a thread, no spill; 75.8 KB of shared memory each), one
// at DP = 128 (181 registers, 149.5 KB).
template <int DP>
constexpr int kTcBlocksPerSm = DP == 64 ? 3 : 1;

// DP: head dim padded to 64 or 128. Threads: one consumer warpgroup (64
// query rows), then one producer warp.
template <typename T, int DP, bool kStats>
__global__ void __launch_bounds__(160, kTcBlocksPerSm<DP>)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map, const float* __restrict__ bias,
                void* __restrict__ o, float* __restrict__ m_out, float* __restrict__ l_out,
                int sq, int sk, int heads, int dim, long long bias_sb, float scale_log2) {
  using L = TcLayout<DP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_addr(smem_raw);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  uint8_t* smem = smem_raw + pad;
  const uint32_t base = raw + pad;
  float* bias_tiles = reinterpret_cast<float*>(smem + L::kBias);
  const uint32_t full_bar = base + L::kBars;                // + 8 * stage
  const uint32_t empty_bar = full_bar + 8 * kTcStages;      // + 8 * stage
  const uint32_t q_bar = empty_bar + 8 * kTcStages;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * kTcRows;
  const int n_tiles = (sk + kTcKeys - 1) / kTcKeys;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      sm90::mbar_init(full_bar + 8 * s, 32);        // the producer warp's lanes
      sm90::mbar_init(empty_bar + 8 * s, 4);  // one per consumer warp
    }
    sm90::mbar_init(q_bar, 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4) {
    // Producer warp: Q once, then K, V and the bias tile per stage.
    if (lane == 0) {
      sm90::mbar_arrive_expect_tx(q_bar, L::kQBox * L::kBoxes);
#pragma unroll
      for (int x = 0; x < L::kBoxes; ++x) {
        sm90::tma_load_4d(base + L::kQ + x * L::kQBox, &q_map, q_bar, x * 64, h, q0, b);
      }
    }
    for (int t = 0; t < n_tiles; ++t) {
      const int stage = t % kTcStages;
      const int k0 = t * kTcKeys;
      sm90::mbar_wait(empty_bar + 8 * stage, ((t / kTcStages) & 1) ^ 1);
      const uint32_t full = full_bar + 8 * stage;
      if (lane == 0) {
        sm90::mbar_expect_tx(full, 2 * L::kKVBytes);
#pragma unroll
        for (int x = 0; x < L::kBoxes; ++x) {
          const uint32_t off = stage * L::kKVBytes + x * L::kKVBox;
          sm90::tma_load_4d(base + L::kK + off, &k_map, full, x * 64, h, k0, b);
          sm90::tma_load_4d(base + L::kV + off, &v_map, full, x * 64, h, k0, b);
        }
      }
      float* tile = bias_tiles + stage * kTcKeys;
      for (int j = lane; j < kTcKeys; j += 32) {
        const int key = k0 + j;
        tile[j] = key >= sk ? -CUDART_INF_F
                            : (bias != nullptr ? bias[b * bias_sb + key] * kLog2e : 0.f);
      }
      sm90::mbar_arrive(full);  // releases this lane's bias writes
    }
    return;
  }

  // The consumer warpgroup: query rows q0 .. q0 + 63, 16 per warp. In the
  // wgmma accumulator layout this thread holds rows r and r + 8 and, in
  // each 8-column chunk j, columns 8 j + c and 8 j + c + 1.
  const int r = q0 + warp * 16 + lane / 4;
  const int c = 2 * (lane % 4);
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float s[kTcKeys / 2];
  float m[2] = {kSeed2, kSeed2};  // running max, log2 units
  float l[2] = {0.f, 0.f};        // this thread's share of the normalizer
  const uint32_t q_tile = base + L::kQ;

  sm90::mbar_wait(q_bar, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t % kTcStages;
    sm90::mbar_wait(full_bar + 8 * stage, (t / kTcStages) & 1);
    const uint32_t k_tile = base + L::kK + stage * L::kKVBytes;
    const uint32_t v_tile = base + L::kV + stage * L::kKVBytes;

    // S = Q.K^T: K-major operands; a 16-deep step advances 32 bytes inside
    // the 128-byte swizzle row, a box of 64 moves to the next region.
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      Tc<T>::qk(s, sm90::desc_sw128(q_tile + (kk / 4) * L::kQBox + off, 16, 1024),
                sm90::desc_sw128(k_tile + (kk / 4) * L::kKVBox + off, 16, 1024), kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(s);

    // Online softmax in log2 units: x = s * scale * log2 e + bias * log2 e.
    const float* bias_tile = bias_tiles + stage * kTcKeys;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kTcKeys / 8; ++j) {
      const float2 bb = *reinterpret_cast<const float2*>(bias_tile + 8 * j + c);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float& x0 = s[4 * j + 2 * half];
        float& x1 = s[4 * j + 2 * half + 1];
        x0 = fmaf(x0, scale_log2, bb.x);
        x1 = fmaf(x1, scale_log2, bb.y);
        mx[half] = fmaxf(mx[half], fmaxf(x0, x1));
      }
    }
    uint32_t p[kTcKeys / 4];  // P rounded to T, two per register
    float alpha[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 2));
      alpha[half] = exp2_approx(m[half] - mx[half]);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kTcKeys / 8; ++j) {
        const float p0 = exp2_approx(s[4 * j + 2 * half] - mx[half]);  // 0 for -inf
        const float p1 = exp2_approx(s[4 * j + 2 * half + 1] - mx[half]);
        sum += p0 + p1;  // l from the f32 probabilities
        p[2 * j + half] = Tc<T>::pack(p0, p1);
      }
      l[half] = l[half] * alpha[half] + sum;
    }
    if (mx[0] != m[0] || mx[1] != m[1]) {  // a row's max moved: rescale
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        acc[4 * j] *= alpha[0];
        acc[4 * j + 1] *= alpha[0];
        acc[4 * j + 2] *= alpha[1];
        acc[4 * j + 3] *= alpha[1];
      }
    }
    m[0] = mx[0];
    m[1] = mx[1];

    // O += P.V: P's registers for keys 16 kk .. 16 kk + 15 are p[4 kk ..
    // 4 kk + 3]; V is MN-major, 8 keys (1024 bytes) per core-matrix row,
    // the second head-dim box one tile further on.
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcKeys / 16; ++kk) {
      Tc<T>::template pv<DP>(acc, p + 4 * kk,
                             sm90::desc_sw128(v_tile + kk * 16 * 128, L::kKVBox, 1024));
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(acc);
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(empty_bar + 8 * stage);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 1);
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 2);
    const int row = r + 8 * half;
    if (row >= sq) continue;  // rows past Sq store nothing
    const long long row_idx = (static_cast<long long>(b) * sq + row) * heads + h;
    if constexpr (kStats) {
      float* orow = static_cast<float*>(o) + row_idx * dim;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        if (8 * j + c < dim) {
          *reinterpret_cast<float2*>(orow + 8 * j + c) =
              make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
        }
      }
      if (lane % 4 == 0) {  // a row whose max never left the seed saw no finite score
        m_out[row_idx] = m[half] <= kSeed2 ? kNegInf : m[half] * kLn2;
        l_out[row_idx] = l[half];
      }
    } else {
      T* orow = static_cast<T*>(o) + row_idx * dim;
      const float inv = 1.f / l[half];
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        if (8 * j + c < dim) {
          *reinterpret_cast<uint32_t*>(orow + 8 * j + c) =
              Tc<T>::pack(acc[4 * j + 2 * half] * inv, acc[4 * j + 2 * half + 1] * inv);
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no -lcuda.
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A 4-D map over (D, H, S, B) of a 16-bit tensor, boxes of (64, 1, rows,
// 1), 128-byte swizzle, zero fill outside the tensor. A dimension of extent
// 1 gets a dense stride: its stride is never used and may be anything.
bool make_map(CUtensorMap* map, CUtensorMapDataType type, const void* ptr, int batch, int seq,
              int heads, int dim, Strides st, int rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t sh = heads > 1 ? st.h * 2 : dim * 2;
  const cuuint64_t ss = seq > 1 ? st.s * 2 : sh * heads;
  const cuuint64_t sb = batch > 1 ? st.b * 2 : ss * seq;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dim), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {sh, ss, sb};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, type, 4, const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tensor-core kernel's head dim for a call: padded to 64 or 128.
int tc_dim(int dim) { return dim <= 64 ? 64 : 128; }

int tc_smem_bytes(int dim) {
  return tc_dim(dim) == 64 ? TcLayout<64>::kDynamic : TcLayout<128>::kDynamic;
}

template <typename T, int DP, bool kStats>
cudaError_t launch_tc_kernel(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
                             const float* bias, void* o, float* m_out, float* l_out, int batch,
                             int sq, int sk, int heads, int dim, long long bias_sb, float scale,
                             cudaStream_t stream) {
  auto kernel = flash_fwd_wgmma<T, DP, kStats>;
  constexpr int smem = TcLayout<DP>::kDynamic;
  // The shared-memory opt-in is set once per device and instantiation.
  static std::atomic<uint64_t> opted_in{0};
  const int device = [] { int d = 0; cudaGetDevice(&d); return d; }();
  const uint64_t bit = device < 64 ? 1ull << device : 0;
  if (bit == 0 || !(opted_in.load(std::memory_order_relaxed) & bit)) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    opted_in.fetch_or(bit, std::memory_order_relaxed);
  }
  const dim3 grid((sq + kTcRows - 1) / kTcRows, heads, batch);
  kernel<<<grid, 160, smem, stream>>>(qm, km, vm, bias, o, m_out, l_out, sq, sk, heads, dim,
                                      bias_sb, scale * kLog2e);
  return cudaGetLastError();
}

template <typename T, bool kStats>
cudaError_t launch_tc(const void* q, const void* k, const void* v, const float* bias, void* o,
                      float* m_out, float* l_out, int batch, int sq, int sk, int heads, int dim,
                      Strides qs, Strides ks, Strides vs, long long bias_sb, float scale,
                      cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, Tc<T>::kMapType, q, batch, sq, heads, dim, qs, kTcRows) ||
      !make_map(&km, Tc<T>::kMapType, k, batch, sk, heads, dim, ks, kTcKeys) ||
      !make_map(&vm, Tc<T>::kMapType, v, batch, sk, heads, dim, vs, kTcKeys)) {
    return cudaErrorInvalidValue;
  }
  if (tc_dim(dim) == 64) {
    return launch_tc_kernel<T, 64, kStats>(qm, km, vm, bias, o, m_out, l_out, batch, sq, sk,
                                           heads, dim, bias_sb, scale, stream);
  }
  return launch_tc_kernel<T, 128, kStats>(qm, km, vm, bias, o, m_out, l_out, batch, sq, sk,
                                          heads, dim, bias_sb, scale, stream);
}

// -- float32: the CUDA-core kernel ----------------------------------------------

void launch_f32(const void* q, const void* k, const void* v, const float* bias, void* o,
                float* m_out, float* l_out, bool stats, int batch, int sq, int sk, int heads,
                int dim, Strides qs, Strides ks, Strides vs, long long bias_sb, float scale,
                cudaStream_t stream) {
  const dim3 grid((sq + kRowsPerBlock - 1) / kRowsPerBlock, heads, batch);
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
#define TPUSERVE_F32_LAUNCH(TPR)                                                        \
  if (stats) {                                                                          \
    flash_fwd_kernel<float, TPR, true><<<grid, kRowsPerBlock * TPR, 0, stream>>>(       \
        qt, kt, vt, bias, o, m_out, l_out, sq, sk, heads, dim, qs, ks, vs, bias_sb, scale); \
  } else {                                                                              \
    flash_fwd_kernel<float, TPR, false><<<grid, kRowsPerBlock * TPR, 0, stream>>>(      \
        qt, kt, vt, bias, o, m_out, l_out, sq, sk, heads, dim, qs, ks, vs, bias_sb, scale); \
  }
  if (dim <= 32) {
    TPUSERVE_F32_LAUNCH(1)
  } else if (dim <= 64) {
    TPUSERVE_F32_LAUNCH(2)
  } else {
    TPUSERVE_F32_LAUNCH(4)
  }
#undef TPUSERVE_F32_LAUNCH
}

template <bool kStats>
int launch_checked(const void* q, const void* k, const void* v, const void* bias,
                   void* o, float* m_out, float* l_out, int batch, int sq, int sk,
                   int heads, int dim, long long q_sb, long long q_ss, long long q_sh,
                   long long k_sb, long long k_ss, long long k_sh, long long v_sb,
                   long long v_ss, long long v_sh, long long bias_sb, float scale,
                   int dtype, int device, void* stream) {
  if (dim <= 0 || dim > 128 || dim % 8 != 0 || batch <= 0 || sq <= 0 ||
      sk <= 0 || heads <= 0 || heads > 65535 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides qs{q_sb, q_ss, q_sh};
  const Strides ks{k_sb, k_ss, k_sh};
  const Strides vs{v_sb, v_ss, v_sh};
  const float* b = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      launch_f32(q, k, v, b, o, m_out, l_out, kStats, batch, sq, sk, heads, dim, qs, ks, vs,
                 bias_sb, scale, s);
      return static_cast<int>(cudaGetLastError());
    case 1:
      return static_cast<int>(launch_tc<__nv_bfloat16, kStats>(
          q, k, v, b, o, m_out, l_out, batch, sq, sk, heads, dim, qs, ks, vs, bias_sb, scale, s));
    case 2:
      return static_cast<int>(launch_tc<__half, kStats>(
          q, k, v, b, o, m_out, l_out, batch, sq, sk, heads, dim, qs, ks, vs, bias_sb, scale, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launches K1 on `stream` and returns the launch's cudaError_t (0 = the
// kernel was accepted). dtype: 0 float32, 1 bfloat16, 2 float16. The grid
// is (ceil(Sq / rows), H, B), so H and B must each stay below 65536. For
// bfloat16 and float16, q, k and v need 16-byte aligned bases and strides
// that are multiples of 16 bytes (the TMA's rule); the wrapper checks it.
extern "C" int tpuserve_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* bias, void* o,
    int batch, int sq, int sk, int heads, int dim,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long bias_sb, float scale, int dtype, int device, void* stream) {
  return launch_checked<false>(q, k, v, bias, o, nullptr, nullptr, batch, sq, sk, heads, dim,
                               q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, bias_sb,
                               scale, dtype, device, stream);
}

// Launches K2 on `stream`, as tpuserve_flash_attention_fwd launches K1:
// acc is a contiguous float32 (B, Sq, H, D) tensor, m and l contiguous
// float32 (B, Sq, H) tensors.
extern "C" int tpuserve_flash_attention_stats_fwd(
    const void* q, const void* k, const void* v, const void* bias, void* acc,
    void* m, void* l, int batch, int sq, int sk, int heads, int dim,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long bias_sb, float scale, int dtype, int device, void* stream) {
  return launch_checked<true>(q, k, v, bias, acc, static_cast<float*>(m),
                              static_cast<float*>(l), batch, sq, sk, heads, dim, q_sb, q_ss,
                              q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, bias_sb, scale, dtype,
                              device, stream);
}

// The dynamic shared memory, in bytes, of the kernel instantiation that a
// call with this dtype and head dim launches; 0 for float32, whose kernel
// uses 32 KB of static shared memory.
extern "C" int tpuserve_flash_attention_smem_bytes(int dtype, int dim) {
  if (dtype == 0 || dim <= 0 || dim > 128) return 0;
  return tc_smem_bytes(dim);
}
