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
// step of ring attention: the same recurrence (the kernel template with
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
// 8 up to 128.
//
// Design. One thread block per (query tile of 64 rows, head, batch). TPR
// threads share one query row (TPR = 1, 2, 4 for D <= 32, 64, 128): each
// holds every TPR-th element of q and of the accumulator in registers, and
// a butterfly of warp shuffles sums the partial dot products. A loop over
// key tiles takes the place of the TPU grid's sequential k axis: the block
// stages a tile of K, V and the bias in shared memory as float32 (32 KB)
// and each row scores it 8 keys per online-softmax update. Keys past Sk
// are absent: a ragged tile is zero-filled and its scores are forced to
// -inf (the running max starts at -1e30), so they add nothing to m, l or
// the accumulator, even in a row whose present keys all carry a -inf bias.
// Fully masked rows keep the reference's semantics: the -1e9 bias is added
// like any other score and no tile is skipped, so a row whose keys are all
// padding gets the same finite average of V as the reference, never 0/0.
//
// What bounds it. At the BERT-base serving shapes (B up to 32, S 64 or 128,
// H 12, D 64, bf16) the work is 4*B*H*Sq*Sk*D operations against
// 2*B*H*(2*Sq+2*Sk)*D bytes of q/k/v/o: S/2 = 64 operations per byte at
// S = 128, below the ~295 at which the H100's bf16 tensor cores, rather
// than its 3.35 TB/s memory, become the limit. So the least time for the
// function is set by its bytes. The design moves each byte of q and o once
// and keeps the score matrix out of device memory: scores, probabilities
// and the accumulator live in registers and K/V tiles in shared memory,
// and a second query tile rereads K/V from L2, not from HBM. The products
// themselves run on the CUDA cores in float32 FMA, whose ~67 TFLOP/s is
// what limits this first version in practice; moving them to the tensor
// cores (mma.sync or wgmma, with TMA loads) is the next step.
//
// K2 on ring attention's long-context path (B 8, S 2048, H 12, D 64, bf16)
// does 4*B*H*S^2*D = 103 GFLOP on 127.5 MB (q, k, v in bf16; acc, m, l in
// float32): 809 operations per byte, so there the tensor cores' rate, not
// the memory, sets the least time, and the float32 FMA loop sits further
// from it than at BERT's short shapes.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kRowsPerBlock = 64;   // query rows per thread block
constexpr int kKeysPerStep = 8;     // keys scored per online-softmax update
constexpr int kDimsPerThread = 32;  // head-dim elements held by one thread
constexpr float kNegInf = -1e30f;   // running-max seed (the reference's NEG_INF)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}

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

template <typename T, bool kStats>
void launch(const void* q, const void* k, const void* v, const float* bias,
            void* o, float* m_out, float* l_out, int batch, int sq, int sk,
            int heads, int dim, Strides qs, Strides ks, Strides vs,
            long long bias_sb, float scale, cudaStream_t stream) {
  const dim3 grid((sq + kRowsPerBlock - 1) / kRowsPerBlock, heads, batch);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  if (dim <= 32) {
    flash_fwd_kernel<T, 1, kStats><<<grid, kRowsPerBlock * 1, 0, stream>>>(
        qt, kt, vt, bias, o, m_out, l_out, sq, sk, heads, dim, qs, ks, vs, bias_sb, scale);
  } else if (dim <= 64) {
    flash_fwd_kernel<T, 2, kStats><<<grid, kRowsPerBlock * 2, 0, stream>>>(
        qt, kt, vt, bias, o, m_out, l_out, sq, sk, heads, dim, qs, ks, vs, bias_sb, scale);
  } else {
    flash_fwd_kernel<T, 4, kStats><<<grid, kRowsPerBlock * 4, 0, stream>>>(
        qt, kt, vt, bias, o, m_out, l_out, sq, sk, heads, dim, qs, ks, vs, bias_sb, scale);
  }
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
      launch<float, kStats>(q, k, v, b, o, m_out, l_out, batch, sq, sk, heads, dim, qs, ks,
                            vs, bias_sb, scale, s);
      break;
    case 1:
      launch<__nv_bfloat16, kStats>(q, k, v, b, o, m_out, l_out, batch, sq, sk, heads, dim,
                                    qs, ks, vs, bias_sb, scale, s);
      break;
    case 2:
      launch<__half, kStats>(q, k, v, b, o, m_out, l_out, batch, sq, sk, heads, dim, qs, ks,
                             vs, bias_sb, scale, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches K1 on `stream` and returns the launch's cudaError_t (0 = the
// kernel was accepted). dtype: 0 float32, 1 bfloat16, 2 float16. The grid
// is (ceil(Sq / 64), H, B), so H and B must each stay below 65536.
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
