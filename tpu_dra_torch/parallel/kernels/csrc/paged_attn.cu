// Paged decode attention for Hopper (sm_90a), bf16 or int8 block pools.
//
// Replaces: tpu_dra/parallel/kernels/paged_attn.py::paged_attention, the
// two pl.pallas_call passes _paged_ml_kernel (softmax statistics) and
// _paged_att_kernel (the probability-weighted V sum).
//
// What it computes: one decode step's attention for B rows.  Row b's
// single query q[b] (H, K) attends positions j <= pos[b] of the context
// its block table names: position j lives in physical block
// table[b, j / W] at offset j % W of the pool (NB, W, H, K).  A pool is
// bf16, or int8 values (NB, W, H, K) with one f32 scale per (position,
// head), (NB, W, H, 1); an int8 element is read as bf16(f32(q) * s), the
// reference's _block_kv.  Rounding is the reference's, point for point:
//   score = bf16(dot_f32(q, k)); score = bf16(score / bf16(sqrt(K)));
//   widened to f32; masked positions contribute exactly zero;
//   l = max(sum exp(s - m), 1e-30); p = bf16(exp(s - m) / l);
//   out = bf16(sum_f32(p * v)).
//
// What bounds it on an H100: the bytes of K and V of the visible
// positions, read from device memory (3.35 TB/s): 4*K bytes a position
// and head in bf16, 2*(K + 4) in int8.  Each position costs 4*K flops
// against those bytes, three orders of magnitude below the card's
// flops-per-byte balance, so the tensor cores have nothing to do here.
//
// What the design does about it:
// - One thread block owns one (row, head) and walks that row's table
//   itself.  The TPU grid (B, NW) carried m/l/acc in scratch from one
//   sequential step to the next; Hopper's blocks run in no order, so the
//   loop over table columns moves inside the block and nothing is
//   carried across blocks: one launch, no second pass over the grid.
// - Each K and V row of the head (K values, contiguous) is read by K/8
//   neighbouring lanes, 8 values each; the dot product is reduced with
//   warp shuffles inside that lane group.
// - Every byte is read once.  The TPU kernel streams K twice (statistics
//   pass, then output pass) because nothing survives between its passes;
//   here the scores of the row's visible positions (4 bytes each) stay in
//   shared memory between the two passes, so pass 2 reads V only.
// - The walk stops at pos[b]: table columns past the row's last position
//   (scratch block 0, masked tails) are never read.
// - The two pool types differ only in the element load: the kernel is a
//   template on a loader, Bf16Pool (one 16-byte load of 8 values) or
//   Int8Pool (one 8-byte load of 8 values and the (position, head)'s
//   scale, a 4-byte load that the K/8 lanes of a position share).
// - A simple kernel: no TMA, no cp.async pipelining, no tensor cores.
//   At the engine's shapes the bf16 form runs at about 7x its bound and
//   the int8 form, as fast or a little slower, at about 14x its smaller
//   bound.  The blocks of the longest row set the time; giving each lane
//   8 positions' loads in flight was measured and gained nothing.
//   Splitting a long row's context across blocks (with the exact
//   two-phase softmax kept) is the next step; see PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;  // bf16 values per 16-byte load

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float out[kVec]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The two pool types.  load(elem, row, out) fills out with the 8 values
// at element offset elem; row = (block * W + offset) * H + head indexes
// the position's scale.
struct Bf16Pool {
  const __nv_bfloat16* data;
  __device__ __forceinline__ void load(size_t elem, size_t, float out[kVec]) const {
    load8(data + elem, out);
  }
};

struct Int8Pool {
  const int8_t* q;
  const float* s;
  __device__ __forceinline__ void load(size_t elem, size_t row, float out[kVec]) const {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(q + elem));
    const int8_t* v = reinterpret_cast<const int8_t*>(&raw);
    const float scale = __ldg(s + row);
#pragma unroll
    for (int i = 0; i < kVec; ++i) out[i] = round_bf16(static_cast<float>(v[i]) * scale);
  }
};

// Block-wide max or sum of one value per thread; every thread gets it.
template <bool kMax>
__device__ float block_reduce(float v, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = kMax ? fmaxf(v, o) : v + o;
  }
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) scratch[warp] = v;
  __syncthreads();
  float r = scratch[0];
  for (int w = 1; w < kWarps; ++w) r = kMax ? fmaxf(r, scratch[w]) : r + scratch[w];
  __syncthreads();  // scratch is reused by the next reduction
  return r;
}

// Grid: one block per (row, head), blockIdx.x = b * H + h.  Shared
// memory: span floats of scores, kWarps floats of reduction scratch,
// groups * K floats for the cross-group output sum.
template <class Pool>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const Pool k_pool,
                       const Pool v_pool,
                       const int32_t* __restrict__ table,
                       const int32_t* __restrict__ pos,
                       __nv_bfloat16* __restrict__ out,
                       int H, int K, int W, int NW, float sqrt_d) {
  extern __shared__ float smem[];
  const int span = NW * W;
  float* scores = smem;
  float* scratch = smem + span;
  float* partial = scratch + kWarps;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int lanes = K / kVec;          // lanes sharing one position
  const int groups = kThreads / lanes; // positions in flight per sweep
  const int g = threadIdx.x / lanes;
  const int c = threadIdx.x % lanes;   // this lane's 8-value chunk of K
  const int n_vis = min(pos[b] + 1, span);  // <= 0: nothing visible
  const int32_t* trow = table + (size_t)b * NW;
  const size_t row_stride = (size_t)H * K;       // between offsets in a block
  const size_t blk_stride = (size_t)W * row_stride;
  const size_t head_off = (size_t)h * K + (size_t)c * kVec;

  float qf[kVec];
  load8(q + ((size_t)b * H + h) * K + (size_t)c * kVec, qf);

  // Pass 1: every visible score, once, into shared memory; the max.  The
  // sweep bound is uniform across the block so that all lanes of a warp
  // take part in the shuffles.
  float m = -INFINITY;
  for (int t0 = 0; t0 < n_vis; t0 += groups) {
    const int t = t0 + g;
    float dot = 0.f;
    if (t < n_vis) {
      const int blk = trow[t / W];
      float kf[kVec];
      k_pool.load(blk * blk_stride + (size_t)(t % W) * row_stride + head_off,
                  ((size_t)blk * W + t % W) * H + h, kf);
#pragma unroll
      for (int i = 0; i < kVec; ++i) dot = fmaf(qf[i], kf[i], dot);
    }
    for (int off = lanes / 2; off > 0; off >>= 1) {
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
    }
    if (t < n_vis) {
      const float s = round_bf16(round_bf16(dot) / sqrt_d);
      m = fmaxf(m, s);
      if (c == 0) scores[t] = s;
    }
  }
  m = block_reduce<true>(m, scratch);  // also orders the score writes

  float l = 0.f;
  for (int t = threadIdx.x; t < n_vis; t += kThreads) l += expf(scores[t] - m);
  l = fmaxf(block_reduce<false>(l, scratch), 1e-30f);

  // Pass 2: bf16-rounded probabilities against V, f32 sums per group.
  float acc[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) acc[i] = 0.f;
  for (int t = g; t < n_vis; t += groups) {
    const float p = round_bf16(expf(scores[t] - m) / l);
    const int blk = trow[t / W];
    float vf[kVec];
    v_pool.load(blk * blk_stride + (size_t)(t % W) * row_stride + head_off,
                ((size_t)blk * W + t % W) * H + h, vf);
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[i] = fmaf(p, vf[i], acc[i]);
  }
#pragma unroll
  for (int i = 0; i < kVec; ++i) partial[g * K + c * kVec + i] = acc[i];
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += kThreads) {
    float sum = 0.f;
    for (int gg = 0; gg < groups; ++gg) sum += partial[gg * K + k];
    out[((size_t)b * H + h) * K + k] = __float2bfloat16_rn(sum);
  }
}

// Shared memory one block needs, in bytes.
size_t smem_bytes(int K, int W, int NW) {
  const int groups = kThreads / (K / kVec);
  return sizeof(float) * ((size_t)NW * W + kWarps + (size_t)groups * K);
}

template <class Pool>
int launch(const void* q, Pool k_pool, Pool v_pool, const void* table, const void* pos,
           void* out, int B, int H, int K, int W, int NW, float sqrt_d, void* stream) {
  const size_t smem = smem_bytes(K, W, NW);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<Pool>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  paged_attention_kernel<Pool><<<B * H, kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, k_pool, v_pool, (const int32_t*)table,
      (const int32_t*)pos, (__nv_bfloat16*)out, H, K, W, NW, sqrt_d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory the launch needs, in bytes, for either pool type (the
// wrapper checks it against the card's limit before launching).
size_t paged_attention_smem_bytes(int K, int W, int NW) { return smem_bytes(K, W, NW); }

// Launch on `stream`; return cudaGetLastError() (0 on success).  The
// wrapper has checked shapes, dtypes, contiguity and alignment: K is a
// multiple of 8 with K / 8 a power of two <= 32.
int paged_attention_bf16(const void* q, const void* k_pool, const void* v_pool,
                         const void* table, const void* pos, void* out,
                         int B, int H, int K, int W, int NW, float sqrt_d,
                         void* stream) {
  return launch(q, Bf16Pool{(const __nv_bfloat16*)k_pool},
                Bf16Pool{(const __nv_bfloat16*)v_pool}, table, pos, out,
                B, H, K, W, NW, sqrt_d, stream);
}

// The int8 pools: values (NB, W, H, K) int8 and scales (NB, W, H, 1) f32.
int paged_attention_int8(const void* q, const void* k_q, const void* k_s,
                         const void* v_q, const void* v_s, const void* table,
                         const void* pos, void* out, int B, int H, int K, int W,
                         int NW, float sqrt_d, void* stream) {
  return launch(q, Int8Pool{(const int8_t*)k_q, (const float*)k_s},
                Int8Pool{(const int8_t*)v_q, (const float*)v_s}, table, pos, out,
                B, H, K, W, NW, sqrt_d, stream);
}

}  // extern "C"
