// Flash attention forward for Hopper (sm_90a), bf16 or f32 inputs.
//
// Replaces: tpu_dra/parallel/flash.py::flash_attention, whose forward
// _flash_forward runs the pl.pallas_call of _flash_fwd_kernel.  Its
// backward is not a kernel in the reference either: the port's autograd
// Function differentiates the reference attention (parallel/ring.py).
//
// What it computes: softmax attention of q (B, S, H, D) against k, v of
// the same shape, causal or not, with the online softmax.  Arithmetic is
// the reference's: q widened to f32 and multiplied by an f32 1/sqrt(D);
// f32 scores; running max m, denominator l and numerator acc in f32; p
// kept in f32 for the V product (no bf16 rounding of p, unlike the dense
// path); out = acc / max(l, 1e-30) cast to the input type once.  Masked
// scores are excluded exactly (p = 0), and key tiles wholly in a query
// tile's future are never loaded, as the reference's @pl.when(live)
// skips them.
//
// Layout: q, k and v may be strided views of the (B, S, 3, H, D) qkv
// product.  The kernel takes each one's batch and sequence strides (in
// elements); head and feature dimensions are contiguous (the wrapper
// checks).  The output is contiguous (B, S, H, D).
//
// What bounds it on an H100: at the trainer's shapes (16, 1024, 32, 128)
// bf16 it must read q, k and v and write o, 536.9 MB, which takes about
// 160 us at 3.35 TB/s.  The causal products are 2*B*H*S^2*D = 1.37e11
// flops, about 139 us at the 989 TFLOP/s bf16 tensor-core peak.  So the
// bound is about 160 us, set by the bytes.
//
// What the design does, and why it stays far above that bound:
// - One thread block owns one (batch*head, 64-row query tile) and walks
//   the key tiles up to the causal diagonal itself, with m, l and acc in
//   registers.  Hopper's blocks run in no order, so nothing is carried
//   across blocks (the TPU grid carried them in VMEM scratch from one
//   sequential step to the next).  The longest walks (last query tiles)
//   are scheduled first.
// - Products run in f32 on the CUDA cores, which is what the CPU tests
//   hold: the reference's interpret mode computes its f32 dots in full
//   f32.  Each thread owns a 4 x 4 tile of scores and 4 rows x D/16
//   columns of acc, fed by 16-byte shared-memory reads; Q and K sit in
//   shared memory transposed so that those reads are conflict-free.
// - The f32 CUDA-core peak is 67 TFLOP/s, so this first version is tens
//   of times above the bound.  It is kept for exact parity first: bf16
//   tensor cores (wgmma or mma.sync), TMA and a pipelined ring of tiles
//   are the next step, once their rounding is held to the tolerance.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // keys per tile
constexpr int kThreads = 256;   // 16 x 16: thread (ty, tx) owns rows ty*4.. and key columns tx*4..
constexpr int kPQ = kBQ + 4;    // padded row of the transposed probability tile

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float out[8]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float out[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

template <int D>
constexpr size_t smem_floats() {
  // Qt [D][kBQ]; Kt [D][kBK], which the probability tile Pt [kBK][kPQ]
  // reuses once the scores are in registers; Vs [kBK][D].
  return (size_t)D * kBQ + (D * kBK > kBK * kPQ ? D * kBK : kBK * kPQ) + (size_t)kBK * D;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int S, int H,
                 long long q_sb, long long q_ss, long long k_sb, long long k_ss,
                 long long v_sb, long long v_ss, int causal, float scale) {
  static_assert(D % 64 == 0, "each thread owns D/64 float4 columns of acc");
  constexpr int kChunks = D / 8;  // 8-value loads per row
  constexpr int kCols = D / 16;   // acc columns per thread
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);
  float* Kt = Qt + D * kBQ;
  float* Pt = Kt;
  float* Vs = Kt + (D * kBK > kBK * kPQ ? D * kBK : kBK * kPQ);

  const int n_qt = (S + kBQ - 1) / kBQ;
  const int BH = gridDim.x / n_qt;
  const int bh = blockIdx.x % BH;
  const int qt = n_qt - 1 - blockIdx.x / BH;
  const int b = bh / H, h = bh % H;
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const T* qb = q + b * q_sb + (long long)h * D;
  const T* kb = k + b * k_sb + (long long)h * D;
  const T* vb = v + b * v_sb + (long long)h * D;

  for (int idx = tid; idx < kBQ * kChunks; idx += kThreads) {
    const int r = idx % kBQ, c = idx / kBQ;
    float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (q0 + r < S) load8(qb + (q0 + r) * q_ss + c * 8, x);
#pragma unroll
    for (int i = 0; i < 8; ++i) Qt[(c * 8 + i) * kBQ + r] = x[i] * scale;
  }

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  // Key tiles that hold a key visible to some row of this query tile.
  const int kv_end = causal ? min(S, q0 + kBQ) : S;
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the previous tile's Pt and Vs are read
    for (int idx = tid; idx < kBK * kChunks; idx += kThreads) {
      const int r = idx % kBK, c = idx / kBK;
      float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (k0 + r < S) load8(kb + (k0 + r) * k_ss + c * 8, x);
#pragma unroll
      for (int i = 0; i < 8; ++i) Kt[(c * 8 + i) * kBK + r] = x[i];
    }
    for (int idx = tid; idx < kBK * kChunks; idx += kThreads) {
      const int c = idx % kChunks, r = idx / kChunks;
      float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (k0 + r < S) load8(vb + (k0 + r) * v_ss + c * 8, x);
      float4* dst = reinterpret_cast<float4*>(Vs + r * D + c * 8);
      dst[0] = make_float4(x[0], x[1], x[2], x[3]);
      dst[1] = make_float4(x[4], x[5], x[6], x[7]);
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < D; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(Qt + kk * kBQ + ty * 4);
      const float4 c = *reinterpret_cast<const float4*>(Kt + kk * kBK + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

    // Online softmax over this tile.  The 16 threads that share rows are
    // one half-warp, so the row reductions are xor shuffles within it.
    // Key 0 is visible to every row, so m is finite after the first tile
    // and a masked score (-inf) gives p = exp(-inf) = 0 exactly.
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx * 4 + j;
        const bool vis = key < S && (!causal || key <= row);
        s[i][j] = vis ? s[i][j] : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        ps += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = l[i] * alpha[i] + ps;
    }

    __syncthreads();  // every thread is done with Kt before Pt overwrites it
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(Pt + (tx * 4 + j) * kPQ + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha[i];
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(Pt + j * kPQ + ty * 4);
      const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int u = 0; u < D / 64; ++u) {
        const float4 w = *reinterpret_cast<const float4*>(Vs + j * D + u * 64 + tx * 4);
        const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            acc[i][u * 4 + jj] = fmaf(pv[i], wv[jj], acc[i][u * 4 + jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* o = out + (((long long)b * S + row) * H + h) * D;
#pragma unroll
    for (int u = 0; u < D / 64; ++u)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) store(o + u * 64 + tx * 4 + jj, acc[i][u * 4 + jj] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int H,
           long long q_sb, long long q_ss, long long k_sb, long long k_ss, long long v_sb,
           long long v_ss, int causal, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int n_qt = (S + kBQ - 1) / kBQ;
  flash_fwd_kernel<T, D><<<n_qt * B * H, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, S, H, q_sb, q_ss, k_sb, k_ss, v_sb,
      v_ss, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a head width the kernel does not take.  The
// wrapper has checked shapes, dtypes, strides and 16-byte alignment.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* out, int B,
                        int S, int H, int D, long long q_sb, long long q_ss,
                        long long k_sb, long long k_ss, long long v_sb, long long v_ss,
                        int causal, int is_bf16, float scale, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, out, B, S, H, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, causal, scale, st);
  if (is_bf16 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, out, B, S, H, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, causal, scale, st);
  if (!is_bf16 && D == 64)
    return launch<float, 64>(q, k, v, out, B, S, H, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, causal, scale, st);
  if (!is_bf16 && D == 128)
    return launch<float, 128>(q, k, v, out, B, S, H, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
