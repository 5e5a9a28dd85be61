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
// What held the first design (one block per (row, head)) far above that
// bound was latency: the longest row's 640 positions were walked in 40
// sweeps, each a table load and then a dependent pool load, and then V
// the same way, so the 32 blocks of the longest row set the time.
//
// The design:
// - Each (row, head group) is one thread-block cluster of kCluster = 8
//   blocks (the portable cluster size).  Block c of a cluster takes the
//   c-th contiguous chunk of the row's n_vis = min(pos + 1, NW * W)
//   visible positions, so a long row is walked by 8 blocks at once.  The
//   TPU grid (B, NW) carried m/l/acc in scratch from one sequential step
//   to the next; here the blocks of a cluster run together and trade
//   their partial results through distributed shared memory.
// - A block takes up to 4 heads of its row (64 threads each) and holds at
//   most 51 registers a thread, so that 5 blocks fit an SM.  The card
//   holds only so many clusters of 8 at once (paged_attention_clusters
//   reports it; chip_smoke.py logs it), fewer than one cluster per (row,
//   head) at the engine's 8 rows x 32 heads: such a grid ran in waves,
//   each paying the fixed cost.  Head groups make it 64 clusters, one
//   wave.  Rows vary fastest in the launch order.
// - A block first writes the pool row of each position of its chunk into
//   shared memory (one table read per position, not one per lane), then
//   keeps kUnroll positions' loads in flight per lane group.  Each K and V
//   row of a head (K values, contiguous) is read by K/8 neighbouring
//   lanes, 8 values each, with a hint that L2 fetch the row's 256 bytes
//   at once; the dot product is reduced with warp shuffles inside the
//   lane group.  Work that is the same for every lane of a position (its
//   score's rounding, its probability) is done once per position.
// - Pass 1: the chunk's scores go to shared memory, with a local max m_c
//   and l_c = sum exp(s - m_c).  Each block stores its pair into every
//   block of the cluster (distributed shared memory), a cluster barrier,
//   and every block forms the row's exact m = max m_c and l = max(sum
//   l_c * exp(m_c - m), 1e-30) in rank order: the same bits everywhere.
//   An empty chunk (a short row, or n_vis <= 0) gives m_c = -inf and
//   l_c = 0 and adds nothing; it never forms -inf - (-inf).
// - Pass 2: p = bf16(exp(s - m) / l) against V with f32 sums over the
//   chunk: the reference's two-pass rounding, kept exact because its
//   one-pass variant flipped near-ties.  Each block stores its partial of
//   every output column into the block that writes that column, a cluster
//   barrier, and block c sums its K / 8 columns over the 8 partials in
//   rank order, rounds once to bf16 and writes.  No block reads another's
//   shared memory after the last barrier, so none waits at the end.
//   Every block, empty or not, takes part in every barrier; an arrive at
//   the start lets the first remote store know the cluster is running.
// - No float atomics: every sum has a fixed order, so the output is
//   bitwise the same from call to call (the poison checks compare it
//   bitwise).  Atomics would drop the output exchange and give up that
//   repeatability.
// - The walk stops at pos[b]: table columns past the row's last position
//   (scratch block 0, masked tails) are never read.
// - Shared memory is bounded by a chunk (ceil(NW * W / 8) positions), not
//   by the table's whole reach.
// - The two pool types differ only in the element load: the kernel is a
//   template on a loader, Bf16Pool (one 16-byte load of 8 values) or
//   Int8Pool (one 8-byte load of 8 values and the (position, head)'s
//   scale, a 4-byte load that the K/8 lanes of a position share).
// - What is left: about 14 us of the engine-shape time is fixed (launch,
//   the pos -> table -> pool chain, two cluster exchanges), measured with
//   every row at position 0; see PERF.md.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kHeadThreads = 64;  // threads on one head in a block
constexpr int kHeadWarps = kHeadThreads / 32;
constexpr int kMaxThreads = 256;  // up to 4 heads a block
constexpr int kVec = 8;           // bf16 values per 16-byte load
constexpr int kCluster = 8;       // blocks per (row, head group)
constexpr int kUnroll = 4;        // positions in flight per lane group
constexpr int kMinBlocks = 5;     // blocks an SM must hold: caps registers at 51

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The two pool types.  fetch(elem, row) loads the 8 values at element
// offset elem as stored (row = (block * W + offset) * H + head indexes the
// position's scale); widen(raw, out) turns them into f32, so that a lane
// can have several positions' loads in flight before it uses any.
struct Bf16Pool {
  using Raw = uint4;
  const __nv_bfloat16* data;
  __device__ __forceinline__ Raw fetch(size_t elem, size_t) const {
    // A head's row of a position is K contiguous values: have L2 fetch
    // 256 bytes at once.
    uint4 r;
    asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
                 : "l"(data + elem));
    return r;
  }
  __device__ __forceinline__ static void widen(const Raw& raw, float out[kVec]) {
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < kVec / 2; ++i) {
      const float2 f = __bfloat1622float2(h2[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

struct Int8Pool {
  struct Raw {
    uint2 q;
    float s;
  };
  const int8_t* q;
  const float* s;
  __device__ __forceinline__ Raw fetch(size_t elem, size_t row) const {
    return {__ldg(reinterpret_cast<const uint2*>(q + elem)), __ldg(s + row)};
  }
  // bf16(f32(q) * s) for each of the 8 values.  A byte x + 128 placed
  // under the exponent of 2^23 reads as 2^23 + x + 128, so one subtraction
  // gives f32(x) exactly without the slower integer conversion; the
  // products are rounded to bf16 two at a time.
  __device__ __forceinline__ static void widen(const Raw& raw, float out[kVec]) {
    const uint32_t words[2] = {raw.q.x ^ 0x80808080u, raw.q.y ^ 0x80808080u};
#pragma unroll
    for (int i = 0; i < kVec; i += 2) {
      const uint32_t w = words[i / 4];
      const float x0 = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 | (i % 4))) - 8388736.f;
      const float x1 =
          __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 | (i % 4 + 1))) - 8388736.f;
      const __nv_bfloat162 r = __floats2bfloat162_rn(x0 * raw.s, x1 * raw.s);
      const uint32_t bits = *reinterpret_cast<const uint32_t*>(&r);
      out[i] = __uint_as_float(bits << 16);
      out[i + 1] = __uint_as_float(bits & 0xFFFF0000u);
    }
  }
};

// Max or sum of one value per thread over one head's kHeadThreads threads
// (kHeadWarps warps); every thread of the head gets it.  Called by every
// thread of the block.
template <bool kMax>
__device__ float head_reduce(float v, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = kMax ? fmaxf(v, o) : v + o;
  }
  if ((threadIdx.x & 31) == 0) scratch[(threadIdx.x % kHeadThreads) / 32] = v;
  __syncthreads();
  float r = scratch[0];
  for (int w = 1; w < kHeadWarps; ++w) r = kMax ? fmaxf(r, scratch[w]) : r + scratch[w];
  __syncthreads();  // scratch is reused by the next reduction
  return r;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// Shared memory of one block, in 4-byte words: the pool row of each
// position of its chunk, then per head: the chunk's scores (then
// probabilities), the lane groups' output partials, every rank's (m_c,
// l_c), every rank's partial of this block's K / kCluster output columns,
// reduction scratch and the row's (m, l).
__host__ __device__ inline int chunk_cap(int W, int NW) {
  return (NW * W + kCluster - 1) / kCluster;
}
__host__ __device__ inline int head_words(int K, int W, int NW) {
  const int groups = kHeadThreads / (K / kVec);
  return chunk_cap(W, NW) + groups * K + 2 * kCluster + K + kHeadWarps + 2;
}

size_t smem_bytes(int heads, int K, int W, int NW) {
  return 4 * ((size_t)chunk_cap(W, NW) + (size_t)heads * head_words(K, W, NW));
}

// Grid (kCluster, B * H / heads), clusters of (kCluster, 1, 1), blocks of
// heads * kHeadThreads threads: blockIdx.y names the row and its group of
// `heads` heads (row fastest), blockIdx.x is the block's rank in its
// cluster.
template <class Pool>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
paged_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const Pool k_pool,
                       const Pool v_pool,
                       const int32_t* __restrict__ table,
                       const int32_t* __restrict__ pos,
                       __nv_bfloat16* __restrict__ out,
                       int H, int K, int W, int NW, float sqrt_d) {
  // Announce this block at once; the matching wait, just before the first
  // store into another block's shared memory, then knows every block of
  // the cluster has started.
  cluster_arrive();
  cg::cluster_group cluster = cg::this_cluster();
  const int heads = blockDim.x / kHeadThreads;
  const int hg = threadIdx.x / kHeadThreads;  // this thread's head within the block
  const int tid = threadIdx.x % kHeadThreads;
  const int lanes = K / kVec;                 // lanes sharing one position
  const int groups = kHeadThreads / lanes;    // positions per sweep of one unrolled step
  const int per = K / kCluster;               // output columns each rank writes

  extern __shared__ float smem[];
  int32_t* rows = reinterpret_cast<int32_t*>(smem);
  float* scores = smem + chunk_cap(W, NW) + hg * head_words(K, W, NW);
  float* partial = scores + chunk_cap(W, NW);
  float* stats = partial + groups * K;        // [rank][m_c, l_c]
  float* gather = stats + 2 * kCluster;       // [rank][per]
  float* scratch = gather + K;
  float* row_ml = scratch + kHeadWarps;       // the row's (m, l)

  const int rank = (int)cluster.block_rank();
  // Rows vary fastest along y, so that a long row's clusters are spread
  // over the launch order, and so over the card.
  const int B = gridDim.y / (H / heads);
  const int b = blockIdx.y % B;
  const int h = (blockIdx.y / B) * heads + hg;
  const int g = tid / lanes;
  const int c = tid % lanes;                  // this lane's 8-value chunk of K
  const int n_vis = max(0, min(pos[b] + 1, NW * W));
  const int chunk = (n_vis + kCluster - 1) / kCluster;
  const int lo = min(rank * chunk, n_vis);
  const int n_mine = min(lo + chunk, n_vis) - lo;  // positions lo .. lo + n_mine - 1
  const size_t row_stride = (size_t)H * K;    // between offsets in a block
  const size_t head_off = (size_t)h * K + (size_t)c * kVec;

  // The pool row (block * W + offset) of each position of the chunk, once
  // per position rather than once per lane.
  for (int t = threadIdx.x; t < n_mine; t += blockDim.x) {
    const int j = lo + t;
    rows[t] = table[(size_t)b * NW + j / W] * W + j % W;
  }
  float qf[kVec];
  const __nv_bfloat16* qrow = q + ((size_t)b * H + h) * K + (size_t)c * kVec;
  Bf16Pool::widen(__ldg(reinterpret_cast<const uint4*>(qrow)), qf);
  __syncthreads();

  // Pass 1: the chunk's dot products into shared memory.  The sweep bound
  // is uniform across the block, so all lanes of a warp take part in the
  // shuffles.
  for (int t0 = 0; t0 < n_mine; t0 += groups * kUnroll) {
    typename Pool::Raw kr[kUnroll] = {};
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + g + groups * u;
      if (t < n_mine) {
        const size_t r = rows[t];
        kr[u] = k_pool.fetch(r * row_stride + head_off, r * H + h);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + g + groups * u;
      float kf[kVec];
      Pool::widen(kr[u], kf);
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kVec; ++i) dot = fmaf(qf[i], kf[i], dot);
      for (int off = lanes / 2; off > 0; off >>= 1) {
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      }
      if (t < n_mine && c == 0) scores[t] = dot;
    }
  }
  __syncthreads();
  // The scores, one thread a position, and their max.
  float m = -INFINITY;
  for (int t = tid; t < n_mine; t += kHeadThreads) {
    const float s = round_bf16(round_bf16(scores[t]) / sqrt_d);
    scores[t] = s;
    m = fmaxf(m, s);
  }
  m = head_reduce<true>(m, scratch);  // also orders the score writes
  float l = 0.f;
  for (int t = tid; t < n_mine; t += kHeadThreads) l += expf(scores[t] - m);
  l = head_reduce<false>(l, scratch);

  // Every rank's (m_c, l_c) into every block's stats[rank], then the row's
  // m and l from them in rank order, the same in every block.
  cluster_wait();  // every block of the cluster has started
  if (tid < kCluster) {
    float* remote = cluster.map_shared_rank(stats, tid);
    remote[2 * rank] = m;
    remote[2 * rank + 1] = l;
  }
  cluster_arrive();
  cluster_wait();
  if (tid < 32) {
    const float mc = tid < kCluster ? stats[2 * tid] : -INFINITY;
    const float lc = tid < kCluster ? stats[2 * tid + 1] : 0.f;
    float mr = mc;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mr = fmaxf(mr, __shfl_xor_sync(0xffffffffu, mr, off));
    const float term = lc > 0.f ? lc * expf(mc - mr) : 0.f;
    float lr = 0.f;
#pragma unroll
    for (int i = 0; i < kCluster; ++i) lr += __shfl_sync(0xffffffffu, term, i);
    if (tid == 0) {
      row_ml[0] = mr;
      row_ml[1] = fmaxf(lr, 1e-30f);
    }
  }
  __syncthreads();
  const float m_row = row_ml[0], l_row = row_ml[1];
  for (int t = tid; t < n_mine; t += kHeadThreads) {
    scores[t] = round_bf16(expf(scores[t] - m_row) / l_row);  // now the probability
  }
  __syncthreads();

  // Pass 2: bf16-rounded probabilities against V, f32 sums per lane group.
  float acc[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) acc[i] = 0.f;
  for (int t0 = 0; t0 < n_mine; t0 += groups * kUnroll) {
    typename Pool::Raw vr[kUnroll] = {};
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + g + groups * u;
      if (t < n_mine) {
        const size_t r = rows[t];
        vr[u] = v_pool.fetch(r * row_stride + head_off, r * H + h);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + g + groups * u;
      if (t < n_mine) {
        const float p = scores[t];
        float vf[kVec];
        Pool::widen(vr[u], vf);
#pragma unroll
        for (int i = 0; i < kVec; ++i) acc[i] = fmaf(p, vf[i], acc[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kVec; ++i) partial[g * K + c * kVec + i] = acc[i];
  __syncthreads();

  // This block's partial of column k goes to the block that writes k.
  for (int k = tid; k < K; k += kHeadThreads) {
    float sum = 0.f;
    for (int gg = 0; gg < groups; ++gg) sum += partial[gg * K + k];
    cluster.map_shared_rank(gather, k / per)[rank * per + k % per] = sum;
  }
  cluster_arrive();
  cluster_wait();  // no store into this block's shared memory comes later

  // This block's K / kCluster columns: the kCluster partials in rank order.
  for (int i = tid; i < per; i += kHeadThreads) {
    float sum = 0.f;
    for (int cc = 0; cc < kCluster; ++cc) sum += gather[cc * per + i];
    out[((size_t)b * H + h) * K + rank * per + i] = __float2bfloat16_rn(sum);
  }
}

// Heads one block takes: as many as fit kMaxThreads and divide H.
int heads_per_block(int H) {
  for (int heads = kMaxThreads / kHeadThreads; heads > 1; heads /= 2)
    if (H % heads == 0) return heads;
  return 1;
}

// The launch's shape: a cluster of kCluster blocks for each row and head
// group.  `attr` must outlive `config`.
template <class Pool>
cudaError_t cluster_config(cudaLaunchConfig_t& config, cudaLaunchAttribute& attr, int B, int H,
                           int K, int W, int NW, void* stream) {
  const int heads = heads_per_block(H);
  const size_t smem = smem_bytes(heads, K, W, NW);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<Pool>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  config = {};
  config.gridDim = dim3(kCluster, B * (H / heads), 1);
  config.blockDim = dim3(heads * kHeadThreads, 1, 1);
  config.dynamicSmemBytes = smem;
  config.stream = (cudaStream_t)stream;
  config.attrs = &attr;
  config.numAttrs = 1;
  return cudaSuccess;
}

template <class Pool>
int launch(const void* q, Pool k_pool, Pool v_pool, const void* table, const void* pos,
           void* out, int B, int H, int K, int W, int NW, float sqrt_d, void* stream) {
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  const cudaError_t e = cluster_config<Pool>(config, attr, B, H, K, W, NW, stream);
  if (e != cudaSuccess) return (int)e;
  const cudaError_t launched = cudaLaunchKernelEx(
      &config, paged_attention_kernel<Pool>, (const __nv_bfloat16*)q, k_pool, v_pool,
      (const int32_t*)table, (const int32_t*)pos, (__nv_bfloat16*)out, H, K, W, NW, sqrt_d);
  if (launched != cudaSuccess) return (int)launched;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block of the launch needs, in bytes, for either pool
// type (the wrapper checks it against the card's limit before launching).
size_t paged_attention_smem_bytes(int H, int K, int W, int NW) {
  return smem_bytes(heads_per_block(H), K, W, NW);
}

// How many clusters the bf16 form's launch for these dims has
// (*grid_clusters) and how many of them the card holds at once (the
// return value, or minus a CUDA error): a launch of more runs in waves.
int paged_attention_clusters(int B, int H, int K, int W, int NW, int* grid_clusters) {
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  cudaError_t e = cluster_config<Bf16Pool>(config, attr, B, H, K, W, NW, nullptr);
  if (e != cudaSuccess) return -(int)e;
  *grid_clusters = (int)(config.gridDim.y);
  int resident = 0;
  e = cudaOccupancyMaxActiveClusters(&resident, (void*)paged_attention_kernel<Bf16Pool>, &config);
  return e == cudaSuccess ? resident : -(int)e;
}

// Launch on `stream`; return the launch's error (0 on success).  The
// wrapper has checked shapes, dtypes, contiguity and alignment: K is a
// multiple of 8 with K / 8 a power of two <= 32, and B * H fits the
// grid's second dimension.
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
