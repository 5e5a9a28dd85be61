// Flash attention forward for Hopper (sm_90a): bf16 on the tensor cores,
// f32 on the CUDA cores.
//
// Replaces: tpu_dra/parallel/flash.py::flash_attention, whose forward
// _flash_forward runs the pl.pallas_call of _flash_fwd_kernel.  Its
// backward is not a kernel in the reference either: the port's autograd
// Function differentiates the reference attention (parallel/ring.py).
//
// What it computes: softmax attention of q (B, S, H, D) against k, v of
// the same shape, causal or not, with the online softmax: f32 scores of
// q . k scaled by an f32 1/sqrt(D); running max m, denominator l and
// numerator acc in f32; p kept in f32 for the V product (no bf16 rounding
// of p, unlike the dense path); out = acc / max(l, 1e-30) cast to the
// input type once.  Masked scores are excluded exactly (p = 0), and key
// tiles wholly in a query tile's future are never loaded, as the
// reference's @pl.when(live) skips them.
//
// Layout: q, k and v may be strided views of the (B, S, 3, H, D) qkv
// product.  Head and feature dimensions are contiguous (the wrapper
// checks); batch and sequence strides are taken per tensor.  The output
// is contiguous (B, S, H, D).
//
// What bounds it on an H100: at the trainer's shapes (16, 1024, 32, 128)
// bf16 it must read q, k and v and write o, 536.9 MB, about 160 us at
// 3.35 TB/s.  The causal products are 2*B*H*S^2*D = 1.37e11 flops, about
// 139 us at the 989 TFLOP/s bf16 tensor-core peak.  So the bound is about
// 160 us, set by the bytes; any design on the f32 CUDA cores (67 TFLOP/s)
// is held above 2 ms by the products alone.
//
// The bf16 design (flash_fwd_kernel):
// - One block is one warpgroup (128 threads) owning one (batch*head,
//   64-row query tile); it walks the key tiles (64 keys each) up to the
//   causal diagonal with m, l and acc in registers.  Hopper's blocks run
//   in no order, so nothing is carried across blocks (the TPU grid
//   carried them in VMEM scratch from one sequential step to the next).
//   The longest walks (last query tiles) are scheduled first.  Two blocks
//   fit an SM (80 KB of shared memory each at D = 128), so one block's
//   softmax overlaps the other's products.
// - Copies are TMA: q once per block, K and V through a two-stage ring
//   in shared memory with one mbarrier per stage, so the next tile's
//   loads fly while this tile's products run.  The tensor maps are built
//   per call from each view's strides (dims d, h, s, b); a row of a box
//   is 64 bf16 values (the 128-byte swizzle's width), so a D = 128 tile
//   comes in two boxes.  Out-of-range rows (a ragged last tile) are
//   zero-filled by TMA and masked.
// - S = Q . K^T is a wgmma with both operands in shared memory, K-major
//   (128-byte swizzle, as TMA wrote them).  O += P . V is a wgmma with P
//   from registers (the score accumulator's layout is the A operand's)
//   and V from shared memory in its stored (MN-major) layout, so V needs
//   no transpose pass.  Accumulators are f32 in registers.
// - Only the diagonal tile and a ragged last tile are masked.
// - The output goes through shared memory to 16-byte stores.
//
// Rounding contract (the plain version and the tolerances are the f32
// CUDA-core kernel's):
// - Scores: a product of two bf16 values is exact in f32, so S = q . k is
//   taken with f32 accumulation and then multiplied by the f32 1/sqrt(D).
//   The reference scales widened q first; the two differ only at f32
//   rounding, as does exp taken as exp2 of a log2(e)-scaled exponent.
// - P in the V product: the reference keeps p in f32.  A bf16 wgmma takes
//   bf16 operands, so p goes in as p_hi = bf16(p) plus p_lo = bf16(p -
//   p_hi), two wgmmas into one accumulator, which carries p to about
//   2^-16 of its value.  A single bf16 p would round each probability to
//   2^-9 and depart from the reference's arithmetic; it is not taken.
// - Output: acc / max(l, 1e-30), cast once.
//
// The f32 form (flash_fwd_f32_kernel) is on no path of the package (only
// the f32 tests use it) and keeps the first design: f32 products on the
// CUDA cores, each thread a 4 x 4 tile of scores, Q and K transposed in
// shared memory.  dtype picks the form; nothing falls back between them.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// bf16: TMA ring and wgmma.

constexpr int kRows = 64;      // query rows per block: the wgmma M of one warpgroup
constexpr int kKeys = 64;      // keys per tile
constexpr int kStages = 2;     // depth of the K/V ring
constexpr int kTcThreads = 128;
constexpr int kBox = 64;       // bf16 values in one 128-byte swizzled row
constexpr uint32_t kBoxBytes = 64 * 128;  // one 64-row box
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct TcLayout {
  static constexpr int kChunks = D / kBox;              // boxes per row of a tile
  static constexpr uint32_t kQBytes = kRows * D * 2;    // q tile, chunk after chunk
  static constexpr uint32_t kKBytes = kKeys * D * 2;    // one K (or V) tile
  static constexpr uint32_t kStageBytes = 2 * kKBytes;  // K, then V
  static constexpr uint32_t kBarOff = kQBytes + kStages * kStageBytes;
  // mbarriers (q, then one per stage), then slack to align the base.
  static constexpr uint32_t kBytes = kBarOff + 8 * (1 + kStages) + 1024;
  static constexpr int kOutPitch = D + 8;  // bf16 row of the staged output, conflict-free
  static_assert(kRows * kOutPitch * 2 <= kStages * kStageBytes, "output staging fits the ring");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// A wait that has not ended after some seconds is a fault (a copy that
// never lands): trap, so that the launch fails instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    if (spins == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One box (64 values of d x 1 head x 64 rows x 1 batch) into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int d0, int h, int s0, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d0), "r"(h), "r"(s0),
      "r"(b)
      : "memory");
}

// A shared-memory matrix descriptor for the 128-byte swizzle: start
// address, leading and stride byte offsets (see each use).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// The same for A operands in registers, which a product reads until it
// completes.
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define F16(i) F4(i), F4(i + 4), F4(i + 8), F4(i + 12)
#define R16(a, b, c, d, e, f, g, h, i, j, k, l, m, n, o, p)                                   \
  "%" #a ", %" #b ", %" #c ", %" #d ", %" #e ", %" #f ", %" #g ", %" #h ", %" #i ", %" #j ", %" #k \
  ", %" #l ", %" #m ", %" #n ", %" #o ", %" #p

// d (64 x 64, f32) += A (64 x 16) . B (64 x 16)^T, both in shared memory,
// K-major; acc = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      R16(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15) ", "
      R16(16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31)
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : F16(0), F16(16)
      : "l"(a), "l"(b), "r"(acc));
}

// d (64 x 64, f32) += A (64 x 16, registers) . B (16 x 64, shared memory, MN-major).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      R16(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15) ", "
      R16(16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31)
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F16(0), F16(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128, f32) += A (64 x 16, registers) . B (16 x 128, shared memory, MN-major).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      R16(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15) ", "
      R16(16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31) ", "
      R16(32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47) ", "
      R16(48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63)
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : F16(0), F16(16), F16(32), F16(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef F4
#undef F16
#undef R16

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a, uint64_t b) {
  wgmma_rs_n64(d, a, b);
}
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a, uint64_t b) {
  wgmma_rs_n128(d, a, b);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Thread layout of a 64 x N accumulator: warp w holds rows 16w..16w+15;
// lane l holds rows 16w + l/4 (values i with bit 1 clear) and that + 8
// (bit 1 set), columns 8*(i/4) + 2*(l%4) + (i%2).
template <int D>
__global__ void __launch_bounds__(kTcThreads, 2)
flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ out,
                 int S, int H, int causal, float scale) {
  using L = TcLayout<D>;
  constexpr int kAcc = D / 2;  // output accumulator floats per thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle repeats every 1024 bytes
  uint8_t* base_ptr = smem_raw + (base - raw);
  const uint32_t q_s = base;
  const uint32_t ring = base + L::kQBytes;
  const uint32_t q_bar = base + L::kBarOff;  // stage i's barrier follows at 8 * (1 + i)

  const int n_qt = (S + kRows - 1) / kRows;
  const int BH = gridDim.x / n_qt;
  const int bh = blockIdx.x % BH;
  const int qt = n_qt - 1 - blockIdx.x / BH;
  const int b = bh / H, h = bh % H;
  const int q0 = qt * kRows;
  const int tid = threadIdx.x;
  const int kv_end = causal ? min(S, q0 + kRows) : S;
  const int n_tiles = (kv_end + kKeys - 1) / kKeys;

  auto load_tile = [&](int tile, int stage) {
    const uint32_t bar = q_bar + 8 * (1 + stage);
    const uint32_t k_dst = ring + stage * L::kStageBytes;
    mbar_expect_tx(bar, L::kStageBytes);
#pragma unroll
    for (int c = 0; c < L::kChunks; ++c) {
      tma_load(k_dst + c * kBoxBytes, &k_map, bar, c * kBox, h, tile * kKeys, b);
      tma_load(k_dst + L::kKBytes + c * kBoxBytes, &v_map, bar, c * kBox, h, tile * kKeys, b);
    }
  };

  if (tid == 0) {
    for (int i = 0; i <= kStages; ++i) mbar_init(q_bar + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(q_bar, L::kQBytes);
#pragma unroll
    for (int c = 0; c < L::kChunks; ++c) {
      tma_load(q_s + c * kBoxBytes, &q_map, q_bar, c * kBox, h, q0, b);
    }
    for (int t = 0; t < kStages && t < n_tiles; ++t) load_tile(t, t);
  }

  const int warp = tid / 32, lane = tid % 32;
  const int r_lo = warp * 16 + lane / 4;  // this thread's rows: r_lo and r_lo + 8
  const int cpair = 2 * (lane % 4);

  float o[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this thread's share of each row's sum

  mbar_wait(q_bar, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t % kStages;
    mbar_wait(q_bar + 8 * (1 + stage), (t / kStages) & 1);
    const uint32_t k_s = ring + stage * L::kStageBytes;
    const uint32_t v_s = k_s + L::kKBytes;

    // S = Q . K^T: D/16 steps of 16 along d; step kk lies in box kk/4, 32
    // bytes further along its swizzled 128-byte rows for each step.
    // K-major operands: 8-row groups 1024 bytes apart (SBO); LBO unused.
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
      wgmma_ss_n64(s, smem_desc(q_s + off, 16, 1024), smem_desc(k_s + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);

    const int k0 = t * kKeys;
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] *= scale;
    if ((causal && k0 + kKeys - 1 > q0) || k0 + kKeys > S) {  // the diagonal or a ragged tile
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = k0 + 8 * (i / 4) + cpair + (i % 2);
        const int row = q0 + r_lo + 8 * ((i / 2) % 2);
        if (key >= S || (causal && key > row)) s[i] = -INFINITY;
      }
    }

    // Online softmax.  The four lanes l%4 of a row hold its 64 scores; key
    // 0 is visible to every row, so m is finite after the first tile and a
    // masked score gives p = exp2(-inf) = 0 exactly.
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f((m[r] - mx[r]) * kLog2e);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
    uint32_t p_hi[16], p_lo[16];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = (i / 2) % 2;
      const float p0 = exp2f((s[i] - m[r]) * kLog2e);
      const float p1 = exp2f((s[i + 1] - m[r]) * kLog2e);
      l[r] += p0 + p1;
      const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
      const float2 hf = __bfloat1622float2(hi);
      p_hi[i / 2] = *reinterpret_cast<const uint32_t*>(&hi);
      p_lo[i / 2] = pack_bf16(p0 - hf.x, p1 - hf.y);
    }
#pragma unroll
    for (int i = 0; i < kAcc; ++i) o[i] *= alpha[(i / 2) % 2];

    // O += P . V: 4 steps of 16 keys, each as p_hi and p_lo.  V is
    // MN-major: rows of 64 d-values (128 bytes, swizzled), 8-key groups
    // 1024 bytes apart (SBO), 64-wide d boxes kBoxBytes apart (LBO); a
    // step of 16 keys is 2048 bytes.  P's registers for keys 16kt.. are
    // the score accumulator's values 8kt..8kt+7, two to a register.
    wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < kKeys / 16; ++kt) {
      const uint64_t vd = smem_desc(v_s + kt * 2048, kBoxBytes, 1024);
      wgmma_rs(o, p_hi + 4 * kt, vd);
      wgmma_rs(o, p_lo + 4 * kt, vd);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(o);
    fence_regs(p_hi);
    fence_regs(p_lo);

    __syncthreads();  // every warp is done reading this stage
    if (tid == 0 && t + kStages < n_tiles) load_tile(t + kStages, stage);
  }

  // out = acc / max(l, 1e-30) in bf16, staged in the (now idle) ring as
  // rows of kOutPitch values, then written as 16-byte rows.
  float denom[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r] + __shfl_xor_sync(0xffffffffu, l[r], 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    denom[r] = fmaxf(sum, 1e-30f);
  }
  __nv_bfloat16* stage_out = reinterpret_cast<__nv_bfloat16*>(base_ptr + L::kQBytes);
#pragma unroll
  for (int i = 0; i < kAcc; i += 2) {
    const int r = (i / 2) % 2;
    const int row = r_lo + 8 * r;
    const int col = 8 * (i / 4) + cpair;
    *reinterpret_cast<__nv_bfloat162*>(stage_out + row * L::kOutPitch + col) =
        __floats2bfloat162_rn(o[i] / denom[r], o[i + 1] / denom[r]);
  }
  __syncthreads();
  constexpr int kVecs = D / 8;  // 16-byte pieces per row
  for (int idx = tid; idx < kRows * kVecs; idx += kTcThreads) {
    const int row = idx / kVecs, piece = idx % kVecs;
    if (q0 + row >= S) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(stage_out + row * L::kOutPitch + piece * 8);
    *reinterpret_cast<uint4*>(out + (((long long)b * S + q0 + row) * H + h) * D + piece * 8) = v;
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the CUDA driver, without linking libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// A 4-d map of one (B, S, H, D) view (dims d, h, s, b; strides in
// elements) with 64 x 1 x 64 x 1 boxes, 128-byte swizzle, zero fill.
template <int D>
CUresult encode_map(EncodeTiled fn, CUtensorMap* map, const void* ptr, int B, int S, int H,
                    long long sb, long long ss) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)ss * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kBox, 1, (cuuint32_t)kRows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Error codes past the runtime's: no encoder in the CUDA driver, or a map
// it refused (kEncodeFailed + its CUresult).
constexpr int kNoEncoder = 10000;
constexpr int kEncodeFailed = 10001;

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out, int B, int S, int H,
                long long q_sb, long long q_ss, long long k_sb, long long k_ss, long long v_sb,
                long long v_ss, int causal, float scale, cudaStream_t stream) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kNoEncoder;
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  const long long sbs[3] = {q_sb, k_sb, v_sb}, sss[3] = {q_ss, k_ss, v_ss};
  for (int i = 0; i < 3; ++i) {
    const CUresult r = encode_map<D>(fn, &maps[i], ptrs[i], B, S, H, sbs[i], sss[i]);
    if (r != CUDA_SUCCESS) return kEncodeFailed + (int)r;
  }
  const uint32_t smem = TcLayout<D>::kBytes;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int n_qt = (S + kRows - 1) / kRows;
  flash_fwd_kernel<D><<<n_qt * B * H, kTcThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], (__nv_bfloat16*)out, S, H, causal, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: products on the CUDA cores.

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // keys per tile
constexpr int kThreads = 256;   // 16 x 16: thread (ty, tx) owns rows ty*4.. and key columns tx*4..
constexpr int kPQ = kBQ + 4;    // padded row of the transposed probability tile

__device__ __forceinline__ void load8(const float* p, float out[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

template <int D>
constexpr size_t smem_floats() {
  // Qt [D][kBQ]; Kt [D][kBK], which the probability tile Pt [kBK][kPQ]
  // reuses once the scores are in registers; Vs [kBK][D].
  return (size_t)D * kBQ + (D * kBK > kBK * kPQ ? D * kBK : kBK * kPQ) + (size_t)kBK * D;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out, int S, int H,
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
  const float* qb = q + b * q_sb + (long long)h * D;
  const float* kb = k + b * k_sb + (long long)h * D;
  const float* vb = v + b * v_sb + (long long)h * D;

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
    float* o = out + (((long long)b * S + row) * H + h) * D;
#pragma unroll
    for (int u = 0; u < D / 64; ++u)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) o[u * 64 + tx * 4 + jj] = acc[i][u * 4 + jj] / denom;
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B, int S, int H,
               long long q_sb, long long q_ss, long long k_sb, long long k_ss, long long v_sb,
               long long v_ss, int causal, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int n_qt = (S + kBQ - 1) / kBQ;
  flash_fwd_f32_kernel<D><<<n_qt * B * H, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, S, H, q_sb, q_ss, k_sb,
      k_ss, v_sb, v_ss, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 on success),
// cudaErrorInvalidValue for a head width the kernel does not take, or
// (bf16) 10000 when the CUDA driver has no tensor-map encoder and 10001 + its
// CUresult when it refuses a map.  The wrapper has checked shapes, dtypes,
// strides and 16-byte alignment.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* out, int B,
                        int S, int H, int D, long long q_sb, long long q_ss,
                        long long k_sb, long long k_ss, long long v_sb, long long v_ss,
                        int causal, int is_bf16, float scale, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16 && D == 64)
    return launch_bf16<64>(q, k, v, out, B, S, H, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, causal, scale, st);
  if (is_bf16 && D == 128)
    return launch_bf16<128>(q, k, v, out, B, S, H, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, causal, scale, st);
  if (!is_bf16 && D == 64)
    return launch_f32<64>(q, k, v, out, B, S, H, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, causal, scale, st);
  if (!is_bf16 && D == 128)
    return launch_f32<128>(q, k, v, out, B, S, H, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
