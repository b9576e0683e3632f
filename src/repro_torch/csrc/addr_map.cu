// K4: trace address decode (paper §5.2 fixed mapping) with a per-bank
// histogram.
//
// Replaces (TPU, Pallas):
//   src/repro/kernels/addr_map/addr_map.py:67
//   addr_map_pallas (body _kernel :26).
//
// What bounds it on an H100: bytes. Each address is read once (4 B) and
// its bank, rank and row written once (12 B), a handful of integer
// operations apiece: 2^24 addresses move 268 MB, ~80 us at 3.35 TB/s.
// The TPU kernel counts banks by comparing each block against every bank
// id and carries the histogram across its sequential grid; here CTAs run
// in parallel and in no order.
//
// Design: a grid-stride loop of 256-thread CTAs (at most 8 per SM) over
// the addresses; each CTA counts its banks into a shared-memory histogram
// of num_banks int32 (sized at launch) with shared atomics and adds it to
// the global histogram (zeroed by the wrapper) with one global atomicAdd
// per nonzero bank. Integer sums do not depend on their order, so the
// result is bit-identical to the plain version's. The ragged tail is
// masked (no padding). `>>` on int32 is arithmetic, as in jnp. A tiered
// decode reads (interleave_log2, cxl_frac_log2) from an int32[2] on the
// device, so placement stays data, as in the reference.
//
// ABI: addr int32[N]; bank, rank, row int32[N]; hist int32[num_banks];
// tier int32[2] or null; the geometry as ints (every count a power of two).
#include <cuda_runtime.h>

#include "addr_decode.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCtasPerSm = 8;

__global__ void __launch_bounds__(kThreads)
    addr_map_kernel(const int* __restrict__ addr, int n, AddrGeometry g,
                    const int* __restrict__ tier, int* __restrict__ bank,
                    int* __restrict__ rank, int* __restrict__ row,
                    int* __restrict__ hist) {
  extern __shared__ int counts[];
  for (int i = threadIdx.x; i < g.num_banks; i += kThreads) counts[i] = 0;
  int il = 0, frac_mask = 0;
  if (tier != nullptr) {
    il = tier[0];
    frac_mask = (1 << tier[1]) - 1;
  }
  __syncthreads();
  const int stride = gridDim.x * kThreads;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    const int a = addr[i];
    int rnk;
    const int bk = decode_bank(g, a, tier != nullptr, il, frac_mask, &rnk);
    bank[i] = bk;
    rank[i] = rnk;
    row[i] = a >> g.row_shift;
    atomicAdd(&counts[bk], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < g.num_banks; i += kThreads)
    if (counts[i] != 0) atomicAdd(&hist[i], counts[i]);
}

}  // namespace

extern "C" int addr_map_launch(const void* addr, void* bank, void* rank,
                               void* row, void* hist, const void* tier, int n,
                               int banks_per_group, int bankgroups, int ranks,
                               int channels, int bank_bits,
                               int bankgroup_bits, int rank_bits,
                               int row_shift, int dram_channels,
                               int cxl_channels, int num_banks,
                               void* stream) {
  if (n < 1 || num_banks < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(int) * (size_t)num_banks;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int want = (n + kThreads - 1) / kThreads;
  const int ctas = want < sms * kMaxCtasPerSm ? want : sms * kMaxCtasPerSm;
  AddrGeometry g{banks_per_group, bankgroups, ranks, channels,
             bank_bits, bankgroup_bits, rank_bits, row_shift,
             dram_channels, cxl_channels, num_banks};
  addr_map_kernel<<<ctas, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(addr), n, g, static_cast<const int*>(tier),
      static_cast<int*>(bank), static_cast<int*>(rank),
      static_cast<int*>(row), static_cast<int*>(hist));
  return (int)cudaGetLastError();
}
