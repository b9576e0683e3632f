// The paper's §5.2 fixed address map, shared by K4 (addr_map.cu) and the
// front end of the persistent event-horizon kernel (fused.cu), so the two
// cannot drift apart. Mirrors repro_torch.core.dram_model.decode_address:
// the bank, bank group, rank and channel fields from the low bits (channel
// above the rank), and on a tiered topology the placement decode that sends
// the all-ones residue of (addr >> interleave_log2) & frac_mask to the CXL
// channels. `>>` on int32 is arithmetic, as in jnp. Every count is a power
// of two.
#pragma once

struct AddrGeometry {
  int banks_per_group, bankgroups, ranks, channels;
  int bank_bits, bankgroup_bits, rank_bits, row_shift;
  int dram_channels, cxl_channels, num_banks;
};

// Flat bank of `a`; its flat rank into *rank. `tiered` selects the
// placement decode with (interleave_log2 il, (1 << cxl_frac_log2) - 1).
__device__ __forceinline__ int decode_bank(const AddrGeometry& g, int a,
                                           bool tiered, int il,
                                           int frac_mask, int* rank) {
  const int ba = a & (g.banks_per_group - 1);
  const int bg = (a >> g.bank_bits) & (g.bankgroups - 1);
  const int rk = (a >> (g.bank_bits + g.bankgroup_bits)) & (g.ranks - 1);
  int ch = (a >> (g.bank_bits + g.bankgroup_bits + g.rank_bits)) &
           (g.channels - 1);
  if (tiered) {
    const bool is_cxl = ((a >> il) & frac_mask) == frac_mask;
    ch = is_cxl ? g.dram_channels + (ch & (g.cxl_channels - 1))
                : ch & (g.dram_channels - 1);
  }
  const int rnk = ch * g.ranks + rk;
  *rank = rnk;
  return (rnk * g.bankgroups + bg) * g.banks_per_group + ba;
}
