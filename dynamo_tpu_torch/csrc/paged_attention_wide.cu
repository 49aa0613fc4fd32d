// Paged attention over the block-table-indirect KV cache, for sm_90a: the
// head widths D = 192 and 256 (Gemma-3's 256).
//
// Replaces the same three Pallas TPU kernels as paged_attention.cu
// (dynamo_tpu/ops/paged_attention_pallas.py::paged_decode_attention,
// ::paged_prefill_attention,
// dynamo_tpu/ops/ragged_paged_attention_pallas.py::ragged_mixed_attention)
// at the head widths above 128. The kernels and their design are in
// paged_attention.cuh, which says what changes above D = 128 (Q in shared
// memory, 4 walking warps in the decode body). Its own translation unit,
// so its instantiations build in parallel with the narrower ones.

#include "paged_attention.cuh"

extern "C" int paged_attention_wide_launch(PAGED_ATTENTION_PARAMS) {
  return paged_attention_entry<192, 256>(PAGED_ATTENTION_ARGS);
}
