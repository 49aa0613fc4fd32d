// Paged attention over the block-table-indirect KV cache, for sm_90a: the
// head widths D = 64 and 128 (Llama, Qwen, Mistral, gpt-oss, ...).
//
// Replaces three Pallas TPU kernels of the JAX package,
// dynamo_tpu/ops/paged_attention_pallas.py::paged_decode_attention and
// ::paged_prefill_attention and
// dynamo_tpu/ops/ragged_paged_attention_pallas.py::ragged_mixed_attention.
// The kernels, what bounds them and their design are in
// paged_attention.cuh; paged_attention_wide.cu builds the wider heads
// beside this file, in parallel.

#include "paged_attention.cuh"

extern "C" int paged_attention_launch(PAGED_ATTENTION_PARAMS) {
  return paged_attention_entry<64, 128>(PAGED_ATTENTION_ARGS);
}
