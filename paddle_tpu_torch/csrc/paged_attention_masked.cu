// K4 and K4-int8 under blha_attention's additive encoder / decoder masks
// (paddle_tpu/ops/paged_attention.py:285-308): every instance of
// paged_attention.cu compiled a second time with kMask set, into the
// entries ptt_paged_attention_masked and ptt_paged_attention_int8_masked,
// to which ptt_paged_attention and ptt_paged_attention_int8 hand a call
// with a mask.  A source of its own, so that nvcc builds the masked
// instances in parallel with the unmasked ones (one source holding both
// takes about 60 s longer to build: PERF.md), and the serving engine's
// unmasked instances stay the code they were.  The note at the head of
// paged_attention.cu describes the masks' semantics.
#define PTT_PAGED_MASKED 1
#include "paged_attention.cu"
