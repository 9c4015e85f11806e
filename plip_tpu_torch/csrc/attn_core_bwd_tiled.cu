// K2's core backward past 128 tokens (plip_attn_core_bwd_tiled): the kernels
// of csrc/mha_bwd.cu in their deferred schedule, a translation unit of its
// own so that it compiles in parallel with K4's (csrc/mha_bwd.cu).
#define PLIP_MHA_BWD_DEFERRED
#include "mha_bwd.cu"
