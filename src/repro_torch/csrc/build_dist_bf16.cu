// The bfloat16-data entries of build_dist.cu, B8 gram_dist_bf16 and
// gram_chol_dist_levels_bf16 and B9 cross_solve_dist_levels_bf16 (a
// mixed-precision policy's bfloat16 distance tiles; float32 Linv and
// outputs), in a library of their own, so that build_dist.cu's float32
// and float64 entries compile as they do alone (see build_stage_bf16.cu).
#define REPRO_BF16_ENTRIES
#include "build_dist.cu"
