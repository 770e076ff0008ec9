// The bfloat16-data entries of build_dist_panel.cu, B8
// gram_chol_dist_levels_panel_bf16 and B9 cross_solve_dist_levels_panel_bf16
// (a mixed-precision policy's bfloat16 distance tiles past the resident
// forms' limits; float32 Linv and outputs), in a library of their own, so
// that the float32 and float64 panel entries compile as they do alone
// (see build_stage_bf16.cu).
#define REPRO_PANEL_BF16_ENTRIES
#include "build_dist_panel.cu"
