// The bfloat16-data entries of build_stage_panel.cu, B1
// gram_chol_levels_panel_bf16 and B2 cross_solve_levels_panel_bf16 (a
// mixed-precision policy's bfloat16 points and landmarks past the resident
// forms' limits; float32 Linv and outputs), in a library of their own, so
// that the float32 and float64 panel entries compile as they do alone
// (see build_stage_bf16.cu).
#define REPRO_PANEL_BF16_ENTRIES
#include "build_stage_panel.cu"
