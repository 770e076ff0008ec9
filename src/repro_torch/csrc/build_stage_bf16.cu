// The bfloat16-data entries of build_stage.cu, B1 gram_chol_levels_bf16
// and B2 cross_solve_levels_bf16 (a mixed-precision policy's bfloat16
// points and landmarks; float32 Linv and outputs), in a library of their
// own.  Instantiated in build_stage.cu's translation unit they change how
// nvcc compiles the float32 and float64 entries there (more registers, and
// B2's float32 NT 16 entry spills), so the kernels are shared as source
// and each library instantiates its own entries.
#define REPRO_BF16_ENTRIES
#include "build_stage.cu"
