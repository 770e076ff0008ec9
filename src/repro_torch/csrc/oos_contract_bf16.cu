// The bfloat16-data entry of oos_contract.cu, B7 oos_contract_bf16 (a
// mixed-precision policy's bfloat16 points, landmarks and queries; float32
// weights and output), in a library of its own, so that oos_contract.cu's
// float32 and float64 entries compile as they do alone (see
// build_stage_bf16.cu).
#define REPRO_BF16_ENTRIES
#include "oos_contract.cu"
