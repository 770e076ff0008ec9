// The table of a grouped launch: one group per tree level, every level of
// a stage in one launch, so that the top levels' few blocks run inside the
// largest level's waves.  Shared by build_stage.cu (B1 gram_chol_levels,
// B2 cross_solve_levels) and build_dist.cu (B8 gram_chol_dist_levels, B9
// cross_solve_dist_levels).
//
// The wrapper (kernels/build_stage/ops.py::level_table) passes a host
// array of int64 rows, one a group: the data pointers of the group's
// tensors in the stage's order (``cols`` of them; a null pointer for an
// output the group does not want), then its node count and its m.  The
// entry point copies the rows into a Table passed to the kernel by value
// (__grid_constant__).  Groups need not be contiguous in memory (the rank
// masks replace single levels' Linv).
#pragma once

#include <cuda_runtime.h>

namespace levels {

constexpr int kMaxGroups = 32;     // 32 levels is 2**32 leaves
constexpr int kMaxPtrs = 4;

template <typename T>
struct Group {
  T* ptr[kMaxPtrs];     // the row's tensors, in the stage's order
  int nodes;
  int m;
};

template <typename T>
struct Table {
  Group<T> g[kMaxGroups];
};

// The group of node ``b`` of a kernel whose blocks run one node each and,
// in ``b``, the node's index within it: a prefix of node counts (groups
// of 0 nodes are passed over).
template <typename T>
__device__ __forceinline__ int find_group(const Table<T>& tab, int& b) {
  int gi = 0;
  while (b >= tab.g[gi].nodes) {
    b -= tab.g[gi].nodes;
    ++gi;
  }
  return gi;
}

// The host table (groups x (cols + 2) int64) as the kernels' struct; the
// number of nodes and the largest m.  Returns a CUDA error code.
template <typename T>
int read_table(const void* table, int groups, int cols, Table<T>& tab,
               long long& nodes, int& mmax) {
  if (groups < 0 || groups > kMaxGroups || cols > kMaxPtrs)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long* row = static_cast<const long long*>(table);
  nodes = 0;
  mmax = 0;
  for (int i = 0; i < groups; ++i, row += cols + 2) {
    Group<T>& g = tab.g[i];
    for (int k = 0; k < kMaxPtrs; ++k)
      g.ptr[k] = k < cols ? reinterpret_cast<T*>(row[k]) : nullptr;
    g.nodes = static_cast<int>(row[cols]);
    g.m = static_cast<int>(row[cols + 1]);
    nodes += g.nodes;
    if (g.m > mmax) mmax = g.m;
  }
  for (int i = groups; i < kMaxGroups; ++i) tab.g[i] = Group<T>{};
  return 0;
}

}  // namespace levels
