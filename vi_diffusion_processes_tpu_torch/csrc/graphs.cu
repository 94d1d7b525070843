// The node count of a captured CUDA graph, which optim/compiled.py records
// for each replay of the graph: cudaGraphGetNodes, every node type.
#include <cstddef>

#include <cuda_runtime.h>

extern "C" int vidp_graph_nodes(void* graph, size_t* count) {
  return static_cast<int>(cudaGraphGetNodes(static_cast<cudaGraph_t>(graph), nullptr, count));
}
