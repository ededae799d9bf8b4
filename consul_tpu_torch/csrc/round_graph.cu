// Conditional CUDA graph nodes for the SWIM round program
// (consul_tpu_torch/gossip/program.py): the counterpart of the lax.conds
// inside the reference's jitted scan (consul_tpu/gossip/kernel.py: the join
// tick, the quiescent / hot / full tail).
//
// What it does.  The round is captured by PyTorch's graph capture as a list
// of segment graphs, in the order they run; a segment is either plain work
// or the body of a branch.  round_graph_build joins them into one graph: a
// plain segment becomes a child-graph node, a branch body a conditional IF
// node whose body holds the segment as a child graph, preceded by a
// one-thread kernel that reads the branch's predicate (one bool in device
// memory, computed by an earlier segment) and sets the node's condition.
// Each node depends on the one before, so the segments run in capture order
// and a replay reads nothing on the host.  This is the mechanism of
// torch.cuda.CUDAGraph.begin_capture_to_if_node in later PyTorch releases,
// built here from the CUDA runtime because the card's PyTorch lacks it.
//
// Bound: none to speak of.  A condition costs one kernel node of one
// thread; a launch of the joined graph costs one cudaGraphLaunch on the
// host, whatever the segments hold.

#include <cuda_runtime.h>

#include <cstdint>
#include <vector>

namespace round_graph {

__global__ void set_condition(cudaGraphConditionalHandle handle,
                              const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

// Appends segment `seg` to `g` after `prev` (nullptr: first node), under
// an IF node on *pred when pred is not nullptr.  An empty segment becomes
// an empty node.  `child`, where not nullptr, gets the child-graph node
// that holds the segment (nullptr for an empty one).
cudaError_t append(cudaGraph_t g, cudaGraphNode_t prev, cudaGraph_t seg,
                   const bool* pred, cudaGraphNode_t* node,
                   cudaGraphNode_t* child = nullptr) {
  if (child != nullptr) *child = nullptr;
  const cudaGraphNode_t* deps = prev ? &prev : nullptr;
  const size_t n_deps = prev ? 1 : 0;
  size_t n_nodes = 0;
  cudaError_t e = cudaGraphGetNodes(seg, nullptr, &n_nodes);
  if (e != cudaSuccess) return e;
  if (pred == nullptr) {
    if (n_nodes == 0) return cudaGraphAddEmptyNode(node, g, deps, n_deps);
    e = cudaGraphAddChildGraphNode(node, g, deps, n_deps, seg);
    if (e == cudaSuccess && child != nullptr) *child = *node;
    return e;
  }
  cudaGraphConditionalHandle handle;
  e = cudaGraphConditionalHandleCreate(&handle, g, 0, 0);
  if (e != cudaSuccess) return e;
  cudaKernelNodeParams kp = {};
  void* args[2] = {&handle, &pred};
  kp.func = reinterpret_cast<void*>(set_condition);
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(1);
  kp.kernelParams = args;
  cudaGraphNode_t set_node;
  e = cudaGraphAddKernelNode(&set_node, g, deps, n_deps, &kp);
  if (e != cudaSuccess) return e;
  cudaGraphNodeParams cp = {};
  cp.type = cudaGraphNodeTypeConditional;
  cp.conditional.handle = handle;
  cp.conditional.type = cudaGraphCondTypeIf;
  cp.conditional.size = 1;
  e = cudaGraphAddNode(node, g, &set_node, 1, &cp);
  if (e != cudaSuccess || n_nodes == 0) return e;
  cudaGraphNode_t body_node;
  e = cudaGraphAddChildGraphNode(&body_node, cp.conditional.phGraph_out[0],
                                 nullptr, 0, seg);
  if (e == cudaSuccess && child != nullptr) *child = body_node;
  return e;
}

// The edges of `g` (its own, not its child graphs'), counted by type:
// programmatic (cudaGraphDependencyTypeProgrammatic, a programmatic
// dependent launch's edge) and the rest.
cudaError_t edge_types(cudaGraph_t g, int* programmatic, int* other) {
  size_t n = 0;
#if CUDART_VERSION >= 13000
  cudaError_t e = cudaGraphGetEdges(g, nullptr, nullptr, nullptr, &n);
#else
  cudaError_t e = cudaGraphGetEdges_v2(g, nullptr, nullptr, nullptr, &n);
#endif
  *programmatic = *other = 0;
  if (e != cudaSuccess || n == 0) return e;
  std::vector<cudaGraphNode_t> from(n), to(n);
  std::vector<cudaGraphEdgeData> data(n);
#if CUDART_VERSION >= 13000
  e = cudaGraphGetEdges(g, from.data(), to.data(), data.data(), &n);
#else
  e = cudaGraphGetEdges_v2(g, from.data(), to.data(), data.data(), &n);
#endif
  if (e != cudaSuccess) return e;
  for (size_t k = 0; k < n; ++k) {
    if (data[k].type == cudaGraphDependencyTypeProgrammatic) {
      ++*programmatic;
    } else {
      ++*other;
    }
  }
  return cudaSuccess;
}

}  // namespace round_graph

// Joins `n` segment graphs (cudaGraph_t) into one executable graph, in
// order; segment i runs under an IF node on the device bool preds[i], or
// unconditionally where preds[i] is nullptr.  The segments are cloned, so
// their graphs may be destroyed after; the memory they use may not.
// Returns the joined graph and its executable in *graph and *exec, or the
// first CUDA error (then nothing is left allocated).
extern "C" int round_graph_build(void* const* segs, void* const* preds,
                                 int n, void** graph, void** exec) {
  cudaGraph_t g = nullptr;
  cudaError_t e = cudaGraphCreate(&g, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaGraphNode_t prev = nullptr;
  for (int i = 0; i < n && e == cudaSuccess; ++i) {
    cudaGraphNode_t node = nullptr;
    e = round_graph::append(g, prev, static_cast<cudaGraph_t>(segs[i]),
                            static_cast<const bool*>(preds[i]), &node);
    prev = node;
  }
  cudaGraphExec_t x = nullptr;
  if (e == cudaSuccess) e = cudaGraphInstantiate(&x, g, 0);
  if (e != cudaSuccess) {
    cudaGraphDestroy(g);
    return static_cast<int>(e);
  }
  *graph = g;
  *exec = x;
  return 0;
}

// What the joining keeps of a segment's programmatic edges: the segment
// `seg` joined alone, under an IF node on *pred (round_graph_build's
// form), into an executable graph.  counts[0], counts[1]: the segment's
// programmatic and other edges; counts[2], counts[3]: those of the child
// graph in the IF node's body (the clone the joined graph runs).  Returns
// the joined graph and its executable as round_graph_build does, or the
// first CUDA error (the counts as far as they were read).
extern "C" int round_graph_edges(void* seg, const void* pred, int* counts,
                                 void** graph, void** exec) {
  using namespace round_graph;
  for (int k = 0; k < 4; ++k) counts[k] = 0;
  cudaError_t e = edge_types(static_cast<cudaGraph_t>(seg), counts,
                             counts + 1);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaGraph_t g = nullptr;
  e = cudaGraphCreate(&g, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaGraphNode_t node = nullptr, child = nullptr;
  e = append(g, nullptr, static_cast<cudaGraph_t>(seg),
             static_cast<const bool*>(pred), &node, &child);
  cudaGraph_t body = nullptr;
  if (e == cudaSuccess && child != nullptr) {
    e = cudaGraphChildGraphNodeGetGraph(child, &body);
  }
  if (e == cudaSuccess && body != nullptr) {
    e = edge_types(body, counts + 2, counts + 3);
  }
  cudaGraphExec_t x = nullptr;
  if (e == cudaSuccess) e = cudaGraphInstantiate(&x, g, 0);
  if (e != cudaSuccess) {
    cudaGraphDestroy(g);
    return static_cast<int>(e);
  }
  *graph = g;
  *exec = x;
  return 0;
}

// Launches the joined graph on `stream`; does not synchronise.
extern "C" int round_graph_launch(void* exec, void* stream) {
  return static_cast<int>(cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                                          static_cast<cudaStream_t>(stream)));
}

extern "C" int round_graph_destroy(void* graph, void* exec) {
  cudaError_t e = cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
  const cudaError_t e2 = cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
  return static_cast<int>(e != cudaSuccess ? e : e2);
}

extern "C" const char* round_graph_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
