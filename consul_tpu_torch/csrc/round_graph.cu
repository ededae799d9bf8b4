// Conditional CUDA graph nodes for the SWIM round program
// (consul_tpu_torch/gossip/program.py): the counterpart of the lax.conds
// inside the reference's jitted scan (consul_tpu/gossip/kernel.py: the join
// tick, the quiescent / hot / full tail).
//
// What it does.  The round is captured by PyTorch's graph capture as a list
// of segment graphs, in the order they run; a segment is either plain work
// or the body of a branch.  round_graph_build joins them into one graph: a
// plain segment becomes a child-graph node, a branch body a conditional IF
// node whose body holds the segment as a child graph.  The IF nodes of one
// branch group (the k bodies of one lax.switch, or the one of a lax.cond)
// follow one chooser node, choose_kernel, the joined graph's own: it makes
// the group's choice on the card from the group's operand, sets every
// handle of the group (1 for the branch taken, 0 for the others) and adds
// one to the taken branch's run counter (the program's branch_runs).  Each
// node depends on the one before, so the segments run in capture order and
// a replay reads nothing on the host.  This is the mechanism of
// torch.cuda.CUDAGraph.begin_capture_to_if_node in later PyTorch releases,
// built here from the CUDA runtime because the card's PyTorch lacks it.
//
// The choice (kernel.py's choice_ref is its plain version).  A cond's group
// (k = 1, the join tick) reads one device bool, computed by an earlier
// segment: its branch runs where the bool holds.  The tail's switch (k = 2:
// quiescent, full; k = 3: quiescent, hot, full) counts the live slots,
// n_active = #(slot_node >= 0) over slot_node [s], and takes branch 0 where
// none is live, 1 where at most `hot` are (k = 3, the hot tier on), else
// the last; it writes n_active where the round reads it after the tail
// (the flight row's tx).  So the round makes no launch of its own for the
// choice: the count, the rule, the conditions and the runs are this one
// node's.
//
// The loop (the reference's lax.scan over a call's rounds).  A chunk of a
// call's rounds runs as one launch of a loop graph: a WHILE node whose body
// is one loop_kernel node and then U round slots in series (the caller's
// U: program.py's LOOP_ROUNDS), each one SWITCH conditional node whose V
// bodies are the captured variants' joined rounds (kernel.Variant:
// push/pull, in the nemesis window, degraded, flap down), each as above
// (its chooser nodes, its IF nodes and their segments: three levels of
// conditional nodes).  So the body holds U x V joined rounds, each with
// its own chooser nodes and handles.
//
// The slot rule.  The loop kernel runs first in each iteration, with the
// chunk's rounds left (a word in device memory, which the table kernel of
// round_table.cu sets to the chunk's rows) and the program's row counter
// `step` (which the rounds advance, one each): it takes m = min(U, left)
// rounds; slot u < m gets the body of the variant code that the table's
// variant column names at row step + u (a lookup, code to body, in the
// kernel's arguments: no search), counted in runs[code]; every slot u >= m
// gets a value >= V, which runs no body.  It subtracts the rounds taken
// from `left`, counts its own run, and keeps the WHILE handle set only
// while rounds remain after this iteration.  The fault rule, per slot: a
// code with no built body ends the loop at that slot; the slots before it
// run, it and those after it run nothing, `left` goes to 0 and the fault
// words get a count and the code.  The WHILE handle's default, 1, is
// applied at each launch, so one executable serves every chunk length, 0
// included (one loop kernel, no round); a launch takes at most the chunk's
// rounds, whatever the other words hold.  So a chunk of n rounds costs one
// cudaGraphLaunch and ceil(n / U) loop_kernel nodes, and its rounds read
// nothing on the host.  The program's U is 4: on the card its toy loop
// (round_graph_loop_toy) takes a round faster than at U = 8 over a 4-round
// chunk and 3-25% slower over 512 rounds, real rounds run as fast at 4
// slots as at 8, and the host's launch of the loop graph grows with its
// slots times variants (PERF.md); the toy also builds the older form, an
// IF node a variant a slot, to measure it beside the SWITCH form.
//
// Bound: the chooser reads slot_node and one int64 run counter and writes
// the count and the counter, 276 bytes at S = 64; the loop kernel reads
// the rounds left and the step, writes the rounds left and adds one to its
// own run counter (32 bytes an iteration), and for each round taken reads
// its code and adds one to its run counter (20 bytes); a launch costs
// more.  A launch of the joined graph, or of the loop, costs one
// cudaGraphLaunch on the host, whatever the segments hold, but its host
// time grows with the graph's nodes (PERF.md).

#include <cuda_runtime.h>

#include <cstdint>
#include <vector>

namespace round_graph {

constexpr int kMaxBranches = 3;
constexpr int kMaxThreads = 1024;
constexpr int kMaxVariants = 16;  // variant codes (kernel.VARIANT_CODES)
constexpr int kMaxSlots = 8;      // round slots an iteration at most

// One branch group's chooser node's arguments, by value (program.py's
// _Choice mirrors this layout).
struct Choice {
  const void* operand;  // k = 1: one device bool; else slot_node, int32 [s]
  int32_t* n_active;    // k > 1: the live slots' count (nullptr: not kept)
  long long* runs;      // the program's branch_runs (nullptr: not counted)
  int s;                // k > 1: slot_node's length
  int hot;              // k = 3: the hot tier's slots
  int k;                // branches: 1 (a cond), 2 or 3 (the tail's switch)
  int bid[kMaxBranches];  // each branch's index into runs
  cudaGraphConditionalHandle handle[kMaxBranches];  // the IF nodes', in order
};

// The branch of a switch group with n live slots.
__device__ __forceinline__ int branch_of(int n, int k, int hot) {
  if (n == 0) return 0;
  if (k == 3 && n <= hot) return 1;
  return k - 1;
}

// One block: the count by __syncthreads_count over chunks of the block's
// width (every thread takes part in each), then thread 0 sets the handles
// and writes the count and the run.
__global__ void __launch_bounds__(kMaxThreads) choose_kernel(const Choice c) {
  int taken, n = 0;
  if (c.k == 1) {
    taken = *static_cast<const bool*>(c.operand) ? 0 : -1;
  } else {
    const int32_t* node = static_cast<const int32_t*>(c.operand);
    const int width = static_cast<int>(blockDim.x);
    for (int i0 = 0; i0 < c.s; i0 += width) {
      const int i = i0 + static_cast<int>(threadIdx.x);
      n += __syncthreads_count(i < c.s && node[i] >= 0);
    }
    taken = branch_of(n, c.k, c.hot);
  }
  if (threadIdx.x != 0) return;
  for (int b = 0; b < c.k; ++b) {
    cudaGraphSetConditional(c.handle[b], b == taken ? 1u : 0u);
  }
  if (c.k > 1 && c.n_active != nullptr) *c.n_active = n;
  if (taken >= 0 && c.runs != nullptr) c.runs[c.bid[taken]] += 1;
}

// The chooser's block: a warp for a cond's bool, else the slots rounded up
// to warps, at most kMaxThreads (more slots loop).
inline unsigned choose_threads(const Choice& c) {
  if (c.k == 1) return 32u;
  const int w = (c.s + 31) / 32 * 32;
  return static_cast<unsigned>(w < kMaxThreads ? w : kMaxThreads);
}

inline bool valid(const Choice& c) {
  if (c.operand == nullptr || c.k < 1 || c.k > kMaxBranches) return false;
  if (c.k > 1 && c.s < 1) return false;
  if (c.k == 3 && c.hot < 1) return false;
  return true;
}

// The loop node's arguments, by value (program.py's _LoopArgs mirrors this
// layout; the build fills the lookup and the handles, and
// round_graph_loop_build also n, the form and the codes).
struct Loop {
  int32_t* left;           // the chunk's rounds left
  const long long* step;   // the program's row counter (the rounds advance)
  const int32_t* variant;  // the table's variant column, `rows` long
  long long* runs;         // rounds run a code (kMaxVariants), then the
                           // faults, the last faulty code and the loop
                           // kernel's runs (nullptr: none)
  int rows;
  int n;                   // variants built: each slot's bodies
  int u;                   // round slots an iteration
  int ifs;                 // 0: a SWITCH node a slot; 1 (the toy's older
                           // form): an IF node a variant a slot
  int code[kMaxVariants];  // body b's variant code
  int body[kMaxVariants];  // code c's body, -1 where none was built
  // Slot u's handle (SWITCH: [u][0]; IF: [u][b], body b's).
  cudaGraphConditionalHandle handle[kMaxSlots][kMaxVariants];
  cudaGraphConditionalHandle loop;  // the WHILE node's
};

// One thread: an iteration's rounds (the module comment's slot rule and
// fault rule).  The codes are loaded before any is used, and the counts
// are fire-and-forget atomics, so the rounds wait on two loads in a row.
__global__ void loop_kernel(const Loop l) {
  const int left = *l.left;
  const long long s = *l.step;
  int code[kMaxSlots];
#pragma unroll
  for (int u = 0; u < kMaxSlots; ++u) {
    const long long r = s + u;
    code[u] = u < l.u && u < left && r >= 0 && r < l.rows ? l.variant[r]
                                                         : -1;
  }
  int taken = 0;
  bool fault = false;
#pragma unroll
  for (int u = 0; u < kMaxSlots; ++u) {
    if (u >= l.u) break;
    int b = -1;
    if (u < left && !fault) {
      const int c = code[u];
      b = c >= 0 && c < kMaxVariants ? l.body[c] : -1;
      if (b >= 0) {
        ++taken;
        if (l.runs != nullptr) {
          atomicAdd(reinterpret_cast<unsigned long long*>(l.runs + c), 1ull);
        }
      } else {
        fault = true;
        if (l.runs != nullptr) {
          atomicAdd(reinterpret_cast<unsigned long long*>(l.runs +
                                                          kMaxVariants),
                    1ull);
          l.runs[kMaxVariants + 1] = c;
        }
      }
    }
    if (l.ifs) {
      for (int v = 0; v < l.n; ++v) {
        cudaGraphSetConditional(l.handle[u][v], v == b ? 1u : 0u);
      }
    } else {
      cudaGraphSetConditional(l.handle[u][0],
                              b < 0 ? static_cast<unsigned>(kMaxVariants)
                                    : static_cast<unsigned>(b));
    }
  }
  if (left > 0) *l.left = fault ? 0 : left - taken;
  if (l.runs != nullptr) {
    atomicAdd(reinterpret_cast<unsigned long long*>(l.runs + kMaxVariants +
                                                    2),
              1ull);
  }
  cudaGraphSetConditional(l.loop, !fault && left - taken > 0 ? 1u : 0u);
}

// One thread: the attribution's WHILE iteration (round_graph_nest): the
// IF handle set, the WHILE handle cleared, so the body runs once.
__global__ void nest_kernel(cudaGraphConditionalHandle cond,
                            cudaGraphConditionalHandle loop) {
  cudaGraphSetConditional(cond, 1u);
  cudaGraphSetConditional(loop, 0u);
}

// One thread, a toy round: order[*step] = b, then the step advances (the
// IF body of variant b in round_graph_loop_toy's loop).
__global__ void toy_round(int32_t* order, int b, long long* step) {
  order[*step] = b;
  *step += 1;
}

// Appends the chooser node of group `c` (its handles created here, in `g`)
// after `prev`; *node gets it.
cudaError_t add_chooser(cudaGraph_t g, cudaGraphNode_t prev, Choice* c,
                        cudaGraphNode_t* node) {
  if (!valid(*c)) return cudaErrorInvalidValue;
  for (int b = 0; b < c->k; ++b) {
    const cudaError_t e = cudaGraphConditionalHandleCreate(&c->handle[b], g,
                                                           0, 0);
    if (e != cudaSuccess) return e;
  }
  cudaKernelNodeParams kp = {};
  void* args[1] = {c};
  kp.func = reinterpret_cast<void*>(choose_kernel);
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(choose_threads(*c));
  kp.kernelParams = args;
  return cudaGraphAddKernelNode(node, g, prev ? &prev : nullptr,
                                prev ? 1 : 0, &kp);
}

// Appends segment `seg` to `g` after `prev` (nullptr: first node), under
// an IF node on `handle` when `cond` is set.  An empty segment becomes an
// empty node.  `child`, where not nullptr, gets the child-graph node that
// holds the segment (nullptr for an empty one).
cudaError_t append(cudaGraph_t g, cudaGraphNode_t prev, cudaGraph_t seg,
                   bool cond, cudaGraphConditionalHandle handle,
                   cudaGraphNode_t* node, cudaGraphNode_t* child = nullptr) {
  if (child != nullptr) *child = nullptr;
  const cudaGraphNode_t* deps = prev ? &prev : nullptr;
  const size_t n_deps = prev ? 1 : 0;
  size_t n_nodes = 0;
  cudaError_t e = cudaGraphGetNodes(seg, nullptr, &n_nodes);
  if (e != cudaSuccess) return e;
  if (!cond) {
    if (n_nodes == 0) return cudaGraphAddEmptyNode(node, g, deps, n_deps);
    e = cudaGraphAddChildGraphNode(node, g, deps, n_deps, seg);
    if (e == cudaSuccess && child != nullptr) *child = *node;
    return e;
  }
  cudaGraphNodeParams cp = {};
  cp.type = cudaGraphNodeTypeConditional;
  cp.conditional.handle = handle;
  cp.conditional.type = cudaGraphCondTypeIf;
  cp.conditional.size = 1;
  e = cudaGraphAddNode(node, g, deps, n_deps, &cp);
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

// Appends the joined round to `g` (segments in order, a group's chooser
// node before its first segment; round_graph_build's contract), each node
// after the one before, the first with no dependency.  The choosers'
// handles are made in `g`.
cudaError_t join(cudaGraph_t g, void* const* segs, const int* group_of,
                 int n, const Choice* given, int n_groups) {
  if (n < 0 || n_groups < 0 || (n_groups > 0 && given == nullptr)) {
    return cudaErrorInvalidValue;
  }
  std::vector<Choice> c(given, given + n_groups);
  std::vector<int> seen(static_cast<size_t>(n_groups), 0);
  cudaError_t e = cudaSuccess;
  cudaGraphNode_t prev = nullptr;
  for (int i = 0; i < n && e == cudaSuccess; ++i) {
    const int grp = group_of[i];
    cudaGraphNode_t node = nullptr;
    const cudaGraph_t seg = static_cast<cudaGraph_t>(segs[i]);
    if (grp < 0) {
      e = append(g, prev, seg, false, 0, &node);
    } else if (grp >= n_groups || seen[grp] >= c[grp].k) {
      e = cudaErrorInvalidValue;
    } else {
      const int b = seen[grp]++;
      if (b == 0) e = add_chooser(g, prev, &c[grp], &prev);
      if (e == cudaSuccess) {
        e = append(g, prev, seg, true, c[grp].handle[b], &node);
      }
    }
    prev = node;
  }
  for (int k = 0; k < n_groups && e == cudaSuccess; ++k) {
    if (seen[k] != c[k].k) e = cudaErrorInvalidValue;
  }
  return e;
}

// Appends the loop to `g` (the module comment): the WHILE node, its handle
// made in `g` with default 1 applied at each launch, and in its body the
// loop kernel node, then l->u round slots (at most kMaxSlots), each a
// SWITCH node of l->n bodies or, with l->ifs, l->n IF nodes, all in series;
// the slots' handles are made in the body and written to l->handle, and
// the codes' lookup (l->code: distinct, in [0, kMaxVariants)) to l->body.
// bodies[u][b] gets slot u's body of variant b.
cudaError_t add_loop(cudaGraph_t g, Loop* l,
                     cudaGraph_t (*bodies)[kMaxVariants]) {
  if (l->n < 1 || l->n > kMaxVariants || l->u < 1 || l->u > kMaxSlots ||
      l->left == nullptr || l->step == nullptr || l->variant == nullptr ||
      l->rows < 1) {
    return cudaErrorInvalidValue;
  }
  for (int c = 0; c < kMaxVariants; ++c) l->body[c] = -1;
  for (int b = 0; b < l->n; ++b) {
    const int c = l->code[b];
    if (c < 0 || c >= kMaxVariants || l->body[c] >= 0) {
      return cudaErrorInvalidValue;
    }
    l->body[c] = b;
  }
  cudaError_t e = cudaGraphConditionalHandleCreate(
      &l->loop, g, 1, cudaGraphCondAssignDefault);
  if (e != cudaSuccess) return e;
  cudaGraphNodeParams wp = {};
  wp.type = cudaGraphNodeTypeConditional;
  wp.conditional.handle = l->loop;
  wp.conditional.type = cudaGraphCondTypeWhile;
  wp.conditional.size = 1;
  cudaGraphNode_t loop_node = nullptr;
  e = cudaGraphAddNode(&loop_node, g, nullptr, 0, &wp);
  if (e != cudaSuccess) return e;
  const cudaGraph_t body = wp.conditional.phGraph_out[0];
  const int per_slot = l->ifs ? l->n : 1;
  for (int u = 0; u < l->u; ++u) {
    for (int h = 0; h < per_slot && e == cudaSuccess; ++h) {
      e = cudaGraphConditionalHandleCreate(&l->handle[u][h], body, 0, 0);
    }
  }
  if (e != cudaSuccess) return e;
  cudaKernelNodeParams kp = {};
  void* args[1] = {l};
  kp.func = reinterpret_cast<void*>(loop_kernel);
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(1);
  kp.kernelParams = args;
  cudaGraphNode_t prev = nullptr;
  e = cudaGraphAddKernelNode(&prev, body, nullptr, 0, &kp);
  for (int u = 0; u < l->u; ++u) {
    for (int h = 0; h < per_slot && e == cudaSuccess; ++h) {
      cudaGraphNodeParams cp = {};
      cp.type = cudaGraphNodeTypeConditional;
      cp.conditional.handle = l->handle[u][h];
      cp.conditional.type = l->ifs ? cudaGraphCondTypeIf
                                   : cudaGraphCondTypeSwitch;
      cp.conditional.size = l->ifs ? 1 : l->n;
      cudaGraphNode_t node = nullptr;
      e = cudaGraphAddNode(&node, body, &prev, 1, &cp);
      if (e != cudaSuccess) break;
      if (l->ifs) {
        bodies[u][h] = cp.conditional.phGraph_out[0];
      } else {
        for (int v = 0; v < l->n; ++v) {
          bodies[u][v] = cp.conditional.phGraph_out[v];
        }
      }
      prev = node;
    }
  }
  return e;
}

// Instantiates `g` into *exec and hands both out; on an error destroys `g`.
int finish(cudaGraph_t g, cudaError_t e, void** graph, void** exec) {
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

// One thread: adds one to ran[b] (the body of branch b in
// round_graph_choice's graph).
__global__ void count_run(int32_t* ran, int b) { ran[b] += 1; }

}  // namespace round_graph

// Joins `n` segment graphs (cudaGraph_t) into one executable graph, in
// order; segment i runs unconditionally where group_of[i] is -1, else as
// the next branch of group group_of[i], whose chooser node
// (round_graph::Choice, choices[group_of[i]]: the operand, the count's
// buffer, branch_runs and the branches' run indices; its handles are made
// here) comes just before the group's first segment.  A group's k branches
// are its segments in order, and each group must get exactly k.  The
// segments are cloned, so their graphs may be destroyed after; the memory
// they use may not.  Returns the joined graph and its executable in *graph
// and *exec, or the first CUDA error (then nothing is left allocated).
extern "C" int round_graph_build(void* const* segs, const int* group_of,
                                 int n, const void* choices, int n_groups,
                                 void** graph, void** exec) {
  using namespace round_graph;
  cudaGraph_t g = nullptr;
  const cudaError_t e = cudaGraphCreate(&g, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  return finish(g, join(g, segs, group_of, n,
                        static_cast<const Choice*>(choices), n_groups),
                graph, exec);
}

// One variant's joined round as round_graph_loop_build takes it
// (program.py's _Join): round_graph_build's arguments and its code.
struct RoundJoin {
  void* const* segs;
  const int* group_of;
  int n;
  const void* choices;
  int n_groups;
  int code;
};

// The loop of the module comment over `n_joins` variants (RoundJoin: each
// joined as round_graph_build joins it, in each slot's body of its
// variant), loop->u slots of SWITCH nodes, into an executable graph.
// `loop`: a round_graph::Loop whose left, step, variant, runs, rows and
// slots are the caller's; the build writes its variants, form, codes (the
// joins'), lookup and handles (made here) back into it.  The segments are
// cloned, as by round_graph_build, once a slot.  Returns the graph and its
// executable, or the first CUDA error (then nothing is left allocated):
// invalid value for codes that repeat or lie outside [0, kMaxVariants).
extern "C" int round_graph_loop_build(const void* joins, int n_joins,
                                      void* loop, void** graph,
                                      void** exec) {
  using namespace round_graph;
  if (joins == nullptr || loop == nullptr || n_joins < 1 ||
      n_joins > kMaxVariants) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const RoundJoin* j = static_cast<const RoundJoin*>(joins);
  Loop& l = *static_cast<Loop*>(loop);
  l.n = n_joins;
  l.ifs = 0;
  for (int b = 0; b < n_joins; ++b) l.code[b] = j[b].code;
  cudaGraph_t g = nullptr;
  cudaError_t e = cudaGraphCreate(&g, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaGraph_t bodies[kMaxSlots][kMaxVariants] = {};
  e = add_loop(g, &l, bodies);
  for (int u = 0; u < l.u; ++u) {
    for (int b = 0; b < n_joins && e == cudaSuccess; ++b) {
      e = join(bodies[u][b], j[b].segs, j[b].group_of, j[b].n,
               static_cast<const Choice*>(j[b].choices), j[b].n_groups);
    }
  }
  return finish(g, e, graph, exec);
}

// A loop of toy rounds (the loop's measure and check): add_loop's loop
// with the codes, variants, slots and form of `loop` (a round_graph::Loop;
// its lookup and handles written back), each slot's body of variant b one
// toy_round node writing b at order[*step] and advancing the step
// (`loop`'s step, here written).  Returns the graph and its executable as
// round_graph_build does.
extern "C" int round_graph_loop_toy(void* loop, int32_t* order,
                                    void** graph, void** exec) {
  using namespace round_graph;
  if (loop == nullptr || order == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Loop& l = *static_cast<Loop*>(loop);
  cudaGraph_t g = nullptr;
  cudaError_t e = cudaGraphCreate(&g, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaGraph_t bodies[kMaxSlots][kMaxVariants] = {};
  e = add_loop(g, &l, bodies);
  long long* step = const_cast<long long*>(l.step);
  for (int u = 0; u < l.u && e == cudaSuccess; ++u) {
    for (int b = 0; b < l.n && e == cudaSuccess; ++b) {
      int branch = b;
      void* args[3] = {&order, &branch, &step};
      cudaKernelNodeParams kp = {};
      kp.func = reinterpret_cast<void*>(toy_round);
      kp.gridDim = dim3(1);
      kp.blockDim = dim3(1);
      kp.kernelParams = args;
      cudaGraphNode_t node = nullptr;
      e = cudaGraphAddKernelNode(&node, bodies[u][b], nullptr, 0, &kp);
    }
  }
  return finish(g, e, graph, exec);
}

// The nesting's cost (a measure): `join` (a RoundJoin) joined as
// round_graph_build joins it, at `depth` 0 straight into the graph, at 1
// inside one IF node whose handle's default, 1, is applied at each launch,
// at 2 inside a WHILE node (default 1 at each launch) whose body is
// nest_kernel, which sets the IF handle and clears the WHILE handle, then
// an IF node holding it: one iteration.  Each launch runs the round once.
// Returns the graph and its executable as round_graph_build does.
extern "C" int round_graph_nest(const void* join_args, int depth,
                                void** graph, void** exec) {
  using namespace round_graph;
  if (join_args == nullptr || depth < 0 || depth > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const RoundJoin& j = *static_cast<const RoundJoin*>(join_args);
  cudaGraph_t g = nullptr;
  cudaError_t e = cudaGraphCreate(&g, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaGraph_t where = g;
  cudaGraphNode_t prev = nullptr;
  cudaGraphConditionalHandle cond = 0, loop = 0;
  if (depth == 2) {
    e = cudaGraphConditionalHandleCreate(&loop, g, 1,
                                         cudaGraphCondAssignDefault);
    cudaGraphNodeParams wp = {};
    wp.type = cudaGraphNodeTypeConditional;
    wp.conditional.handle = loop;
    wp.conditional.type = cudaGraphCondTypeWhile;
    wp.conditional.size = 1;
    cudaGraphNode_t node = nullptr;
    if (e == cudaSuccess) e = cudaGraphAddNode(&node, g, nullptr, 0, &wp);
    if (e == cudaSuccess) where = wp.conditional.phGraph_out[0];
    if (e == cudaSuccess) {
      e = cudaGraphConditionalHandleCreate(&cond, where, 0, 0);
    }
    void* args[2] = {&cond, &loop};
    cudaKernelNodeParams kp = {};
    kp.func = reinterpret_cast<void*>(nest_kernel);
    kp.gridDim = dim3(1);
    kp.blockDim = dim3(1);
    kp.kernelParams = args;
    if (e == cudaSuccess) {
      e = cudaGraphAddKernelNode(&prev, where, nullptr, 0, &kp);
    }
  } else if (depth == 1) {
    e = cudaGraphConditionalHandleCreate(&cond, g, 1,
                                         cudaGraphCondAssignDefault);
  }
  if (depth > 0 && e == cudaSuccess) {
    cudaGraphNodeParams cp = {};
    cp.type = cudaGraphNodeTypeConditional;
    cp.conditional.handle = cond;
    cp.conditional.type = cudaGraphCondTypeIf;
    cp.conditional.size = 1;
    cudaGraphNode_t node = nullptr;
    e = cudaGraphAddNode(&node, where, prev ? &prev : nullptr, prev ? 1 : 0,
                         &cp);
    if (e == cudaSuccess) where = cp.conditional.phGraph_out[0];
  }
  if (e == cudaSuccess) {
    e = join(where, j.segs, j.group_of, j.n,
             static_cast<const Choice*>(j.choices), j.n_groups);
  }
  return finish(g, e, graph, exec);
}

// What the joining keeps of a segment's programmatic edges: the segment
// `seg` joined alone as the one branch of a cond's group on *pred
// (round_graph_build's form: its chooser node, then the IF node), into an
// executable graph; with `loop` (a round_graph::Loop of one code, its left,
// step, variant, rows and slots the caller's) that group in each slot's
// body of the loop's one variant (SWITCH slots), three levels of
// conditional nodes deep, as round_graph_loop_build places a round.
// counts[0], counts[1]: the segment's programmatic and other edges;
// counts[2], counts[3]: those of the child graph in slot 0's IF node's
// body (the clone the graph runs).  Returns the graph and its executable
// as round_graph_build does, or the first CUDA error (the counts as far as
// they were read).
extern "C" int round_graph_edges(void* seg, const void* pred,
                                 const void* loop, int* counts, void** graph,
                                 void** exec) {
  using namespace round_graph;
  for (int k = 0; k < 4; ++k) counts[k] = 0;
  cudaError_t e = edge_types(static_cast<cudaGraph_t>(seg), counts,
                             counts + 1);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaGraph_t g = nullptr;
  e = cudaGraphCreate(&g, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaGraph_t bodies[kMaxSlots][kMaxVariants] = {};
  int slots = 1;
  bodies[0][0] = g;
  if (loop != nullptr) {
    Loop l = *static_cast<const Loop*>(loop);
    l.n = 1;
    l.ifs = 0;
    e = add_loop(g, &l, bodies);
    slots = l.u;
  }
  cudaGraphNode_t child = nullptr;
  for (int u = 0; u < slots && e == cudaSuccess; ++u) {
    Choice c = {};
    c.operand = pred;
    c.k = 1;
    cudaGraphNode_t chooser = nullptr, node = nullptr;
    e = add_chooser(bodies[u][0], nullptr, &c, &chooser);
    if (e == cudaSuccess) {
      e = append(bodies[u][0], chooser, static_cast<cudaGraph_t>(seg), true,
                 c.handle[0], &node, u == 0 ? &child : nullptr);
    }
  }
  cudaGraph_t body = nullptr;
  if (e == cudaSuccess && child != nullptr) {
    e = cudaGraphChildGraphNodeGetGraph(child, &body);
  }
  if (e == cudaSuccess && body != nullptr) {
    e = edge_types(body, counts + 2, counts + 3);
  }
  return finish(g, e, graph, exec);
}

// The joined graph `graph` as the runtime describes it, in Graphviz's
// language, into the file at `path` (cudaGraphDebugDotPrint, verbose: each
// kernel node with its function's name).  Returns the CUDA error.
extern "C" int round_graph_dot(void* graph, const char* path) {
  return static_cast<int>(cudaGraphDebugDotPrint(
      static_cast<cudaGraph_t>(graph), path, cudaGraphDebugDotFlagsVerbose));
}

// The chooser of one group alone, as round_graph_build places it: a graph
// of the chooser node of `choice` (a round_graph::Choice; its handles made
// here) and the group's k IF nodes in order, branch b's body one thread
// adding one to ran[b] (int32 [k], the caller's).  Each launch (through
// round_graph_launch) chooses on the operand as it then is.  Returns the
// graph and its executable as round_graph_build does.
extern "C" int round_graph_choice(const void* choice, int32_t* ran,
                                  void** graph, void** exec) {
  using namespace round_graph;
  if (choice == nullptr || ran == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Choice c = *static_cast<const Choice*>(choice);
  cudaGraph_t g = nullptr;
  cudaError_t e = cudaGraphCreate(&g, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaGraphNode_t prev = nullptr;
  e = add_chooser(g, nullptr, &c, &prev);
  for (int b = 0; b < c.k && e == cudaSuccess; ++b) {
    cudaGraphNodeParams cp = {};
    cp.type = cudaGraphNodeTypeConditional;
    cp.conditional.handle = c.handle[b];
    cp.conditional.type = cudaGraphCondTypeIf;
    cp.conditional.size = 1;
    cudaGraphNode_t node = nullptr;
    e = cudaGraphAddNode(&node, g, &prev, 1, &cp);
    if (e != cudaSuccess) break;
    int branch = b;
    void* args[2] = {&ran, &branch};
    cudaKernelNodeParams kp = {};
    kp.func = reinterpret_cast<void*>(count_run);
    kp.gridDim = dim3(1);
    kp.blockDim = dim3(1);
    kp.kernelParams = args;
    cudaGraphNode_t body = nullptr;
    e = cudaGraphAddKernelNode(&body, cp.conditional.phGraph_out[0],
                               nullptr, 0, &kp);
    prev = node;
  }
  return finish(g, e, graph, exec);
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
