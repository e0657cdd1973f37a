// CUDA-graph plumbing for the decoder's one-sync block loop (sm_90a).
//
// The counterpart of the JAX package's lax.while_loop over denoise steps
// (src/repro/core/decoder.py, _fused_fn): a block runs as one CUDA graph
//
//   prologue -> n x ( set_if(pred) -> IF(pred) { body } ) -> epilogue
//
// where prologue, body and epilogue are graphs that PyTorch captured
// (the refresh pass, one denoise step, the straggler finalize) and pred
// is a 0-dim bool on the device that the prologue and every body
// recompute (the loop condition). Each IF node runs its body only while
// pred holds, so the iterations after the loop closes do no work, and
// the host reads nothing until the block ends.
//
// PyTorch builds the three graphs (stream capture into its memory pool);
// this library clones each into the block graph as a child graph node,
// adds the conditional nodes (CUDA 12.4+: cudaGraphConditionalHandleCreate,
// cudaGraphAddNode with cudaGraphNodeTypeConditional) and the one kernel
// of its own, set_if_kernel, which copies pred into the IF node's handle
// (cudaGraphSetConditional) right before the node. Plain C interface,
// bound with ctypes; every call returns its cudaError_t.

#include <cuda_runtime.h>

__global__ void set_if_kernel(cudaGraphConditionalHandle handle,
                              const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

extern "C" {

int graph_loop_create(void** graph) {
  return cudaGraphCreate(reinterpret_cast<cudaGraph_t*>(graph), 0);
}

// Clones `child` into `graph` after `dep` (nullptr: no dependency).
int graph_loop_add_child(void* graph, void* dep, void* child, void** node) {
  cudaGraphNode_t d = static_cast<cudaGraphNode_t>(dep);
  return cudaGraphAddChildGraphNode(
      reinterpret_cast<cudaGraphNode_t*>(node),
      static_cast<cudaGraph_t>(graph), d ? &d : nullptr, d ? 1 : 0,
      static_cast<cudaGraph_t>(child));
}

// After `dep`: set_if_kernel(handle, pred), then an IF node on that handle
// whose body is a clone of `body`. Returns the IF node.
int graph_loop_add_if(void* graph, void* dep, const void* pred, void* body,
                      void** node) {
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  cudaGraphConditionalHandle handle;
  cudaError_t err = cudaGraphConditionalHandleCreate(&handle, g, 0, 0);
  if (err != cudaSuccess) return err;
  cudaGraphNode_t d = static_cast<cudaGraphNode_t>(dep);
  const bool* p = static_cast<const bool*>(pred);
  void* args[] = {&handle, &p};
  cudaKernelNodeParams kp = {};
  kp.func = reinterpret_cast<void*>(set_if_kernel);
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(1);
  kp.kernelParams = args;
  cudaGraphNode_t set_node;
  err = cudaGraphAddKernelNode(&set_node, g, d ? &d : nullptr, d ? 1 : 0,
                               &kp);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams cp = {};
  cp.type = cudaGraphNodeTypeConditional;
  cp.conditional.handle = handle;
  cp.conditional.type = cudaGraphCondTypeIf;
  cp.conditional.size = 1;
  cudaGraphNode_t if_node;
  err = cudaGraphAddNode(&if_node, g, &set_node, 1, &cp);
  if (err != cudaSuccess) return err;
  cudaGraphNode_t inner;
  err = cudaGraphAddChildGraphNode(&inner, cp.conditional.phGraph_out[0],
                                   nullptr, 0,
                                   static_cast<cudaGraph_t>(body));
  if (err != cudaSuccess) return err;
  *node = if_node;
  return cudaSuccess;
}

int graph_loop_instantiate(void* graph, void** exec) {
  return cudaGraphInstantiate(reinterpret_cast<cudaGraphExec_t*>(exec),
                              static_cast<cudaGraph_t>(graph), 0);
}

int graph_loop_upload(void* exec, void* stream) {
  return cudaGraphUpload(static_cast<cudaGraphExec_t>(exec),
                         static_cast<cudaStream_t>(stream));
}

int graph_loop_launch(void* exec, void* stream) {
  return cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                         static_cast<cudaStream_t>(stream));
}

int graph_loop_node_count(void* graph, unsigned long long* n) {
  size_t count = 0;
  cudaError_t err = cudaGraphGetNodes(static_cast<cudaGraph_t>(graph),
                                      nullptr, &count);
  *n = count;
  return err;
}

int graph_loop_destroy(void* graph, void* exec) {
  cudaError_t err = cudaSuccess;
  if (exec) err = cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
  if (graph && err == cudaSuccess)
    err = cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
  return err;
}

const char* graph_loop_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
