// CUDA graph conditional nodes for the executor's control flow: a kernel
// that sets a conditional node's handle from a condition tensor on the
// device, and the host code that adds a WHILE or IF node to the graph
// being captured on a stream and captures the node's body into it.
//
// Replaces: no Pallas kernel.  The JAX package lowers a forward-only
// while to lax.while_loop and a conditional_block to lax.cond inside one
// XLA executable (paddle_tpu/fluid/executor.py:553 `_lower_while`, :735
// `_lower_conditional_block`), so its condition never crosses to the
// host.  In a CUDA graph the same holds only through conditional nodes
// (CUDA 12.3 and later): the node's body graph runs while (WHILE) or
// once if (IF) the handle holds a non-zero value, and only a kernel can
// set the handle (cudaGraphSetConditional, a device function).
//
// Bound: one thread reads one scalar: the launch itself, a few
// microseconds; nothing to move.
//
// Design: `graph_cond_set` is the one kernel: a single thread reads the
// condition (bool / int8 / uint8, int32, int64, f32, f64, or a 16-bit
// float read by its bits, non-zero as Python's bool() of the tensor:
// NaN true, -0.0 false) and sets the handle.  The executor launches it
// before the node (the entry condition) and at the end of a WHILE body
// (the next trip's).  The host side never reads the condition:
//
//   graph_cond_handle  creates a handle in the graph being captured on
//                      `stream` (reset to 0 at each launch of the graph)
//   graph_cond_node    adds the WHILE / IF node after the capture's
//                      current dependencies, makes the node the
//                      capture's one dependency, and begins capturing
//                      `body_stream` into the node's body graph
//   graph_cond_end     ends that body capture
//
// A body graph may hold kernels, memcpy / memset nodes, child graphs and
// conditional nodes, so what runs in a body must not fork onto another
// stream, record an event or call the host; the caller routes the body
// stream's allocations into the graph's memory pool.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

__global__ void set_cond_kernel(cudaGraphConditionalHandle handle,
                                const void* pred, int kind) {
  unsigned int v = 0;
  switch (kind) {
    case 0: v = *static_cast<const uint8_t*>(pred) != 0; break;
    case 1: v = *static_cast<const int32_t*>(pred) != 0; break;
    case 2: v = *static_cast<const int64_t*>(pred) != 0; break;
    case 3: v = *static_cast<const float*>(pred) != 0.0f ||
                *static_cast<const float*>(pred) !=
                    *static_cast<const float*>(pred); break;
    case 4: v = *static_cast<const double*>(pred) != 0.0 ||
                *static_cast<const double*>(pred) !=
                    *static_cast<const double*>(pred); break;
    case 5: v = (*static_cast<const uint16_t*>(pred) & 0x7fff) != 0; break;
    default: v = 0;
  }
  cudaGraphSetConditional(handle, v);
}

}  // namespace

extern "C" int graph_cond_versions(int* driver, int* runtime) {
  cudaError_t err = cudaDriverGetVersion(driver);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaRuntimeGetVersion(runtime);
}

extern "C" int graph_cond_handle(void* stream,
                                 unsigned long long* handle_out) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  unsigned long long id = 0;
  cudaGraph_t graph = nullptr;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, &id, &graph,
                                             nullptr, nullptr, nullptr);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, &id, &graph,
                                             nullptr, nullptr);
#endif
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive)
    return (int)cudaErrorStreamCaptureInvalidated;
  cudaGraphConditionalHandle h;
  err = cudaGraphConditionalHandleCreate(&h, graph, 0,
                                         cudaGraphCondAssignDefault);
  if (err != cudaSuccess) return (int)err;
  *handle_out = (unsigned long long)h;
  return 0;
}

extern "C" int graph_cond_set(unsigned long long handle, const void* pred,
                              int kind, void* stream) {
  set_cond_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      (cudaGraphConditionalHandle)handle, pred, kind);
  return (int)cudaGetLastError();
}

extern "C" int graph_cond_node(void* stream, unsigned long long handle,
                               int is_while, void* body_stream, int mode) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  unsigned long long id = 0;
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t n = 0;
#if CUDART_VERSION >= 13000
  const cudaGraphEdgeData* edges = nullptr;
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, &id, &graph, &deps,
                                             &edges, &n);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, &id, &graph, &deps,
                                             &n);
#endif
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive)
    return (int)cudaErrorStreamCaptureInvalidated;
  // the struct's union has members without a default constructor: it
  // is zeroed as raw storage
  alignas(cudaGraphNodeParams) unsigned char raw[sizeof(cudaGraphNodeParams)];
  memset(raw, 0, sizeof(raw));
  cudaGraphNodeParams* params = reinterpret_cast<cudaGraphNodeParams*>(raw);
  params->type = cudaGraphNodeTypeConditional;
  params->conditional.handle = (cudaGraphConditionalHandle)handle;
  params->conditional.type =
      is_while ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  params->conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, edges, n, params);
#else
  err = cudaGraphAddNode(&node, graph, deps, n, params);
#endif
  if (err != cudaSuccess) return (int)err;
  cudaGraph_t body = params->conditional.phGraph_out[0];
#if CUDART_VERSION >= 13000
  err = cudaStreamUpdateCaptureDependencies(s, &node, nullptr, 1,
                                            cudaStreamSetCaptureDependencies);
#else
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                            cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return (int)err;
  return (int)cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(body_stream), body, nullptr, nullptr, 0,
      static_cast<cudaStreamCaptureMode>(mode));
}

extern "C" int graph_cond_end(void* body_stream) {
  cudaGraph_t g = nullptr;
  return (int)cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream),
                                   &g);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
