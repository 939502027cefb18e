// The counterpart of lax.while_loop inside a CUDA graph: a conditional
// node of type cudaGraphCondTypeWhile added to the graph that a stream is
// capturing (ops/device_loop.py drives it).  JAX lowers lax.while_loop to
// an XLA While that runs on the device (ddp_generator_tpu/solver.py:854,
// :181, ddp_generator_tpu/ops/boxqp.py:340, :366); here the loop's body is
// captured into the node's body graph, which the device re-runs as long as
// the node's condition handle is nonzero.  Nothing is read on the host.
//
//   ddp_while_begin: the handle is created on the capturing graph, a
//     one-thread kernel on the capturing stream sets it from the device
//     value of the first condition, the node is added after the stream's
//     current dependencies (and becomes its only one), and `body_stream`
//     starts capturing into the node's body graph.
//   ddp_while_end: a kernel at the end of the body sets the handle from
//     the condition computed there, and the body's capture ends.
//
// Conditional nodes need CUDA 12.3 (runtime and driver); WHILE nodes
// nested in a body, and memset/memcpy nodes in a body, 12.4.  The wrapper
// checks ddp_loop_versions first; this file compiles with any toolkit and
// returns kOldCuda where the toolkit lacks the API.
#include <cuda_runtime.h>

#include "common.cuh"

#if CUDART_VERSION >= 12040
namespace {

// The predicate is a torch bool: one byte, 0 or 1.
__global__ void set_condition(cudaGraphConditionalHandle handle,
                              const bool* value) {
  cudaGraphSetConditional(handle, *value ? 1u : 0u);
}

}  // namespace
#endif

// out[0] the toolkit the library was built with (CUDART_VERSION), out[1]
// the runtime it runs (cudaRuntimeGetVersion), out[2] the driver's
// (cudaDriverGetVersion), each as 1000 * major + 10 * minor.
extern "C" int ddp_loop_versions(int* out) {
  out[0] = CUDART_VERSION;
  cudaError_t e = cudaRuntimeGetVersion(&out[1]);
  if (e == cudaSuccess) e = cudaDriverGetVersion(&out[2]);
  return static_cast<int>(e);
}

// A stream of its own on `device` for a body's capture, never handed out
// elsewhere (torch's streams come from a pool of 32 per device, round
// robin, so two of them may be one stream): out[0] the cudaStream_t.
extern "C" int ddp_stream_create(int device, void** out) {
  int prev;
  cudaError_t e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return e;
  e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s;
  e = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  cudaSetDevice(prev);
  out[0] = s;
  return e;
}

#if CUDART_VERSION >= 13000
#define DDP_CAPTURE_INFO cudaStreamGetCaptureInfo
#define DDP_ADD_NODE cudaGraphAddNode
#define DDP_UPDATE_DEPS cudaStreamUpdateCaptureDependencies
#elif CUDART_VERSION >= 12040
#define DDP_CAPTURE_INFO cudaStreamGetCaptureInfo_v3
#define DDP_ADD_NODE cudaGraphAddNode_v2
#define DDP_UPDATE_DEPS cudaStreamUpdateCaptureDependencies_v2
#endif

// stream: the capturing stream; pred: a device bool, the first condition;
// body_stream: a stream that is not capturing, which captures the body
// until ddp_while_end.  out[0] the condition handle, out[1] the body graph
// (owned by the node).  Returns 0, a cudaError_t, or kNotCapturing /
// kOldCuda.
extern "C" int ddp_while_begin(void* stream, const void* pred,
                               void* body_stream,
                               unsigned long long* out) {
#if CUDART_VERSION >= 12040
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  cudaError_t e = DDP_CAPTURE_INFO(s, &status, nullptr, &graph, nullptr,
                                   nullptr, nullptr);
  if (e != cudaSuccess) return e;
  if (status != cudaStreamCaptureStatusActive) return ddp::kNotCapturing;
  cudaGraphConditionalHandle handle;
  e = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (e != cudaSuccess) return e;
  set_condition<<<1, 1, 0, s>>>(handle, static_cast<const bool*>(pred));
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // the dependencies now end in the kernel above
  const cudaGraphNode_t* deps;
  const cudaGraphEdgeData* edges;
  size_t n_deps;
  e = DDP_CAPTURE_INFO(s, &status, nullptr, &graph, &deps, &edges, &n_deps);
  if (e != cudaSuccess) return e;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  e = DDP_ADD_NODE(&node, graph, deps, edges, n_deps, &params);
  if (e != cudaSuccess) return e;
  cudaGraph_t body = params.conditional.phGraph_out[0];
  e = DDP_UPDATE_DEPS(s, &node, nullptr, 1, cudaStreamSetCaptureDependencies);
  if (e != cudaSuccess) return e;
  e = cudaStreamBeginCaptureToGraph(static_cast<cudaStream_t>(body_stream),
                                    body, nullptr, nullptr, 0,
                                    cudaStreamCaptureModeThreadLocal);
  if (e != cudaSuccess) return e;
  out[0] = handle;
  out[1] = reinterpret_cast<unsigned long long>(body);
  return 0;
#else
  return ddp::kOldCuda;
#endif
}

// body_stream: the stream ddp_while_begin started; handle: its out[0];
// pred: a device bool, the condition after the body.  Ends the body's
// capture.
extern "C" int ddp_while_end(void* body_stream, unsigned long long handle,
                             const void* pred) {
#if CUDART_VERSION >= 12040
  cudaStream_t s = static_cast<cudaStream_t>(body_stream);
  set_condition<<<1, 1, 0, s>>>(handle, static_cast<const bool*>(pred));
  cudaError_t launched = cudaGetLastError();
  cudaGraph_t body;
  cudaError_t e = cudaStreamEndCapture(s, &body);
  return launched != cudaSuccess ? launched : e;
#else
  return ddp::kOldCuda;
#endif
}

// Ends a body's capture after the body raised, so that the stream is
// usable again; the enclosing capture is then invalid and fails at its end.
extern "C" int ddp_while_abort(void* body_stream) {
  cudaGraph_t body;
  cudaError_t e = cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream),
                                       &body);
  cudaGetLastError();
  return e;
}
