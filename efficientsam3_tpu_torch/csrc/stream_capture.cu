// Whether a stream is being captured into a CUDA graph, and the capture's
// id: ops/_build.tickets keeps the ticket buffers of the backward kernels
// (depthwise_conv2d.cu, layer_norm.cu) by stream outside capture and by
// stream and capture during one, so a graph's replays never share tickets
// with eager launches or with another graph. Replaces no TPU kernel: the
// JAX VJPs hold no state across calls.

#include <cuda_runtime.h>

// capturing: 1 while `stream` is being captured (0 otherwise, or when a
// capture was invalidated); id: the capture's id, unique in the process.
// Returns a CUDA error.
extern "C" int stream_capture_id(void* stream, int* capturing, unsigned long long* id) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  unsigned long long ident = 0;
  const cudaError_t err =
      cudaStreamGetCaptureInfo(static_cast<cudaStream_t>(stream), &status, &ident);
  if (err != cudaSuccess) return static_cast<int>(err);
  *capturing = status == cudaStreamCaptureStatusActive;
  *id = ident;
  return 0;
}
