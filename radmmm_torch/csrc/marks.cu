// Device marks: empty kernels that name a phase of device work in a device
// trace (utils/profiling.device_span). Mark <name> is a pair of kernels,
// radmmm_mark_<name>_begin and radmmm_mark_<name>_end, launched on the
// caller's stream before and after the phase's work; inside a stream
// capture they become nodes of the graph, so each replay puts them on the
// device's timeline around the phase. extern "C" keeps the names as
// written in the trace.
//
// Replaces no TPU kernel: the JAX package names phases with XLA's
// named scopes, which have no counterpart inside a CUDA graph.
//
// What bounds it: one launch of one thread doing nothing, about 1-2 us of
// device time a mark.
//
// A new mark is one more name in RADMMM_MARKS and in profiling.MARKS, in
// the same order (the loader compares them).
#include <cuda_runtime.h>

#define RADMMM_MARKS(X) X(train_featurize) X(serve_stage_a) X(serve_stage_b) X(train_align) X(train_attributes)

#define RADMMM_MARK_KERNELS(name)                               \
  extern "C" __global__ void radmmm_mark_##name##_begin() {}    \
  extern "C" __global__ void radmmm_mark_##name##_end() {}
RADMMM_MARKS(RADMMM_MARK_KERNELS)

typedef void (*MarkKernel)();

#define RADMMM_MARK_PAIR(name) \
  {radmmm_mark_##name##_begin, radmmm_mark_##name##_end},
static const MarkKernel kMarks[][2] = {RADMMM_MARKS(RADMMM_MARK_PAIR)};

#define RADMMM_MARK_NAME(name) #name,
static const char* kNames[] = {RADMMM_MARKS(RADMMM_MARK_NAME)};

static const int kCount = (int)(sizeof(kNames) / sizeof(kNames[0]));

extern "C" {

int radmmm_mark_count() { return kCount; }

// The name of mark i (its kernels' names without prefix and suffix), or
// an empty string.
const char* radmmm_mark_name(int i) {
  return i >= 0 && i < kCount ? kNames[i] : "";
}

// Launches mark i's begin (end = 0) or end (end = 1) kernel on stream
// (0 on success).
int radmmm_mark_launch(int i, int end, void* stream) {
  if (i < 0 || i >= kCount || (end != 0 && end != 1))
    return (int)cudaErrorInvalidValue;
  kMarks[i][end]<<<1, 1, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

const char* radmmm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
